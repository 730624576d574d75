"""Device mesh, data, parameter and tensor parallelism (port of
``ldmae_tpu/parallel/mesh.py``).

The JAX package lays a ``(dp, fsdp, tp)`` mesh over every device and lets
pjit insert the collectives from the shardings (``dit_param_spec``). The
port runs one process per card: the mesh is a ``DeviceMesh`` over the ranks
with the same axis names and the same order, tp innermost, so the ranks of
a tp group are consecutive.

* ``dp``: ``DistributedDataParallel`` (``wrap_data_parallel``, the
  reference's DDP). DDP averages the ranks' gradients, each the gradient of
  the mean loss over that rank's local batch; the local batches are equal,
  so that average is the gradient of the mean loss over the global batch,
  which is what the JAX step differentiates.
* ``fsdp``: FSDP2 (``wrap_fsdp``: ``fully_shard`` on every block and on the
  root) shards the parameters, gradients and AdamW state over the fsdp
  ranks, and with dp > 1 shards over fsdp and replicates over dp (hybrid
  sharding). The batch is split over (dp, fsdp) jointly, as in the JAX
  step, so a rank's data index is its rank.
* ``tp`` (sampling and training): ``shard_dit_for_tp_`` keeps a rank's
  slices of every block's linears, by the JAX tp rules: qkv's output rows a rank's heads of
  q, k and v, proj's input columns, adaLN's output rows contiguously, the
  MLP's hidden dim (fc1 rows, fc2 columns; w3 columns). The per-out-channel
  int8 scales are those of the full weight (it quantizes before it shards).
  One difference is kept: the merged SwiGLU ``w12`` is sharded on its output
  rows gate-aligned, rank r holding [w1 rows r | w2 rows r], where the JAX
  package shards it on its contracting dim because XLA cannot partition #4:
  here #4 runs whole on each rank's rows (every column it writes is the
  column it writes at tp 1) and the MLP needs one all-reduce, after w3.
  Ranks of a tp group sample (or train on) one batch together; its data
  index (the batch rows it owns) is ``rank // tp``. In training every rank
  builds and seeds the whole model alike and then keeps its slices, so the
  slices are those of the one-process model; ``tp_state_gather`` is the
  exact inverse of ``tp_state_slice`` (checkpoints hold the whole model).
  With dp > 1, DDP runs over the dp ranks (``wrap_data_parallel``'s
  ``group``); with fsdp > 1, FSDP2 shards each rank's tp-local parameters
  over the fsdp (or dp x fsdp) ranks on dim 0, so a rank holds 1/(tp fsdp)
  of a split leaf, as the JAX 2-D layout does (ROADMAP, kept differences:
  the JAX rule shards fsdp on the complementary dim).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from .distributed import get_world_size, group_all_gather

AXES = ("dp", "fsdp", "tp")


def create_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1, device_type: Optional[str] = None):
    """The ``(dp, fsdp, tp)`` mesh over the ranks: ``dp = -1`` takes what
    fsdp x tp leaves, and dp x fsdp x tp must equal the world size (the JAX
    function's assertions and messages, a rank standing for a device).
    Returns a ``DeviceMesh`` with ``AXES`` as its dim names when a process
    group exists, else None (one process: nothing to lay out).
    ``device_type`` defaults to the card under NCCL and the CPU otherwise;
    FSDP needs it to be the parameters' device type."""
    n = get_world_size()
    if dp == -1:
        if n % (fsdp * tp) != 0:
            raise AssertionError(f"{n} devices not divisible by fsdp*tp={fsdp * tp}")
        dp = n // (fsdp * tp)
    if dp * fsdp * tp != n:
        raise AssertionError(f"mesh {dp}x{fsdp}x{tp} != {n} devices")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, (dp, fsdp, tp), mesh_dim_names=AXES)


def wrap_data_parallel(module: nn.Module, device: Optional[Union[str, torch.device]] = None, group=None
                       ) -> Optional[nn.parallel.DistributedDataParallel]:
    """``module`` in ``DistributedDataParallel`` over ``group`` (default:
    every rank; under tp the mesh's dp group) whenever a process group
    exists (at world 1 too, so one card runs DDP's buckets and all-reduce),
    else None. Every parameter takes a gradient in each step
    (``find_unused_parameters=False``); the buffers are constants that every
    rank computes alike, so they are not broadcast before each forward."""
    if not dist.is_initialized():
        return None
    device = torch.device(device) if device is not None else next(module.parameters()).device
    return nn.parallel.DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        find_unused_parameters=False, broadcast_buffers=False, process_group=group)


def wrap_fsdp(module: nn.Module, mesh) -> nn.Module:
    """FSDP2 in place: ``fully_shard`` on each of ``module.blocks`` and on
    the root, over the mesh's fsdp dim, or over (dp, fsdp) as hybrid
    sharding (shard over fsdp, replicate over dp) when dp > 1. Parameters
    are gathered in fp32, as the one-process step holds them, and the model
    casts them where it uses them (no mixed-precision policy), so the
    forward's numbers are the one-process forward's. Under tp the module
    holds this rank's slices (``shard_dit_for_tp_`` first), which FSDP2
    shards on dim 0 over this rank's fsdp group. Returns ``module``."""
    from torch.distributed.fsdp import fully_shard

    sub = mesh["dp", "fsdp"] if mesh["dp"].size() > 1 else mesh["fsdp"]
    for blk in module.blocks:
        fully_shard(blk, mesh=sub)
    fully_shard(module, mesh=sub)
    return module


# ---------------------------------------------------------------------------
# tensor parallelism: the tp rules of the JAX dit_param_spec, in nn.Linear's
# (out, in) layout
# ---------------------------------------------------------------------------

_COLUMN, _ROW = 0, 1  # the dim a rule splits: nn.Linear's output rows or input columns


def _tp_rule(name: str, spec, n: int, r: int):
    """(dim, index) of rank r's slice of the block linear ``name`` (its
    module path from the block, e.g. 'attn.qkv'), or None for a module that
    stays whole."""
    d, h = spec.hidden_size, spec.num_heads
    if name == "attn.qkv":  # rows [q; k; v], each H heads of head_dim: rank r's heads of each
        hd = d // h
        heads = torch.arange(r * h // n, (r + 1) * h // n)
        rows = (heads[:, None] * hd + torch.arange(hd)).reshape(-1)
        return _COLUMN, torch.cat([rows + j * d for j in range(3)])
    if name in ("attn.proj", "mlp.w3", "mlp.fc2"):
        k = d if name == "attn.proj" else (spec.swiglu_hidden if name == "mlp.w3" else spec.mlp_hidden)
        return _ROW, torch.arange(r * k // n, (r + 1) * k // n)
    if name == "mlp.w12":  # gate-aligned: [w1 rows r | w2 rows r]
        hh = spec.swiglu_hidden
        rows = torch.arange(r * hh // n, (r + 1) * hh // n)
        return _COLUMN, torch.cat([rows, rows + hh])
    if name == "mlp.fc1":
        hm = spec.mlp_hidden
        return _COLUMN, torch.arange(r * hm // n, (r + 1) * hm // n)
    if name == "adaLN_modulation.1":  # contiguous over the (num_adaln * D) outputs
        o = spec.num_adaln * d
        return _COLUMN, torch.arange(r * o // n, (r + 1) * o // n)
    return None


def tp_slice_index(key: str, spec, n: int, r: int):
    """(dim, index) of rank r's slice of the state-dict entry ``key`` of a
    DiT under tp n, or None when every rank holds it whole. ``key`` names a
    block linear's weight, bias or int8 ``w_q`` / ``w_scale``: a column
    split takes the rows (the bias and the per-out-channel scales with
    them), a row split takes the weight's input columns and keeps the bias
    and scales whole."""
    parts = key.split(".")
    if parts[0] != "blocks" or len(parts) < 4:
        return None
    rule = _tp_rule(".".join(parts[2:-1]), spec, n, r)
    if rule is None:
        return None
    dim, index = rule
    if parts[-1] in ("weight", "w_q"):
        return dim, index
    if dim == _COLUMN and parts[-1] in ("bias", "w_scale"):
        return 0, index
    return None  # a row split's bias and scales: whole


def tp_state_slice(state: dict, spec, n: int, r: int) -> dict:
    """Rank r's entries of a DiT state dict (sampling layout: half-split
    RoPE, int8 where quantized) under tp n: each entry that a rule splits
    sliced, every other one itself."""
    out = {}
    for key, t in state.items():
        found = tp_slice_index(key, spec, n, r)
        out[key] = t if found is None else t.detach().index_select(found[0], found[1].to(t.device)).contiguous()
    return out


def tp_state_gather(parts: list, spec) -> dict:
    """The whole DiT state dict from every rank's ``tp_state_slice`` (a list
    in rank order, n = its length): each split entry put back at its
    index, every other entry rank 0's. ``tp_state_gather([tp_state_slice(sd,
    spec, n, r) for r in range(n)], spec)`` equals ``sd`` bit for bit."""
    n, out = len(parts), {}
    for key, t0 in parts[0].items():
        found = tp_slice_index(key, spec, n, 0)
        if found is None:
            out[key] = t0
            continue
        dim = found[0]
        full = t0.new_empty(*[t0.shape[i] * n if i == dim else t0.shape[i] for i in range(t0.dim())])
        for r, part in enumerate(parts):
            full.index_copy_(dim, tp_slice_index(key, spec, n, r)[1].to(t0.device), part[key])
        out[key] = full
    return out


def all_gather_tp_state(sd: dict, spec, group) -> dict:
    """The whole state dict from every tp rank's slices ``sd`` (a state dict
    of parameter names, or of gradients or optimizer moments by those
    names): collective, each split entry all-gathered over ``group`` in
    ``sd``'s order, which every rank of the group shares."""
    n = dist.get_world_size(group)
    parts = [dict(sd)] + [{} for _ in range(n - 1)]
    for key, t in sd.items():
        if tp_slice_index(key, spec, n, 0) is not None:
            for r, part in enumerate(group_all_gather(t.detach().unsqueeze(0), group, dim=0).unbind(0)):
                parts[r][key] = part
    return tp_state_gather(parts, spec)


def tp_group_of(model: nn.Module):
    """The tp group a DiT's blocks were sharded over
    (``shard_dit_for_tp_``), or None."""
    blocks = getattr(model, "blocks", None)
    return getattr(blocks[0], "tp_group", None) if blocks else None


def _check_tp(spec, n: int) -> None:
    h = spec.swiglu_hidden if spec.use_swiglu else spec.mlp_hidden
    if spec.num_heads % n or h % n or (spec.num_adaln * spec.hidden_size) % n:
        raise ValueError(f"tp {n} must divide the heads ({spec.num_heads}), the MLP's hidden dim ({h}) and the "
                         f"adaLN outputs ({spec.num_adaln * spec.hidden_size})")


@torch.no_grad()
def shard_dit_for_tp_(model: nn.Module, group) -> nn.Module:
    """Keep this rank's slices (its index in ``group``) of every block
    linear of a full ``LightningDiT`` in place (``tp_state_slice``), and
    point the blocks at the group. Run it after ``permute_qk_for_half_rope``
    (the slices are whole heads, so q and k keep their permuted channels)
    and after ``quantize_dit_`` (the scales are the full weight's, as the
    JAX package quantizes before it shards). Without a group, or with a
    group of one, it changes nothing. Returns the model."""
    n = dist.get_world_size(group) if group is not None else 1
    if n == 1:
        return model
    spec = model.spec
    _check_tp(spec, n)
    state = model.state_dict(keep_vars=True)
    for key, part in tp_state_slice(state, spec, n, dist.get_rank(group)).items():
        t = state[key]
        if part is t:
            continue
        path, leaf = key.rsplit(".", 1)
        module = model.get_submodule(path)
        setattr(module, leaf, nn.Parameter(part, requires_grad=t.requires_grad) if isinstance(t, nn.Parameter)
                else part)
        if isinstance(module, nn.Linear):
            module.out_features, module.in_features = module.weight.shape
    for blk in model.blocks:
        blk.tp_group = group
    return model
