"""Train state and ``.pt`` checkpoints (port of ``ldmae_tpu/train/state.py``).

A checkpoint is the reference's DiT layout, ``{model, ema, opt, config,
step}`` (the JAX package's Orbax checkpoints mirror it; a VMAE state has no
EMA and its checkpoint no ``ema``), written to
``<exp_dir>/checkpoints/<step:07d>.pt``: ``model`` and ``ema`` are state
dicts in the canonical interleaved RoPE layout, so the inference CLI and the
reference load them as they are; ``opt`` is the AdamW state dict, its
moments re-indexed the same way. A run in the half-split layout is
permuted back on save and forward again on restore. Resume picks the
largest step. Orbax checkpoints are not read or written here.

Under data parallelism the state also holds the ``DistributedDataParallel``
wrapper that the step runs through (``ddp``); ``model`` stays the module
itself, so the EMA and the checkpoints are the module's, and a checkpoint
file is what a one-process run writes. Rank 0 writes it and every rank
waits at a barrier until it is on disk; every rank restores.

Under FSDP (``init_sharded_train_state``) the model, the EMA and the AdamW
state are sharded: a checkpoint gathers their full state dicts
(``torch.distributed.checkpoint.state_dict``, every rank taking part) and
writes the same file, the optimizer state indexed by parameter as
``torch.optim`` indexes it; a restore hands each rank the full state dicts
to shard. So a checkpoint written under ``--fsdp`` restores in one process
and the reverse.

Under tensor parallelism (``parallel.shard_dit_for_tp_``; with FSDP too) a
checkpoint is still the one-process file: every rank takes part in
gathering the model, the EMA and the AdamW moments over fsdp (as above,
every rank receiving them) and then over tp (``parallel.tp_state_gather``),
and rank 0 writes the whole model; a restore hands each rank its slices
(``parallel.tp_state_slice``). So a checkpoint written under ``--tp``
restores in one process and the reverse.

The JAX package's Orbax checkpoints (``checkpoints/NNNNNNN/`` directories)
are not read: a restore that finds one later than every ``.pt`` raises and
names the conversion (``python -m ldmae_tpu.cli.export_torch``), rather
than start again from step 0.
"""

from __future__ import annotations

import copy
import os
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn as nn

from ..models.lightningdit import LightningDiT, permute_qk_for_half_rope
from ..parallel.distributed import barrier, get_rank, group_size
from ..parallel.mesh import all_gather_tp_state, tp_group_of, tp_state_slice

# what the refusals of the JAX package's Orbax checkpoints say to do instead
ORBAX_HINT = ("the port reads .pt / .pth checkpoints only (it does not import jax or orbax): convert the directory in "
              "the JAX environment with `python -m ldmae_tpu.cli.export_torch --config <yaml> --ckpt <dir> --out "
              "<file>.pt` and pass the .pt (sampling: --ckpt; training: train.weight_init). The export holds the "
              "model and the EMA; AdamW's moments do not cross (it writes an empty opt), so a training run "
              "continued on the port restarts them")


@dataclass
class TrainState:
    """The step, the model (a ``LightningDiT`` or a ``VMAE``, never a
    wrapper), its EMA (None for the VMAE, whose trainer keeps none), the
    optimizer, and under data parallelism the ``DistributedDataParallel``
    wrapper the train step calls (None for one process)."""

    step: int
    model: nn.Module
    ema: Optional[nn.Module]
    optimizer: torch.optim.Optimizer
    ddp: Optional[nn.Module] = None


def init_train_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> TrainState:
    """Step 0, with the EMA a copy of the model that takes no gradient."""
    ema = copy.deepcopy(model).requires_grad_(False)
    return TrainState(step=0, model=model, ema=ema, optimizer=optimizer)


def init_sharded_train_state(model: nn.Module, mesh, make_optimizer: Callable) -> TrainState:
    """Step 0 under tp and/or FSDP: the EMA copied from the whole model,
    then the model and the EMA sharded alike, first to this rank's tp
    slices (``parallel.shard_dit_for_tp_`` over the mesh's tp group, when
    tp > 1), then by FSDP2 (``parallel.wrap_fsdp``, when fsdp > 1), and the
    optimizer built by ``make_optimizer(parameters)`` over the sharded
    parameters."""
    from ..parallel.mesh import shard_dit_for_tp_, wrap_fsdp

    ema = copy.deepcopy(model).requires_grad_(False)
    for module in (model, ema):
        if mesh["tp"].size() > 1:
            shard_dit_for_tp_(module, mesh["tp"].get_group())
        if mesh["fsdp"].size() > 1:
            wrap_fsdp(module, mesh)
    return TrainState(step=0, model=model, ema=ema, optimizer=make_optimizer(model.parameters()))


def _sharded(module: Optional[nn.Module]) -> bool:
    return module is not None and hasattr(module, "set_requires_gradient_sync")


def _full_state(module: nn.Module, every_rank: bool = False) -> Dict[str, torch.Tensor]:
    """The module's state dict with whole tensors: under FSDP gathered
    (collective; rank 0 gets them, on the CPU, or with ``every_rank`` every
    rank, on the device), else as it is."""
    if not _sharded(module):
        return module.state_dict()
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

    return get_model_state_dict(module, options=StateDictOptions(full_state_dict=True, cpu_offload=not every_rank))


def _param_names(model: nn.Module) -> List[str]:
    return [n for n, p in model.named_parameters() if p.requires_grad]


def _full_optimizer_state(state: TrainState, every_rank: bool = False) -> Dict[str, Any]:
    """The optimizer's state dict as ``torch.optim`` writes it (parameters
    by index); under FSDP gathered from the shards (collective; rank 0 gets
    it, or with ``every_rank`` every rank)."""
    if not _sharded(state.model):
        return state.optimizer.state_dict()
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_optimizer_state_dict

    osd = get_optimizer_state_dict(state.model, state.optimizer,
                                   options=StateDictOptions(full_state_dict=True, cpu_offload=not every_rank))
    if not osd:  # ranks other than 0
        return osd
    index = {n: i for i, n in enumerate(_param_names(state.model))}
    # the groups as torch.optim writes them (its own values and indices)
    return {"state": {index[n]: s for n, s in osd["state"].items()},
            "param_groups": state.optimizer.state_dict()["param_groups"]}


def _load_optimizer_state(state: TrainState, opt: Dict[str, Any]) -> None:
    if not _sharded(state.model):
        state.optimizer.load_state_dict(opt)
        return
    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_optimizer_state_dict

    names = _param_names(state.model)
    by_name = {"state": {names[i]: s for i, s in opt["state"].items()},
               "param_groups": [dict(g, params=[names[i] for i in g["params"]]) for g in opt["param_groups"]]}
    set_optimizer_state_dict(state.model, state.optimizer, by_name, options=StateDictOptions(full_state_dict=True))
    for group, saved in zip(state.optimizer.param_groups, opt["param_groups"]):  # the values as written
        group.update({k: v for k, v in saved.items() if k != "params"})


def _load_module_state(module: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    if not _sharded(module):
        module.load_state_dict(sd, strict=True)
        return
    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_model_state_dict

    set_model_state_dict(module, sd, options=StateDictOptions(full_state_dict=True, strict=True))


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _opt_moments(opt: Dict[str, Any], names: List[str], fn: Callable) -> Dict[str, Any]:
    """``opt`` with each AdamW moment dict (by parameter name) replaced by
    ``fn(moments)``; the steps and groups as they are."""
    out = {"state": {i: dict(s) for i, s in opt["state"].items()}, "param_groups": opt["param_groups"]}
    for key in _MOMENTS:
        by_name = {names[i]: s[key] for i, s in opt["state"].items() if key in s}
        for name, t in fn(by_name).items():
            out["state"][names.index(name)][key] = t
    return out


def _ckpt_dir(base: str) -> str:
    return os.path.abspath(os.path.join(base, "checkpoints"))


def list_checkpoints(base_dir: str) -> List[int]:
    d = _ckpt_dir(base_dir)
    if not os.path.isdir(d):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(d) if (m := re.fullmatch(r"(\d{7})\.pt", name)))


def _refuse_orbax(base_dir: str, steps: List[int]) -> None:
    """Raise where the JAX package's Orbax checkpoints (``NNNNNNN/``
    directories) reach further than every ``.pt``: resuming from an older
    step, or from step 0, would drop that progress silently."""
    d = _ckpt_dir(base_dir)
    if not os.path.isdir(d):
        return
    orbax = sorted(name for name in os.listdir(d)
                   if re.fullmatch(r"\d{7}", name) and os.path.isdir(os.path.join(d, name)))
    if orbax and int(orbax[-1]) > (steps[-1] if steps else -1):
        raise NotImplementedError(f"{os.path.join(d, orbax[-1])} is an Orbax checkpoint of the JAX package: "
                                  f"{ORBAX_HINT}")


def _permute_opt_state(opt_sd: Dict[str, Any], model: LightningDiT, inverse: bool) -> Dict[str, Any]:
    """The AdamW moments of the q/k channels moved between the RoPE layouts
    (optimizer state is indexed by the parameters' order in the model)."""
    names = _param_names(model)
    state = opt_sd["state"]
    out = {"state": {i: dict(s) for i, s in state.items()}, "param_groups": opt_sd["param_groups"]}
    for key in ("exp_avg", "exp_avg_sq"):
        by_name = {names[i]: s[key] for i, s in state.items() if key in s}
        if len(by_name) != len(names):  # no step taken yet
            continue
        moved = permute_qk_for_half_rope(by_name, model.spec, inverse=inverse)
        for i in state:
            out["state"][i][key] = moved[names[i]]
    return out


def save_checkpoint(base_dir: str, state: TrainState, config: Optional[Dict] = None,
                    half_rope: bool = False) -> str:
    """Write ``<base_dir>/checkpoints/<step:07d>.pt`` (atomically, on rank 0,
    with every rank waiting until it is written) and return its path;
    ``half_rope``: the run trains in the half-split layout."""
    spec = state.model.spec
    path = os.path.join(_ckpt_dir(base_dir), f"{int(state.step):07d}.pt")
    # every rank takes part in the gathers under FSDP and tp; rank 0 writes
    tp = tp_group_of(state.model)
    model_sd, opt = _full_state(state.model, tp is not None), _full_optimizer_state(state, tp is not None)
    ema_sd = None if state.ema is None else _full_state(state.ema, tp is not None)
    if tp is not None:
        model_sd = all_gather_tp_state(model_sd, spec, tp)
        ema_sd = None if ema_sd is None else all_gather_tp_state(ema_sd, spec, tp)
        opt = _opt_moments(opt, _param_names(state.model), lambda m: all_gather_tp_state(m, spec, tp))
    if get_rank() == 0:

        def canonical(sd):
            sd = {k: v.detach().cpu() for k, v in sd.items()}
            return permute_qk_for_half_rope(sd, spec, inverse=True) if half_rope else sd

        if half_rope:
            opt = _permute_opt_state(opt, state.model, inverse=True)
        ckpt = {"model": canonical(model_sd)}
        if ema_sd is not None:
            ckpt["ema"] = canonical(ema_sd)
        ckpt |= {"opt": opt, "config": config, "step": int(state.step)}
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
    barrier("save_checkpoint")
    return path


def restore_checkpoint(base_dir: str, state: TrainState, step: Optional[int] = None,
                       half_rope: bool = False) -> Optional[TrainState]:
    """Load the latest (or the given) checkpoint into ``state`` in place and
    return it; None when there is none."""
    steps = list_checkpoints(base_dir)
    _refuse_orbax(base_dir, steps)
    if not steps:
        return None
    step = steps[-1] if step is None else step
    path = os.path.join(_ckpt_dir(base_dir), f"{step:07d}.pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    spec = state.model.spec
    tp = tp_group_of(state.model)
    n, r = group_size(tp), (0 if tp is None else torch.distributed.get_rank(tp))

    def mine(sd):  # this rank's tp slices
        return sd if tp is None else tp_state_slice(sd, spec, n, r)

    for module, key in ((state.model, "model"), (state.ema, "ema")):
        if module is None:
            continue
        sd = ckpt[key]
        _load_module_state(module, mine(permute_qk_for_half_rope(sd, spec) if half_rope else sd))
    opt = ckpt["opt"]
    if half_rope:
        opt = _permute_opt_state(opt, state.model, inverse=False)
    if tp is not None:
        opt = _opt_moments(opt, _param_names(state.model), mine)
    _load_optimizer_state(state, opt)
    state.step = int(ckpt["step"])
    return state
