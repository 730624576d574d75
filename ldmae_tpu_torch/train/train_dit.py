"""LightningDiT training step (port of ``ldmae_tpu/train/train_dit.py``).

One step: per micro-batch the flow-matching loss (t sampling, path
interpolation, forward, the velocity MSE plus the optional cosine term) and
its backward, the gradients summed over the A micro-batches and divided by
A, then optional global-norm clipping, AdamW (weight decay 0, betas (0.9,
beta2)) and the EMA update ema = decay * ema + (1 - decay) * param. The
JAX package does all of it in one jitted program; here it is eager
PyTorch, with the port's kernels inside the model's forward and backward.

Clipping follows ``optax.clip_by_global_norm``: gradients are scaled by
max_norm / norm when norm >= max_norm and left alone otherwise
(``torch.nn.utils.clip_grad_norm_`` would divide by norm + 1e-6).

Under FSDP (``parallel.wrap_fsdp``) the parameters, their gradients and
the EMA are sharded DTensors: the global norm sums every shard's squares
over the shard ranks, and clipping, the accumulation's division and the EMA
update run on the local shards, which hold the same elements in the model,
its gradients and the EMA. Under tensor parallelism (``shard_dit_for_tp_``)
a rank holds its slices of the split leaves and the whole of the others:
the global norm sums the split leaves' squares over the tp group and counts
the replicated ones once, which is ``optax.clip_by_global_norm`` on the
logical parameters; AdamW and the EMA act on the local slices.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from ..core.config import LDMAEConfig
from ..core.device import resolve_device
from ..models.lightningdit import DiTSpec, LightningDiT, dit_spec, init_dit_weights_
from ..parallel.distributed import global_batch_draws, group_all_reduce_, group_size
from ..parallel.mesh import tp_group_of, tp_slice_index
from ..transport.transport import Transport, create_transport
from .state import TrainState

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_optimizer(params, lr: float, beta2: float = 0.95) -> torch.optim.AdamW:
    """AdamW(lr, betas=(0.9, beta2), eps=1e-8, weight_decay=0), optax.adamw's
    update; clipping is the train step's (``max_grad_norm``)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, beta2), eps=1e-8, weight_decay=0.0)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its storage: in-place ops update it), else t."""
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tensors, split=None, tp_group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``).
    For FSDP's sharded gradients: the local shards' squares summed, then
    summed over the mesh dims they are sharded on. ``split`` (one bool a
    tensor) marks the tensors that hold this rank's slice under tensor
    parallelism over ``tp_group``: their squares are summed over the group,
    the others' (replicated: every rank holds them whole) counted once."""
    tensors = list(tensors)
    sharded = bool(tensors) and isinstance(tensors[0], DTensor)
    if not sharded and tp_group is None:
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))
    squares = [torch.linalg.vector_norm(_local(t).float()) ** 2 for t in tensors]
    sq = torch.stack(squares).sum()
    if tp_group is not None:
        part = torch.stack([q for q, s in zip(squares, split) if s]).sum()
        sq = sq - part + group_all_reduce_(part.clone(), tp_group)
    if sharded:
        mesh = tensors[0].device_mesh
        for dim, placement in enumerate(tensors[0].placements):
            if placement.is_shard():
                group_all_reduce_(sq, mesh.get_group(dim))
    return sq.sqrt()


def tp_split_mask(model: torch.nn.Module, names) -> tuple:
    """(one bool a parameter name: split over the tp group, the group) for a
    DiT sharded by ``shard_dit_for_tp_``; (None, None) without tp."""
    group = tp_group_of(model)
    if group is None:
        return None, None
    n = group_size(group)
    return [tp_slice_index(name, model.spec, n, 0) is not None for name in names], group


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor) -> None:
    """``optax.clip_by_global_norm`` in place, given the global norm."""
    coef = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_([_local(g) for g in grads], coef)


@torch.no_grad()
def update_ema_(ema: torch.nn.Module, model: torch.nn.Module, decay: float) -> None:
    e = [_local(p) for p in ema.parameters()]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [_local(p.detach()) for p in model.parameters()], alpha=1.0 - decay)


def dit_loss(
    model: LightningDiT,
    transport: Transport,
    x: torch.Tensor,
    y: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    x0: Optional[torch.Tensor] = None,
    t: Optional[torch.Tensor] = None,
    drop_ids: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "xla",
    rope_layout: str = "interleaved",
    adaln_impl: str = "xla",
) -> torch.Tensor:
    """The total optimised loss of one micro-batch (the velocity MSE, plus
    the cosine term when the transport has it), label dropout on. ``x0``,
    ``t`` and ``drop_ids`` (1 = drop the label) override the draws from
    ``generator``."""

    def model_fn(xt, tt, y):
        return model(xt, tt, y, train=True, generator=generator, force_drop_ids=drop_ids,
                     compute_dtype=compute_dtype, attn_impl=attn_impl, rope_layout=rope_layout,
                     adaln_impl=adaln_impl)

    terms = transport.training_losses(model_fn, x, dict(y=y), generator=generator, x0=x0, t=t)
    loss = terms["loss"].mean()
    if "cos_loss" in terms:
        loss = terms["cos_loss"].mean() + loss
    return loss


@torch.no_grad()
def apply_update_(state: TrainState, *, max_grad_norm: Optional[float] = None,
                  ema_decay: float = 0.9999) -> torch.Tensor:
    """One optimizer step from the parameters' ``.grad``: the global norm
    (returned, before clipping), optional clipping, AdamW, then the EMA;
    the gradients are cleared and the step counted."""
    named = [(n, p.grad) for n, p in state.model.named_parameters() if p.grad is not None]
    grads = [g for _, g in named]
    norm = global_norm(grads, *tp_split_mask(state.model, [n for n, _ in named]))
    if max_grad_norm is not None:
        clip_by_global_norm_(grads, max_grad_norm, norm)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    update_ema_(state.ema, state.model, ema_decay)
    state.step += 1
    return norm


def make_train_step(
    spec: DiTSpec,
    transport: Transport,
    *,
    grad_accum: int = 1,
    ema_decay: float = 0.9999,
    max_grad_norm: Optional[float] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "xla",
    rope_layout: str = "interleaved",
    adaln_impl: str = "xla",
):
    """Build ``train_step(state, batch, generator=None, *, x0=None, t=None,
    drop_ids=None) -> {"loss", "grad_norm"}``, which updates ``state`` in
    place (model, optimizer, EMA, step).

    batch: {"x": (A, m, C, H, W), "y": (A, m)} with A = grad_accum; for A ==
    1 a flat (B, C, H, W) / (B,) batch is also taken. ``x0`` (noise), ``t``
    and ``drop_ids`` override the generator's draws, in the batch's layout.
    ``loss`` is the mean total optimised loss over the micro-batches and
    ``grad_norm`` the global norm of the averaged gradient before clipping;
    both stay on the device (0-dim tensors).

    With ``state.ddp`` (data parallelism) the forward runs through the
    ``DistributedDataParallel`` wrapper on this rank's (A, m) slice of the
    global batch: DDP averages the ranks' gradients, each of the mean loss
    over m local samples, which is the gradient of the mean over the global
    batch; the generator's draws are the global batch's rows, so with every
    rank seeding it alike a step equals one process's step on the
    concatenated batch. ``loss`` stays this rank's. A model under FSDP
    (``parallel.wrap_fsdp``) runs the same way through itself: FSDP
    averages the gradients over the (dp, fsdp) ranks in the last
    micro-batch's backward. Under tensor parallelism the ranks of a tp
    group take the same rows and draws (``parallel.data_index``) and
    compute one model together."""
    impls = dict(compute_dtype=compute_dtype, attn_impl=attn_impl, rope_layout=rope_layout,
                 adaln_impl=adaln_impl)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], generator=None, *,
                   x0=None, t=None, drop_ids=None) -> Dict[str, torch.Tensor]:
        flat = batch["x"].dim() == 4

        def lead(a):
            return None if a is None else (a[None] if flat else a)

        x, y, x0_, t_, drop_ = (lead(a) for a in (batch["x"], batch["y"], x0, t, drop_ids))
        if x.shape[0] != grad_accum:
            raise ValueError(f"batch leading (accumulation) dim {x.shape[0]} != grad_accum={grad_accum}")
        total = torch.zeros((), device=x.device)
        ddp = state.ddp
        fsdp = hasattr(state.model, "set_requires_gradient_sync")
        tp = group_size(tp_group_of(state.model))
        for i in range(grad_accum):
            # under DDP or FSDP the gradients are reduced in the last
            # micro-batch's backward only, and the draws are the global
            # batch's rows (parallel.global_batch_draws)
            last = i == grad_accum - 1
            if fsdp:
                state.model.set_requires_gradient_sync(last)
            with (ddp.no_sync() if ddp is not None and not last else contextlib.nullcontext()), \
                    (global_batch_draws(generator, x.shape[1], tp) if ddp is not None or fsdp
                     else contextlib.nullcontext()):
                loss = dit_loss(state.model if ddp is None else ddp, transport, x[i], y[i], generator,
                                x0=None if x0_ is None else x0_[i], t=None if t_ is None else t_[i],
                                drop_ids=None if drop_ is None else drop_[i], **impls)
                loss.backward()  # the gradients sum over the micro-batches
            total += loss.detach()
        if grad_accum > 1:
            with torch.no_grad():
                torch._foreach_div_([_local(p.grad) for p in state.model.parameters() if p.grad is not None],
                                    float(grad_accum))
        norm = apply_update_(state, max_grad_norm=max_grad_norm, ema_decay=ema_decay)
        return {"loss": total / grad_accum, "grad_norm": norm}

    return train_step


def spec_from_config(config: LDMAEConfig) -> DiTSpec:
    m, d = config.model, config.data
    return dit_spec(
        m.model_type,
        input_size=d.image_size // config.vae.downsample_ratio,
        in_channels=m.in_chans,
        num_classes=d.num_classes,
        class_dropout_prob=0.0 if d.num_classes == 1 else 0.1,
        learn_sigma=m.learn_sigma,
        use_qknorm=m.use_qknorm,
        use_swiglu=m.use_swiglu,
        use_rope=m.use_rope,
        use_rmsnorm=m.use_rmsnorm,
        wo_shift=m.wo_shift,
        use_checkpoint=config.train.use_checkpoint or m.use_checkpoint,
        remat_policy=m.remat_policy,
    )


def build_from_config(config: LDMAEConfig, device=None, generator: Optional[torch.Generator] = None):
    """(spec, model, transport, train_step) from a reference-layout config,
    the model on ``device`` with the reference initialisation drawn from
    ``generator`` (class_dropout_prob 0 for a 1-class run)."""
    device = resolve_device(device)
    spec = spec_from_config(config)
    model = init_dit_weights_(LightningDiT(spec, device=device), generator)
    t = config.transport
    transport = create_transport(
        path_type=t.path_type, prediction=t.prediction, loss_weight=t.loss_weight,
        train_eps=t.train_eps, sample_eps=t.sample_eps, use_cosine_loss=t.use_cosine_loss,
        use_lognorm=t.use_lognorm, partitial_train=t.partitial_train,
        partial_ratio=t.partial_ratio, shift_lg=t.shift_lg,
    )
    par = config.parallel
    step_fn = make_train_step(
        spec, transport,
        grad_accum=config.train.gradient_accumulation_steps,
        max_grad_norm=config.optimizer.max_grad_norm,
        compute_dtype=COMPUTE_DTYPES[par.compute_dtype],
        attn_impl=par.train_attention_impl,
        rope_layout=par.rope_layout,
        adaln_impl=par.train_adaln_impl,
    )
    return spec, model, transport, step_fn


@torch.no_grad()
def evaluate_step(
    model: LightningDiT,
    transport: Transport,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "xla",
    rope_layout: str = "interleaved",
) -> torch.Tensor:
    """Validation loss (the velocity MSE) with t uniform on (0, 1)."""

    def model_fn(xt, t, y):
        return model(xt, t, y, compute_dtype=compute_dtype, attn_impl=attn_impl,
                     rope_layout=rope_layout)

    terms = transport.training_losses(model_fn, batch["x"], dict(y=batch["y"]),
                                      generator=generator, sp_timesteps=(0.0, 1.0))
    return terms["loss"].mean()
