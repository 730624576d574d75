"""VMAE tokenizer training step (port of ``ldmae_tpu/train/train_vmae.py``).

The three stages of the reference recipe (``scripts/train_ae.sh``):

  * stage 1: ``VMAE.forward_vanilla`` (masked encoder, KL bottleneck,
    visible/masked MSE split, optional LPIPS), or with ``--gradual_resol``
    its gradual-resolution form, the same forward of a
    ``models.vmae_variants.GradualVMAE``;
  * stage 2: the positional-table resize, ``cli.pe_reset`` (the model's
    sin-cos tables are recomputed for any resolution, so training needs it
    only for checkpoints read elsewhere);
  * stage 3 (``tune_decoder``): ``VMAE.forward_ldmae`` (mask ratio 0, pixel
    MSE plus LPIPS) with everything but ``decoder*`` and ``from_latent``
    frozen.

The optimizer is AdamW(betas (0.9, 0.95), eps 1e-8) with the JAX package's
weight-decay mask and a half-cosine learning rate with linear warmup at
fractional epochs. As in optax, the rate is a function of the number of
updates applied so far (the optimizer state's step count), so a step whose
loss is not finite, which applies no update and leaves the optimizer state
alone, does not advance it. One step runs the A micro-batches one after
another, each with its backward (as the JAX step's ``lax.scan``), divides
the summed gradients by A, and applies one update. bf16 compute keeps the
float32 master weights; the losses are float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from ..data.images import normalize_uint8_images
from ..models.vmae import VMAE
from ..parallel.distributed import any_rank, global_batch_draws
from .state import TrainState

METRIC_KEYS = ("loss", "vis_loss", "mask_loss", "kl_loss", "p_loss")


def cosine_lr(base_lr: float, min_lr: float, warmup_epochs: float, total_epochs: float,
              fixed_lr: bool = False) -> Callable[[float], float]:
    """(fractional) epoch -> learning rate: linear warmup to ``base_lr``,
    then a half cosine down to ``min_lr`` at ``total_epochs``."""

    def fn(epoch: float) -> float:
        if fixed_lr:
            return base_lr
        if epoch < warmup_epochs:
            return base_lr * epoch / max(warmup_epochs, 1e-8)
        prog = (epoch - warmup_epochs) / max(total_epochs - warmup_epochs, 1e-8)
        return min_lr + (base_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * prog))

    return fn


def decays(name: str, p: torch.Tensor, stacked: bool = True) -> bool:
    """The JAX package's weight-decay mask on the port's names. It decays
    every leaf of two or more dims in its own layout. There the blocks'
    parameters are stacked on a depth axis (``stacked``): so every
    parameter of the encoder and decoder blocks decays (their norms and
    biases too), and outside them the matrices and convolution kernels. The
    gradual model keeps its blocks in lists (not ``stacked``), so there the
    blocks' matrices and kernels decay, and the qkv bias, which is (3, D)
    there. The cls and mask tokens, (1, 1, D) here, are vectors there and
    do not."""
    if name.split(".")[0] in ("blocks", "decoder_blocks") and (stacked or name.endswith("attn.qkv.bias")):
        return True
    return p.ndim >= 2 and name not in ("cls_token", "mask_token")


def trains(name: str, tune_decoder: bool) -> bool:
    """Stage 3 trains only the parameters whose top-level name holds
    "decoder" or "from_latent" (the reference matches name substrings)."""
    top = name.split(".")[0]
    return not tune_decoder or "decoder" in top or "from_latent" in top


def make_vmae_optimizer(model: VMAE, *, weight_decay: float = 0.05,
                        tune_decoder: bool = False) -> torch.optim.AdamW:
    """AdamW(betas (0.9, 0.95), eps 1e-8) over two groups, with and without
    weight decay (``decays``). With ``tune_decoder`` the parameters that do
    not train are left out and their ``requires_grad`` turned off (optax's
    ``set_to_zero`` gives them no update and no decay). The learning rate is
    set before each update by the train step."""
    from ..models.vmae_variants import GradualVMAE

    stacked = not isinstance(model, GradualVMAE)
    groups = ([], [])
    for name, p in model.named_parameters():
        if trains(name, tune_decoder):
            groups[decays(name, p, stacked)].append(p)
        else:
            p.requires_grad_(False)
    return torch.optim.AdamW(
        [{"params": groups[True], "weight_decay": weight_decay}, {"params": groups[False], "weight_decay": 0.0}],
        lr=0.0, betas=(0.9, 0.95), eps=1e-8)


def lr_schedule(steps_per_epoch: int, base_lr: float, min_lr: float = 0.0, warmup_epochs: float = 40,
                total_epochs: float = 400, fixed_lr: bool = False) -> Callable[[int], float]:
    """Number of updates applied -> learning rate, ``cosine_lr`` at
    count / steps_per_epoch epochs (the first update takes lr(0), which is 0
    under warmup)."""
    fn = cosine_lr(base_lr, min_lr, warmup_epochs, total_epochs, fixed_lr)
    return lambda count: fn(count / steps_per_epoch)


def applied_updates(optimizer: torch.optim.Optimizer) -> int:
    """The number of updates the optimizer has applied (its state's step
    count; 0 before the first)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and "step" in st:
                return int(st["step"])
    return 0


@torch.no_grad()
def apply_vmae_update_(state: TrainState, schedule: Callable[[int], float], finite: bool) -> None:
    """One optimizer step from the parameters' ``.grad`` when ``finite``,
    at the rate ``schedule(applied updates)``; a trained parameter without a
    gradient takes a zero one (every leaf of the JAX tree gets an update).
    Not ``finite``: no update, the optimizer state untouched. Either way the
    gradients are cleared and the step counted."""
    opt = state.optimizer
    if finite:
        lr = schedule(applied_updates(opt))
        for group in opt.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()
    opt.zero_grad(set_to_none=True)
    state.step += 1


def vmae_loss(model: VMAE, x: torch.Tensor, *, tune_decoder: bool = False, mask_ratio: float = 0.75,
              visible_loss_ratio: float = 0.5, perceptual_loss_fn=None,
              compute_dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
              generator: Optional[torch.Generator] = None, mask_noise: Optional[torch.Tensor] = None,
              latent_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One micro-batch's losses, {"loss", "vis_loss", "mask_loss", "kl_loss",
    "p_loss"}: ``forward_ldmae`` with the posterior sampled (stage 3) or
    ``forward_vanilla`` (for a ``models.vmae_variants.GradualVMAE`` the
    gradual forward, ``forward_vanilla_gradual``). x: (m, 3, H, W) float32 in [-1, 1], or (m, H, W, 3)
    uint8 pixels normalised here."""
    if x.dtype == torch.uint8:
        x = normalize_uint8_images(x)
    kw = dict(perceptual_loss_fn=perceptual_loss_fn, compute_dtype=compute_dtype, attn_impl=attn_impl,
              latent_noise=latent_noise, generator=generator)
    if tune_decoder:
        out = model.forward_ldmae(x, use_mode=False, **kw)
        zero = torch.zeros_like(out["loss"])
        return {"loss": out["loss"], "vis_loss": out["vis_loss"], "mask_loss": zero, "kl_loss": zero,
                "p_loss": out["p_loss"]}
    out = model.forward_vanilla(x, mask_ratio=mask_ratio, visible_loss_ratio=visible_loss_ratio,
                                mask_noise=mask_noise, **kw)
    return {k: out[k] for k in METRIC_KEYS}


class VMAELoss(nn.Module):
    """``vmae_loss`` of ``model`` as a module's forward, so that
    ``DistributedDataParallel``, which sees calls of ``forward`` only, can
    wrap the training forwards (``forward_vanilla`` / ``forward_ldmae``)."""

    def __init__(self, model: VMAE):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor, **kw) -> Dict[str, torch.Tensor]:
        return vmae_loss(self.model, x, **kw)


def make_vmae_train_step(
    schedule: Callable[[int], float],
    *,
    mask_ratio: float = 0.75,
    visible_loss_ratio: float = 0.5,
    tune_decoder: bool = False,
    perceptual_loss_fn=None,
    compute_dtype: torch.dtype = torch.float32,
    attn_impl: str = "xla",
    grad_accum: int = 1,
):
    """Build ``train_step(state, batch, generator=None, *, mask_noise=None,
    latent_noise=None) -> metrics``, which updates ``state`` (model,
    optimizer, step) in place. No EMA (the reference VMAE trainer keeps
    none).

    batch: {"x": (A, m, ...)} with A = grad_accum, uint8 (m, H, W, 3) or
    float32 (m, 3, H, W) micro-batches; for A == 1 a flat batch is also
    taken. ``mask_noise`` (A, m, L) and ``latent_noise`` (A, m, latent_dim,
    tokens) override the generator's draws. metrics: the micro-batch means
    of ``METRIC_KEYS`` (0-dim tensors on the device) and ``loss_finite``; a
    loss that is not finite applies no update (``apply_vmae_update_``).

    With ``state.ddp`` (a ``DistributedDataParallel`` of ``VMAELoss``) each
    micro-batch runs through the wrapper on this rank's m images, the
    gradients averaged over the ranks (the mean over the global micro-batch),
    the generator's draws the global batch's rows
    (``parallel.global_batch_draws``); the metrics stay this rank's, and
    a loss that is not finite on any rank skips every rank's update."""
    kw = dict(tune_decoder=tune_decoder, mask_ratio=mask_ratio, visible_loss_ratio=visible_loss_ratio,
              perceptual_loss_fn=perceptual_loss_fn, compute_dtype=compute_dtype, attn_impl=attn_impl)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], generator=None, *,
                   mask_noise=None, latent_noise=None) -> Dict[str, torch.Tensor]:
        x = batch["x"]
        flat = x.dim() == 4

        def lead(a):
            return None if a is None else (a[None] if flat else a)

        x, mask_noise, latent_noise = lead(x), lead(mask_noise), lead(latent_noise)
        if x.shape[0] != grad_accum:
            raise ValueError(f"batch leading (accumulation) dim {x.shape[0]} != grad_accum={grad_accum}")
        sums = torch.zeros(len(METRIC_KEYS), device=x.device)
        ddp = state.ddp
        for i in range(grad_accum):
            noise = dict(mask_noise=None if mask_noise is None else mask_noise[i],
                         latent_noise=None if latent_noise is None else latent_noise[i])
            last = ddp is None or i == grad_accum - 1
            with (contextlib.nullcontext() if last else ddp.no_sync()), \
                    (contextlib.nullcontext() if ddp is None else global_batch_draws(generator, x.shape[1])):
                if ddp is None:
                    out = vmae_loss(state.model, x[i], generator=generator, **noise, **kw)
                else:
                    out = ddp(x[i], generator=generator, **noise, **kw)
                out["loss"].backward()  # the gradients sum over the micro-batches
            sums += torch.stack([out[k].detach().float() for k in METRIC_KEYS])
        params = [p for p in state.model.parameters() if p.grad is not None]
        if grad_accum > 1:
            with torch.no_grad():
                torch._foreach_div_([p.grad for p in params], float(grad_accum))
        means = sums / grad_accum
        finite = bool(torch.isfinite(means[0]))
        if ddp is not None:  # the gradients are averaged: one rank's non-finite loss skips every rank's update
            finite = not any_rank(not finite)
        apply_vmae_update_(state, schedule, finite)
        return dict(zip(METRIC_KEYS, means.unbind(0)), loss_finite=torch.tensor(finite))

    return train_step
