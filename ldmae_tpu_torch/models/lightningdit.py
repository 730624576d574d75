"""LightningDiT — diffusion transformer (port of
``ldmae_tpu/models/lightningdit.py``): the sampling forward, the training
forward (label dropout, rematerialisation) and the reference initialisation.

``LightningDiT`` holds its parameters under the reference's state-dict keys
(``blocks.{i}.attn.qkv.weight``, ``blocks.{i}.mlp.w12.weight``,
``adaLN_modulation.1.*``, ``final_layer.*``, ...), so published ``.pt``
checkpoints and ``convert.dit_state_dict_from_jax`` load with
``strict=True``. Parameters stay float32 and are cast to the compute dtype
where they are used, as the JAX package does. The sin-cos and RoPE tables
are constants rebuilt from the spec (``DiTConsts``); the ``pos_embed`` and
``feat_rope`` buffers exist only so reference checkpoints load.

``rope_layout="half"`` needs weights transformed by
``permute_qk_for_half_rope`` (the same attention, RoPE as two contiguous
halves). ``quant_mode`` ('w8' | 'w8a8') needs a model transformed by
``quantize_dit_`` (sampling only), applied after that permutation.

Tensor parallelism (sampling and training): ``parallel.mesh.shard_dit_for_tp_``
keeps a rank's slices of each block's linears and sets
``DiTBlock.tp_group``; a block then attends over its heads, runs its slice
of the MLP's hidden dim and all-gathers the adaLN modulations, with proj
and w3 (fc2) row-parallel. The embedders and the final layer stay whole on
every rank. Under autograd the replicated inputs of the column-parallel
layers (adaLN's c, qkv's and w12's or fc1's h: ``ops.dense``'s
``tp_group``, fp32 partials rounded once) and the shared qk-norm weights sum their gradients over the
group, the gathered modulations keep this rank's slice of theirs, and the
row-parallel sums pass theirs through (``parallel.distributed``'s
Functions).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..core.device import resolve_device
from ..ops import (
    build_rope_table,
    dense,
    get_2d_sincos_pos_embed,
    layer_norm,
    mlp_gelu,
    modulate,
    multi_head_attention,
    rms_norm,
    silu,
    swiglu_ffn,
    timestep_embedding_freqs,
    unpatchify,
)
from ..ops.fused_adaln import fused_norm_modulate, fused_norm_modulate_quant
from ..ops.patchify import patch_embed
from ..ops.quant import is_quantized, maybe_qdense, quantize_linear, swiglu_ffn_quant
from ..ops.rope import rope_channel_permutation, to_half_layout
from ..parallel.distributed import gather_from_tp, group_size


@dataclass(frozen=True)
class DiTSpec:
    input_size: int = 32
    patch_size: int = 2
    in_channels: int = 32
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    class_dropout_prob: float = 0.1
    num_classes: int = 1000
    learn_sigma: bool = False
    use_qknorm: bool = False
    use_swiglu: bool = False
    use_rope: bool = False
    use_rmsnorm: bool = False
    wo_shift: bool = False
    # rematerialisation in training (torch.utils.checkpoint), as the JAX
    # package's jax.checkpoint: 'full' keeps only block boundaries, 'attn'
    # also each block's attention output (the block runs as two segments split
    # there), 'dots' every matmul output (selective checkpointing; the port's
    # kernels are not aten ops, so they are always recomputed)
    use_checkpoint: bool = False
    remat_policy: str = "full"
    freq_embed_size: int = 256

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    @property
    def num_patches(self) -> int:
        return (self.input_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_adaln(self) -> int:
        return 4 if self.wo_shift else 6

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def swiglu_hidden(self) -> int:
        return int(2 / 3 * self.mlp_hidden)


class DiTConsts:
    """Non-trainable tables derived from the spec, on ``device``."""

    def __init__(self, spec: DiTSpec, device: torch.device):
        grid = spec.input_size // spec.patch_size
        self.pos_embed = torch.from_numpy(get_2d_sincos_pos_embed(spec.hidden_size, grid)).to(device)
        self.t_freqs = torch.from_numpy(timestep_embedding_freqs(spec.freq_embed_size)).to(device)
        if spec.use_rope:
            cos, sin = build_rope_table(spec.head_dim // 2, grid)
            self.rope = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))
            self.rope_half = (
                torch.from_numpy(to_half_layout(cos)).to(device),
                torch.from_numpy(to_half_layout(sin)).to(device),
            )
        else:
            self.rope = self.rope_half = None


# ---------------------------------------------------------------------------
# Modules (reference parameter names)
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))


class _PatchEmbed(nn.Module):
    def __init__(self, in_c: int, d: int, p: int, device):
        super().__init__()
        self.proj = nn.Conv2d(in_c, d, kernel_size=p, stride=p, device=device)


class _TimestepEmbedder(nn.Module):
    def __init__(self, freq: int, d: int, device):
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Linear(freq, d, device=device), nn.SiLU(), nn.Linear(d, d, device=device)
        )


class _LabelEmbedder(nn.Module):
    def __init__(self, n: int, d: int, device):
        super().__init__()
        self.embedding_table = nn.Embedding(n, d, device=device)


class _RopeBuffers(nn.Module):
    def __init__(self, cos: np.ndarray, sin: np.ndarray, device):
        super().__init__()
        self.register_buffer("freqs_cos", torch.from_numpy(cos).to(device))
        self.register_buffer("freqs_sin", torch.from_numpy(sin).to(device))


class Attention(nn.Module):
    def __init__(self, d: int, hd: int, use_qknorm: bool, use_rmsnorm: bool, device):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d, device=device)
        self.proj = nn.Linear(d, d, device=device)
        if use_qknorm:
            norm = (lambda: RMSNorm(hd, device)) if use_rmsnorm else (
                lambda: nn.LayerNorm(hd, device=device)
            )
            self.q_norm, self.k_norm = norm(), norm()
        else:
            self.q_norm = self.k_norm = None


class _SwiGLU(nn.Module):
    def __init__(self, d: int, h: int, device):
        super().__init__()
        self.w12 = nn.Linear(d, 2 * h, device=device)
        self.w3 = nn.Linear(h, d, device=device)


class _Mlp(nn.Module):
    def __init__(self, d: int, h: int, device):
        super().__init__()
        self.fc1 = nn.Linear(d, h, device=device)
        self.fc2 = nn.Linear(h, d, device=device)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """remat_policy 'dots': matmul outputs are kept, everything else is
    recomputed (JAX's dots_with_no_batch_dims_saveable, with the block's
    attention output kept as the proj product)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


_save_dots = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def _norm(x, norm, use_rmsnorm: bool):
    if use_rmsnorm:
        return rms_norm(x, norm.weight)
    return layer_norm(x, eps=1e-6)


def _norm_modulate(x, norm, shift, scale, use_rmsnorm: bool, adaln_impl: str):
    """norm -> modulate; adaln_impl='fused' runs the fused epilogue kernel."""
    if adaln_impl == "fused" and shift is not None:
        return fused_norm_modulate(
            x, norm.weight if use_rmsnorm else None, shift, scale,
            kind="rms" if use_rmsnorm else "layer",
        )
    return modulate(_norm(x, norm, use_rmsnorm), shift, scale)


class DiTBlock(nn.Module):
    """One LightningDiT block (``_block``), full precision or quantized.
    ``tp_group``: the tensor-parallel group whose ranks hold this block's
    slices (``parallel.mesh.shard_dit_for_tp_``), None when whole."""

    tp_group = None

    def __init__(self, spec: DiTSpec, device):
        super().__init__()
        d = spec.hidden_size
        self.norm1 = RMSNorm(d, device) if spec.use_rmsnorm else None
        self.attn = Attention(d, spec.head_dim, spec.use_qknorm, spec.use_rmsnorm, device)
        self.norm2 = RMSNorm(d, device) if spec.use_rmsnorm else None
        if spec.use_swiglu:
            self.mlp = _SwiGLU(d, spec.swiglu_hidden, device)
        else:
            self.mlp = _Mlp(d, spec.mlp_hidden, device)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(d, spec.num_adaln * d, device=device)
        )

    def modulation(self, c_mod, spec: DiTSpec, quant_mode: Optional[str] = None):
        """(shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp),
        each (B, D); the shifts are None for ``wo_shift``."""
        mod = maybe_qdense(c_mod, self.adaLN_modulation[1], quant_mode, col_group=self.tp_group)
        mod = gather_from_tp(mod, self.tp_group)  # a rank holds a contiguous slice of the 6D outputs
        mod = mod.view(-1, spec.num_adaln, spec.hidden_size)
        if spec.wo_shift:
            scale_msa, gate_msa, scale_mlp, gate_mlp = mod.unbind(1)
            return None, scale_msa, gate_msa, None, scale_mlp, gate_mlp
        return mod.unbind(1)

    def attn_branch(self, x, shift, scale, spec: DiTSpec, rope, attn_impl: str, rope_layout: str,
                    adaln_impl: str, quant_mode: Optional[str] = None):
        """The block's attention output (after ``proj``), before its gate."""
        h = _norm_modulate(x, self.norm1, shift, scale, spec.use_rmsnorm, adaln_impl)
        return multi_head_attention(
            h, self.attn, spec.num_heads // group_size(self.tp_group), rope=rope, rope_layout=rope_layout,
            qk_norm_kind="rms" if spec.use_rmsnorm else "layer", impl=attn_impl,
            quant_mode=quant_mode, tp_group=self.tp_group,
        )

    def mlp_residual(self, x, attn_out, gate_msa, shift_mlp, scale_mlp, gate_mlp, spec: DiTSpec,
                     adaln_impl: str, mlp_impl: str, quant_mode: Optional[str] = None):
        """The block's output from its input and attention output."""
        x = x + gate_msa[:, None, :].to(x.dtype) * attn_out
        h = _norm_modulate(x, self.norm2, shift_mlp, scale_mlp, spec.use_rmsnorm, adaln_impl)
        m, g = self.mlp, self.tp_group
        if spec.use_swiglu:
            mlp_out = swiglu_ffn(h, m.w12, m.w3, quant_mode=quant_mode, impl=mlp_impl, row_group=g)
        else:
            mlp_out = mlp_gelu(h, m.fc1, m.fc2, approximate=True, quant_mode=quant_mode, row_group=g)
        return x + gate_mlp[:, None, :].to(x.dtype) * mlp_out

    def forward_remat_attn(self, x, c_mod, spec: DiTSpec, rope, attn_impl: str, rope_layout: str,
                           adaln_impl: str, mlp_impl: str):
        """remat_policy 'attn': the attention branch and the rest of the block
        are two checkpointed segments, so the backward keeps the block input,
        the (B, D) modulation vectors and the attention output, and
        recomputes each segment's inside once. Under tensor parallelism each
        segment holds a row-parallel all-reduce (proj's, w3's), which the
        recomputation runs again; every rank recomputes in the same order."""
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.modulation(c_mod, spec)
        attn_out = checkpoint(self.attn_branch, x, shift_msa, scale_msa, spec, rope, attn_impl,
                              rope_layout, adaln_impl, use_reentrant=False)
        return checkpoint(self.mlp_residual, x, attn_out, gate_msa, shift_mlp, scale_mlp, gate_mlp,
                          spec, adaln_impl, mlp_impl, use_reentrant=False)

    def forward(self, x, c_mod, spec: DiTSpec, rope, attn_impl: str, rope_layout: str,
                adaln_impl: str, mlp_impl: str, quant_mode: Optional[str] = None, remat_attn: bool = False):
        """The block's output; ``remat_attn``: ``forward_remat_attn`` (called
        through the module, so hooks on the block, FSDP's among them, see
        it)."""
        if remat_attn:
            return self.forward_remat_attn(x, c_mod, spec, rope, attn_impl, rope_layout, adaln_impl, mlp_impl)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.modulation(
            c_mod, spec, quant_mode)
        kind = "rms" if spec.use_rmsnorm else "layer"

        # w8a8 + fused epilogue: the adaLN kernel emits the int8 activation
        # and its row scales, which feed the int8 qkv and w12 matmuls directly
        fused_quant = (
            quant_mode == "w8a8"
            and adaln_impl == "fused"
            and shift_msa is not None
            and is_quantized(self.attn.qkv)
            and spec.use_swiglu
        )
        if fused_quant:
            w1 = None if self.norm1 is None else self.norm1.weight
            h_q, h_s = fused_norm_modulate_quant(x, w1, shift_msa, scale_msa, kind=kind)
            attn_out = multi_head_attention(
                None, self.attn, spec.num_heads // group_size(self.tp_group), rope=rope,
                rope_layout=rope_layout, qk_norm_kind=kind, impl=attn_impl, x_quant=(h_q, h_s),
                out_dtype=x.dtype, tp_group=self.tp_group,
            )
            x = x + gate_msa[:, None, :].to(x.dtype) * attn_out
            w2 = None if self.norm2 is None else self.norm2.weight
            h_q, h_s = fused_norm_modulate_quant(x, w2, shift_mlp, scale_mlp, kind=kind)
            mlp_out = swiglu_ffn_quant(h_q, h_s, self.mlp, compute_dtype=x.dtype, row_group=self.tp_group)
            return x + gate_mlp[:, None, :].to(x.dtype) * mlp_out

        attn_out = self.attn_branch(x, shift_msa, scale_msa, spec, rope, attn_impl, rope_layout,
                                    adaln_impl, quant_mode)
        return self.mlp_residual(x, attn_out, gate_msa, shift_mlp, scale_mlp, gate_mlp, spec,
                                 adaln_impl, mlp_impl, quant_mode)


class _FinalLayer(nn.Module):
    def __init__(self, spec: DiTSpec, device):
        super().__init__()
        d, p = spec.hidden_size, spec.patch_size
        if spec.use_rmsnorm:
            self.norm_final = RMSNorm(d, device)
        self.linear = nn.Linear(d, p * p * spec.out_channels, device=device)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 2 * d, device=device))


def timestep_embedding(t: torch.Tensor, freqs: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding in [cos | sin] order (t rounded to its
    own dtype first, as the sampler passes it)."""
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class LightningDiT(nn.Module):
    def __init__(self, spec: DiTSpec, device=None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        self.consts = DiTConsts(spec, device)
        d, p = spec.hidden_size, spec.patch_size
        grid = spec.input_size // p
        self.x_embedder = _PatchEmbed(spec.in_channels, d, p, device)
        self.t_embedder = _TimestepEmbedder(spec.freq_embed_size, d, device)
        n_embed = spec.num_classes + (1 if spec.class_dropout_prob > 0 else 0)
        self.y_embedder = _LabelEmbedder(n_embed, d, device)
        self.register_buffer("pos_embed", self.consts.pos_embed[None].clone())
        if spec.use_rope:
            self.feat_rope = _RopeBuffers(*build_rope_table(spec.head_dim // 2, grid), device)
        self.blocks = nn.ModuleList(DiTBlock(spec, device) for _ in range(spec.depth))
        self.final_layer = _FinalLayer(spec, device)

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        y: torch.Tensor,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        force_drop_ids: Optional[torch.Tensor] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        attn_impl: str = "xla",
        rope_layout: str = "interleaved",
        adaln_impl: str = "xla",
        mlp_impl: str = "xla",
        quant_mode: Optional[str] = None,
    ) -> torch.Tensor:
        """x: (N, C, H, W) latents; t, y: (N,). Returns (N, C, H, W) float32.

        ``train`` drops each label with ``class_dropout_prob`` (a uniform draw
        from ``generator``) unless ``force_drop_ids`` (1 = drop) is given.
        With ``spec.use_checkpoint`` and grad enabled the blocks are
        rematerialised by ``spec.remat_policy``. Sampling callers run it under
        ``torch.no_grad()`` or ``torch.inference_mode()``. ``quant_mode``
        ('w8' | 'w8a8') needs ``quantize_dit_`` first."""
        spec, consts, cd = self.spec, self.consts, compute_dtype
        pe = self.x_embedder.proj
        tokens = patch_embed(x.to(cd), pe.weight, pe.bias, spec.patch_size, compute_dtype=cd)
        tokens = tokens + consts.pos_embed.to(cd)[None]

        mlp = self.t_embedder.mlp
        t_emb = dense(timestep_embedding(t, consts.t_freqs, spec.freq_embed_size).to(cd),
                      mlp[0].weight, mlp[0].bias)
        t_emb = dense(silu(t_emb), mlp[2].weight, mlp[2].bias)

        labels = y
        if force_drop_ids is not None:
            labels = torch.where(force_drop_ids == 1, spec.num_classes, labels)
        elif train and spec.class_dropout_prob > 0:
            drop = torch.rand(y.shape[0], generator=generator, device=y.device) < spec.class_dropout_prob
            labels = torch.where(drop, spec.num_classes, labels)
        y_emb = F.embedding(labels, self.y_embedder.embedding_table.weight).to(cd)
        c_mod = silu(t_emb + y_emb)

        rope = consts.rope_half if (rope_layout == "half" and consts.rope is not None) else consts.rope
        args = (c_mod, spec, rope, attn_impl, rope_layout, adaln_impl, mlp_impl)
        remat = spec.remat_policy if spec.use_checkpoint and torch.is_grad_enabled() else None
        if remat not in (None, "full", "attn", "dots"):
            raise ValueError(f"unknown remat_policy {remat!r} (full | attn | dots)")
        for blk in self.blocks:
            if remat == "attn":
                tokens = blk(tokens, *args, remat_attn=True)
            elif remat == "full":
                tokens = checkpoint(blk, tokens, *args, use_reentrant=False)
            elif remat == "dots":
                tokens = checkpoint(blk, tokens, *args, use_reentrant=False, context_fn=_save_dots)
            else:
                tokens = blk(tokens, *args, quant_mode)

        fl = self.final_layer
        ada = fl.adaLN_modulation[1]
        shift, scale = dense(c_mod, ada.weight, ada.bias).view(-1, 2, spec.hidden_size).unbind(1)
        h = modulate(_norm(tokens, getattr(fl, "norm_final", None), spec.use_rmsnorm), shift, scale)
        h = dense(h, fl.linear.weight, fl.linear.bias)
        out = unpatchify(h.float(), spec.patch_size, spec.out_channels)
        if spec.learn_sigma:
            out = out[:, : spec.in_channels]
        return out


def permute_qk_for_half_rope(
    state_dict: Dict[str, torch.Tensor], spec: DiTSpec, inverse: bool = False
) -> Dict[str, torch.Tensor]:
    """Permute the q/k head-dim channels of a DiT state dict (qkv weight and
    bias rows, qk-norm weights and biases) from EVA-interleaved to
    half-split, so ``rope_layout="half"`` computes the identical attention.
    ``inverse=True`` undoes it. Returns a new dict."""
    if not spec.use_rope:
        return dict(state_dict)
    hd, nh, d = spec.head_dim, spec.num_heads, spec.hidden_size
    perm = rope_channel_permutation(hd)
    if inverse:
        perm = np.argsort(perm)
    perm = torch.from_numpy(perm)
    out = dict(state_dict)
    for i in range(spec.depth):
        pre = f"blocks.{i}.attn"
        w = out[f"{pre}.qkv.weight"].reshape(3, nh, hd, d).clone()
        w[:2] = w[:2, :, perm.to(w.device)]
        out[f"{pre}.qkv.weight"] = w.reshape(3 * d, d)
        if f"{pre}.qkv.bias" in out:
            b = out[f"{pre}.qkv.bias"].reshape(3, nh, hd).clone()
            b[:2] = b[:2, :, perm.to(b.device)]
            out[f"{pre}.qkv.bias"] = b.reshape(3 * d)
        for nk in ("q_norm", "k_norm"):
            for leaf in ("weight", "bias"):
                key = f"{pre}.{nk}.{leaf}"
                if key in out:
                    out[key] = out[key][perm.to(out[key].device)]
    return out


@torch.no_grad()
def init_dit_weights_(model: LightningDiT, generator: Optional[torch.Generator] = None) -> LightningDiT:
    """The reference initialisation in place (``init_dit_params`` of the JAX
    package): xavier-uniform linears, the patch embedding treated as the
    linear (D, C*p*p), N(0, 0.02) for the timestep MLP and the label table,
    zero biases, unit norm weights, and zero adaLN projections and final
    linear (so the model returns exactly 0 at the start). Draws come from
    ``generator`` (CPU); the sin-cos and RoPE buffers are left as they are."""

    def xavier(w: torch.Tensor, fan_in: int, fan_out: int) -> None:
        a = float(np.sqrt(6.0 / (fan_in + fan_out)))
        w.copy_(torch.rand(w.shape, generator=generator) * (2 * a) - a)

    def normal(w: torch.Tensor) -> None:
        w.copy_(torch.randn(w.shape, generator=generator) * 0.02)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_out = m.weight.shape[0]
            xavier(m.weight, m.weight[0].numel(), fan_out)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (RMSNorm, nn.LayerNorm)):
            nn.init.ones_(m.weight)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
    for lin in (model.t_embedder.mlp[0], model.t_embedder.mlp[2]):
        normal(lin.weight)
    normal(model.y_embedder.embedding_table.weight)
    for lin in [blk.adaLN_modulation[1] for blk in model.blocks] + [
            model.final_layer.adaLN_modulation[1], model.final_layer.linear]:
        nn.init.zeros_(lin.weight)
        nn.init.zeros_(lin.bias)
    return model


@torch.no_grad()
def quantize_dit_(model: LightningDiT) -> LightningDiT:
    """int8-quantize the block matmul weights in place for sampling
    (counterpart of ``quantize_dit_params``): each block's qkv, every MLP
    linear and the adaLN projection become ``QLinear``s. The attention
    out-projection, the embedders and the final layer stay fp32. Apply
    after ``permute_qk_for_half_rope`` (it quantizes whatever layout it
    finds); quantized linears are left as they are. Returns the model."""

    def q(lin):
        return lin if is_quantized(lin) else quantize_linear(lin)

    for blk in model.blocks:
        blk.attn.qkv = q(blk.attn.qkv)
        for name, child in list(blk.mlp.named_children()):
            setattr(blk.mlp, name, q(child))
        blk.adaLN_modulation[1] = q(blk.adaLN_modulation[1])
    return model


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY = {
    "LightningDiT-XL/1": dict(depth=28, hidden_size=1152, patch_size=1, num_heads=16),
    "LightningDiT-XL/2": dict(depth=28, hidden_size=1152, patch_size=2, num_heads=16),
    "LightningDiT-L/2": dict(depth=24, hidden_size=1024, patch_size=2, num_heads=16),
    "LightningDiT-B/1": dict(depth=12, hidden_size=768, patch_size=1, num_heads=12),
    "LightningDiT-B/2": dict(depth=12, hidden_size=768, patch_size=2, num_heads=12),
    "LightningDiT-1p0B/1": dict(depth=24, hidden_size=1536, patch_size=1, num_heads=24),
    "LightningDiT-1p0B/2": dict(depth=24, hidden_size=1536, patch_size=2, num_heads=24),
    "LightningDiT-1p6B/1": dict(depth=28, hidden_size=1792, patch_size=1, num_heads=28),
    "LightningDiT-1p6B/2": dict(depth=28, hidden_size=1792, patch_size=2, num_heads=28),
    # tiny config for CPU tests (not in the reference registry)
    "LightningDiT-debug": dict(depth=2, hidden_size=64, patch_size=1, num_heads=4),
}


def dit_spec(model_type: str, **overrides) -> DiTSpec:
    base = dict(_REGISTRY[model_type])
    base.update(overrides)
    return DiTSpec(**base)


def list_models():
    return sorted(_REGISTRY)
