"""Multi-head attention (port of ``ldmae_tpu/ops/attention.py``).

Packed qkv projection -> optional per-head qk-norm (RMS or LayerNorm over
head_dim) -> optional rotary embedding -> softmax(QK^T)V -> output
projection. ``p`` is an attention module with ``qkv`` and ``proj`` linears
(``nn.Linear``, or ``ops.quant.QLinear`` for a quantized qkv) and
``q_norm``/``k_norm`` (or None), in the reference's state-dict layout.

``impl`` selects the inner softmax(QK^T)V:
  * "xla":        fp32 logits and softmax in plain PyTorch
  * "flash":      the flash-attention kernel
  * "flash_rope": the kernel with RoPE applied inside it (half layout)
  * "flash_qkr":  the kernel with the RMS qk-norm and RoPE inside it (half
                  layout, RMS qk-norm without bias; otherwise as flash_rope's
                  fallback)
  * "flash_fused": RoPE and attention on q, k, v in the (B, N, H*hd) layout
                  of the qkv projection, nothing transposed (half layout;
                  the qk-norm runs before it)
  * "sdpa", "cudnn": ``F.scaled_dot_product_attention`` after RoPE applied
                  here, the library call the JAX package makes for both
                  names (``jax.nn.dot_product_attention``); no kernel of the
                  port, and differentiable
Without RoPE, or with the interleaved RoPE layout (applied here, outside
the kernel), every ``flash*`` impl routes to the plain flash kernel (VMAE
attention; DiT training with ``rope_layout: interleaved``). ``xla``,
``flash`` and ``flash_rope`` are differentiable (training); the two opt-in
impls are forward only, as in the JAX package, and raise under autograd.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .flash_attention import (
    flash_attention,
    flash_attention_fused_rope,
    flash_attention_qknorm_rope,
    flash_attention_rope,
)
from ..parallel.distributed import copy_to_tp
from .linear import dense
from .norms import layer_norm, rms_norm
from .quant import is_quantized, maybe_qdense, qdense, qdense_pre
from .rope import apply_rope, apply_rope_half

FLASH_IMPLS = ("flash", "flash_rope", "flash_fused", "flash_qkr")


def _apply_head_norm(x: torch.Tensor, norm, kind: str, tp_group=None) -> torch.Tensor:
    """The per-head qk-norm. Its weights are shared by every head, so under
    tensor parallelism (a rank holding some heads) their gradient is summed
    over the group (``copy_to_tp``)."""
    if norm is None:
        return x
    if kind == "rms":
        return rms_norm(x, copy_to_tp(norm.weight, tp_group))
    return layer_norm(x, copy_to_tp(norm.weight, tp_group), copy_to_tp(norm.bias, tp_group))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, impl: str = "xla") -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v for (B, H, N, hd) operands."""
    if impl in FLASH_IMPLS:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    if impl in ("sdpa", "cudnn"):
        return F.scaled_dot_product_attention(q, k, v)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r} (xla, sdpa, cudnn or {', '.join(FLASH_IMPLS)})")
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights.float(), v.float()).to(v.dtype)


def multi_head_attention(
    x: Optional[torch.Tensor],
    p,
    num_heads: int,
    *,
    rope: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    rope_layout: str = "interleaved",
    qk_norm_kind: str = "rms",
    impl: str = "xla",
    quant_mode: Optional[str] = None,
    x_quant: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    out_dtype: Optional[torch.dtype] = None,
    tp_group=None,
) -> torch.Tensor:
    """x: (B, N, D) -> (B, N, D) in x's dtype.

    x_quant: optional (int8 x, fp32 row scales) from a fused producer kernel,
    used for the qkv matmul instead of x when the qkv weights are quantized
    (the w8a8 fused sampling path). x may then be None; out_dtype sets the
    compute and output dtype (default bfloat16).

    tp_group: tensor parallelism over heads. ``p.qkv`` holds this rank's
    ``num_heads`` heads of q, k and v (their rows in the [q; k; v] layout),
    the qk-norm weights are whole, and ``p.proj`` holds the matching input
    columns: the rank attends over its heads and proj's partial products
    are summed over the group (``dense_row_parallel``). Under autograd x's
    gradient (qkv is column-parallel: ``dense``'s ``tp_group``) and the
    qk-norm's are summed over the group."""
    if x is None:
        if x_quant is None:
            raise ValueError("multi_head_attention needs x or x_quant")
        b, n = x_quant[0].shape[:2]
        dtype = out_dtype or torch.bfloat16
    else:
        b, n = x.shape[:2]
        dtype = x.dtype
    w_qkv = p.qkv.w_q if is_quantized(p.qkv) else p.qkv.weight
    hd = w_qkv.shape[0] // (3 * num_heads)
    d = num_heads * hd  # the width this rank attends over (D under no tp)
    half_rope = rope is not None and rope_layout == "half"
    q_norm, k_norm = getattr(p, "q_norm", None), getattr(p, "k_norm", None)

    if is_quantized(p.qkv) and x_quant is not None:
        qkv = qdense_pre(x_quant[0], x_quant[1], p.qkv, compute_dtype=dtype)
    elif is_quantized(p.qkv):
        qkv = qdense(x, p.qkv, mode=quant_mode or "w8a8")
    else:
        qkv = dense(x, p.qkv.weight, p.qkv.bias, tp_group=tp_group)
    qkv = qkv.view(b, n, 3, num_heads, hd)

    if half_rope and impl == "flash_fused":
        # transpose-free: q, k normed in the (B, N, H, hd) layout, v a strided
        # view of qkv, the output written as (B, N, H*hd) rows for proj
        q = _apply_head_norm(qkv[:, :, 0], q_norm, qk_norm_kind)
        k = _apply_head_norm(qkv[:, :, 1], k_norm, qk_norm_kind)
        cos, sin = rope
        out = flash_attention_fused_rope(q, k, qkv[:, :, 2], cos, sin).view(b, n, d)
        return maybe_qdense(out, p.proj, quant_mode, compute_dtype=dtype, row_group=tp_group)

    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, N, hd)

    if (
        half_rope and impl == "flash_qkr" and qk_norm_kind == "rms"
        and q_norm is not None and getattr(q_norm, "bias", None) is None
    ):
        # RMS qk-norm + RoPE + attention in one kernel, on the views of qkv
        cos, sin = rope
        out = flash_attention_qknorm_rope(q, k, v, q_norm.weight, k_norm.weight, cos, sin)
        out = out.transpose(1, 2).reshape(b, n, d)
        return maybe_qdense(out, p.proj, quant_mode, compute_dtype=dtype, row_group=tp_group)

    q = _apply_head_norm(q, q_norm, qk_norm_kind, tp_group)
    k = _apply_head_norm(k, k_norm, qk_norm_kind, tp_group)

    if half_rope and impl == "flash_rope":
        cos, sin = rope
        out = flash_attention_rope(q.contiguous(), k.contiguous(), v.contiguous(), cos, sin)
    else:
        if rope is not None:
            cos, sin = rope
            rope_fn = apply_rope_half if rope_layout == "half" else apply_rope
            q = rope_fn(q, cos, sin)
            k = rope_fn(k, cos, sin)
        out = sdpa(q, k, v, impl=impl)
    out = out.transpose(1, 2).reshape(b, n, d)
    return maybe_qdense(out, p.proj, quant_mode, compute_dtype=dtype, row_group=tp_group)
