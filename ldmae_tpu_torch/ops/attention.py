"""Multi-head attention (port of ``ldmae_tpu/ops/attention.py``).

Packed qkv projection -> optional per-head qk-norm (RMS or LayerNorm over
head_dim, outside any kernel) -> optional rotary embedding -> softmax(QK^T)V
-> output projection. ``p`` is an attention module with ``qkv`` and ``proj``
``nn.Linear``s and ``q_norm``/``k_norm`` (or None), in the reference's
state-dict layout.

``impl`` selects the inner softmax(QK^T)V:
  * "xla":        fp32 logits and softmax in plain PyTorch
  * "flash":      the flash-attention kernel
  * "flash_rope": the kernel with RoPE applied inside it (half layout);
                  without RoPE it routes to the plain flash kernel, as every
                  ``flash*`` impl does (VMAE attention)
  * "flash_fused", "flash_qkr": not ported yet; they raise where their
                  kernel would run.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, flash_attention_rope
from .linear import dense
from .norms import layer_norm, rms_norm
from .rope import apply_rope, apply_rope_half

FLASH_IMPLS = ("flash", "flash_rope", "flash_fused", "flash_qkr")


def _apply_head_norm(x: torch.Tensor, norm, kind: str) -> torch.Tensor:
    if norm is None:
        return x
    if kind == "rms":
        return rms_norm(x, norm.weight)
    return layer_norm(x, norm.weight, norm.bias)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, impl: str = "xla") -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v for (B, H, N, hd) operands."""
    if impl in FLASH_IMPLS:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    if impl != "xla":
        raise NotImplementedError(f"attention impl {impl!r} is not ported (use 'xla' or 'flash*')")
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights.float(), v.float()).to(v.dtype)


def multi_head_attention(
    x: torch.Tensor,
    p,
    num_heads: int,
    *,
    rope: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    rope_layout: str = "interleaved",
    qk_norm_kind: str = "rms",
    impl: str = "xla",
) -> torch.Tensor:
    """x: (B, N, D) -> (B, N, D) in x's dtype."""
    b, n, d = x.shape
    hd = d // num_heads
    half_rope = rope is not None and rope_layout == "half"
    q_norm, k_norm = getattr(p, "q_norm", None), getattr(p, "k_norm", None)
    if half_rope and impl == "flash_fused":
        raise NotImplementedError(
            "attention impl 'flash_fused' (flash_attention_fused_rope) is not ported yet; "
            "it is queued with the opt-in kernels in ROADMAP.md"
        )
    if (
        half_rope and impl == "flash_qkr" and qk_norm_kind == "rms"
        and q_norm is not None and getattr(q_norm, "bias", None) is None
    ):
        raise NotImplementedError(
            "attention impl 'flash_qkr' (flash_attention_qknorm_rope) is not ported yet; "
            "it is queued with the opt-in kernels in ROADMAP.md"
        )

    qkv = dense(x, p.qkv.weight, p.qkv.bias)
    q, k, v = qkv.view(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, N, hd)
    q = _apply_head_norm(q, q_norm, qk_norm_kind)
    k = _apply_head_norm(k, k_norm, qk_norm_kind)

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
    return dense(out, p.proj.weight, p.proj.bias)
