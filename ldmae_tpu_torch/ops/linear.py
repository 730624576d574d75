"""Linear / MLP primitives (port of ``ldmae_tpu/ops/linear.py``).

Weights are in PyTorch's ``nn.Linear`` layout, (out, in), as the reference
checkpoints store them. ``dense`` casts both operands to the compute dtype
and lets the matmul accumulate in float32 (cuBLAS and oneDNN do for bf16),
with one rounding to the compute dtype at the end.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .fused_adaln import fused_matmul_silu
from .quant import is_quantized, maybe_qdense


def dense(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x @ weight^T + bias with operands in the compute dtype, float32 sums
    and one rounding at the end. On CUDA, cuBLAS accumulates in float32 and
    adds the bias (in the compute dtype) in its epilogue. On the CPU the
    product runs in float32 on the compute-dtype values with the float32
    bias, as XLA does (a bf16 CPU matmul would round before the bias)."""
    cd = compute_dtype or x.dtype
    x, weight = x.to(cd), weight.to(cd)
    if x.device.type == "cuda" or cd == torch.float32:
        return F.linear(x, weight, None if bias is None else bias.to(cd))
    b = None if bias is None else bias.float()
    return F.linear(x.float(), weight.float(), b).to(cd)


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu in its op order, x * (1 / (1 + exp(-x))), each op rounded
    to x's dtype as the JAX package's lowering does."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """jax.nn.gelu in its op order, constants in x's dtype."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    if approximate:
        inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
        return x * (c(0.5) * (1 + torch.tanh(inner)))
    return c(0.5) * x * torch.special.erfc(-x * c(math.sqrt(0.5)))


def mlp_gelu(
    x: torch.Tensor,
    fc1,
    fc2,
    approximate: bool = False,
    quant_mode: Optional[str] = None,
) -> torch.Tensor:
    """timm-style Mlp: fc1 -> GELU -> fc2, over two linears (nn.Linear or
    QLinear). VMAE uses exact GELU, the DiT's non-SwiGLU path the tanh
    approximation."""
    h = gelu(maybe_qdense(x, fc1, quant_mode), approximate=approximate)
    return maybe_qdense(h, fc2, quant_mode)


def swiglu_ffn(
    x: torch.Tensor,
    w12,
    w3,
    quant_mode: Optional[str] = None,
    impl: str = "xla",
) -> torch.Tensor:
    """SwiGLU FFN over the reference's packed ``w12`` linear (2H, D): x1 is
    the first H output channels, x2 the rest. ``impl="fused"`` runs the gate
    inside the w12 matmul kernel when w12 is full precision and the kernel's
    shape gate holds; otherwise (and for ``impl="xla"``) x12 is rounded to
    the compute dtype before the silu."""
    if impl == "fused" and not is_quantized(w12):
        hidden = fused_matmul_silu(x, w12.weight, w12.bias)
        if hidden is not None:
            return maybe_qdense(hidden, w3, quant_mode)
    x12 = maybe_qdense(x, w12, quant_mode)
    x1, x2 = x12.chunk(2, dim=-1)
    return maybe_qdense(silu(x1) * x2, w3, quant_mode)


def modulate(
    x: torch.Tensor, shift: Optional[torch.Tensor], scale: torch.Tensor
) -> torch.Tensor:
    """adaLN modulation in x's dtype. x: (B, N, D); shift/scale: (B, D);
    shift=None is the ``wo_shift`` variant."""
    scale = scale[:, None, :].to(x.dtype)
    if shift is None:
        return x * (1.0 + scale)
    return x * (1.0 + scale) + shift[:, None, :].to(x.dtype)
