"""int8 quantization for sampling-time matmuls (port of ``ldmae_tpu/ops/quant.py``).

Two modes, both inference-only transforms of a full-precision model:

  * ``w8`` (weight-only): int8 weights with a per-output-channel fp32 scale,
    dequantized to the compute dtype right before a float matmul.
  * ``w8a8`` (dynamic): int8 weights and per-row (per-token) dynamic int8
    activations feed an int8 x int8 -> int32 matmul (``torch._int_mm``, the
    counterpart of the product the JAX package leaves to XLA), dequantized
    as (acc * row_scale) * col_scale + bias in fp32, one rounding to the
    compute dtype.

A quantized linear is a ``QLinear``: ``w_q`` int8 (out, in) in nn.Linear's
layout, ``w_scale`` fp32 (out,), ``bias`` fp32 (out,) or None. Weights are
quantized symmetrically per output channel, so the absmax is taken over the
last dim (JAX's (in, out) layout takes it over dim -2). Rounding is
half-to-even on both sides (``torch.round`` and ``jnp.round``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .fused_adaln import fused_silu_mul_quant, quantize_rows_fp32

_EPS = 1e-8
# torch._int_mm on CUDA takes more than 16 rows; fewer (the adaLN projection
# of c_mod has one row per sample) are padded with zero rows, which is exact.
INT_MM_MIN_ROWS = 17


class QLinear(nn.Module):
    """An nn.Linear replaced by its int8 weights, per-output-channel scales
    and the float bias (``quantize_linear``)."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("bias", bias)

    def extra_repr(self) -> str:
        return f"in_features={self.w_q.shape[1]}, out_features={self.w_q.shape[0]}"


@torch.no_grad()
def quantize_linear(lin) -> QLinear:
    """nn.Linear (weight (out, in), bias) -> QLinear. Symmetric
    per-output-channel int8: scale = absmax / 127 over the input dim."""
    w = lin.weight.float()
    absmax = w.abs().amax(dim=-1, keepdim=True)  # (out, 1)
    scale = torch.clamp_min(absmax / 127.0, _EPS)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8).contiguous()
    bias = None if lin.bias is None else lin.bias.detach().clone()
    return QLinear(w_q, scale.squeeze(-1), bias)


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 quantization of activations. x:
    (..., K). Returns (int8 x, fp32 per-row scale (..., 1))."""
    return quantize_rows_fp32(x.float())


def _int_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int32 (..., out) = int8 x_q (..., in) @ int8 w_q (out, in)^T. The
    weight goes in as the transposed view of the contiguous (out, in)
    tensor, the column-major operand cuBLASLt takes."""
    k = x_q.shape[-1]
    a = x_q.reshape(-1, k)
    m = a.shape[0]
    if m < INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros(INT_MM_MIN_ROWS - m, k)])
    if a.device.type == "cuda" and (k % 8 or w_q.shape[0] % 8):
        raise ValueError(f"torch._int_mm on CUDA needs K ({k}) and N ({w_q.shape[0]}) multiples of 8")
    acc = torch._int_mm(a.contiguous(), w_q.t())
    return acc[:m].reshape(*x_q.shape[:-1], w_q.shape[0])


def _dequant(acc, x_scale, p: QLinear, compute_dtype: torch.dtype) -> torch.Tensor:
    out = (acc.float() * x_scale) * p.w_scale.float()
    if p.bias is not None:
        out = out + p.bias.float()
    return out.to(compute_dtype)


def qdense(
    x: torch.Tensor,
    p: QLinear,
    mode: str = "w8a8",
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Quantized counterpart of ``linear.dense``. Output dtype follows the
    input (like dense)."""
    from .linear import dense

    cd = compute_dtype or x.dtype
    if mode == "w8":
        w = p.w_q.to(cd) * p.w_scale.to(cd)[:, None]
        return dense(x, w, p.bias, compute_dtype=cd)
    if mode == "w8a8":
        x_q, x_scale = _quantize_rows(x)
        return _dequant(_int_mm(x_q, p.w_q), x_scale, p, cd)
    raise ValueError(f"unknown quant mode: {mode}")


def qdense_pre(
    x_q: torch.Tensor,
    x_scale: torch.Tensor,
    p: QLinear,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """w8a8 matmul over an activation already quantized by a producer
    kernel (``fused_norm_modulate_quant`` / ``fused_silu_mul_quant``).
    x_q: int8 (..., K); x_scale: fp32 (..., 1)."""
    return _dequant(_int_mm(x_q, p.w_q), x_scale, p, compute_dtype)


def swiglu_ffn_quant(
    x_q: torch.Tensor,
    x_scale: torch.Tensor,
    mlp,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """SwiGLU FFN over a pre-quantized input, the silu gate and the w3
    input quantization in one kernel (``fused_silu_mul_quant``). ``mlp``
    has quantized ``w12`` and ``w3``."""
    x12 = qdense_pre(x_q, x_scale, mlp.w12, compute_dtype)
    h_q, h_s = fused_silu_mul_quant(x12)
    return qdense_pre(h_q, h_s, mlp.w3, compute_dtype)


def is_quantized(lin) -> bool:
    return hasattr(lin, "w_q")


def maybe_qdense(
    x: torch.Tensor,
    lin,
    mode: Optional[str],
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """dense() over either an nn.Linear or a QLinear, so one forward serves
    quantized and full-precision models."""
    from .linear import dense

    if is_quantized(lin):
        return qdense(x, lin, mode=mode or "w8a8", compute_dtype=compute_dtype)
    return dense(x, lin.weight, lin.bias, compute_dtype=compute_dtype)
