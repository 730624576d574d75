"""int8 quantization for sampling-time matmuls (port of ``ldmae_tpu/ops/quant.py``).

Two modes, both inference-only transforms of a full-precision model:

  * ``w8`` (weight-only): int8 weights with a per-output-channel fp32 scale,
    dequantized to the compute dtype right before a float matmul.
  * ``w8a8`` (dynamic): int8 weights and per-row (per-token) dynamic int8
    activations feed an int8 x int8 -> int32 matmul, dequantized as (acc *
    row_scale) * col_scale + bias in fp32, one rounding to the compute
    dtype: on CUDA one kernel, ``int8_dense`` (``csrc/dense.cu``: int8
    wgmma with the dequant in its epilogue, the counterpart of the XLA
    fusion the JAX package's ``qdense_pre`` compiles to); its plain version
    ``int8_dense_plain`` (``torch._int_mm``, then the fp32 passes) runs for
    CPU tensors.

Under tensor parallelism a row-parallel layer (its input dim split over
the ranks of ``row_group``: w3, and fc2 of the GELU MLP) quantizes its
sharded input with the whole row's absmax (the ranks' maxima reduced with
max), takes the exact int32 partial product (``int8_dense_i32``, the GEMM
engine's raw int32 epilogue), all-reduces it and dequantizes after, as the
JAX package's psum of the int32 dot does: the result equals the unsharded
layer's bit for bit.

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
import torch.nn.functional as F

from .. import kernels
from ..parallel.distributed import group_all_reduce_
from .fused_adaln import fused_silu_mul_quant, quantize_rows_fp32, silu_mul_amax, silu_mul_quant_scaled

_EPS = 1e-8
# torch._int_mm on CUDA takes more than 16 rows; fewer (the adaLN projection
# of c_mod has one row per sample) are padded with zero rows, which is exact
# (the plain version only).
INT_MM_MIN_ROWS = 17
INT8_OUT_DTYPES = (torch.bfloat16, torch.float32)


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


def int8_dense_plain(x_q: torch.Tensor, x_scale: torch.Tensor, p: QLinear, compute_dtype: torch.dtype) -> torch.Tensor:
    """``int8_dense``'s plain version: the exact int32 product
    (``torch._int_mm``), then (acc * x_scale) * w_scale + bias in fp32 and
    one rounding to ``compute_dtype``, as the JAX package's ``qdense_pre``."""
    return _dequant(_int_mm(x_q, p.w_q), x_scale, p, compute_dtype)


def _int8_args(x_q: torch.Tensor, x_scale: torch.Tensor, p: QLinear, compute_dtype: torch.dtype):
    """The operands as ``ldmae_int8_dense`` takes them: x_q (M, K) and w_q
    (N, K) int8, contiguous and 16-byte aligned, K zero-padded to a multiple
    of 16 where it is not (TMA reads rows of 16-byte multiples; zero columns
    add nothing to an int sum); x_scale (M rows of one fp32), w_scale (N,)
    and the bias (N,) fp32 and contiguous, or None. Returns (x_q, w_q,
    x_scale, w_scale, bias). Raises on what the kernel does not take; the
    output (``compute_dtype``) is bf16 or fp32. Tensors already in the
    kernel's form pass as they are (this runs four times a DiT block)."""
    if compute_dtype not in INT8_OUT_DTYPES:
        raise ValueError(f"int8_dense: the kernel writes bf16 or fp32, not {compute_dtype}")
    w, ws, bias = p.w_q, p.w_scale, p.bias
    k = x_q.shape[-1]
    if x_q.dtype != torch.int8 or w.dtype != torch.int8 or w.dim() != 2 or w.shape[1] != k:
        raise ValueError(f"int8_dense: x_q (..., {k}) and w_q (N, {k}) must be int8, "
                         f"got {x_q.dtype} and {w.dtype} {tuple(w.shape)}")
    a = x_q.reshape(-1, k)
    if x_scale.dtype != torch.float32 or x_scale.numel() != a.shape[0] or x_scale.shape[-1] != 1:
        raise ValueError(f"int8_dense: x_scale must be fp32 (..., 1) with one scale a row of x_q, "
                         f"got {x_scale.dtype} {tuple(x_scale.shape)}")
    if k % 16 or a.data_ptr() % 16 or not a.is_contiguous():
        a = F.pad(a, (0, -k % 16))
    if k % 16 or w.data_ptr() % 16 or not w.is_contiguous():
        w = F.pad(w, (0, -k % 16))
    if not x_scale.is_contiguous():
        x_scale = x_scale.contiguous()
    if ws.dtype != torch.float32 or not ws.is_contiguous():
        ws = ws.to(torch.float32).contiguous()
    if bias is not None and (bias.dtype != torch.float32 or not bias.is_contiguous()):
        bias = bias.to(torch.float32).contiguous()
    return a, w, x_scale, ws, bias


def int8_dense(x_q: torch.Tensor, x_scale: torch.Tensor, p: QLinear, compute_dtype: torch.dtype) -> torch.Tensor:
    """The w8a8 linear layer: x_q int8 (..., K) with its fp32 row scales
    (..., 1) times the QLinear's int8 weights (N, K), dequantized as (acc *
    x_scale) * w_scale + bias in fp32 and rounded once to ``compute_dtype``
    (bf16 or fp32). On CUDA the int8 wgmma GEMM with the dequant in its
    epilogue (``ldmae_int8_dense``), bit for bit the plain version, which
    runs for CPU tensors. ``int8_dense.launches`` counts launches."""
    if x_q.device.type == "cpu":
        return int8_dense_plain(x_q, x_scale, p, compute_dtype)
    a, w, xs, ws, bias = _int8_args(x_q, x_scale, p, compute_dtype)
    m, k = a.shape
    n = w.shape[0]
    out = torch.empty(m, n, device=a.device, dtype=compute_dtype)
    lib = kernels.load("dense")
    err = kernels.on_device(a, lib.ldmae_int8_dense, a.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                            None if bias is None else bias.data_ptr(), out.data_ptr(), m, k, n,
                            int(compute_dtype == torch.float32))
    kernels.check(err, "int8_dense")
    int8_dense.launches += 1
    return out.view(*x_q.shape[:-1], n)


int8_dense.launches = 0


def int8_dense_i32(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product (..., N) of x_q int8 (..., K) and w_q int8 (N,
    K): a row-parallel layer's partial sum, dequantized after the
    all-reduce. On CUDA the int8 wgmma GEMM with its raw int32 epilogue
    (``ldmae_int8_dense_i32``), equal to its plain version
    (``torch._int_mm``), which runs for CPU tensors. Operands are padded and
    aligned as ``int8_dense``'s. ``int8_dense_i32.launches`` counts
    launches."""
    if x_q.device.type == "cpu":
        return _int_mm(x_q, w_q)
    k = x_q.shape[-1]
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.shape[1] != k:
        raise ValueError(f"int8_dense_i32: x_q (..., {k}) and w_q (N, {k}) must be int8, "
                         f"got {x_q.dtype} and {w_q.dtype} {tuple(w_q.shape)}")
    a = x_q.reshape(-1, k)
    if k % 16 or a.data_ptr() % 16 or not a.is_contiguous():
        a = F.pad(a, (0, -k % 16))
    if k % 16 or w_q.data_ptr() % 16 or not w_q.is_contiguous():
        w_q = F.pad(w_q, (0, -k % 16))
    m, n = a.shape[0], w_q.shape[0]
    out = torch.empty(m, n, device=a.device, dtype=torch.int32)
    lib = kernels.load("dense")
    err = kernels.on_device(a, lib.ldmae_int8_dense_i32, a.data_ptr(), w_q.data_ptr(), out.data_ptr(), m,
                            a.shape[1], n)
    kernels.check(err, "int8_dense_i32")
    int8_dense_i32.launches += 1
    return out.view(*x_q.shape[:-1], n)


int8_dense_i32.launches = 0


def qdense(
    x: torch.Tensor,
    p: QLinear,
    mode: str = "w8a8",
    compute_dtype: Optional[torch.dtype] = None,
    row_group=None,
) -> torch.Tensor:
    """Quantized counterpart of ``linear.dense``. Output dtype follows the
    input (like dense). ``row_group``: ``p`` holds this rank's slice of the
    input dim (w_scale and the bias whole) and the partial products are
    summed over the group (module docstring)."""
    from .linear import dense, dense_row_parallel

    cd = compute_dtype or x.dtype
    if mode == "w8":
        w = p.w_q.to(cd) * p.w_scale.to(cd)[:, None]
        if row_group is not None:
            return dense_row_parallel(x, w, p.bias, row_group, compute_dtype=cd)
        return dense(x, w, p.bias, compute_dtype=cd)
    if mode == "w8a8":
        if row_group is None:
            x_q, x_scale = _quantize_rows(x)
            return int8_dense(x_q, x_scale, p, cd)
        xf = x.float()
        amax = group_all_reduce_(xf.abs().amax(dim=-1, keepdim=True), row_group, "max")
        x_q, x_scale = quantize_rows_fp32(xf, amax)
        return qdense_pre(x_q, x_scale, p, cd, row_group)
    raise ValueError(f"unknown quant mode: {mode}")


def qdense_pre(
    x_q: torch.Tensor,
    x_scale: torch.Tensor,
    p: QLinear,
    compute_dtype: torch.dtype = torch.bfloat16,
    row_group=None,
) -> torch.Tensor:
    """w8a8 matmul over an activation already quantized by a producer
    kernel (``fused_norm_modulate_quant`` / ``fused_silu_mul_quant``).
    x_q: int8 (..., K); x_scale: fp32 (..., 1). ``row_group``: x_q and
    ``p.w_q`` are this rank's slices of K; the int32 partials are summed
    over the group (exact) before the dequant."""
    if row_group is None:
        return int8_dense(x_q, x_scale, p, compute_dtype)
    acc = group_all_reduce_(int8_dense_i32(x_q, p.w_q), row_group)
    return _dequant(acc, x_scale, p, compute_dtype)


def swiglu_ffn_quant(
    x_q: torch.Tensor,
    x_scale: torch.Tensor,
    mlp,
    compute_dtype: torch.dtype = torch.bfloat16,
    row_group=None,
) -> torch.Tensor:
    """SwiGLU FFN over a pre-quantized input, the silu gate and the w3
    input quantization in one kernel (``fused_silu_mul_quant``). ``mlp``
    has quantized ``w12`` and ``w3``. ``row_group``: w12 holds this rank's
    gate-aligned rows [w1_r | w2_r] and w3 the matching input columns; the
    gate runs as #10's two halves around the all-reduce of the row
    maxima."""
    x12 = qdense_pre(x_q, x_scale, mlp.w12, compute_dtype)
    if row_group is None:
        h_q, h_s = fused_silu_mul_quant(x12)
    else:
        amax = group_all_reduce_(silu_mul_amax(x12), row_group, "max")
        h_q, h_s = silu_mul_quant_scaled(x12, amax)
    return qdense_pre(h_q, h_s, mlp.w3, compute_dtype, row_group)


def is_quantized(lin) -> bool:
    return hasattr(lin, "w_q")


def maybe_qdense(
    x: torch.Tensor,
    lin,
    mode: Optional[str],
    compute_dtype: Optional[torch.dtype] = None,
    row_group=None,
    col_group=None,
) -> torch.Tensor:
    """dense() over either an nn.Linear or a QLinear, so one forward serves
    quantized and full-precision models. ``row_group``: ``lin`` is
    row-parallel over that group (``dense_row_parallel`` / ``qdense``);
    ``col_group``: ``lin`` is column-parallel over that group, x replicated
    (``dense``'s ``tp_group``: dx summed over the group under autograd)."""
    from .linear import dense, dense_row_parallel

    if is_quantized(lin):
        return qdense(x, lin, mode=mode or "w8a8", compute_dtype=compute_dtype, row_group=row_group)
    if row_group is not None:
        return dense_row_parallel(x, lin.weight, lin.bias, row_group, compute_dtype=compute_dtype)
    return dense(x, lin.weight, lin.bias, compute_dtype=compute_dtype, tp_group=col_group)
