"""Linear / MLP primitives (port of ``ldmae_tpu/ops/linear.py``).

Weights are in PyTorch's ``nn.Linear`` layout, (out, in), as the reference
checkpoints store them. ``dense`` casts both operands to the compute dtype
and lets the matmul accumulate in float32 (cuBLAS and oneDNN do for bf16),
adds the float32 bias in float32 and rounds once to the compute dtype at
the end.

Under tensor parallelism a column-parallel layer (its output dim split
over the ranks) is the local ``dense`` on the rank's rows; under autograd
its replicated input's gradient is summed over the ranks in the backward
(``dense``'s ``tp_group``, ``maybe_qdense``'s ``col_group``) from the
ranks' fp32 partials, rounded once: ``copy_to_tp`` on the fp32 operand, or
on the card the fp32 partial dx of ``dense_f32_out``. A row-parallel
layer (its input dim split: proj, w3, fc2) is ``dense_row_parallel``: the
fp32 partial product without the bias (``dense_f32_out``, the GEMM
engine's fp32 epilogue), all-reduced in fp32 (``reduce_from_tp``), then
the fp32 bias and one rounding, the math of the JAX package's psum over
its fp32 dot; it is differentiable (dx = g w_r, dw = g^T x_r, dbias = the
sum of g in fp32).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels
from ..parallel.distributed import copy_to_tp, group_all_reduce_, group_size, reduce_from_tp
from .fused_adaln import fused_matmul_silu
from .quant import is_quantized, maybe_qdense


def dense_bias_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(M, N) bf16: x (M, K) bf16 @ weight (N, K)^T bf16 with float32 sums,
    plus bias (N,) float32 in float32, one rounding, on contiguous CUDA
    tensors of any M, K and N: the wgmma GEMM engine's ``dense`` kernel
    (``csrc/dense.cu``, ``ldmae_dense_bias_f32``), its tile configuration
    chosen in the C entry by (M, N). A PyTorch bf16 linear would round the
    bias to bf16 before adding it, and cuBLASLt's bias epilogue takes the
    bias only in the output's dtype. TMA reads rows of 16-byte multiples
    from 16-byte aligned bases, so x and weight are first zero-padded to a K
    that is a multiple of 8 where it is not (a patch embedding at patch 14
    has K = 588), and copied where their base is not aligned; the zero
    columns add nothing to the sums."""
    m, k = x.shape
    n = weight.shape[0]
    x, weight = (F.pad(t, (0, -k % 8)) if k % 8 or t.data_ptr() % 16 else t for t in (x, weight))
    out = torch.empty(m, n, device=x.device, dtype=torch.bfloat16)
    lib = kernels.load("dense")
    err = kernels.on_device(x, lib.ldmae_dense_bias_f32, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), m, x.shape[1], n)
    kernels.check(err, "dense_bias_f32")
    dense_bias_f32.launches += 1
    return out


dense_bias_f32.launches = 0


class _DenseBiasF32(torch.autograd.Function):
    """``dense_bias_f32`` with its gradients: dx = g w and dw = g^T x in bf16
    (as a bf16 linear's backward), dbias the sum of g accumulated in float32
    (no float32 copy of g). With a tp ``group`` (a column-parallel layer: x
    replicated, w this rank's output rows) dx is this rank's fp32 partial
    g w (``dense_f32_out`` on w^T), summed over the group in fp32 and
    rounded once."""

    @staticmethod
    def forward(ctx, x, weight, bias, group):
        ctx.save_for_backward(x, weight)
        ctx.group = group
        return dense_bias_f32(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = None
        if need_x and group_size(ctx.group) > 1:
            dx = group_all_reduce_(dense_f32_out(g, weight.t().contiguous()), ctx.group).to(x.dtype)
        elif need_x:
            dx = g @ weight
        return dx, g.t() @ x if need_w else None, g.sum(0, dtype=torch.float32) if need_b else None, None


def dense(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
    tp_group=None,
) -> torch.Tensor:
    """x @ weight^T + bias with operands in the compute dtype, float32 sums,
    the float32 bias added in float32 and one rounding at the end, as the
    JAX package's dense. On CUDA in bf16 with a bias, ``dense_bias_f32``
    (differentiable); without a bias, or in float32, cuBLAS through
    ``F.linear``. On the CPU the product runs in
    float32 on the compute-dtype values with the float32 bias, as XLA does
    (a bf16 CPU matmul would round before the bias).

    ``tp_group``: the layer is column-parallel over the group (x replicated,
    weight and bias this rank's output rows). Under autograd dx is then
    summed over the group in the backward (``copy_to_tp``), from the ranks'
    fp32 partials and rounded once to x's dtype, the JAX psum of its fp32
    transposed dot: a bf16 dx is the one-process dx but for the sum's
    order."""
    cd = compute_dtype or x.dtype
    x, weight = x.to(cd), weight.to(cd)
    if cd == torch.float32 or (x.device.type != "cpu" and bias is None):
        return F.linear(copy_to_tp(x, tp_group), weight, None if bias is None else bias.to(cd))
    if x.device.type != "cpu" and cd == torch.bfloat16:
        args = (x.reshape(-1, x.shape[-1]).contiguous(), weight.contiguous(), bias.float().contiguous())
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
        out = _DenseBiasF32.apply(*args, tp_group) if grad else dense_bias_f32(*args)
        return out.view(*x.shape[:-1], weight.shape[0])
    b = None if bias is None else bias.float()
    return F.linear(copy_to_tp(x.float(), tp_group), weight.float(), b).to(cd)


def dense_f32_out_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``dense_f32_out``'s plain version: fp32 x @ weight^T of the operands'
    values, no bias, no rounding."""
    return F.linear(x.float(), weight.float())


def dense_f32_out(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(M, N) fp32: x (M, K) bf16 @ weight (N, K)^T bf16 with fp32 sums, no
    bias and no rounding: a row-parallel layer's partial product. On CUDA
    the GEMM engine's fp32 epilogue (``ldmae_dense_f32_out``; operands
    padded and aligned as ``dense_bias_f32``'s), on the same mainloop and
    configuration as ``dense_bias_f32``, so bf16(out + bias) is that
    kernel's output bit for bit; for CPU tensors the plain version.
    ``dense_f32_out.launches`` counts launches."""
    if x.device.type == "cpu":
        return dense_f32_out_plain(x, weight)
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise ValueError(f"dense_f32_out: the kernel takes bf16 operands, got {x.dtype} and {weight.dtype}")
    m, k = x.shape
    n = weight.shape[0]
    x, weight = (F.pad(t, (0, -k % 8)) if k % 8 or t.data_ptr() % 16 or not t.is_contiguous() else t
                 for t in (x, weight))
    out = torch.empty(m, n, device=x.device, dtype=torch.float32)
    lib = kernels.load("dense")
    err = kernels.on_device(x, lib.ldmae_dense_f32_out, x.data_ptr(), weight.data_ptr(), out.data_ptr(), m,
                            x.shape[1], n)
    kernels.check(err, "dense_f32_out")
    dense_f32_out.launches += 1
    return out


dense_f32_out.launches = 0


class _PartialProduct(torch.autograd.Function):
    """x_r (M, K_r) @ w_r (N, K_r)^T with fp32 sums out: ``dense_f32_out``
    for bf16 operands, else the product in the operands' dtype. The
    backward takes the (fp32) gradient of the sum, which holds bf16 values
    when the operands are bf16 (it is the gradient of the rounded output),
    and returns dx = g w_r and dw = g^T x_r in the operands' dtype, as a
    bf16 linear's backward does."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return dense_f32_out(x, weight) if x.dtype == torch.bfloat16 else F.linear(x, weight)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad
        g = g.to(x.dtype)
        return g @ weight if need_x else None, g.t() @ x if need_w else None


def dense_row_parallel(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    group,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``dense`` of a layer whose input dim is split over ``group``: x (...,
    K_r) and weight (N, K_r) are this rank's slices, the bias (N,) whole.
    The fp32 partial products are summed over the group, then the fp32 bias
    is added and the sum rounded once to the compute dtype (the JAX psum's
    math). bf16 runs ``dense_f32_out``; fp32 the fp32 product ``dense`` runs
    in fp32. Differentiable: the all-reduce's transpose is the identity, so
    dx = g w_r, dw = g^T x_r (the operands' dtype) and dbias = the sum of g
    in fp32, g the gradient of the rounded output, every rank holding it
    whole."""
    cd = compute_dtype or x.dtype
    x, weight = x.to(cd), weight.to(cd)
    rows = x.reshape(-1, x.shape[-1])
    part = reduce_from_tp(_PartialProduct.apply(rows, weight), group)
    if bias is not None:
        part = part + bias.to(part.dtype)
    return part.to(cd).view(*x.shape[:-1], weight.shape[0])


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
    row_group=None,
) -> torch.Tensor:
    """timm-style Mlp: fc1 -> GELU -> fc2, over two linears (nn.Linear or
    QLinear). VMAE uses exact GELU, the DiT's non-SwiGLU path the tanh
    approximation. ``row_group``: fc1 holds this rank's hidden rows and fc2
    is row-parallel over the group."""
    h = gelu(maybe_qdense(x, fc1, quant_mode, col_group=row_group), approximate=approximate)
    return maybe_qdense(h, fc2, quant_mode, row_group=row_group)


def swiglu_ffn(
    x: torch.Tensor,
    w12,
    w3,
    quant_mode: Optional[str] = None,
    impl: str = "xla",
    row_group=None,
) -> torch.Tensor:
    """SwiGLU FFN over the reference's packed ``w12`` linear (2H, D): x1 is
    the first H output channels, x2 the rest. ``impl="fused"`` runs the gate
    inside the w12 matmul kernel when w12 is full precision and the kernel's
    shape gate holds; otherwise (and for ``impl="xla"``) x12 is rounded to
    the compute dtype before the silu. ``row_group``: w12 holds this rank's
    gate-aligned rows [w1_r | w2_r] (so x1 and x2 stay paired on the rank)
    and w3 is row-parallel over the group."""
    if impl == "fused" and not is_quantized(w12):
        hidden = fused_matmul_silu(x, w12.weight, w12.bias)
        if hidden is not None:
            return maybe_qdense(hidden, w3, quant_mode, row_group=row_group)
    x12 = maybe_qdense(x, w12, quant_mode, col_group=row_group)
    x1, x2 = x12.chunk(2, dim=-1)
    return maybe_qdense(silu(x1) * x2, w3, quant_mode, row_group=row_group)


def modulate(
    x: torch.Tensor, shift: Optional[torch.Tensor], scale: torch.Tensor
) -> torch.Tensor:
    """adaLN modulation in x's dtype. x: (B, N, D); shift/scale: (B, D);
    shift=None is the ``wo_shift`` variant."""
    scale = scale[:, None, :].to(x.dtype)
    if shift is None:
        return x * (1.0 + scale)
    return x * (1.0 + scale) + shift[:, None, :].to(x.dtype)
