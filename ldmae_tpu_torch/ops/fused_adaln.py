"""Fused adaLN epilogue and fused SwiGLU gate: the CUDA kernels
(``csrc/fused_norm_modulate.cu``, ``csrc/fused_matmul_silu.cu``,
``csrc/fused_quant.cu``) and their plain PyTorch versions.

Counterpart of ``ldmae_tpu/ops/fused_adaln.py``'s ``fused_norm_modulate``
(``_kernel``), ``fused_matmul_silu`` (``_kernel_matmul_silu``) and the two
quantizing kernels of the w8a8 leg, ``fused_norm_modulate_quant``
(``_kernel_quant``) and ``fused_silu_mul_quant``
(``_kernel_silu_mul_quant``). ``fused_norm_modulate`` is differentiable, as
the JAX package's custom VJP is (``fused_norm_modulate_bwd_kernel``, with
``fused_norm_modulate_bwd`` its plain PyTorch version); the others are
forward only (sampling). A wrapper runs the plain
version for CPU tensors only; for CUDA tensors it launches the kernel or
raises. The kernels take bf16 or fp32 (the configs' two compute dtypes);
fp32 runs the same kernels with the element type a template parameter,
except ``fused_matmul_silu``, whose fp32 kernel is a plain SIMT GEMM (the
tensor cores take no fp32). Rows of D <= MAX_WIDTH elements, D a multiple
of 8 (bf16) or 4 (fp32): every width of the DiT registry (64 to 1,792).
``<wrapper>.launches`` counts kernel launches.

The gate kernel (#10) takes any hidden width 1 <= H <= MAX_GATE_H, as the
TPU kernel does (its block spans the whole row). Under tensor parallelism a
rank holds a slice [x1_r | x2_r] of the SwiGLU hidden dim, so #10 runs as
its two halves (``silu_mul_amax``, then
``silu_mul_quant_scaled`` with the ranks' maxima reduced): two modes of the
same gate kernel, which together equal #10 on the whole row bit for bit.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import kernels
from .flash_attention import _acc, _needs_grad

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_WIDTH = 2048  # row elements the norm kernels hold in registers (64 a lane)
MAX_GATE_H = 8192  # SwiGLU hidden width the gate kernel (#10) holds in registers (64 a thread)


def _check_rows(what: str, x: torch.Tensor) -> tuple[int, int, int]:
    """x a (B, N, D) tensor as the row kernels (#3, #9) take it: contiguous,
    16-byte aligned, of a kernel dtype, rows of D elements they hold.
    Returns (B, N, D)."""
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be a contiguous, 16-byte aligned (B, N, D) tensor")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what}: the CUDA kernels take bf16 or fp32, got {x.dtype}")
    b, n, d = x.shape
    unit = 16 // x.element_size()
    if d % unit or d > MAX_WIDTH:
        raise ValueError(f"{what}: D={d} must be a multiple of {unit} and <= {MAX_WIDTH} for {x.dtype}")
    return b, n, d


def _param_rows(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """shift or scale as #3's kernel reads it: rows of x's dtype on x's
    device with unit column stride, in place where they already are (a row
    stride apart, as the adaLN projection writes them); a cast here is the
    one rounding the TPU kernel does to x's dtype."""
    if t.dtype != x.dtype or t.device != x.device:
        t = t.to(device=x.device, dtype=x.dtype)
    return t if t.stride(-1) == 1 else t.contiguous()


def _row_weight(weight: Optional[torch.Tensor], x: torch.Tensor, kind: str) -> Optional[torch.Tensor]:
    """The RMSNorm weight as the row kernels read it (fp32 on x's device), or
    None, which they take as a weight of ones (and always for kind='layer')."""
    if kind == "rms" and weight is not None:
        return weight.to(device=x.device, dtype=torch.float32).contiguous()
    return None


def fused_norm_modulate_plain(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    shift: torch.Tensor,
    scale: torch.Tensor,
    *,
    kind: str = "rms",
    eps: float = 1e-6,
) -> torch.Tensor:
    """The kernel's math: the norm in fp32 (float64 for float64 x), cast to
    x's dtype, times the weight (rms) in x's dtype, then y*(1+scale[b]) +
    shift[b] in x's dtype."""
    xf = _acc(x)
    if kind == "layer":
        xc = xf - xf.mean(-1, keepdim=True)
        y = (xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)).to(x.dtype)
    else:
        y = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)).to(x.dtype)
        if weight is not None:
            y = y * weight.to(x.dtype)
    sc = _acc(scale).to(x.dtype)[:, None, :]
    sh = _acc(shift).to(x.dtype)[:, None, :]
    return y * (1.0 + sc) + sh


def fused_norm_modulate_bwd(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    shift: torch.Tensor,
    scale: torch.Tensor,
    g: torch.Tensor,
    *,
    kind: str = "rms",
    eps: float = 1e-6,
):
    """(dx, dweight, dshift, dscale) of ``fused_norm_modulate`` for the
    output gradient g: the JAX custom VJP's fp32 math
    (``ldmae_tpu/ops/fused_adaln.py``, ``_fnm_custom_vjp``) in plain
    PyTorch ops: the CPU path and the oracle of the kernel
    (``fused_norm_modulate_bwd_kernel``). dweight is summed over (B, N); it
    is None without a weight (and zeros for kind='layer', whose norm takes
    no weight)."""
    xf, gf = _acc(x), _acc(g)
    dxh = gf * (1.0 + _acc(scale))[:, None, :]
    dw = None
    if kind == "layer":
        xc = xf - xf.mean(-1, keepdim=True)
        r = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
        xhat = xc * r
        dx = r * (dxh - dxh.mean(-1, keepdim=True) - xhat * (dxh * xhat).mean(-1, keepdim=True))
        if weight is not None:
            dw = torch.zeros_like(weight)
    else:
        r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        u = xf * r  # normalised, before the weight
        wf = torch.ones_like(u[0, 0]) if weight is None else _acc(weight)
        xhat = u * wf
        if weight is not None:
            dw = (dxh * u).sum(dim=(0, 1)).to(weight.dtype)
        du = dxh * wf
        dx = r * (u * -(du * u).mean(-1, keepdim=True) + du)
    dshift = gf.sum(dim=1).to(shift.dtype)
    dscale = (gf * xhat).sum(dim=1).to(scale.dtype)
    return dx.to(x.dtype), dw, dshift, dscale


class _FusedNormModulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, shift, scale, kind, eps):
        ctx.save_for_backward(x, weight, shift, scale)
        ctx.kind, ctx.eps = kind, eps
        return _fused_norm_modulate_fwd(x, weight, shift, scale, kind=kind, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, shift, scale = ctx.saved_tensors
        bwd = fused_norm_modulate_bwd if x.device.type == "cpu" else fused_norm_modulate_bwd_kernel
        return (*bwd(x, weight, shift, scale, g, kind=ctx.kind, eps=ctx.eps), None, None)


def fused_norm_modulate_bwd_kernel(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    shift: torch.Tensor,
    scale: torch.Tensor,
    g: torch.Tensor,
    *,
    kind: str = "rms",
    eps: float = 1e-6,
):
    """``fused_norm_modulate_bwd`` by the CUDA kernel (``rows::bwd`` in
    ``csrc/norm_rows.cuh``): the same fp32 math, dx in x's dtype, the column
    sums (dweight, dshift, dscale) in fp32 without atomics, so the same bits
    from run to run, each cast once to its input's dtype. Takes what the
    forward kernel takes; raises otherwise, or on a launch error."""
    what = "fused_norm_modulate_bwd"
    b, n, d = _check_rows(what, x)
    if shift.shape != (b, d) or scale.shape != (b, d) or g.shape != x.shape:
        raise ValueError(f"{what}: shift/scale must be ({b}, {d}) and g {tuple(x.shape)}")
    if g.dtype != x.dtype or not g.is_contiguous():
        g = g.to(dtype=x.dtype).contiguous()
    scale_r = _param_rows(scale, x)
    w = _row_weight(weight, x, kind)
    fp32 = int(x.dtype == torch.float32)
    slots = _bwd_grid(x.device, b, n, d, fp32) + b
    # the partials' workspace, then dshift and dscale unless they come out in
    # bf16 (their dtype; one rounding of the fp32 sums), as a tensor of
    # their own; dw apart (it becomes the weight's .grad)
    sums_bf16 = shift.dtype == scale.dtype == torch.bfloat16
    nw = slots * 3 * d
    ws = torch.empty(nw + (0 if sums_bf16 else 2 * b * d), device=x.device, dtype=torch.float32)
    sums = torch.empty(2, b, d, device=x.device, dtype=torch.bfloat16) if sums_bf16 else ws[nw:].view(2, b, d)
    dw = None if w is None else torch.empty(d, device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    lib = kernels.load("fused_norm_modulate")
    err = kernels.on_device(
        x, lib.ldmae_fused_norm_modulate_bwd, x.data_ptr(), g.data_ptr(), None if w is None else w.data_ptr(),
        scale_r.data_ptr(), scale_r.stride(0), dx.data_ptr(), None if dw is None else dw.data_ptr(),
        sums.data_ptr(), sums.data_ptr() + b * d * sums.element_size(), ws.data_ptr(), slots, b, n, d,
        int(kind == "layer"), eps, fp32, int(sums_bf16),
    )
    kernels.check(err, what)
    fused_norm_modulate_bwd_kernel.launches += 1
    if weight is None:
        dweight = None
    elif dw is None:  # kind 'layer': the norm takes no weight
        dweight = torch.zeros_like(weight)
    else:
        dweight = dw if weight.dtype == torch.float32 else dw.to(weight.dtype)
    dshift, dscale = sums[0], sums[1]
    if dshift.dtype != shift.dtype:
        dshift = dshift.to(shift.dtype)
    if dscale.dtype != scale.dtype:
        dscale = dscale.to(scale.dtype)
    return dx, dweight, dshift, dscale


@functools.lru_cache(maxsize=None)
def _bwd_grid(device: torch.device, b: int, n: int, d: int, fp32: int) -> int:
    """Blocks of the backward kernel's grid at this shape on ``device`` (its
    workspace holds one partial a block and batch element it meets)."""
    lib = kernels.load("fused_norm_modulate")
    grid = kernels.on_device(torch.empty(0, device=device), lib.ldmae_fused_norm_modulate_bwd_grid, b, n, d, fp32)
    if grid < 1:
        kernels.check(-grid or -1, "fused_norm_modulate_bwd")
    return grid


fused_norm_modulate_bwd_kernel.launches = 0


def fused_norm_modulate(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    shift: torch.Tensor,
    scale: torch.Tensor,
    *,
    kind: str = "rms",
    eps: float = 1e-6,
) -> torch.Tensor:
    """x: (B, N, D); weight: (D,) RMSNorm weight (ignored for kind='layer');
    shift/scale: (B, D). Returns modulate(norm(x), shift, scale).
    Differentiable: the forward is the kernel (or, for CPU tensors, its
    plain version), the backward ``fused_norm_modulate_bwd_kernel`` (for CPU
    tensors ``fused_norm_modulate_bwd``)."""
    if kind not in ("rms", "layer"):
        raise ValueError(f"unknown norm kind {kind!r}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, weight, shift, scale)):
        return _FusedNormModulate.apply(x, weight, shift, scale, kind, eps)
    return _fused_norm_modulate_fwd(x, weight, shift, scale, kind=kind, eps=eps)


def _fused_norm_modulate_fwd(x, weight, shift, scale, *, kind: str, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_norm_modulate_plain(x, weight, shift, scale, kind=kind, eps=eps)
    what = "fused_norm_modulate"
    b, n, d = _check_rows(what, x)
    if shift.shape != (b, d) or scale.shape != (b, d):
        raise ValueError(f"{what}: shift/scale must be ({b}, {d})")
    shift, scale = _param_rows(shift, x), _param_rows(scale, x)
    w = _row_weight(weight, x, kind)
    out = torch.empty_like(x)
    lib = kernels.load(what)
    err = kernels.on_device(
        x, lib.ldmae_fused_norm_modulate, x.data_ptr(), None if w is None else w.data_ptr(),
        shift.data_ptr(), scale.data_ptr(), shift.stride(0), scale.stride(0), out.data_ptr(), b, n, d,
        int(kind == "layer"), eps, int(x.dtype == torch.float32),
    )
    kernels.check(err, what)
    fused_norm_modulate.launches += 1
    return out


fused_norm_modulate.launches = 0


def fused_matmul_silu_plain(
    x: torch.Tensor, w12: torch.Tensor, b12: Optional[torch.Tensor]
) -> torch.Tensor:
    """silu(x1) * x2 of x @ w12^T + b12 (fp32 products of the compute-dtype
    operands, fp32 bias and gate), cast to x's dtype."""
    acc = torch.matmul(x.float(), w12.to(x.dtype).float().t())
    if b12 is not None:
        acc = acc + b12.float()
    x1, x2 = acc.chunk(2, dim=-1)
    return (x1 * torch.sigmoid(x1) * x2).to(x.dtype)


def fused_matmul_silu(
    x: torch.Tensor, w12: torch.Tensor, b12: Optional[torch.Tensor]
) -> Optional[torch.Tensor]:
    """SwiGLU first stage with the gate fused into the matmul epilogue.
    x: (..., D); w12: (2H, D), the reference's packed ``w12`` weight; b12:
    (2H,) or None. Returns (..., H), or None when the shape gate of the TPU
    kernel fails (M % 128, D % 128 and 2H % 256 must all be 0), in which
    case the caller runs the unfused path. bf16 runs the wgmma kernel, fp32
    the SIMT one (``matmul_silu_f32_kernel``). Forward only, as the JAX
    kernel is: off the CPU, where autograd would record the call (an input
    that requires grad, grad enabled) it raises before any launch, since
    the kernel's output would carry no gradient to x, w12 or b12; on the
    CPU the plain version stays differentiable."""
    d = x.shape[-1]
    m = x.numel() // d
    h2 = w12.shape[0]
    if m % 128 or d % 128 or h2 % 256:
        return None
    if x.device.type == "cpu":
        return fused_matmul_silu_plain(x, w12, b12)
    if _needs_grad(x, w12, *(() if b12 is None else (b12,))):
        raise RuntimeError(
            "fused_matmul_silu is forward only (sampling); differentiate the DiT with mlp_impl 'xla', "
            "or call it under torch.no_grad()")
    if x.dtype not in KERNEL_DTYPES or not x.is_contiguous():
        raise ValueError("fused_matmul_silu: x must be a contiguous bf16 or fp32 tensor")
    if w12.shape != (h2, d):
        raise ValueError(f"fused_matmul_silu: w12 must be (2H, {d}), got {tuple(w12.shape)}")
    w = w12.to(device=x.device, dtype=x.dtype).contiguous()
    bias = (
        torch.zeros(h2, device=x.device, dtype=torch.float32) if b12 is None
        else b12.to(device=x.device, dtype=torch.float32).contiguous()
    )
    out = torch.empty(*x.shape[:-1], h2 // 2, device=x.device, dtype=x.dtype)
    lib = kernels.load("fused_matmul_silu")
    entry = lib.ldmae_fused_matmul_silu if x.dtype == torch.bfloat16 else lib.ldmae_fused_matmul_silu_f32
    err = kernels.on_device(x, entry, x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), m, d, h2 // 2)
    kernels.check(err, "fused_matmul_silu")
    fused_matmul_silu.launches += 1
    return out


fused_matmul_silu.launches = 0


def quantize_rows_fp32(o: torch.Tensor, amax: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 of fp32 ``o`` (..., K): scale = max(absmax /
    127, 1e-8), q = round(o / scale) half-to-even. ``amax`` (..., 1), when
    given, is the row's absmax (a row split across ranks: the max of every
    rank's slice), else it is taken over ``o``. Returns (int8 (..., K), fp32
    (..., 1))."""
    if amax is None:
        amax = o.abs().amax(dim=-1, keepdim=True)
    qs = torch.clamp_min(amax / 127.0, 1e-8)
    return torch.round(o / qs).to(torch.int8), qs


def fused_norm_modulate_quant_plain(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    shift: torch.Tensor,
    scale: torch.Tensor,
    *,
    kind: str = "rms",
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math: norm, weight and modulation all in fp32 (nothing
    rounded to x's dtype), then per-row int8."""
    xf = x.float()
    if kind == "layer":
        xc = xf - xf.mean(-1, keepdim=True)
        y = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    else:
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        if weight is not None:
            y = y * weight.float()
    o = y * (1.0 + scale.float()[:, None, :])
    o = o + shift.float()[:, None, :]
    return quantize_rows_fp32(o)


def fused_norm_modulate_quant(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    shift: torch.Tensor,
    scale: torch.Tensor,
    *,
    kind: str = "rms",
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, N, D); weight: (D,) RMSNorm weight (ignored for kind='layer');
    shift/scale: (B, D). Returns (int8 (B, N, D), fp32 row scales (B, N, 1))
    with o_q * scales ~= modulate(norm(x), shift, scale) computed in fp32."""
    if kind not in ("rms", "layer"):
        raise ValueError(f"unknown norm kind {kind!r}")
    if x.device.type == "cpu":
        return fused_norm_modulate_quant_plain(x, weight, shift, scale, kind=kind, eps=eps)
    what = "fused_norm_modulate_quant"
    b, n, d = _check_rows(what, x)
    for name, t in (("shift", shift), ("scale", scale)):
        # read in place as rows of x's dtype a row stride apart (as the adaLN
        # projection writes them); a cast would be a rounding the TPU kernel
        # does not make
        if t.shape != (b, d) or t.dtype != x.dtype or t.device != x.device or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be {x.dtype} ({b}, {d}) rows "
                             f"with unit column stride on {x.device}")
    w = _row_weight(weight, x, kind)
    out = torch.empty(b, n, d, device=x.device, dtype=torch.int8)
    scales = torch.empty(b, n, 1, device=x.device, dtype=torch.float32)
    lib = kernels.load("fused_quant")
    err = kernels.on_device(
        x, lib.ldmae_fused_norm_modulate_quant, x.data_ptr(), None if w is None else w.data_ptr(),
        shift.data_ptr(), scale.data_ptr(), shift.stride(0), scale.stride(0), out.data_ptr(),
        scales.data_ptr(), b, n, d, int(kind == "layer"), eps, int(x.dtype == torch.float32),
    )
    kernels.check(err, what)
    fused_norm_modulate_quant.launches += 1
    return out, scales


fused_norm_modulate_quant.launches = 0


def _silu_mul_fp32(x12: torch.Tensor) -> torch.Tensor:
    """silu(x1) * x2 in fp32 over the packed (..., 2H) pre-activation."""
    xf = x12.float()
    h = xf.shape[-1] // 2
    x1, x2 = xf[..., :h], xf[..., h:]
    return (x1 * torch.sigmoid(x1)) * x2


def fused_silu_mul_quant_plain(x12: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """silu(x1) * x2 in fp32 over the packed (..., 2H) pre-activation, then
    per-row int8."""
    return quantize_rows_fp32(_silu_mul_fp32(x12))


def _gate_rows(what: str, x12: torch.Tensor) -> tuple[int, int]:
    """x12 as the gate kernel takes it: contiguous bf16 or fp32 rows of 2H
    values, 1 <= H <= MAX_GATE_H, at least one row. Any such H and base: the
    vector kernel where H % 8 == 0 and the bases are aligned, else the
    realigning one, which reads and writes 16-byte words too (the SwiGLU
    widths of L and 1p6B, 2,730 and 4,778, and their halves under tensor
    parallelism). Returns (rows, H)."""
    if x12.dtype not in KERNEL_DTYPES or not x12.is_contiguous():
        raise ValueError(f"{what}: x12 must be a contiguous bf16 or fp32 tensor")
    h2 = x12.shape[-1]
    if h2 % 2 or not 1 <= h2 // 2 <= MAX_GATE_H or x12.numel() == 0:
        raise ValueError(f"{what}: 2H={h2} must be even with 1 <= H <= {MAX_GATE_H}, over at least one row")
    return x12.numel() // h2, h2 // 2


def fused_silu_mul_quant(x12: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x12: (..., 2H) packed SwiGLU pre-activation (x1 the first H
    channels). Returns (int8 (..., H), fp32 row scales (..., 1))."""
    if x12.device.type == "cpu":
        return fused_silu_mul_quant_plain(x12)
    rows, h = _gate_rows("fused_silu_mul_quant", x12)
    out = torch.empty(*x12.shape[:-1], h, device=x12.device, dtype=torch.int8)
    scales = torch.empty(*x12.shape[:-1], 1, device=x12.device, dtype=torch.float32)
    lib = kernels.load("fused_quant")
    err = kernels.on_device(x12, lib.ldmae_fused_silu_mul_quant, x12.data_ptr(), out.data_ptr(), scales.data_ptr(),
                            rows, h, int(x12.dtype == torch.float32))
    kernels.check(err, "fused_silu_mul_quant")
    fused_silu_mul_quant.launches += 1
    return out, scales


fused_silu_mul_quant.launches = 0


# #10 on a hidden dim split over tensor-parallel ranks (each holds [x1_r |
# x2_r]): the row's absmax, reduced with max over the ranks, then the int8
# rows from that absmax. Together they equal #10 on the whole row bit for bit.


def silu_mul_amax_plain(x12: torch.Tensor) -> torch.Tensor:
    """The absmax (..., 1) fp32 of each row of silu(x1) * x2 in fp32."""
    return _silu_mul_fp32(x12).abs().amax(dim=-1, keepdim=True)


def silu_mul_quant_scaled_plain(x12: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """silu(x1) * x2 in fp32, per-row int8 with the whole row's ``amax``."""
    return quantize_rows_fp32(_silu_mul_fp32(x12), amax)


def silu_mul_amax(x12: torch.Tensor) -> torch.Tensor:
    """x12: (..., 2H) a rank's slice [x1_r | x2_r]. Returns the absmax (...,
    1) fp32 of each row of silu(x1_r) * x2_r (``ldmae_silu_mul_amax``, the
    first pass of #10's gate kernel)."""
    if x12.device.type == "cpu":
        return silu_mul_amax_plain(x12)
    rows, h = _gate_rows("silu_mul_amax", x12)
    amax = torch.empty(*x12.shape[:-1], 1, device=x12.device, dtype=torch.float32)
    lib = kernels.load("fused_quant")
    err = kernels.on_device(x12, lib.ldmae_silu_mul_amax, x12.data_ptr(), amax.data_ptr(), rows, h,
                            int(x12.dtype == torch.float32))
    kernels.check(err, "silu_mul_amax")
    silu_mul_amax.launches += 1
    return amax


silu_mul_amax.launches = 0


def silu_mul_quant_scaled(x12: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x12: (..., 2H) a rank's slice; amax: (..., 1) fp32, the whole row's
    absmax. Returns (int8 (..., H), fp32 row scales (..., 1)) as #10 writes
    them for the whole row (``ldmae_silu_mul_quant_scaled``)."""
    if x12.device.type == "cpu":
        return silu_mul_quant_scaled_plain(x12, amax)
    rows, h = _gate_rows("silu_mul_quant_scaled", x12)
    if amax.dtype != torch.float32 or amax.numel() != rows or amax.device != x12.device:
        raise ValueError(f"silu_mul_quant_scaled: amax must be fp32 with one value a row ({rows}) on {x12.device}")
    amax = amax.contiguous()
    out = torch.empty(*x12.shape[:-1], h, device=x12.device, dtype=torch.int8)
    scales = torch.empty(*x12.shape[:-1], 1, device=x12.device, dtype=torch.float32)
    lib = kernels.load("fused_quant")
    err = kernels.on_device(x12, lib.ldmae_silu_mul_quant_scaled, x12.data_ptr(), amax.data_ptr(), out.data_ptr(),
                            scales.data_ptr(), rows, h, int(x12.dtype == torch.float32))
    kernels.check(err, "silu_mul_quant_scaled")
    silu_mul_quant_scaled.launches += 1
    return out, scales


silu_mul_quant_scaled.launches = 0
