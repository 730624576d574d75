"""Flash attention: the CUDA kernels (``csrc/flash_attention.cu``) and their
plain PyTorch versions.

Counterpart of ``ldmae_tpu/ops/flash_attention.py``'s ``flash_attention``
(forward ``_flash_fwd_kernel`` and backward ``_flash_bwd_kernel``),
``flash_attention_rope`` (``_flash_rope_bhnd_kernel``, and the backward
``_flash_rope_bwd_kernel`` of ``flash_attention_rope_trainable``),
``flash_attention_qknorm_rope``
(``_flash_qknorm_rope_kernel``) and ``flash_attention_fused_rope``
(``_flash_rope_kernel``). q, k, v are (B, H, N, d), except for the fused
kernel's (B, N, H, d). The plain version is the TPU kernel's math: fp32
logits scaled by d^-1/2, exact softmax, the probabilities cast to v's
dtype, P.V accumulated in fp32. With RoPE, q and k are rotated in fp32 with
(N, d) half-split tables and cast back to their dtype first; this follows
the kernel, not ``rope.apply_rope_half``, which rotates in x's dtype. The
qk-norm kernel normalises in fp32, rounds to q's dtype, multiplies by the
fp32 weight and rotates that fp32 value, one rounding at the end.

``flash_attention`` and ``flash_attention_rope`` are differentiable
(``torch.autograd.Function``s that save their inputs, their output and the
softmax's lse): the backward is the backward kernel for CUDA tensors and,
for CPU tensors, its plain version, the TPU backward's math: p recomputed in
fp32 and never rounded, dv = p^T g, ds = p (g v^T - rowsum(g v^T p)),
dq = ds k d^-1/2, dk = ds^T q d^-1/2 on the rotated q, k, then for RoPE the
transposed RoPE Jacobian on dq and dk; cos and sin get no gradient. lse is
the log2 of each query row's softmax denominator, max included, in the
units of the logits times log2(e) (``flash_attention_lse_plain``): the CUDA
forward writes it at head dims 64 and 72, where the backward is one pass that
takes it and the output instead of recomputing them; on the CPU the Functions save
the plain lse, which the plain backward does not need. The other two
wrappers are forward only (sampling), as in the JAX package, and raise when
autograd would have to record them.

A wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises: bf16 or fp32 (the configs' two compute
dtypes), any head dim 1 <= d <= 128 (every arch of both registries; d > 128
raises), any N. bf16 runs ``csrc/flash_attention.cu``, fp32
``csrc/flash_attention_fp32.cu``; within bf16 the kernel is chosen by shape
(see ``flash_attention`` and ``flash_attention_rope``), and so are the fp32
forward's and backward's, in their C dispatches: at d = 64 and 72 with
16-byte aligned rows every product runs on the tensor cores as 3xTF32
(the forward ``tf32x3_fwd_kernel`` for all four wrappers, #7's and #8's
strided views included), at other head dims and for unaligned views on the
FMA pipes. In fp32 the forward always writes lse, and the backward
takes it with the output, as at d = 64 and 72 in bf16.
``<wrapper>.launches`` counts kernel launches. The plain
versions compute in fp32, or in float64 for float64 inputs
(``torch.autograd.gradcheck``).
"""

from __future__ import annotations

import math

import torch

from .. import kernels

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 128  # the largest head-dim class of the CUDA kernels
# the head dims of the bf16 wgmma kernels (DiT B to 1p6B; XL): the forward writes
# lse, the backward is one pass
WGMMA_HEAD_DIMS = (64, 72)
# the resident forward (``flash_attention_resident``): bf16, these head dims, N keys at most
RESIDENT_HEAD_DIMS, RESIDENT_MAX_N = (8, 16), 3072
_TILE = 64  # rows of a kernel tile; the backward's row statistics are padded to it


def _needs_grad(*tensors) -> bool:
    """Whether autograd must record the call: the sampling path (grad off)
    skips the autograd Function and its per-call host cost."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _acc(t: torch.Tensor) -> torch.Tensor:
    """t in its accumulation dtype: fp32, or float64 for float64 t."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _rope_fp32(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    return _rotate_fp32(_acc(x), cos, sin).to(x.dtype)


def _rotate_fp32(xf: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return xf * cos.to(xf.dtype) + rot * sin.to(xf.dtype)


def _rope_transpose(y: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The transposed half-split RoPE Jacobian, y cos + [(y sin)_2 | -(y sin)_1],
    in y's dtype, in the TPU backward's op order. (For an odd head dim the
    halves are (d - d//2) and d//2 wide, the transpose of ``_rotate_fp32``.)"""
    h1 = y.shape[-1] - y.shape[-1] // 2
    sy = y * sin.to(y.dtype)
    return y * cos.to(y.dtype) + torch.cat([sy[..., h1:], -sy[..., :h1]], dim=-1)


def _qknorm_rope_fp32(x, w, cos, sin, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32, rounded to x's dtype BEFORE the fp32 weight (as
    ``norms.rms_norm``), then RoPE on that fp32 value, one rounding."""
    xf = x.float()
    normed = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    y = normed.to(x.dtype).float() * w.float()
    return _rotate_fp32(y, cos, sin).to(x.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(_acc(q), _acc(k).transpose(-1, -2)) * q.shape[-1] ** -0.5
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(_acc(p), _acc(v)).to(q.dtype)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, H, N) log2 of each query row's softmax denominator: the natural
    logsumexp of the fp32 logits q k^T d^-1/2 over ln 2, the kernels' lse."""
    logits = torch.matmul(_acc(q), _acc(k).transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.logsumexp(logits, dim=-1) * math.log2(math.e)


def flash_attention_rope_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    return flash_attention_plain(_rope_fp32(q, cos, sin), _rope_fp32(k, cos, sin), v)


def flash_attention_qknorm_rope_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_scale: torch.Tensor,
    k_scale: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
) -> torch.Tensor:
    return flash_attention_plain(
        _qknorm_rope_fp32(q, q_scale, cos, sin), _qknorm_rope_fp32(k, k_scale, cos, sin), v)


def flash_attention_fused_rope_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
) -> torch.Tensor:
    """q, k, v: (B, N, H, d); returns (B, N, H, d)."""
    def bhnd(t):
        return t.transpose(1, 2)

    return bhnd(flash_attention_rope_plain(bhnd(q), bhnd(k), bhnd(v), cos, sin)).contiguous()


def _attention_bwd_fp32(q, k, v, g):
    """(dq, dk, dv) of softmax(q k^T d^-1/2) v for the output gradient g, all
    in the accumulation dtype; p is fp32 and never rounded."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = _acc(q), _acc(k), _acc(v), _acc(g)
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return torch.matmul(ds, kf) * scale, torch.matmul(ds.transpose(-1, -2), qf) * scale, dv


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dq, dk, dv = _attention_bwd_fp32(q, k, v, g)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_rope_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, cos: torch.Tensor,
    sin: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on q, k rotated (and rounded to their dtype) as the
    forward rotates them, then the transposed RoPE Jacobian on dq and dk."""
    dqr, dkr, dv = _attention_bwd_fp32(_rope_fp32(q, cos, sin), _rope_fp32(k, cos, sin), v, g)
    return (_rope_transpose(dqr, cos, sin).to(q.dtype), _rope_transpose(dkr, cos, sin).to(k.dtype),
            dv.to(v.dtype))


def flash_attention_resident_emulated(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The resident kernel's arithmetic in plain PyTorch (for the tests):
    pass 1 the row maxima of the fp32 logits, pass 2 p = 2^(s d^-1/2 log2 e
    - m), the fp32 row sums, p rounded to bf16, P.V in fp32 and one division
    and rounding at the end."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    m = s.amax(-1, keepdim=True) * scale_log2
    e = torch.exp2(s * scale_log2 - m)
    out = torch.matmul(e.to(torch.bfloat16).float(), v.float()) / e.sum(-1, keepdim=True)
    return out.to(q.dtype)


def _vec(d: int, *tensors, strides=()) -> int:
    """Elements (at most 16 bytes' worth) that d, every pointer and every
    given stride are multiples of: how wide the kernels may copy a row."""
    size = tensors[0].element_size()
    vec = 16 // size
    while vec > 1 and (d % vec or any(t.data_ptr() % (vec * size) for t in tensors)
                       or any(st % vec for st in strides)):
        vec //= 2
    return vec


def _lib(dtype: torch.dtype):
    return kernels.load("flash_attention" if dtype == torch.bfloat16 else "flash_attention_fp32")


def _uses_lse(dtype: torch.dtype, d: int, vec: int) -> bool:
    """Whether the CUDA backward takes the forward's output and lse (one
    pass at bf16 d = 64 or 72 with 16-byte aligned rows, and every fp32
    backward) instead of recomputing the row statistics (the bf16 three
    passes)."""
    return dtype == torch.float32 or (d in WGMMA_HEAD_DIMS and vec == 8)


def _check_head_dim(what: str, b: int, h: int, d: int) -> None:
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} is not in 1..{MAX_HEAD_DIM}")
    if b * h > 65535:
        raise ValueError(f"{what}: batch*heads {b * h} exceeds the grid limit 65535")


def _check_dtype(what: str, dtype: torch.dtype) -> None:
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what}: the CUDA kernels take bf16 or fp32, got {dtype}")


def _check_bhnd(what: str, **operands) -> tuple[int, int, int, int]:
    """Contiguous bf16 or fp32 (B, H, N, d) operands of one shape and dtype
    on one device."""
    ref = next(iter(operands.values()))
    _check_dtype(what, ref.dtype)
    for name, t in operands.items():
        if t.device != ref.device or t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError(f"{what}: {name} must be a {ref.dtype} {tuple(ref.shape)} tensor on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if ref.dim() != 4:
        raise ValueError(f"{what}: expected (B, H, N, d), got {tuple(ref.shape)}")
    b, h, n, d = ref.shape
    _check_head_dim(what, b, h, d)
    return b, h, n, d


def _check_views(what: str, q, k, v) -> tuple[int, int, int, int]:
    """bf16 or fp32 (B, H, N, d) operands of one shape, dtype and device in
    one layout: the same strides, each row (d elements) contiguous."""
    _check_dtype(what, q.dtype)
    if q.dim() != 4:
        raise ValueError(f"{what}: expected (B, H, N, d), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{what}: {name} must be a {q.dtype} {tuple(q.shape)} tensor on {q.device}")
    if q.stride(3) != 1 or k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError(f"{what}: q, k, v must share one layout with contiguous rows, got strides "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")
    b, h, n, d = q.shape
    _check_head_dim(what, b, h, d)
    return b, h, n, d


def _tables(cos, sin, n: int, d: int, device, what: str):
    cos = cos.to(device=device, dtype=torch.float32).contiguous()
    sin = sin.to(device=device, dtype=torch.float32).contiguous()
    if cos.shape != (n, d) or sin.shape != (n, d):
        raise ValueError(f"{what}: cos/sin must be ({n}, {d})")
    return cos, sin


def _launch(q, k, v, what: str, cos=None, sin=None, with_lse=False):
    """Contiguous (B, H, N, d) operands: plain attention, or with RoPE.
    Returns the output or, with ``with_lse``, (output, lse): lse (B, H, N)
    fp32 where the backward takes it (``_uses_lse``), else None."""
    b, h, n, d = _check_bhnd(what, q=q, k=k, v=v)
    out = torch.empty_like(q)
    vec = _vec(d, q, k, v, out)
    lse = None
    if with_lse and _uses_lse(q.dtype, d, vec):
        lse = torch.empty(b, h, n, device=q.device, dtype=torch.float32)
    lse_ptr = None if lse is None else lse.data_ptr()
    lib = _lib(q.dtype)
    if cos is None:
        err = kernels.on_device(q, lib.ldmae_flash_attention_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), lse_ptr, b * h, n, d, vec)
    else:
        cos, sin = _tables(cos, sin, n, d, q.device, what)
        qr, kr = torch.empty_like(q), torch.empty_like(k)  # rotated q, k (scratch)
        err = kernels.on_device(
            q, lib.ldmae_flash_attention_rope_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), qr.data_ptr(), kr.data_ptr(), out.data_ptr(), lse_ptr, b * h, n, d, vec)
    kernels.check(err, what)
    return (out, lse) if with_lse else out


def _launch_bwd(q, k, v, g, what: str, cos=None, sin=None, out=None, lse=None):
    """The backward on contiguous (B, H, N, d) operands; with cos, sin the
    RoPE variant. Where it takes the forward's output and lse
    (``_uses_lse``) and either is missing, it first runs the forward kernel
    (through the library, so ``<wrapper>.launches`` does not count it).
    Returns (dq, dk, dv)."""
    b, h, n, d = _check_bhnd(what, q=q, k=k, v=v, g=g)
    npad = -(-n // _TILE) * _TILE
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    vec = _vec(d, q, k, v, g, dq, dk, dv)
    dq_acc = None
    if not _uses_lse(q.dtype, d, vec):  # the three passes recompute the row statistics
        out = lse = None
    else:
        if out is None or lse is None:
            out, lse = _launch(q, k, v, what, cos, sin, with_lse=True)
        _check_bhnd(what, q=q, out=out)
        if (lse.device, lse.dtype, lse.shape) != (q.device, torch.float32, (b, h, n)) or not lse.is_contiguous():
            raise ValueError(f"{what}: lse must be a contiguous fp32 {(b, h, n)} tensor on {q.device}")
        if q.dtype == torch.bfloat16:  # dq summed in fp32 over the key tiles, then the order's counters (scratch)
            dq_acc = torch.empty(b * h * npad * d + b * h * npad // _TILE, device=q.device, dtype=torch.float32)
    # per query row: the softmax's log2 denominator and rowsum(g * o), padded (scratch)
    lse_pad = torch.empty(b * h, npad, device=q.device, dtype=torch.float32)
    delta = torch.empty_like(lse_pad)
    ptrs = [None if t is None else t.data_ptr() for t in (out, lse)]
    scratch = [lse_pad.data_ptr(), delta.data_ptr(), None if dq_acc is None else dq_acc.data_ptr()]
    grads = [dq.data_ptr(), dk.data_ptr(), dv.data_ptr()]
    lib = _lib(q.dtype)
    if cos is None:
        err = kernels.on_device(q, lib.ldmae_flash_attention_bwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                g.data_ptr(), *ptrs, *grads, *scratch, b * h, n, d, vec)
    else:
        cos, sin = _tables(cos, sin, n, d, q.device, what)
        qr, kr = torch.empty_like(q), torch.empty_like(k)  # rotated q, k (scratch)
        err = kernels.on_device(
            q, lib.ldmae_flash_attention_rope_bwd, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), *ptrs,
            cos.data_ptr(), sin.data_ptr(), qr.data_ptr(), kr.data_ptr(), *grads, *scratch, b * h, n, d, vec)
    kernels.check(err, what)
    return dq, dk, dv


def _resident_fits(q, k, v) -> bool:
    """Whether the resident kernel takes these contiguous (B, H, N, d) operands."""
    n, d = q.shape[-2:]
    return (q.dtype == torch.bfloat16 and d in RESIDENT_HEAD_DIMS and n <= RESIDENT_MAX_N
            and _vec(d, q, k, v) == 8)


def flash_attention_resident(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The forward of ``flash_attention`` by the resident kernel
    (``flash_fwd_resident_kernel``: K and V of a head in shared memory, an
    exact two-pass softmax): bf16, d = 8 or 16, N <= RESIDENT_MAX_N, 16-byte
    aligned, forward only. ``flash_attention`` calls it for those shapes
    when no gradient is recorded; ``launches`` counts its launches."""
    _forward_only("flash_attention_resident", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    b, h, n, d = _check_bhnd("flash_attention_resident", q=q, k=k, v=v)
    if not _resident_fits(q, k, v):
        raise ValueError("flash_attention_resident: takes 16-byte aligned bf16 operands at d = 8 or 16, "
                         f"N <= {RESIDENT_MAX_N}; got {q.dtype} {tuple(q.shape)}")
    out = torch.empty_like(q)
    lib = kernels.load("flash_attention")
    err = kernels.on_device(q, lib.ldmae_flash_attention_resident_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), b * h, n, d)
    kernels.check(err, "flash_attention_resident")
    flash_attention_resident.launches += 1
    return out


flash_attention_resident.launches = 0


def _flash_attention_fwd(q, k, v, with_lse=False):
    """The counted forward; with ``with_lse``, (output, lse) (see the module note)."""
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v)
        return (out, flash_attention_lse_plain(q, k)) if with_lse else out
    if not with_lse and _resident_fits(q, k, v):
        return flash_attention_resident(q, k, v)
    res = _launch(q, k, v, "flash_attention", with_lse=with_lse)
    flash_attention.launches += 1
    return res


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    out: torch.Tensor | None = None, lse: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` for the output gradient g. out and
    lse, the forward's output and lse, are what the CUDA kernel takes in
    bf16 at head dims 64 and 72 (one pass) and in fp32; when either is
    missing (a standalone call) the forward kernel is first run through the
    library, uncounted. The bf16 three passes at the other head dims and the plain
    version (CPU) need neither."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, g)
    res = _launch_bwd(q, k, v, g, "flash_attention_bwd", out=out, lse=lse)
    flash_attention_bwd.launches += 1
    return res


flash_attention_bwd.launches = 0


def flash_attention_rope_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, cos: torch.Tensor,
    sin: torch.Tensor, out: torch.Tensor | None = None, lse: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_rope`` for the output gradient g;
    dq and dk are the gradients of the unrotated q and k. out and lse as for
    ``flash_attention_bwd``."""
    if q.device.type == "cpu":
        return flash_attention_rope_bwd_plain(q, k, v, g, cos, sin)
    res = _launch_bwd(q, k, v, g, "flash_attention_rope_bwd", cos, sin, out, lse)
    flash_attention_rope_bwd.launches += 1
    return res


flash_attention_rope_bwd.launches = 0


# Both Functions save their inputs (not the kernel's rotated scratch), the
# output and lse: under checkpointing these are what the recomputation
# gives back.
class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _flash_attention_fwd(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand in a non-contiguous gradient (a transposed view)
        return flash_attention_bwd(q, k, v, g.contiguous(), out, lse)


class _FlashAttentionRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cos, sin):
        out, lse = _flash_attention_rope_fwd(q, k, v, cos, sin, with_lse=True)
        ctx.save_for_backward(q, k, v, cos, sin, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        return (*flash_attention_rope_bwd(q, k, v, g.contiguous(), cos, sin, out, lse), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T d^-1/2) v for (B, H, N, d) operands, any N, d <= 128;
    differentiable in q, k and v. The CUDA kernel is chosen by shape:

    * bf16, d = 8 or 16 (VMAE), N <= RESIDENT_MAX_N, 16-byte aligned, no
      gradient recorded: ``flash_attention_resident`` (which counts it);
    * bf16, d = 64 or 72, 16-byte aligned: the wgmma forward
      ``flash_fwd_wgmma_kernel`` (see ``flash_attention_rope``) and the
      single-pass backward ``flash_bwd_wgmma_kernel``;
    * every other bf16 shape (VMAE d = 8 to 80 under autograd or past
      RESIDENT_MAX_N): the ``mma.sync`` core and the three-pass backward;
    * fp32: the fp32 kernels (``csrc/flash_attention_fp32.cu``): at d = 64
      and 72 with 16-byte aligned rows on the tensor cores as 3xTF32, the
      forward ``tf32x3_fwd_kernel`` and the backward's dK/dV and dQ kernels
      (``tf32x3_bwd_dkdv_kernel``, ``tf32x3_bwd_dq_kernel``); the SIMT
      ones (``flash32_fwd_kernel`` and the like) at other d.

    ``launches`` counts the forward launches but the resident kernel's
    (``flash_attention_resident.launches``)."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v)
    return _flash_attention_fwd(q, k, v)


flash_attention.launches = 0


def _flash_attention_rope_fwd(q, k, v, cos, sin, with_lse=False):
    if q.device.type == "cpu":
        qr, kr = _rope_fp32(q, cos, sin), _rope_fp32(k, cos, sin)
        out = flash_attention_plain(qr, kr, v)
        return (out, flash_attention_lse_plain(qr, kr)) if with_lse else out
    res = _launch(q, k, v, "flash_attention_rope", cos, sin, with_lse=with_lse)
    flash_attention_rope.launches += 1
    return res


def flash_attention_rope(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Flash attention with half-split RoPE on q and k, applied by the
    kernel's own elementwise pre-pass in fp32. cos/sin: (N, d) HALF-SPLIT
    tables. Differentiable in q, k and v through ``flash_attention_rope_bwd``
    (the JAX package's ``flash_attention_rope_trainable``); ``launches``
    counts the forward kernel.

    The CUDA forward picks its attention kernel by shape: bf16 at d = 64
    (DiT B, 1p0B, 1p6B) or 72 (DiT XL: its rows are loaded as a 128-byte and
    a 32-byte swizzled part) with 16-byte aligned rows runs the wgmma/TMA
    kernel ``flash_fwd_wgmma_kernel`` (which also writes lse for the
    backward), and the backward is the single-pass ``flash_bwd_wgmma_kernel``;
    every other bf16 head dim d <= 128 runs the ``mma.sync`` core that the
    other attention kernels share, and the three-pass backward; fp32 runs
    the fp32 kernels, on the tensor cores at d = 64 and 72 as
    ``flash_attention``'s."""
    if _needs_grad(q, k, v):
        return _FlashAttentionRope.apply(q, k, v, cos, sin)
    return _flash_attention_rope_fwd(q, k, v, cos, sin)


flash_attention_rope.launches = 0


def _forward_only(what: str, *tensors) -> None:
    """Raise when autograd would record a kernel that has no backward: the
    kernel's output would carry no gradient and training would silently
    leave the attention weights untouched."""
    if _needs_grad(*tensors):
        raise RuntimeError(
            f"{what} is forward only (sampling); train with attention impl "
            "'flash_rope' or 'flash', or call it under torch.no_grad()")


def flash_attention_qknorm_rope(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_scale: torch.Tensor,
    k_scale: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
) -> torch.Tensor:
    """(B, H, N, d) flash attention with the per-head RMS qk-norm (weights
    q_scale, k_scale: (d,)) and half-split RoPE applied by the kernel's
    pre-pass. Forward only (sampling). q, k, v may be views in one layout
    (the same strides, rows contiguous), as the attention module's
    permuted views of the packed qkv are: the pre-pass reads q and k and the
    attention reads v in place. Returns a contiguous (B, H, N, d) tensor.
    The attention after the pre-pass is chosen by shape as in
    ``flash_attention_rope`` (at d = 64 or 72 with 16-byte aligned rows
    and strides: in bf16 the wgmma kernel, in fp32 ``tf32x3_fwd_kernel``)."""
    what = "flash_attention_qknorm_rope"
    _forward_only(what, q, k, v, q_scale, k_scale)
    if q.device.type == "cpu":
        return flash_attention_qknorm_rope_plain(q, k, v, q_scale, k_scale, cos, sin)
    b, h, n, d = _check_views(what, q, k, v)
    cos, sin = _tables(cos, sin, n, d, q.device, what)
    qw, kw = (t.to(device=q.device, dtype=torch.float32).contiguous() for t in (q_scale, k_scale))
    if qw.shape != (d,) or kw.shape != (d,):
        raise ValueError(f"{what}: q_scale/k_scale must be ({d},)")
    out = torch.empty(b, h, n, d, device=q.device, dtype=q.dtype)
    qr, kr = torch.empty_like(out), torch.empty_like(out)  # normed, rotated q, k (scratch)
    strides = q.stride()[:3]
    err = kernels.on_device(
        q, _lib(q.dtype).ldmae_flash_attention_qknorm_rope_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        qw.data_ptr(), kw.data_ptr(), cos.data_ptr(), sin.data_ptr(), qr.data_ptr(), kr.data_ptr(), out.data_ptr(),
        b, h, n, d, *strides, _vec(d, q, k, v, out, strides=strides), 1e-6)
    kernels.check(err, what)
    flash_attention_qknorm_rope.launches += 1
    return out


flash_attention_qknorm_rope.launches = 0


def _row_stride(t: torch.Tensor, what: str, name: str) -> int:
    """The token stride of a (B, N, H, d) operand whose heads lie side by
    side in a row (a view of the packed qkv is one)."""
    b, n, h, d = t.shape
    if t.stride(3) != 1 or t.stride(2) != d or t.stride(0) != n * t.stride(1):
        raise ValueError(f"{what}: {name} must have (B, N, H*d) rows, got strides {t.stride()}")
    return t.stride(1)


def flash_attention_fused_rope(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
) -> torch.Tensor:
    """q, k, v: (B, N, H, d), each row (one token, all heads) contiguous,
    possibly a strided view of the packed qkv projection; cos/sin: (N, d)
    HALF-SPLIT tables. Returns (B, N, H, d), contiguous, so its (B, N, H*d)
    view feeds the output projection. Forward only (sampling).

    The CUDA kernel's pre-pass rotates q and k into (B, N, H*d) scratch;
    the attention reads that and v in place and writes the output rows
    directly, nothing transposed: in bf16 at d = 64 or 72 with 16-byte
    aligned rows and strides the wgmma kernel ``flash_fwd_wgmma_kernel`` (4D tensor
    maps over the strided operands), else the ``mma.sync`` core; fp32 the
    fp32 kernels (at d = 64 or 72 with 16-byte aligned rows and strides
    ``tf32x3_fwd_kernel``, on the tensor cores as 3xTF32)."""
    what = "flash_attention_fused_rope"
    _forward_only(what, q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fused_rope_plain(q, k, v, cos, sin)
    if q.dim() != 4:
        raise ValueError(f"{what}: expected (B, N, H, d), got {tuple(q.shape)}")
    _check_dtype(what, q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{what}: {name} must be a {q.dtype} {tuple(q.shape)} tensor on {q.device}")
    b, n, h, d = q.shape
    _check_head_dim(what, b, h, d)
    strides = [_row_stride(t, what, name) for name, t in (("q", q), ("k", k), ("v", v))]
    cos, sin = _tables(cos, sin, n, d, q.device, what)
    out = torch.empty(b, n, h, d, device=q.device, dtype=q.dtype)
    qr, kr = torch.empty_like(out), torch.empty_like(out)  # rotated q, k (scratch)
    vec = _vec(d, q, k, v, out, strides=strides)
    err = kernels.on_device(
        q, _lib(q.dtype).ldmae_flash_attention_fused_rope_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), qr.data_ptr(), kr.data_ptr(), out.data_ptr(), b, h, n, d, *strides, vec)
    kernels.check(err, what)
    flash_attention_fused_rope.launches += 1
    return out


flash_attention_fused_rope.launches = 0
