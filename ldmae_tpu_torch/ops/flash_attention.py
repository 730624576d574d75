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
(``torch.autograd.Function``s that save only their inputs):
the backward is the backward kernel for CUDA tensors and, for CPU tensors,
its plain version, the TPU backward's math: p recomputed in fp32 and never
rounded, dv = p^T g, ds = p (g v^T - rowsum(g v^T p)), dq = ds k d^-1/2,
dk = ds^T q d^-1/2 on the rotated q, k, then for RoPE the transposed RoPE
Jacobian on dq and dk; cos and sin get no gradient. The other two
wrappers are forward only (sampling), as in the JAX package, and raise when
autograd would have to record them.

A wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel (bf16, head dim 16, 64 or 72) or raises.
``<wrapper>.launches`` counts kernel launches. The plain versions compute
in fp32, or in float64 for float64 inputs (``torch.autograd.gradcheck``).
"""

from __future__ import annotations

import torch

from .. import kernels

KERNEL_HEAD_DIMS = (16, 64, 72)  # VMAE decoder; DiT B/1 to 1p6B; DiT XL
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
    in y's dtype, in the TPU backward's op order."""
    half = y.shape[-1] // 2
    sy = y * sin.to(y.dtype)
    return y * cos.to(y.dtype) + torch.cat([sy[..., half:], -sy[..., :half]], dim=-1)


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


def _check_head_dim(what: str, b: int, h: int, d: int) -> None:
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {KERNEL_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"{what}: batch*heads {b * h} exceeds the grid limit 65535")


def _check_bhnd(what: str, **operands) -> tuple[int, int, int, int]:
    """Contiguous bf16 (B, H, N, d) operands of one shape on one device."""
    ref = next(iter(operands.values()))
    for name, t in operands.items():
        if t.device != ref.device or t.dtype != torch.bfloat16 or t.shape != ref.shape:
            raise ValueError(f"{what}: {name} must be a bf16 {tuple(ref.shape)} tensor on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if ref.dim() != 4:
        raise ValueError(f"{what}: expected (B, H, N, d), got {tuple(ref.shape)}")
    b, h, n, d = ref.shape
    _check_head_dim(what, b, h, d)
    return b, h, n, d


def _tables(cos, sin, n: int, d: int, device, what: str):
    cos = cos.to(device=device, dtype=torch.float32).contiguous()
    sin = sin.to(device=device, dtype=torch.float32).contiguous()
    if cos.shape != (n, d) or sin.shape != (n, d):
        raise ValueError(f"{what}: cos/sin must be ({n}, {d})")
    return cos, sin


def _launch(q, k, v, what: str, cos=None, sin=None, q_scale=None, k_scale=None) -> torch.Tensor:
    """Contiguous (B, H, N, d) operands: plain attention, with RoPE, or with
    the RMS qk-norm and RoPE."""
    b, h, n, d = _check_bhnd(what, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lib = kernels.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if cos is None:
            err = lib.ldmae_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, n, d, stream)
        else:
            cos, sin = _tables(cos, sin, n, d, q.device, what)
            qr, kr = torch.empty_like(q), torch.empty_like(k)  # rotated q, k (scratch)
            if q_scale is None:
                err = lib.ldmae_flash_attention_rope_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                    qr.data_ptr(), kr.data_ptr(), out.data_ptr(), b * h, n, d, stream)
            else:
                qw, kw = (t.to(device=q.device, dtype=torch.float32).contiguous()
                          for t in (q_scale, k_scale))
                if qw.shape != (d,) or kw.shape != (d,):
                    raise ValueError(f"{what}: q_scale/k_scale must be ({d},)")
                err = lib.ldmae_flash_attention_qknorm_rope_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), qw.data_ptr(), kw.data_ptr(),
                    cos.data_ptr(), sin.data_ptr(), qr.data_ptr(), kr.data_ptr(), out.data_ptr(),
                    b * h, n, d, 1e-6, stream)
    kernels.check(err, what)
    return out


def _launch_bwd(q, k, v, g, what: str, cos=None, sin=None):
    """The three backward passes on contiguous (B, H, N, d) operands; with
    cos, sin the RoPE variant. Returns (dq, dk, dv)."""
    b, h, n, d = _check_bhnd(what, q=q, k=k, v=v, g=g)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    npad = -(-n // _TILE) * _TILE
    # per query row: the softmax's log2 denominator and rowsum(g * o) (scratch)
    lse = torch.empty(b * h, npad, device=q.device, dtype=torch.float32)
    delta = torch.empty_like(lse)
    lib = kernels.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if cos is None:
            err = lib.ldmae_flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), b * h, n, d, stream)
        else:
            cos, sin = _tables(cos, sin, n, d, q.device, what)
            qr, kr = torch.empty_like(q), torch.empty_like(k)  # rotated q, k (scratch)
            err = lib.ldmae_flash_attention_rope_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), cos.data_ptr(),
                sin.data_ptr(), qr.data_ptr(), kr.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), b * h, n, d, stream)
    kernels.check(err, what)
    return dq, dk, dv


def _flash_attention_fwd(q, k, v):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    out = _launch(q, k, v, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` for the output gradient g."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, g)
    out = _launch_bwd(q, k, v, g, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return out


flash_attention_bwd.launches = 0


def flash_attention_rope_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, cos: torch.Tensor,
    sin: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_rope`` for the output gradient g;
    dq and dk are the gradients of the unrotated q and k."""
    if q.device.type == "cpu":
        return flash_attention_rope_bwd_plain(q, k, v, g, cos, sin)
    out = _launch_bwd(q, k, v, g, "flash_attention_rope_bwd", cos, sin)
    flash_attention_rope_bwd.launches += 1
    return out


flash_attention_rope_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _flash_attention_fwd(q, k, v)

    @staticmethod
    def backward(ctx, g):
        # autograd may hand in a non-contiguous gradient (a transposed view)
        return flash_attention_bwd(*ctx.saved_tensors, g.contiguous())


class _FlashAttentionRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cos, sin):
        # the inputs, not the kernel's rotated scratch: under checkpointing
        # these are what the recomputation gives back
        ctx.save_for_backward(q, k, v, cos, sin)
        return _flash_attention_rope_fwd(q, k, v, cos, sin)

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos, sin = ctx.saved_tensors
        return (*flash_attention_rope_bwd(q, k, v, g.contiguous(), cos, sin), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T d^-1/2) v for (B, H, N, d) operands, any N;
    differentiable in q, k and v. ``launches`` counts the forward kernel."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v)
    return _flash_attention_fwd(q, k, v)


flash_attention.launches = 0


def _flash_attention_rope_fwd(q, k, v, cos, sin):
    if q.device.type == "cpu":
        return flash_attention_rope_plain(q, k, v, cos, sin)
    out = _launch(q, k, v, "flash_attention_rope", cos, sin)
    flash_attention_rope.launches += 1
    return out


def flash_attention_rope(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Flash attention with half-split RoPE on q and k, applied by the
    kernel's own elementwise pre-pass in fp32. cos/sin: (N, d) HALF-SPLIT
    tables. Differentiable in q, k and v through ``flash_attention_rope_bwd``
    (the JAX package's ``flash_attention_rope_trainable``); ``launches``
    counts the forward kernel.

    The CUDA forward picks its attention kernel by head dim: d = 64 (DiT B,
    1p0B, 1p6B) runs the wgmma/TMA kernel ``flash_fwd_wgmma_kernel``; d = 72
    (DiT XL) runs the ``mma.sync`` core that the other attention kernels
    share, because a 144-byte row is no 128-byte TMA swizzle row and Q K^T
    would need d padded to 80."""
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
    pre-pass. Forward only (sampling)."""
    _forward_only("flash_attention_qknorm_rope", q, k, v, q_scale, k_scale)
    if q.device.type == "cpu":
        return flash_attention_qknorm_rope_plain(q, k, v, q_scale, k_scale, cos, sin)
    out = _launch(q, k, v, "flash_attention_qknorm_rope", cos, sin, q_scale, k_scale)
    flash_attention_qknorm_rope.launches += 1
    return out


flash_attention_qknorm_rope.launches = 0


def _row_stride(t: torch.Tensor, what: str, name: str) -> int:
    """The token stride of a (B, N, H, d) operand whose heads lie side by
    side in a row (a view of the packed qkv is one)."""
    b, n, h, d = t.shape
    if t.stride(3) != 1 or t.stride(2) != d or t.stride(0) != n * t.stride(1):
        raise ValueError(f"{what}: {name} must have (B, N, H*d) rows, got strides {t.stride()}")
    if t.stride(1) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} rows must be 16-byte aligned")
    return t.stride(1)


def flash_attention_fused_rope(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
) -> torch.Tensor:
    """q, k, v: (B, N, H, d), each row (one token, all heads) contiguous,
    possibly a strided view of the packed qkv projection; cos/sin: (N, d)
    HALF-SPLIT tables. Returns (B, N, H, d), contiguous, so its (B, N, H*d)
    view feeds the output projection. Forward only (sampling)."""
    what = "flash_attention_fused_rope"
    _forward_only(what, q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fused_rope_plain(q, k, v, cos, sin)
    if q.dim() != 4:
        raise ValueError(f"{what}: expected (B, N, H, d), got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 or t.shape != q.shape:
            raise ValueError(f"{what}: {name} must be a bf16 {tuple(q.shape)} tensor on {q.device}")
    b, n, h, d = q.shape
    _check_head_dim(what, b, h, d)
    strides = [_row_stride(t, what, name) for name, t in (("q", q), ("k", k), ("v", v))]
    cos, sin = _tables(cos, sin, n, d, q.device, what)
    out = torch.empty(b, n, h, d, device=q.device, dtype=q.dtype)
    qr, kr = torch.empty_like(out), torch.empty_like(out)  # rotated q, k (scratch)
    lib = kernels.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.ldmae_flash_attention_fused_rope_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            qr.data_ptr(), kr.data_ptr(), out.data_ptr(), b, h, n, d, *strides,
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, what)
    flash_attention_fused_rope.launches += 1
    return out


flash_attention_fused_rope.launches = 0
