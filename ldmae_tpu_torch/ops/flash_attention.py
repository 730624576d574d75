"""Flash attention forward: the CUDA kernels (``csrc/flash_attention.cu``) and
their plain PyTorch versions.

Counterpart of ``ldmae_tpu/ops/flash_attention.py``'s ``flash_attention``
(forward; ``_flash_fwd_kernel``), ``flash_attention_rope``
(``_flash_rope_bhnd_kernel``), ``flash_attention_qknorm_rope``
(``_flash_qknorm_rope_kernel``) and ``flash_attention_fused_rope``
(``_flash_rope_kernel``). q, k, v are (B, H, N, d), except for the fused
kernel's (B, N, H, d). The plain version is the TPU kernel's math: fp32
logits scaled by d^-1/2, exact softmax, the probabilities cast to v's
dtype, P.V accumulated in fp32. With RoPE, q and k are rotated in fp32 with
(N, d) half-split tables and cast back to their dtype first; this follows
the kernel, not ``rope.apply_rope_half``, which rotates in x's dtype. The
qk-norm kernel normalises in fp32, rounds to q's dtype, multiplies by the
fp32 weight and rotates that fp32 value, one rounding at the end.

A wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel (bf16, head dim 16, 64 or 72) or raises.
``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import kernels

KERNEL_HEAD_DIMS = (16, 64, 72)  # VMAE decoder; DiT B/1 to 1p6B; DiT XL


def _rope_fp32(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    return _rotate_fp32(x.float(), cos, sin).to(x.dtype)


def _rotate_fp32(xf: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return xf * cos.float() + rot * sin.float()


def _qknorm_rope_fp32(x, w, cos, sin, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32, rounded to x's dtype BEFORE the fp32 weight (as
    ``norms.rms_norm``), then RoPE on that fp32 value, one rounding."""
    xf = x.float()
    normed = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    y = normed.to(x.dtype).float() * w.float()
    return _rotate_fp32(y, cos, sin).to(x.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


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


def _check_head_dim(what: str, b: int, h: int, d: int) -> None:
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {KERNEL_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"{what}: batch*heads {b * h} exceeds the grid limit 65535")


def _tables(cos, sin, n: int, d: int, device, what: str):
    cos = cos.to(device=device, dtype=torch.float32).contiguous()
    sin = sin.to(device=device, dtype=torch.float32).contiguous()
    if cos.shape != (n, d) or sin.shape != (n, d):
        raise ValueError(f"{what}: cos/sin must be ({n}, {d})")
    return cos, sin


def _launch(q, k, v, what: str, cos=None, sin=None, q_scale=None, k_scale=None) -> torch.Tensor:
    """Contiguous (B, H, N, d) operands: plain attention, with RoPE, or with
    the RMS qk-norm and RoPE."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 or t.shape != q.shape:
            raise ValueError(f"{what}: {name} must be a bf16 {tuple(q.shape)} tensor on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.dim() != 4:
        raise ValueError(f"{what}: expected (B, H, N, d), got {tuple(q.shape)}")
    b, h, n, d = q.shape
    _check_head_dim(what, b, h, d)
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T d^-1/2) v for (B, H, N, d) operands, any N."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    out = _launch(q, k, v, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_rope(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Flash attention with half-split RoPE on q and k, applied by the
    kernel's own elementwise pre-pass in fp32. cos/sin: (N, d) HALF-SPLIT
    tables. Forward only (sampling)."""
    if q.device.type == "cpu":
        return flash_attention_rope_plain(q, k, v, cos, sin)
    out = _launch(q, k, v, "flash_attention_rope", cos, sin)
    flash_attention_rope.launches += 1
    return out


flash_attention_rope.launches = 0


def flash_attention_qknorm_rope(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_scale: torch.Tensor,
    k_scale: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
) -> torch.Tensor:
    """(B, H, N, d) flash attention with the per-head RMS qk-norm (weights
    q_scale, k_scale: (d,)) and half-split RoPE applied by the kernel's
    pre-pass. Forward only (sampling)."""
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
