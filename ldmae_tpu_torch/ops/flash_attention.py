"""Flash attention forward: the CUDA kernel (``csrc/flash_attention.cu``) and
its plain PyTorch version.

Counterpart of ``ldmae_tpu/ops/flash_attention.py``'s ``flash_attention``
(forward; ``_flash_fwd_kernel``) and ``flash_attention_rope``
(``_flash_rope_bhnd_kernel``). q, k, v are (B, H, N, d). The plain version
is the TPU kernel's math: fp32 logits scaled by d^-1/2, exact softmax, the
probabilities cast to v's dtype, P.V accumulated in fp32. With RoPE, q and
k are rotated in fp32 with (N, d) half-split tables and cast back to their
dtype first; this follows the kernel, not ``rope.apply_rope_half``, which
rotates in x's dtype.

A wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel (bf16, head dim 16, 64 or 72, contiguous) or raises.
``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import kernels

KERNEL_HEAD_DIMS = (16, 64, 72)  # VMAE decoder; DiT B/1 to 1p6B; DiT XL


def _rope_fp32(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    half = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos.float() + rot * sin.float()).to(x.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_attention_rope_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    return flash_attention_plain(_rope_fp32(q, cos, sin), _rope_fp32(k, cos, sin), v)


def _launch(q, k, v, cos, sin, what: str) -> torch.Tensor:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 or t.shape != q.shape:
            raise ValueError(f"{what}: {name} must be a bf16 {tuple(q.shape)} tensor on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.dim() != 4:
        raise ValueError(f"{what}: expected (B, H, N, d), got {tuple(q.shape)}")
    b, h, n, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {KERNEL_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"{what}: batch*heads {b * h} exceeds the grid limit 65535")
    out = torch.empty_like(q)
    lib = kernels.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if cos is None:
            err = lib.ldmae_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, n, d, stream)
        else:
            cos = cos.to(device=q.device, dtype=torch.float32).contiguous()
            sin = sin.to(device=q.device, dtype=torch.float32).contiguous()
            if cos.shape != (n, d) or sin.shape != (n, d):
                raise ValueError(f"{what}: cos/sin must be ({n}, {d})")
            qr, kr = torch.empty_like(q), torch.empty_like(k)  # rotated q, k (scratch)
            err = lib.ldmae_flash_attention_rope_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                qr.data_ptr(), kr.data_ptr(), out.data_ptr(), b * h, n, d, stream)
    kernels.check(err, what)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T d^-1/2) v for (B, H, N, d) operands, any N."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    out = _launch(q, k, v, None, None, "flash_attention")
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
    out = _launch(q, k, v, cos, sin, "flash_attention_rope")
    flash_attention_rope.launches += 1
    return out


flash_attention_rope.launches = 0
