"""Patchify / unpatchify between NCHW images and token sequences (port of
``ldmae_tpu/ops/patchify.py``): patches row-major over (h, w), channels
ordered (ph, pw, c) within a patch."""

from __future__ import annotations

from typing import Optional

import torch

from .linear import dense


def patchify(imgs: torch.Tensor, p: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, L, p*p*C) with L = (H/p)*(W/p)."""
    n, c, height, width = imgs.shape
    if height % p or width % p:
        raise ValueError(f"image {height}x{width} is not divisible by patch {p}")
    h, w = height // p, width // p
    x = imgs.reshape(n, c, h, p, w, p).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(n, h * w, p * p * c)


def unpatchify(x: torch.Tensor, p: int, c: int) -> torch.Tensor:
    """(N, L, p*p*C) -> (N, C, H, W), square grids only."""
    n, length, _ = x.shape
    h = w = int(round(length**0.5))
    if h * w != length:
        raise ValueError("unpatchify expects a square token grid")
    x = x.reshape(n, h, w, p, p, c).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(n, c, h * p, w * p)


def patch_embed(
    imgs: torch.Tensor,
    conv_weight: torch.Tensor,
    conv_bias: Optional[torch.Tensor],
    p: int,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """PatchEmbed as patchify + matmul. ``conv_weight`` is the reference's
    Conv2d weight (D, C, p, p); viewed as a linear over (ph, pw, c)."""
    d = conv_weight.shape[0]
    w = conv_weight.permute(0, 2, 3, 1).reshape(d, -1)
    return dense(patchify(imgs, p), w, conv_bias, compute_dtype=compute_dtype)
