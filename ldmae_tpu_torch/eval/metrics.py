"""PSNR and SSIM (port of ``ldmae_tpu/eval/metrics.py``).

* PSNR on uint8-scale pixels: 20 log10(255 / sqrt(MSE)).
* SSIM as torchmetrics' StructuralSimilarityIndexMeasure computes it by
  default: an 11-tap Gaussian window at sigma 1.5, k1 = 0.01, k2 = 0.03,
  valid (unpadded) filtering, with an explicit data range; a (low, high)
  range clamps both images to it first.

The window runs as a depthwise float32 convolution with TF32 off, as the
JAX package computes it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.conv import conv2d_fp32


def psnr(original: torch.Tensor, processed: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
    mse = torch.mean((original.float() - processed.float()) ** 2)
    return 20 * torch.log10(max_val / torch.sqrt(mse))


def psnr_batch_np(a: np.ndarray, b: np.ndarray, max_val: float = 255.0) -> np.ndarray:
    """Per-image PSNR over a batch in numpy, with ``psnr``'s arithmetic (the
    MSE floored at 1e-12, so identical images read finite)."""
    d = a.astype(np.float32) - b.astype(np.float32)
    mse = (d.reshape(d.shape[0], -1) ** 2).mean(axis=1)
    return 20 * np.log10(max_val / np.sqrt(np.maximum(mse, 1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    data_range=2.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    per_image: bool = False,
) -> torch.Tensor:
    """Mean SSIM over a batch of (N, C, H, W) images, or (N,) per-image
    means with ``per_image``."""
    if isinstance(data_range, (tuple, list)):
        lo, hi = data_range
        img1, img2 = img1.clamp(lo, hi), img2.clamp(lo, hi)
        data_range = float(hi) - float(lo)
    c = img1.shape[1]
    kern = torch.from_numpy(_gaussian_kernel(kernel_size, sigma)).to(img1.device)
    w = kern.expand(c, 1, kernel_size, kernel_size)

    def filt(x):
        return conv2d_fp32(x, w, groups=c)

    x, y = img1.float(), img2.float()
    mu_x, mu_y = filt(x), filt(y)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = filt(x * x) - mu_xx
    sigma_y = filt(y * y) - mu_yy
    sigma_xy = filt(x * y) - mu_xy
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    ssim_map = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / ((mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2))
    if per_image:
        return ssim_map.mean(dim=(1, 2, 3))
    return ssim_map.mean()
