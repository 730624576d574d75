"""Seeded random weights for runs without a checkpoint."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .lightningdit import RMSNorm


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int, std: float = 0.02) -> nn.Module:
    """Fill every parameter, in ``named_parameters`` order, with numpy
    normal(0, std) draws from ``seed``; norm weights get 1 + that draw.

    Unlike the reference initialisation, nothing is zero: that one zeroes
    the DiT's adaLN and final linear, so the DiT returns exactly 0 and no
    kernel's output would reach the images."""
    rng = np.random.default_rng(seed)
    norm_weights = {
        f"{name}.weight" if name else "weight"
        for name, m in module.named_modules()
        if isinstance(m, (RMSNorm, nn.LayerNorm))
    }
    for name, p in module.named_parameters():
        v = rng.standard_normal(p.shape, dtype=np.float32) * np.float32(std)
        if name in norm_weights:
            v += np.float32(1.0)
        p.copy_(torch.from_numpy(v))
    return module
