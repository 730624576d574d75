"""LPIPS perceptual distance on VGG16 (port of ``ldmae_tpu/models/lpips.py``).

The taming-style LPIPS: the ScalingLayer's fixed shift and scale, VGG16's
feature maps at relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, each
normalised to unit length over its channels, the squared difference
weighted by a learned 1x1 projection without bias, averaged over space and
summed over the five. Everything runs in float32, the convolutions with
TF32 off (in their backward too). ``lpips`` is the evaluation metric (no
gradient); ``make_lpips_fn`` is the VMAE trainers' loss, differentiable in
the images, with the LPIPS weights frozen.

``LPIPS``'s state dict has taming's key layout (``net.slice{1-5}.{i}`` at
torchvision's ``vgg16.features`` indices, ``lin{k}.model.1.weight``).
``load_lpips_params`` reads torchvision's ``vgg16`` features state dict and
taming's ``vgg.pth`` from local files; without them it gives seeded random
weights (the same draws as the JAX package's) and warns: the distance is
then a smoke-test metric, not comparable to published numbers.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.conv import conv2d_fp32

# (torchvision vgg16.features index, in channels, out channels) of each
# 3x3 convolution, by slice
VGG_SLICES = [
    [(0, 3, 64), (2, 64, 64)],
    [(5, 64, 128), (7, 128, 128)],
    [(10, 128, 256), (12, 256, 256), (14, 256, 256)],
    [(17, 256, 512), (19, 512, 512), (21, 512, 512)],
    [(24, 512, 512), (26, 512, 512), (28, 512, 512)],
]
CHNS = [64, 128, 256, 512, 512]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class _VGG16Slices(nn.Module):
    def __init__(self, device):
        super().__init__()
        for si, convs in enumerate(VGG_SLICES):
            sl = nn.Module()
            for idx, cin, cout in convs:
                sl.add_module(str(idx), nn.Conv2d(cin, cout, 3, padding=1, device=device))
            self.add_module(f"slice{si + 1}", sl)

    def forward(self, x: torch.Tensor) -> list:
        """x after the ScalingLayer -> the five relu feature maps."""
        feats = []
        for si in range(len(VGG_SLICES)):
            if si > 0:
                x = F.max_pool2d(x, 2)
            for conv in getattr(self, f"slice{si + 1}").children():
                x = torch.relu(conv2d_fp32(x, conv.weight, conv.bias, padding=1))
            feats.append(x)
        return feats


class LPIPS(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        device = resolve_device(device)
        self.net = _VGG16Slices(device)
        for k, c in enumerate(CHNS):
            lin = nn.Module()
            lin.model = nn.Module()
            lin.model.add_module("1", nn.Conv2d(c, 1, 1, bias=False, device=device))
            self.add_module(f"lin{k}", lin)
        self.register_buffer("shift", torch.from_numpy(_SHIFT).reshape(1, 3, 1, 1).to(device), persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).reshape(1, 3, 1, 1).to(device), persistent=False)

    @torch.no_grad()
    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) images in [-1, 1] -> (N, 1, 1, 1) distances."""
        return self.distance(img0, img1)

    def distance(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """``forward`` with autograd on: differentiable in both images (and
        in the weights, unless they are frozen, as ``make_lpips_fn`` does)."""
        f0 = self.net((img0.float() - self.shift) / self.scale)
        f1 = self.net((img1.float() - self.shift) / self.scale)
        val = 0.0
        for k in range(len(CHNS)):
            d = (_normalize_tensor(f0[k]) - _normalize_tensor(f1[k])) ** 2
            w = getattr(getattr(self, f"lin{k}").model, "1").weight
            proj = (d * w.reshape(1, -1, 1, 1)).sum(dim=1, keepdim=True)
            val = val + proj.mean(dim=(2, 3), keepdim=True)
        return val


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x**2).sum(dim=1, keepdim=True)) + eps)


def lpips(model: LPIPS, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) images in [-1, 1] -> (N, 1, 1, 1) LPIPS distances."""
    return model(img0, img1)


def make_lpips_fn(model: LPIPS):
    """The VMAE trainers' perceptual loss: (imgs, recon) -> (N,) float32
    distances with a gradient for both images; the LPIPS weights are frozen
    (``requires_grad`` off), as the JAX package holds them constant."""
    model.requires_grad_(False)

    def fn(imgs: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
        return model.distance(imgs, recon).reshape(-1)

    return fn


def import_lpips_weights(vgg_sd: Optional[Dict[str, np.ndarray]] = None,
                         lin_sd: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, torch.Tensor]:
    """``LPIPS`` state dict from torchvision's vgg16 state dict
    (``features.N.weight``/``bias``) and taming's ``vgg.pth``
    (``lin{k}.model.1.weight``); what is missing is drawn from numpy's
    generator at seed 0 in the JAX package's order."""
    rng = np.random.default_rng(0)
    sd = {}
    for si, convs in enumerate(VGG_SLICES):
        for idx, cin, cout in convs:
            if vgg_sd is not None:
                w = np.asarray(vgg_sd[f"features.{idx}.weight"], np.float32)
                b = np.asarray(vgg_sd[f"features.{idx}.bias"], np.float32)
            else:
                w = (rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(2.0 / (cin * 9))).astype(np.float32)
                b = np.zeros(cout, np.float32)
            sd[f"net.slice{si + 1}.{idx}.weight"] = torch.from_numpy(w)
            sd[f"net.slice{si + 1}.{idx}.bias"] = torch.from_numpy(b)
    for k, c in enumerate(CHNS):
        if lin_sd is not None:
            w = np.asarray(lin_sd[f"lin{k}.model.1.weight"], np.float32)
        else:
            w = np.abs(rng.standard_normal((1, c, 1, 1))).astype(np.float32) / c
        sd[f"lin{k}.model.1.weight"] = torch.from_numpy(w)
    return sd


DEFAULT_VGG_PATHS = ["pretrain_weight/vgg16_features.pth", "pretrain_weight/vgg16-397923af.pth"]
DEFAULT_LIN_PATHS = ["pretrain_weight/vgg.pth", "pretrain_weight/vgg_lpips.pth"]


def load_lpips_params(vgg_path: Optional[str] = None, lin_path: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The ``LPIPS`` state dict from the given files or the default paths
    under ``pretrain_weight/``; seeded random weights, with a warning, where
    the VGG16 file is missing."""
    def find(path, candidates):
        for c in ([path] if path else []) + candidates:
            if os.path.exists(c):
                return c
        return None

    def read(path):
        # a trusted weights file the user points at (torchvision and taming
        # pickles), as the JAX package reads it
        sd = torch.load(path, map_location="cpu", weights_only=False)
        return {k: v.numpy() for k, v in sd.items()}

    vgg_path, lin_path = find(vgg_path, DEFAULT_VGG_PATHS), find(lin_path, DEFAULT_LIN_PATHS)
    vgg_sd = read(vgg_path) if vgg_path else None
    lin_sd = read(lin_path) if lin_path else None
    if vgg_sd is None:
        warnings.warn(
            "VGG16 weights not found — LPIPS uses random features (smoke "
            "tests only). Place vgg16-397923af.pth + vgg.pth under "
            "pretrain_weight/."
        )
    return import_lpips_weights(vgg_sd, lin_sd)


def load_lpips(device=None, vgg_path: Optional[str] = None, lin_path: Optional[str] = None) -> LPIPS:
    model = LPIPS(device)
    model.load_state_dict(load_lpips_params(vgg_path, lin_path), strict=True)
    return model
