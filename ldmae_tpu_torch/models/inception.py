"""InceptionV3, the FID variant (port of ``ldmae_tpu/models/inception.py``).

pytorch-fid's network: torchvision's inception_v3 (1008 classes, no
auxiliary head) with the FID patches, average pooling without the padding
in the count inside the A, C and E blocks, and a max-pool branch in the
last E block. Each convolution's BatchNorm is folded into a per-channel
scale and shift at import (eps 1e-3); the network is inference only and
runs in float32 with TF32 off.

The input is (N, H, W, 3) in [0, 1]: a bilinear resize to 299 x 299
without antialiasing (``F.interpolate(align_corners=False)``, what
``jax.image.resize`` computes), then 2x - 1.

Weights: the pt_inception-2015-12-05 state dict (torchvision names) through
``import_inception_torch_state_dict``. Without that file the network has
seeded random weights (the JAX package's draws; FID values are then not
comparable to published ones).
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.conv import conv2d_fp32

# (name, (out, in, kh, kw), stride, padding); None marks the stem's max-pools
STEM = [
    ("Conv2d_1a_3x3", (32, 3, 3, 3), 2, (0, 0)),
    ("Conv2d_2a_3x3", (32, 32, 3, 3), 1, (0, 0)),
    ("Conv2d_2b_3x3", (64, 32, 3, 3), 1, (1, 1)),
    ("maxpool1", None, None, None),
    ("Conv2d_3b_1x1", (80, 64, 1, 1), 1, (0, 0)),
    ("Conv2d_4a_3x3", (192, 80, 3, 3), 1, (0, 0)),
    ("maxpool2", None, None, None),
]


def _a_convs(in_c, pool_features):
    return {"branch1x1": (64, in_c, 1, 1), "branch5x5_1": (48, in_c, 1, 1), "branch5x5_2": (64, 48, 5, 5),
            "branch3x3dbl_1": (64, in_c, 1, 1), "branch3x3dbl_2": (96, 64, 3, 3), "branch3x3dbl_3": (96, 96, 3, 3),
            "branch_pool": (pool_features, in_c, 1, 1)}


def _c_convs(c7):
    return {"branch1x1": (192, 768, 1, 1), "branch7x7_1": (c7, 768, 1, 1), "branch7x7_2": (c7, c7, 1, 7),
            "branch7x7_3": (192, c7, 7, 1), "branch7x7dbl_1": (c7, 768, 1, 1), "branch7x7dbl_2": (c7, c7, 7, 1),
            "branch7x7dbl_3": (c7, c7, 1, 7), "branch7x7dbl_4": (c7, c7, 7, 1), "branch7x7dbl_5": (192, c7, 1, 7),
            "branch_pool": (192, 768, 1, 1)}


def _e_convs(in_c):
    return {"branch1x1": (320, in_c, 1, 1), "branch3x3_1": (384, in_c, 1, 1), "branch3x3_2a": (384, 384, 1, 3),
            "branch3x3_2b": (384, 384, 3, 1), "branch3x3dbl_1": (448, in_c, 1, 1),
            "branch3x3dbl_2": (384, 448, 3, 3), "branch3x3dbl_3a": (384, 384, 1, 3),
            "branch3x3dbl_3b": (384, 384, 3, 1), "branch_pool": (192, in_c, 1, 1)}


# the Mixed blocks in order: (name, kind, {branch: (out, in, kh, kw)}), in
# torchvision's order of the branches (the order of the random draws)
MIXED = [
    ("Mixed_5b", "a", _a_convs(192, 32)),
    ("Mixed_5c", "a", _a_convs(256, 64)),
    ("Mixed_5d", "a", _a_convs(288, 64)),
    ("Mixed_6a", "b", {"branch3x3": (384, 288, 3, 3), "branch3x3dbl_1": (64, 288, 1, 1),
                       "branch3x3dbl_2": (96, 64, 3, 3), "branch3x3dbl_3": (96, 96, 3, 3)}),
    ("Mixed_6b", "c", _c_convs(128)),
    ("Mixed_6c", "c", _c_convs(160)),
    ("Mixed_6d", "c", _c_convs(160)),
    ("Mixed_6e", "c", _c_convs(192)),
    ("Mixed_7a", "d", {"branch3x3_1": (192, 768, 1, 1), "branch3x3_2": (320, 192, 3, 3),
                       "branch7x7x3_1": (192, 768, 1, 1), "branch7x7x3_2": (192, 192, 1, 7),
                       "branch7x7x3_3": (192, 192, 7, 1), "branch7x7x3_4": (192, 192, 3, 3)}),
    ("Mixed_7b", "e_avg", _e_convs(1280)),
    ("Mixed_7c", "e_max", _e_convs(2048)),
]


class BasicConv(nn.Module):
    """Convolution without bias, the folded BatchNorm's scale and shift,
    ReLU."""

    def __init__(self, shape, device):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(shape, device=device))
        self.scale = nn.Parameter(torch.ones(shape[0], device=device))
        self.shift = nn.Parameter(torch.zeros(shape[0], device=device))

    def forward(self, x, stride=1, padding=(0, 0)):
        out = conv2d_fp32(x, self.weight, stride=stride, padding=padding)
        return torch.relu(out * self.scale.reshape(1, -1, 1, 1) + self.shift.reshape(1, -1, 1, 1))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


def _inception_a(x, p):
    b1 = p.branch1x1(x)
    b5 = p.branch5x5_2(p.branch5x5_1(x), padding=2)
    b3 = p.branch3x3dbl_3(p.branch3x3dbl_2(p.branch3x3dbl_1(x), padding=1), padding=1)
    return torch.cat([b1, b5, b3, p.branch_pool(_avg_pool(x))], dim=1)


def _inception_b(x, p):
    b3 = p.branch3x3(x, stride=2)
    bd = p.branch3x3dbl_3(p.branch3x3dbl_2(p.branch3x3dbl_1(x), padding=1), stride=2)
    return torch.cat([b3, bd, _max_pool(x)], dim=1)


def _inception_c(x, p):
    b1 = p.branch1x1(x)
    b7 = p.branch7x7_3(p.branch7x7_2(p.branch7x7_1(x), padding=(0, 3)), padding=(3, 0))
    bd = p.branch7x7dbl_1(x)
    bd = p.branch7x7dbl_3(p.branch7x7dbl_2(bd, padding=(3, 0)), padding=(0, 3))
    bd = p.branch7x7dbl_5(p.branch7x7dbl_4(bd, padding=(3, 0)), padding=(0, 3))
    return torch.cat([b1, b7, bd, p.branch_pool(_avg_pool(x))], dim=1)


def _inception_d(x, p):
    b3 = p.branch3x3_2(p.branch3x3_1(x), stride=2)
    b7 = p.branch7x7x3_3(p.branch7x7x3_2(p.branch7x7x3_1(x), padding=(0, 3)), padding=(3, 0))
    b7 = p.branch7x7x3_4(b7, stride=2)
    return torch.cat([b3, b7, _max_pool(x)], dim=1)


def _inception_e(x, p, pool: str):
    b1 = p.branch1x1(x)
    b3 = p.branch3x3_1(x)
    b3 = torch.cat([p.branch3x3_2a(b3, padding=(0, 1)), p.branch3x3_2b(b3, padding=(1, 0))], dim=1)
    bd = p.branch3x3dbl_2(p.branch3x3dbl_1(x), padding=1)
    bd = torch.cat([p.branch3x3dbl_3a(bd, padding=(0, 1)), p.branch3x3dbl_3b(bd, padding=(1, 0))], dim=1)
    if pool == "max":  # FIDInceptionE_2
        bp = F.max_pool2d(x, 3, stride=1, padding=1)
    else:  # FIDInceptionE_1
        bp = _avg_pool(x)
    return torch.cat([b1, b3, bd, p.branch_pool(bp)], dim=1)


_BLOCKS = {"a": _inception_a, "b": _inception_b, "c": _inception_c, "d": _inception_d,
           "e_avg": lambda x, p: _inception_e(x, p, "avg"), "e_max": lambda x, p: _inception_e(x, p, "max")}


class InceptionV3(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        device = resolve_device(device)
        for name, shape, _, _ in STEM:
            if shape is not None:
                self.add_module(name, BasicConv(shape, device))
        for name, _, convs in MIXED:
            block = nn.Module()
            for branch, shape in convs.items():
                block.add_module(branch, BasicConv(shape, device))
            self.add_module(name, block)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, resize_input: bool = True, normalize_input: bool = True,
                return_spatial: bool = False, spatial_tap: str = "mixed_6_conv"):
        """(N, H, W, 3) float in [0, 1] -> (N, 2048) pooled features, and
        with ``return_spatial`` the sFID features at ``spatial_tap``: by
        default the ADM evaluator's ``mixed_6/conv`` node, Mixed_6d's
        post-relu 1x1 branch, which is the first 192 channels of the block's
        output (N, 192, 17, 17); any ``Mixed_*`` name taps that block's
        output."""
        x = x.float().permute(0, 3, 1, 2)
        if resize_input:
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False, antialias=False)
        if normalize_input:
            x = 2 * x - 1
        for name, shape, stride, padding in STEM:
            x = _max_pool(x) if shape is None else getattr(self, name)(x, stride, padding)
        spatial = None
        for name, kind, _ in MIXED:
            x = _BLOCKS[kind](x, getattr(self, name))
            if name == spatial_tap:
                spatial = x
            elif name == "Mixed_6d" and spatial_tap == "mixed_6_conv":
                spatial = x[:, :192]
        if return_spatial and spatial is None:
            raise ValueError(f"unknown spatial_tap {spatial_tap!r}")
        pooled = x.mean(dim=(2, 3))
        return (pooled, spatial) if return_spatial else pooled


def _fold_bn(sd: Dict[str, np.ndarray], prefix: str, eps: float = 1e-3) -> Dict[str, torch.Tensor]:
    """conv + BatchNorm (eval) -> {weight, scale, shift}."""
    w = np.asarray(sd[f"{prefix}.conv.weight"], np.float32)
    gamma = np.asarray(sd[f"{prefix}.bn.weight"], np.float32)
    beta = np.asarray(sd[f"{prefix}.bn.bias"], np.float32)
    mean = np.asarray(sd[f"{prefix}.bn.running_mean"], np.float32)
    var = np.asarray(sd[f"{prefix}.bn.running_var"], np.float32)
    inv = gamma / np.sqrt(var + eps)
    return {f"{prefix}.weight": torch.from_numpy(w), f"{prefix}.scale": torch.from_numpy(inv),
            f"{prefix}.shift": torch.from_numpy(beta - mean * inv)}


def _conv_prefixes():
    yield from (name for name, shape, _, _ in STEM if shape is not None)
    for name, _, convs in MIXED:
        yield from (f"{name}.{branch}" for branch in convs)


def import_inception_torch_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """pt_inception-2015-12-05 state dict (torchvision names) -> the
    ``InceptionV3`` state dict, BatchNorms folded."""
    out = {}
    for prefix in _conv_prefixes():
        out |= _fold_bn(sd, prefix)
    return out


def random_inception_torch_state_dict() -> Dict[str, np.ndarray]:
    """A state dict of the pt_inception layout with numpy draws at seed 0
    (normal x 0.05 weights, identity BatchNorms), in the JAX package's
    order, so both packages get the same random network."""
    rng = np.random.default_rng(0)
    sd = {}
    shapes = [shape for _, shape, _, _ in STEM if shape is not None]
    shapes += [shape for _, _, convs in MIXED for shape in convs.values()]
    for prefix, shape in zip(_conv_prefixes(), shapes):
        sd[f"{prefix}.conv.weight"] = rng.standard_normal(shape).astype(np.float32) * 0.05
        sd[f"{prefix}.bn.weight"] = np.ones(shape[0], np.float32)
        sd[f"{prefix}.bn.bias"] = np.zeros(shape[0], np.float32)
        sd[f"{prefix}.bn.running_mean"] = np.zeros(shape[0], np.float32)
        sd[f"{prefix}.bn.running_var"] = np.ones(shape[0], np.float32)
    return sd


DEFAULT_WEIGHTS_PATHS = ["pretrain_weight/pt_inception-2015-12-05-6726825d.pth"]


def find_weights(weights_path: Optional[str] = None) -> Optional[str]:
    """The given path, else the first default path that exists, else None."""
    if weights_path is None:
        weights_path = next((p for p in DEFAULT_WEIGHTS_PATHS if os.path.exists(p)), None)
    return weights_path


def read_weights(weights_path: Optional[str]) -> Optional[Dict[str, np.ndarray]]:
    """The weights file's state dict as numpy arrays, None where there is no
    file (a trusted file the user points at, read as the JAX package reads
    it)."""
    if not (weights_path and os.path.exists(weights_path)):
        return None
    sd = torch.load(weights_path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.numpy() for k, v in sd.items()}


def load_inception(weights_path: Optional[str] = None, device=None) -> InceptionV3:
    """The FID InceptionV3 from ``weights_path``, or with seeded random
    weights where there is no such file."""
    sd = read_weights(weights_path)
    model = InceptionV3(device)
    model.load_state_dict(import_inception_torch_state_dict(sd or random_inception_torch_state_dict()),
                          strict=True)
    return model


def default_feature_fn(weights_path: Optional[str] = None, device=None) -> Callable[[np.ndarray], np.ndarray]:
    """(N, H, W, 3) float in [0, 1] (numpy) -> (N, 2048) pooled features
    (numpy), on ``device`` (default the card)."""
    weights_path = find_weights(weights_path)
    model = load_inception(weights_path, device)
    if weights_path is None:
        warnings.warn(
            "FID Inception weights not found — using random weights; FID "
            "values will NOT be comparable to the reference. Place "
            "pt_inception-2015-12-05-6726825d.pth under pretrain_weight/."
        )
    dev = next(model.parameters()).device
    return lambda x: model(torch.as_tensor(np.asarray(x, np.float32), device=dev)).cpu().numpy()
