"""Training-time image augmentation for VMAE pretraining (the port's copy of
``ldmae_tpu/data/augment.py``; with the same ``np.random.Generator`` it gives
the same bytes).

The reference's train transforms (RandomResizedCrop with scale 0.75-1.0 and
bicubic resampling, RandomHorizontalFlip, Normalize(0.5, 0.5)) in numpy and
PIL, with the loop-free single-draw crop parameters of the reference's
``util/crop.py`` (clipped; no torchvision retry loop). PIL is imported where
an image is transformed, not with the module.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def random_resized_crop_params(
    rng: np.random.Generator,
    width: int,
    height: int,
    scale: Tuple[float, float] = (0.75, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
) -> Tuple[int, int, int, int]:
    """Single-draw crop parameters: returns (i, j, h, w)."""
    area = height * width
    target_area = area * rng.uniform(scale[0], scale[1])
    aspect_ratio = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
    w = int(round(math.sqrt(target_area * aspect_ratio)))
    h = int(round(math.sqrt(target_area / aspect_ratio)))
    w = min(w, width)
    h = min(h, height)
    i = int(rng.integers(0, height - h + 1))
    j = int(rng.integers(0, width - w + 1))
    return i, j, h, w


def train_augment(
    img,
    rng: np.random.Generator,
    input_size: int,
    scale: Tuple[float, float] = (0.75, 1.0),
    hflip_prob: float = 0.5,
    raw_uint8: bool = False,
) -> np.ndarray:
    """A PIL image -> (3, input_size, input_size) float32 in [-1, 1]; with
    ``raw_uint8``, the (input_size, input_size, 3) uint8 pixels, normalised
    later on the device by ``data.images.normalize_uint8_images`` (the same
    float32 arithmetic)."""
    from PIL import Image

    width, height = img.size
    i, j, h, w = random_resized_crop_params(rng, width, height, scale)
    img = img.crop((j, i, j + w, i + h)).resize((input_size, input_size), resample=Image.BICUBIC)
    if rng.uniform() < hflip_prob:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if raw_uint8:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    arr = (arr - 0.5) / 0.5
    return arr.transpose(2, 0, 1)
