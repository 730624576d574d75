"""Image-folder pipeline of the extraction and evaluation paths (port of
``ldmae_tpu/data/images.py``).

* The ADM center crop: halving BOX resizes while the short side is at
  least twice the target, one BICUBIC resize, then the central crop.
* Normalisation to [-1, 1]: x / 255, then (x - 0.5) / 0.5, in float32.
* Class labels from the sorted subdirectory names (torchvision's
  ImageFolder convention); a flat folder is one class.

PIL is imported where an image is decoded, not with the module.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np
import torch

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".JPEG", ".JPG", ".PNG")


def center_crop_arr(pil_image, image_size: int):
    """ADM center crop of a PIL image to image_size x image_size."""
    from PIL import Image

    while min(*pil_image.size) >= 2 * image_size:
        pil_image = pil_image.resize(tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
    scale = image_size / min(*pil_image.size)
    pil_image = pil_image.resize(tuple(round(x * scale) for x in pil_image.size), resample=Image.BICUBIC)
    arr = np.array(pil_image)
    crop_y = (arr.shape[0] - image_size) // 2
    crop_x = (arr.shape[1] - image_size) // 2
    return Image.fromarray(arr[crop_y: crop_y + image_size, crop_x: crop_x + image_size])


def load_image(path: str, image_size: int, raw_uint8: bool = False) -> np.ndarray:
    """-> (3, H, W) float32 in [-1, 1] (crop, normalisation), or with
    ``raw_uint8`` the cropped (H, W, 3) uint8 pixels, normalised later on the
    device by ``normalize_uint8_images``."""
    from PIL import Image

    img = center_crop_arr(Image.open(path).convert("RGB"), image_size)
    if raw_uint8:
        return np.asarray(img, dtype=np.uint8)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return ((arr - 0.5) / 0.5).transpose(2, 0, 1)


def normalize_uint8_images(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) float32 in [-1, 1], with
    ``load_image``'s float32 arithmetic."""
    x = imgs.float() / 255.0
    return ((x - 0.5) / 0.5).permute(0, 3, 1, 2)


class ImageFolderDataset:
    """ImageFolder listing: labels index the sorted class directories; a
    folder without subdirectories gives every image label 0."""

    def __init__(self, root: str, image_size: int = 256):
        self.root = root
        self.image_size = image_size
        self.samples: List[Tuple[str, int]] = []
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.classes = classes or ["all"]
        dirs = [os.path.join(root, c) for c in classes] if classes else [root]
        for ci, cdir in enumerate(dirs):
            self.samples += [(os.path.join(cdir, f), ci) for f in sorted(os.listdir(cdir)) if f.endswith(IMG_EXTS)]

    def __len__(self) -> int:
        return len(self.samples)

    def get(self, idx: int, raw_uint8: bool = False) -> Tuple[np.ndarray, int]:
        path, label = self.samples[idx]
        return load_image(path, self.image_size, raw_uint8), label

    def iter_batches(self, batch_size: int, raw_uint8: bool = False, process_index: int = 0,
                     process_count: int = 1, drop_last: bool = False) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(images, labels) in folder order over this process's images, the
        JAX rule's interleave ``range(process_index, len, process_count)``
        (a sequential DistributedSampler); the last batch may be short unless
        ``drop_last``. Images decode on a thread pool (PIL releases the
        interpreter lock while it decodes)."""
        from concurrent.futures import ThreadPoolExecutor

        idxs = range(process_index, len(self.samples), process_count)
        with ThreadPoolExecutor(16) as pool:
            for s in range(0, len(idxs), batch_size):
                chunk = idxs[s:s + batch_size]
                if drop_last and len(chunk) < batch_size:
                    break
                results = list(pool.map(lambda i: self.get(i, raw_uint8), chunk))
                yield np.stack([r[0] for r in results]), np.asarray([r[1] for r in results], np.int64)
