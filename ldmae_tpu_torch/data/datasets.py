"""Downstream-task datasets (port of ``ldmae_tpu/data/datasets.py``).

The probe and evaluation datasets outside the main pipeline:

  * ``CelebAMaskDataset``: face images and per-class binary part masks,
    resized NEAREST to the latent grid;
  * ``filter_tiny_imagenet``: an ImageFolder cut to the tiny-imagenet-200
    wnids, labels remapped to 0-199;
  * ``ADE20KPatchDataset``: scene images and integer segmentation maps;
  * ``InatDataset``: a json manifest reader (iNaturalist style);
  * ``RobustImageFolder``: an ImageFolder that substitutes a random other
    sample when an image does not decode;
  * ``build_transform``: the train (RandomResizedCrop and flip) and eval
    (resize, then a center crop) transforms;
  * ``HFImageFolderDataset``: a HuggingFace ``imagefolder`` adapter.

Images are (3, H, W) float32 numpy arrays in [-1, 1]. PIL and ``datasets``
are imported where an image is decoded or a dataset loaded, not with the
module.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from .augment import train_augment
from .images import IMG_EXTS, ImageFolderDataset, center_crop_arr, load_image


def _to_tensor_norm(img) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return ((arr - 0.5) / 0.5).transpose(2, 0, 1)


class CelebAMaskDataset:
    """Images and {class: bool mask} dicts on the latent grid."""

    def __init__(self, images_path: str, annot_path: str, target_classes: Sequence[str],
                 img_size: Tuple[int, int] = (256, 256), mask_size: Tuple[int, int] = (32, 32),
                 return_downsized_image: bool = False):
        self.images_path = images_path
        self.target_classes = list(target_classes)
        self.img_size = img_size
        self.mask_size = mask_size
        self.return_downsized_image = return_downsized_image
        self.image_files = sorted(f for f in os.listdir(images_path) if f.endswith(".jpg"))
        self.annot_path_dict: Dict[str, str] = {}
        for folder in os.listdir(annot_path):
            fp = os.path.join(annot_path, folder)
            if os.path.isdir(fp):
                for fn in os.listdir(fp):
                    full = os.path.join(fp, fn)
                    if os.path.isfile(full):
                        self.annot_path_dict[fn] = full

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, idx: int):
        from PIL import Image

        fn = self.image_files[idx]
        img = Image.open(os.path.join(self.images_path, fn))
        image = _to_tensor_norm(img.resize(self.img_size[::-1], Image.BILINEAR))
        base = os.path.splitext(fn)[0].zfill(5)
        masks: Dict[str, np.ndarray] = {}
        for cls in self.target_classes:
            mp = self.annot_path_dict.get(f"{base}_{cls}.png")
            if mp is not None:
                m = np.asarray(Image.open(mp).convert("L").resize(self.mask_size[::-1], Image.NEAREST)) > 0
                if m.sum() > 0:
                    masks[cls] = m
        if self.return_downsized_image:
            return image, masks, _to_tensor_norm(img.resize((32, 32), Image.BILINEAR))
        return image, masks


def filter_tiny_imagenet(dataset: ImageFolderDataset, class_list_file: str) -> ImageFolderDataset:
    """Keep the samples of the wnids listed in ``class_list_file`` (one a
    line), labelled by their line number."""
    with open(class_list_file) as f:
        selected = [line.strip() for line in f if line.strip()]
    remap = {c: i for i, c in enumerate(selected)}
    dataset.samples = [(p, remap[os.path.basename(os.path.dirname(p))]) for p, _ in dataset.samples
                       if os.path.basename(os.path.dirname(p)) in remap]
    dataset.classes = selected
    return dataset


class ADE20KPatchDataset:
    """Scene images and int32 segmentation maps on the latent grid (zeros
    where an image has no annotation)."""

    def __init__(self, images_dir: str, annotations_dir: str, img_size: int = 256, mask_size: int = 32):
        self.images = sorted(os.path.join(images_dir, f) for f in os.listdir(images_dir) if f.endswith(IMG_EXTS))
        self.annotations_dir = annotations_dir
        self.img_size = img_size
        self.mask_size = mask_size

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int):
        from PIL import Image

        ip = self.images[idx]
        image = _to_tensor_norm(Image.open(ip).resize((self.img_size, self.img_size), Image.BILINEAR))
        mp = os.path.join(self.annotations_dir, os.path.splitext(os.path.basename(ip))[0] + ".png")
        mask = np.zeros((self.mask_size, self.mask_size), np.int32)
        if os.path.exists(mp):
            mask = np.asarray(Image.open(mp).resize((self.mask_size, self.mask_size), Image.NEAREST), np.int32)
        return image, mask


class InatDataset:
    """Samples from a json manifest {'images': [{'id', 'file_name'}],
    'annotations': [{'image_id', 'category_id'}]}; labels are the sorted
    category ids' ranks. An image without an annotation raises ``KeyError``
    (a default label would silently mislabel it)."""

    def __init__(self, root: str, annotation_json: str, img_size: int = 224):
        with open(annotation_json) as f:
            manifest = json.load(f)
        self.root = root
        self.img_size = img_size
        anns = {a["image_id"]: a["category_id"] for a in manifest.get("annotations", [])}
        self.samples = []
        for im in manifest.get("images", []):
            if "id" not in im or im["id"] not in anns:
                raise KeyError(f"image {im.get('file_name', '?')!r} has no matching annotation in the manifest")
            self.samples.append((os.path.join(root, im["file_name"]), anns[im["id"]]))
        self._remap = {c: i for i, c in enumerate(sorted({label for _, label in self.samples}))}

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, label = self.samples[idx]
        return load_image(path, self.img_size), self._remap[label]


class RobustImageFolder(ImageFolderDataset):
    """An ImageFolder whose ``get`` substitutes a sample drawn from a numpy
    generator seeded with ``seed`` when an image does not decode, up to
    ``max_retries`` times in a row (``num_corrupt`` counts them)."""

    def __init__(self, root: str, image_size: int = 256, max_retries: int = 10, seed: int = 0):
        super().__init__(root, image_size)
        self.max_retries = max_retries
        self._rng = np.random.default_rng(seed)
        self.num_corrupt = 0

    def get(self, idx: int, raw_uint8: bool = False):
        for _ in range(self.max_retries):
            try:
                return super().get(idx, raw_uint8)
            except (OSError, ValueError):
                self.num_corrupt += 1
                idx = int(self._rng.integers(0, len(self.samples)))
        raise OSError(f"{self.max_retries} consecutive corrupt images")


def build_transform(is_train: bool, input_size: int = 224):
    """fn(PIL image, numpy generator) -> (3, S, S) float32 in [-1, 1].
    Train: ``train_augment`` (RandomResizedCrop at scale (0.2, 1) and a
    flip). Eval: the shorter side resized (BICUBIC) to input_size /
    crop_pct (crop_pct 224/256 up to 224, else 1), then a plain center
    crop."""
    if is_train:
        def tf(img, rng: np.random.Generator) -> np.ndarray:
            return train_augment(img, rng, input_size, scale=(0.2, 1.0))

        return tf

    def tf(img, rng=None) -> np.ndarray:
        from PIL import Image

        crop_pct = 224 / 256 if input_size <= 224 else 1.0
        size = int(input_size / crop_pct)
        w, h = img.size
        scale = size / min(w, h)
        img = img.resize((max(round(w * scale), input_size), max(round(h * scale), input_size)), Image.BICUBIC)
        arr = np.array(img)
        cy, cx = (arr.shape[0] - input_size) // 2, (arr.shape[1] - input_size) // 2
        return _to_tensor_norm(Image.fromarray(arr[cy: cy + input_size, cx: cx + input_size]))

    return tf


class HFImageFolderDataset:
    """A HuggingFace ``load_dataset("imagefolder")`` adapter with the
    ImageFolder's ``get`` (the ADM crop) and a training ``get_train``
    (``train_augment``); labels from the ``label`` column, else 0."""

    def __init__(self, data_dir: str, image_size: int = 256, split: str = "train"):
        from datasets import load_dataset

        self.ds = load_dataset("imagefolder", data_dir=data_dir, split=split)
        self.image_size = image_size
        self.classes = self.ds.features["label"].names if "label" in self.ds.features else ["all"]

    def __len__(self):
        return len(self.ds)

    def get(self, idx: int, hflip: bool = False):
        from PIL import Image

        rec = self.ds[int(idx)]
        img = center_crop_arr(rec["image"].convert("RGB"), self.image_size)
        if hflip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return _to_tensor_norm(img), int(rec.get("label", 0))

    def get_train(self, idx: int, rng: np.random.Generator, input_size: int):
        rec = self.ds[int(idx)]
        return train_augment(rec["image"].convert("RGB"), rng, input_size), int(rec.get("label", 0))
