"""FID (the port's copy of ``ldmae_tpu/eval/fid.py``, pytorch-fid's math).

* ``calculate_frechet_distance``: the Frechet distance between two
  Gaussians in numpy/scipy, with pytorch-fid's eps offset where the product
  of the covariances is singular.
* ``compute_statistics_of_path``: mu and sigma from an ``.npz`` (keys
  ``mu``/``sigma``) or from an image folder (the first ``sp_len`` files).
* ``calculate_fid_given_paths``: the two-path entry point.

Features come from ``models.inception.default_feature_fn`` (the port's FID
InceptionV3 on the card), or from any callable (N, H, W, 3) in [0, 1] ->
(N, D).
"""

from __future__ import annotations

import os
import pathlib
from typing import Callable, Optional, Tuple

import numpy as np
from scipy import linalg

IMAGE_EXTENSIONS = {"bmp", "jpg", "jpeg", "pgm", "png", "ppm", "tif", "tiff", "webp"}


def calculate_frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
                               eps: float = 1e-6) -> float:
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"statistics of different shapes: {mu1.shape} {sigma1.shape}, {mu2.shape} {sigma2.shape}")
    diff = mu1 - mu2
    # scipy >= 1.18 has no ``disp`` (the JAX package's call passes
    # disp=False, which only silenced the singular-matrix message)
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def calculate_activation_statistics(act: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def get_folder_files(path: str, sp_len: int = 0) -> list:
    files = sorted(f for ext in IMAGE_EXTENSIONS for f in pathlib.Path(path).glob(f"*.{ext}"))
    if sp_len:
        if len(files) < sp_len:
            raise ValueError(f"{path} has {len(files)} images < sp_len={sp_len}")
        files = files[:sp_len]
    return files


def get_activations_from_files(files: list, feature_fn: Callable[[np.ndarray], np.ndarray], batch_size: int = 64,
                               num_threads: int = 16) -> np.ndarray:
    """Stream image files through ``feature_fn`` ((N, H, W, 3) float32 in
    [0, 1] -> (N, D)); the resize to 299 happens inside the network."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def load(f):
        return np.asarray(Image.open(f).convert("RGB"), dtype=np.float32) / 255.0

    feats = []
    with ThreadPoolExecutor(num_threads) as pool:
        for s in range(0, len(files), batch_size):
            imgs = np.stack(list(pool.map(load, files[s: s + batch_size])))
            feats.append(np.asarray(feature_fn(imgs)))
    return np.concatenate(feats)


def compute_statistics_of_path(path: str, feature_fn: Callable, batch_size: int = 64,
                               sp_len: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    if path.endswith(".npz"):
        with np.load(path) as f:
            return f["mu"][:], f["sigma"][:]
    act = get_activations_from_files(get_folder_files(path, sp_len=sp_len), feature_fn, batch_size)
    return calculate_activation_statistics(act)


def calculate_fid_given_paths(paths: list, feature_fn: Optional[Callable] = None, batch_size: int = 64,
                              sp_len: int = 0, device=None) -> float:
    """FID between two paths (npz statistics or image folders); without a
    ``feature_fn``, the FID InceptionV3 on ``device`` (default the card)."""
    for p in paths:
        if not os.path.exists(p):
            raise RuntimeError(f"Invalid path: {p}")
    if feature_fn is None:
        from ..models.inception import default_feature_fn

        feature_fn = default_feature_fn(device=device)
    m1, s1 = compute_statistics_of_path(paths[0], feature_fn, batch_size, sp_len)
    m2, s2 = compute_statistics_of_path(paths[1], feature_fn, batch_size, sp_len)
    return calculate_frechet_distance(m1, s1, m2, s2)
