"""The ADM evaluator: FID, sFID, Inception Score, precision and recall (port
of ``ldmae_tpu/eval/evaluator.py``).

* Pooled features (2048) -> FID.
* sFID: the first 7 channels of the ``mixed_6/conv`` node (Mixed_6d's 1x1
  branch), flattened NHWC.
* Inception Score over the 1008-way softmax of the weights file's fc head,
  in splits of 5,000.
* Precision and recall by k-NN manifold radii (k = 3): the squared
  distances ||u||^2 + ||v||^2 - 2 u.v run in float32 on the device (TF32
  off for the products; a product in TF32 could flip a verdict near a
  radius), in blocks of 10,000 rows, and only the (rows, k) results come
  back to the host. Without a device the numpy path runs.
* npz batches (``arr_0``) are streamed member by member; computed
  activations are cached back into the npz as ``arr_1``/``arr_2`` with the
  tap they were taken at (``arr_tap``).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from .fid import calculate_frechet_distance


def _npz_has_members(path: str, names) -> bool:
    import zipfile

    with zipfile.ZipFile(path) as zf:
        have = set(zf.namelist())
    return all(f"{n}.npy" in have for n in names)


def iter_npz_batches(path: str, name: str, batch: int, limit: int = 0):
    """Row batches of an npz member, read from the zip as a stream (stored or
    deflated), never the whole array at once."""
    import zipfile

    from numpy.lib import format as npf

    with zipfile.ZipFile(path) as zf:
        with zf.open(f"{name}.npy") as f:
            version = npf.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = npf.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = npf.read_array_header_2_0(f)
            if fortran:
                raise ValueError(f"{path}:{name} is Fortran-ordered")
            n = shape[0] if not limit else min(limit, shape[0])
            row_bytes = int(np.prod(shape[1:])) * dtype.itemsize
            for s in range(0, n, batch):
                m = min(batch, n - s)
                yield np.frombuffer(f.read(m * row_bytes), dtype=dtype).reshape((m,) + shape[1:])


def _append_npz_arrays(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Append members to an existing npz without rewriting ``arr_0``."""
    import zipfile

    from numpy.lib import format as npf

    with zipfile.ZipFile(path, "a") as zf:
        for k, v in arrays.items():
            with zf.open(f"{k}.npy", "w") as f:
                npf.write_array(f, np.asarray(v))


@dataclass
class FIDStatistics:
    mu: np.ndarray
    sigma: np.ndarray

    def frechet_distance(self, other: "FIDStatistics", eps: float = 1e-6) -> float:
        return calculate_frechet_distance(self.mu, self.sigma, other.mu, other.sigma, eps)


def compute_statistics(activations: np.ndarray) -> FIDStatistics:
    return FIDStatistics(np.mean(activations, axis=0), np.cov(activations, rowvar=False))


def compute_inception_score(preds: np.ndarray, split_size: int = 5000) -> float:
    """preds: (N, classes) softmax outputs."""
    scores = []
    for i in range(0, len(preds), split_size):
        part = preds[i: i + split_size]
        kl = part * (np.log(part) - np.log(np.expand_dims(np.mean(part, 0), 0)))
        scores.append(np.exp(np.mean(np.sum(kl, 1))))
    return float(np.mean(scores))


def _pairwise_sq_distances(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    norm_u = np.square(u).sum(1)[:, None]
    norm_v = np.square(v).sum(1)[None, :]
    return np.maximum(norm_u + norm_v - 2 * (u @ v.T), 0)


@contextlib.contextmanager
def _fp32_matmul():
    """Full float32 products for the duration (the matmul TF32 switch is
    process-wide in PyTorch, so it is restored on the way out)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _sq_distances(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    nu = (u * u).sum(1)[:, None]
    nv = (v * v).sum(1)[None, :]
    return torch.clamp(nu + nv - 2.0 * (u @ v.T), min=0.0)


class ManifoldEstimator:
    """k-NN manifold estimator. ``device`` (a torch device) runs the
    distance blocks there; ``None`` runs them in numpy on the host."""

    def __init__(self, row_batch_size: int = 10000, col_batch_size: int = 10000,
                 nhood_sizes: Tuple[int, ...] = (3,), clamp_to_percentile: Optional[float] = None, device=None):
        self.row_batch_size = row_batch_size
        self.col_batch_size = col_batch_size
        self.nhood_sizes = list(nhood_sizes)
        self.num_nhoods = len(nhood_sizes)
        self.clamp_to_percentile = clamp_to_percentile
        self.device = device

    def manifold_radii(self, features: np.ndarray) -> np.ndarray:
        features = np.ascontiguousarray(features, dtype=np.float32)
        if self.device is not None:
            radii = self._manifold_radii_device(features)
        else:
            radii = self._manifold_radii_host(features)
        if self.clamp_to_percentile is not None:
            max_d = np.percentile(radii, self.clamp_to_percentile, axis=0)
            radii[radii > max_d] = 0
        return radii

    def _manifold_radii_device(self, features: np.ndarray) -> np.ndarray:
        k = max(self.nhood_sizes)
        feats = torch.from_numpy(features).to(self.device)
        out = []
        with _fp32_matmul():
            for b1 in range(0, len(feats), self.row_batch_size):
                d = _sq_distances(feats[b1: b1 + self.row_batch_size], feats)
                out.append(torch.topk(d, k + 1, dim=1, largest=False).values.cpu().numpy())
        return np.concatenate(out)[:, self.nhood_sizes].astype(np.float32)

    def _manifold_radii_host(self, features: np.ndarray) -> np.ndarray:
        n = len(features)
        radii = np.zeros([n, self.num_nhoods], dtype=np.float32)
        seq = np.arange(max(self.nhood_sizes) + 1, dtype=np.int32)
        for b1 in range(0, n, self.row_batch_size):
            e1 = min(b1 + self.row_batch_size, n)
            dist = np.zeros([e1 - b1, n], dtype=np.float32)
            for b2 in range(0, n, self.col_batch_size):
                e2 = min(b2 + self.col_batch_size, n)
                dist[:, b2:e2] = _pairwise_sq_distances(features[b1:e1], features[b2:e2])
            radii[b1:e1, :] = np.partition(dist, seq, axis=1)[:, self.nhood_sizes]
        return radii

    def evaluate_pr(self, features_1: np.ndarray, radii_1: np.ndarray, features_2: np.ndarray,
                    radii_2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """precision = the share of features_2 inside manifold(features_1);
        recall = the share of features_1 inside manifold(features_2)."""
        if self.device is not None:
            return self._evaluate_pr_device(features_1, radii_1, features_2, radii_2)
        return self._evaluate_pr_host(features_1, radii_1, features_2, radii_2)

    def _evaluate_pr_device(self, features_1, radii_1, features_2, radii_2):
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)

        f1, f2, r1, r2 = dev(features_1), dev(features_2), dev(radii_1), dev(radii_2)
        f1_in_2 = torch.zeros(len(f1), r2.shape[1], dtype=torch.bool, device=self.device)
        f2_in_1 = torch.zeros(len(f2), r1.shape[1], dtype=torch.bool, device=self.device)
        rb, cb = self.row_batch_size, self.col_batch_size
        with _fp32_matmul():
            for b1 in range(0, len(f1), rb):
                for b2 in range(0, len(f2), cb):
                    d = _sq_distances(f1[b1: b1 + rb], f2[b2: b2 + cb])
                    f1_in_2[b1: b1 + rb] |= (d[:, :, None] <= r2[b2: b2 + cb][None]).any(dim=1)
                    f2_in_1[b2: b2 + cb] |= (d.T[:, :, None] <= r1[b1: b1 + rb][None]).any(dim=1)
        return (f2_in_1.cpu().numpy().astype(np.float64).mean(axis=0),
                f1_in_2.cpu().numpy().astype(np.float64).mean(axis=0))

    def _evaluate_pr_host(self, features_1, radii_1, features_2, radii_2):
        f1_in_2 = np.zeros([len(features_1), radii_2.shape[1]], dtype=bool)
        f2_in_1 = np.zeros([len(features_2), radii_1.shape[1]], dtype=bool)
        for b1 in range(0, len(features_1), self.row_batch_size):
            e1 = min(b1 + self.row_batch_size, len(features_1))
            for b2 in range(0, len(features_2), self.col_batch_size):
                e2 = min(b2 + self.col_batch_size, len(features_2))
                d = _pairwise_sq_distances(features_1[b1:e1], features_2[b2:e2])
                f1_in_2[b1:e1] |= (d[:, :, None] <= radii_2[b2:e2][None]).any(axis=1)
                f2_in_1[b2:e2] |= (d.T[:, :, None] <= radii_1[b1:e1][None]).any(axis=1)
        return np.mean(f2_in_1.astype(np.float64), axis=0), np.mean(f1_in_2.astype(np.float64), axis=0)


class Evaluator:
    """Every generation metric from image batches, on ``device`` (default
    the card)."""

    def __init__(self, weights_path: Optional[str] = None, batch_size: int = 64,
                 spatial_tap: str = "mixed_6_conv", device=None):
        from ..models.inception import find_weights, load_inception, read_weights

        self.device = resolve_device(device)
        weights_path = find_weights(weights_path)
        self.model = load_inception(weights_path, self.device)
        # the IS head: the fc layer of the weights file, where there is one
        sd = read_weights(weights_path)
        self._fc = None
        if sd is not None and "fc.weight" in sd:
            self._fc = (sd["fc.weight"].T.astype(np.float32), sd["fc.bias"].astype(np.float32))
        self.batch_size = batch_size
        self.spatial_tap = spatial_tap
        self.manifold_estimator = ManifoldEstimator(device=self.device)

    def _fwd(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        pooled, spatial = self.model(x, return_spatial=True, spatial_tap=self.spatial_tap)
        # sFID features: the first 7 channels, flattened NHWC
        return pooled, spatial[:, :7].permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    # -- activations ---------------------------------------------------------
    def _activations_from_batches(self, batches) -> Tuple[np.ndarray, np.ndarray]:
        pooled, spatial = [], []
        for b in batches:
            x = torch.from_numpy(np.ascontiguousarray(b)).to(self.device)
            if x.dtype == torch.uint8:
                x = x.float() / 255.0
            p, sp = self._fwd(x)
            pooled.append(p.cpu().numpy())
            spatial.append(sp.cpu().numpy())
        return np.concatenate(pooled), np.concatenate(spatial)

    def compute_activations(self, images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """images: (N, H, W, 3) uint8 or float in [0, 1] -> (pooled,
        spatial), a batch slice at a time."""
        return self._activations_from_batches(
            images[s: s + self.batch_size] for s in range(0, len(images), self.batch_size))

    def read_activations(self, npz_or_dir: str, limit: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Activations of an ``arr_0`` npz or an image folder (the first
        ``limit`` images; 0 = all). An npz's cached ``arr_1``/``arr_2`` are
        used when their tap (``arr_tap``; none means ``mixed_6_conv``, as the
        ADM evaluator's caches) is this evaluator's; a whole npz without a
        cache gets one appended (where the file is writable)."""
        if npz_or_dir.endswith(".npz"):
            if _npz_has_members(npz_or_dir, ("arr_1", "arr_2")):
                with np.load(npz_or_dir) as f:
                    cached_tap = str(f["arr_tap"]) if "arr_tap" in f.files else "mixed_6_conv"
                    if cached_tap == self.spatial_tap:
                        a1, a2 = f["arr_1"][:], f["arr_2"][:]
                        return (a1[:limit], a2[:limit]) if limit else (a1, a2)
            acts = self._activations_from_batches(iter_npz_batches(npz_or_dir, "arr_0", self.batch_size, limit))
            if not limit and not _npz_has_members(npz_or_dir, ("arr_1",)):
                try:
                    _append_npz_arrays(npz_or_dir, {"arr_1": acts[0], "arr_2": acts[1],
                                                    "arr_tap": np.asarray(self.spatial_tap)})
                except OSError:
                    pass  # a read-only location: no cache
            return acts
        from PIL import Image

        from .fid import get_folder_files

        files = get_folder_files(npz_or_dir)
        if limit:
            files = files[:limit]

        def folder_batches():
            for s in range(0, len(files), self.batch_size):
                yield np.stack([np.asarray(Image.open(f).convert("RGB")) for f in files[s: s + self.batch_size]])

        return self._activations_from_batches(folder_batches())

    def read_statistics(self, npz_path: str, activations) -> Tuple[FIDStatistics, FIDStatistics]:
        """Statistics from an npz holding ``mu``/``sigma``/``mu_s``/``sigma_s``,
        else computed from the activations."""
        if npz_path and npz_path.endswith(".npz") and os.path.isfile(npz_path):
            obj = np.load(npz_path)
            if "mu" in list(obj.keys()):
                return FIDStatistics(obj["mu"], obj["sigma"]), FIDStatistics(obj["mu_s"], obj["sigma_s"])
        return tuple(compute_statistics(x) for x in activations)

    # -- metrics -------------------------------------------------------------
    def compute_inception_score(self, pooled: np.ndarray, split_size: int = 5000) -> float:
        if self._fc is None:
            raise RuntimeError("Inception Score needs the fc head from the pt_inception weights file")
        w, b = self._fc
        logits = pooled @ w + b
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return compute_inception_score(e / e.sum(axis=1, keepdims=True), split_size)

    def compute_prec_recall(self, ref_pooled: np.ndarray, sample_pooled: np.ndarray) -> Tuple[float, float]:
        radii_1 = self.manifold_estimator.manifold_radii(ref_pooled)
        radii_2 = self.manifold_estimator.manifold_radii(sample_pooled)
        pr = self.manifold_estimator.evaluate_pr(ref_pooled, radii_1, sample_pooled, radii_2)
        return float(pr[0][0]), float(pr[1][0])

    def full_report(self, ref_path: str, sample_path: str, ref_stats_npz: Optional[str] = None,
                    limit: int = 0) -> Dict[str, float]:
        """FID, sFID, IS (with the fc head), precision and recall between a
        reference batch and a sample batch; ``limit`` caps the images read
        from each (0 = all)."""
        ref_acts = self.read_activations(ref_path, limit=limit)
        sample_acts = self.read_activations(sample_path, limit=limit)
        ref_stats, ref_stats_spatial = self.read_statistics(ref_stats_npz or ref_path, ref_acts)
        sample_stats, sample_stats_spatial = self.read_statistics("", sample_acts)
        report = {"fid": sample_stats.frechet_distance(ref_stats),
                  "sfid": sample_stats_spatial.frechet_distance(ref_stats_spatial),
                  "precision": 0.0, "recall": 0.0}
        if self._fc is not None:
            report["inception_score"] = self.compute_inception_score(sample_acts[0])
        report["precision"], report["recall"] = self.compute_prec_recall(ref_acts[0], sample_acts[0])
        return report
