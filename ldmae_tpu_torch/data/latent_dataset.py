"""Latent shard dataset (port of ``ldmae_tpu/data/latent_dataset.py``).

The reference's extraction format: shards named
``latents_rank{R:02d}_shard{S:03d}.safetensors`` with keys ``latents`` /
``latents_flip`` (N, C, h, w) and ``labels`` (N,), and a
``latents_stats.pt`` holding channelwise mean/std (1, C, 1, 1).

The port reads and writes the safetensors layout itself
(``read_safetensors``, ``write_safetensors``): an 8-byte little-endian
header length, a JSON header naming each tensor's dtype, shape and byte
range, then the raw little-endian buffers (read memory-mapped with numpy).
Item access, the flip choice, moment sampling, the latent statistics and
the seeded batch order are the JAX package's, drawn from the same numpy
generators, so both give the same batches. ``LatentShardWriter`` writes the
extraction's shards; ``latents_stats.pt`` is written atomically.
"""

from __future__ import annotations

import json
import os
import struct
from glob import glob
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32,
    "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def write_safetensors(path: str, tensors: Dict[str, np.ndarray], metadata: Optional[Dict[str, str]] = None) -> None:
    """Write numpy arrays as a safetensors file (the header padded with
    spaces to a multiple of 8 bytes, the buffers back to back in the given
    order), through a temporary file renamed into place."""
    arrays = {k: np.ascontiguousarray(v) for k, v in tensors.items()}
    header: Dict[str, object] = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for name, a in arrays.items():
        header[name] = {"dtype": _NAMES[a.dtype], "shape": list(a.shape), "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for a in arrays.values():
            f.write(a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes())
    os.replace(tmp, path)


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: read-only numpy view} of a safetensors file, memory-mapped."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    buf = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which is not read here")
        begin, end = info["data_offsets"]
        dt = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        out[name] = buf[begin:end].view(dt).reshape(info["shape"])
    return out


class ImgLatentDataset:
    """Reader with the reference ImgLatentDataset's semantics."""

    def __init__(
        self,
        data_dir: str,
        latent_norm: bool = True,
        latent_multiplier: float = 1.0,
        sample: bool = False,
        seed: int = 0,
    ):
        self.data_dir = data_dir
        self.latent_norm = latent_norm
        self.latent_multiplier = latent_multiplier
        self.sample = sample
        self._rng = np.random.default_rng(seed)
        self.files = sorted(glob(os.path.join(data_dir, "*.safetensors")))
        if not self.files:
            raise FileNotFoundError(f"no .safetensors shards in {data_dir}")
        self._shards = [read_safetensors(f) for f in self.files]
        self._cum = np.cumsum([0] + [len(s["labels"]) for s in self._shards])
        if latent_norm:
            self._latent_mean, self._latent_std = self.get_latent_stats()
        else:
            self._latent_mean = self._latent_std = None

    def __len__(self) -> int:
        return int(self._cum[-1])

    # -- stats -------------------------------------------------------------
    def get_latent_stats(self) -> Tuple[np.ndarray, np.ndarray]:
        cache = os.path.join(self.data_dir, "latents_stats.pt")
        if os.path.exists(cache) or os.path.exists(cache + ".npz"):
            stats = _load_stats(cache)
        else:
            stats = self.compute_latent_stats()
            _save_stats(cache, stats)
        return stats["mean"], stats["std"]

    def compute_latent_stats(self, num_samples: int = 10000) -> Dict[str, np.ndarray]:
        """Channelwise mean/std over <= 10k random latents; moment latents are
        sampled first when ``sample`` is set."""
        n = min(num_samples, len(self))
        idx = self._rng.choice(len(self), n, replace=False)
        latents = np.stack([self._raw(i, "latents") for i in idx])
        if self.sample:
            latents = _sample_moments_np(latents, self._rng)
        mean = latents.mean(axis=(0, 2, 3), keepdims=True)[0][None]
        std = latents.std(axis=(0, 2, 3), ddof=1, keepdims=True)[0][None]
        return {"mean": mean.astype(np.float32), "std": std.astype(np.float32)}

    # -- access --------------------------------------------------------------
    def _raw(self, idx: int, key: str) -> np.ndarray:
        fi = int(np.searchsorted(self._cum, idx, side="right") - 1)
        return np.asarray(self._shards[fi][key][int(idx) - int(self._cum[fi])])

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        key = "latents" if self._rng.uniform() > 0.5 else "latents_flip"
        feature = self._raw(idx, key).astype(np.float32)
        label = self._raw(idx, "labels")
        if self.sample:
            feature = _sample_moments_np(feature[None], self._rng)[0]
        if self.latent_norm:
            feature = (feature - self._latent_mean[0]) / self._latent_std[0]
        return feature * self.latent_multiplier, label

    # -- batches ---------------------------------------------------------------
    def iter_batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        epochs: Optional[int] = None,
        process_index: int = 0,
        process_count: int = 1,
        start_epoch: int = 0,
        skip_batches: int = 0,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """{"x": (B, C, h, w) fp32, "y": (B,) int64} batches. Each epoch
        shuffles with ``seed + epoch``, so ``start_epoch``/``skip_batches``
        resume the stream at an exact position (skipped batches read
        nothing); a process reads every ``process_count``-th index."""
        n = len(self)
        epoch = start_epoch
        while epochs is None or epoch < start_epoch + epochs:
            order = np.arange(n)
            if shuffle:
                np.random.default_rng(seed + epoch).shuffle(order)
            order = order[process_index::process_count]
            stop = len(order) - (len(order) % batch_size if drop_last else 0)
            for s in range(0, stop, batch_size):
                if epoch == start_epoch and s < skip_batches * batch_size:
                    continue
                feats, labels = zip(*(self[i] for i in order[s : s + batch_size]))
                yield {"x": np.stack(feats), "y": np.asarray(labels).reshape(-1).astype(np.int64)}
            epoch += 1


def _sample_moments_np(moments: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """DiagonalGaussian(moments).sample() in numpy (mean and logvar halves of
    the channels)."""
    c = moments.shape[1] // 2
    mean, logvar = moments[:, :c], np.clip(moments[:, c:], -30.0, 20.0)
    return (mean + np.exp(0.5 * logvar) * rng.standard_normal(mean.shape)).astype(np.float32)


def _save_stats(path: str, stats: Dict[str, np.ndarray]) -> None:
    """``latents_stats.pt`` ({name: tensor} through ``torch.save``), written to
    a temporary file and renamed, so a reader never sees part of it."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in stats.items()}, tmp)
    os.replace(tmp, path)


def _load_stats(path: str) -> Dict[str, np.ndarray]:
    """``latents_stats.pt``, or the ``.npz`` the JAX package writes where it
    has no torch."""
    if os.path.exists(path):
        raw = torch.load(path, map_location="cpu", weights_only=True)
        return {k: np.asarray(v.numpy()) for k, v in raw.items()}
    raw = np.load(path + ".npz")
    return {k: raw[k] for k in raw.files}


class LatentShardWriter:
    """The extraction's shard writer (one process, rank 0): buffers
    ``shard_size`` encodings, then writes
    ``latents_rank00_shard{S:03d}.safetensors`` with ``latents``,
    ``latents_flip``, ``labels`` (int64) and the metadata ``total_size`` and
    ``dtype``."""

    def __init__(self, out_dir: str, shard_size: int = 10000):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.shard_size = shard_size
        self.shard_idx = 0
        self._lat: List[np.ndarray] = []
        self._flip: List[np.ndarray] = []
        self._lab: List[np.ndarray] = []
        self._count = 0

    def add(self, latents: np.ndarray, latents_flip: np.ndarray, labels: np.ndarray) -> None:
        self._lat.append(np.asarray(latents))
        self._flip.append(np.asarray(latents_flip))
        self._lab.append(np.asarray(labels))
        self._count += len(labels)
        if self._count >= self.shard_size:
            self.flush()

    def flush(self) -> None:
        if not self._lab:
            return
        lat = np.concatenate(self._lat)
        lab = np.concatenate(self._lab).astype(np.int64)
        name = f"latents_rank00_shard{self.shard_idx:03d}.safetensors"
        write_safetensors(
            os.path.join(self.out_dir, name),
            {"latents": lat, "latents_flip": np.concatenate(self._flip), "labels": lab},
            metadata={"total_size": str(len(lab)), "dtype": str(lat.dtype)},
        )
        self.shard_idx += 1
        self._lat, self._flip, self._lab, self._count = [], [], [], 0
