"""Latent shard dataset (port of ``ldmae_tpu/data/latent_dataset.py``).

The reference's extraction format: shards named
``latents_rank{R:02d}_shard{S:03d}.safetensors`` with keys ``latents`` /
``latents_flip`` (N, C, h, w) and ``labels`` (N,), and a
``latents_stats.pt`` holding channelwise mean/std (1, C, 1, 1).

The port reads the safetensors layout itself (``read_safetensors``): an
8-byte little-endian header length, a JSON header naming each tensor's
dtype, shape and byte range, then the raw little-endian buffers, memory-
mapped with numpy. Item access, the flip choice, moment sampling, the
latent statistics and the seeded batch order are the JAX package's, drawn
from the same numpy generators, so both give the same batches.
"""

from __future__ import annotations

import json
import os
import struct
from glob import glob
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32,
    "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


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
        if os.path.exists(cache):
            raw = torch.load(cache, map_location="cpu", weights_only=True)
            stats = {k: np.asarray(v.numpy()) for k, v in raw.items()}
        elif os.path.exists(cache + ".npz"):
            raw = np.load(cache + ".npz")
            stats = {k: raw[k] for k in raw.files}
        else:
            stats = self.compute_latent_stats()
            tmp = f"{cache}.tmp{os.getpid()}"
            torch.save({k: torch.from_numpy(v) for k, v in stats.items()}, tmp)
            os.replace(tmp, cache)
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
