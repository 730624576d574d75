"""Latent extraction (port of ``ldmae_tpu/cli/extract_features.py``).

Encodes the image folder ``data.origin_path`` through the tokenizer that
``vae.model_name`` names (``models.tokenizers.build_tokenizer_fns``: the
VMAE, the SD-VAE, VA-VAE or MAR-VAE; an unknown name raises), with the
weights at ``vae.weight_path`` (seeded random weights when it is empty; a
path that names no file raises), each image
and its horizontal flip in one doubled batch, and writes reference-format
safetensors shards (``latents_rank{R:02d}_shard{S:03d}.safetensors`` with
``latents`` / ``latents_flip`` / ``labels``) and ``latents_stats.pt`` into
``data.data_path`` (with a ``_sample`` suffix when ``data.sample`` is set).
With ``data.sample`` the raw 2 x latent_dim-channel moments are stored (the
posterior is sampled when the shards are read), otherwise the posterior
mode. The VMAE encodes in bf16 with the ``xla`` attention, the conv VAEs in
float32, as the JAX CLI's.

Across processes (``torchrun``, SLURM or Open MPI) rank r encodes images
r, r + world, ... and writes its own shards; ``--limit`` is a budget over
all ranks, split as the JAX CLI splits it (rank r takes n // world, plus
one while r < n % world). Rank 0 computes the statistics after a barrier
that every rank's shards pass, and every rank waits for it. A background
thread decodes the next batch and copies it to the card.

Usage:
    python -m ldmae_tpu_torch.cli.extract_features --config <yaml> [--batch 64] [--limit N] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..core.config import LDMAEConfig
from ..core.device import resolve_device
from ..data.images import ImageFolderDataset, normalize_uint8_images
from ..data.latent_dataset import ImgLatentDataset, LatentShardWriter
from ..models.tokenizers import TokenizerFns, build_tokenizer_fns
from ..ops.gaussian import diagonal_gaussian
from ..parallel import barrier, get_rank, get_world_size, init_distributed_mode
from ..utils.prefetch import Prefetcher


@torch.no_grad()
def encode_batch(tok: TokenizerFns, imgs_u8: torch.Tensor, store_moments: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) uint8 crops on the model's device -> (latents,
    latents of the flipped images). The flip comes after the crop, so
    flipping the cropped pixels equals decoding the flipped image."""
    imgs = normalize_uint8_images(imgs_u8)
    moments = tok.encode_moments(tok.model, torch.cat([imgs, imgs.flip(-1)]), compute_dtype=torch.bfloat16)
    out = moments if store_moments else diagonal_gaussian(moments, axis=1).mode()
    return out.chunk(2)


def extract(config: LDMAEConfig, batch: int = 64, out_dir=None, limit=None, device=None) -> str:
    """Write this rank's shards, and on rank 0 ``latents_stats.pt`` once
    every rank's shards are on disk; returns the output folder."""
    device = resolve_device(device)
    store_moments = config.data.sample
    out_dir = out_dir or config.data.data_path + ("_sample" if store_moments else "")
    os.makedirs(out_dir, exist_ok=True)
    tok = build_tokenizer_fns(config.vae.model_name, config.vae.weight_path, config.data.image_size, device,
                              config.train.global_seed + 1)
    dataset = ImageFolderDataset(config.data.origin_path, config.data.image_size)
    rank, world = get_rank(), get_world_size()
    n_global = len(dataset) if limit is None else min(limit, len(dataset))
    # --limit is a global budget; this rank's interleaved share of it
    n = n_global // world + (1 if rank < n_global % world else 0)
    print(f"extracting {n_global} images ({n} on rank {rank}) from {config.data.origin_path} -> {out_dir}")
    writer = LatentShardWriter(out_dir, rank=rank, shard_size=10000)

    def device_batches():
        # on the prefetch thread: decode, crop and the host-to-device copy
        # of the next batch overlap this one's encode
        for imgs, labels in dataset.iter_batches(batch, raw_uint8=True, process_index=rank, process_count=world):
            yield torch.from_numpy(imgs).to(device), labels

    t0, done = time.time(), 0
    for imgs, labels in Prefetcher(device_batches(), buffer_size=4):
        if done >= n:
            break
        take = min(len(labels), n - done)
        lat, lat_f = encode_batch(tok, imgs[:take], store_moments)
        writer.add(lat.cpu().numpy(), lat_f.cpu().numpy(), labels[:take])
        done += take
        if done % (batch * 10) < batch:
            print(f"[rank {rank}] {done}/{n} ({done / (time.time() - t0):.1f} img/s)", flush=True)
    writer.flush()
    # every rank's shards are on disk before rank 0 reads the folder
    barrier("extract_shards_flushed")
    if rank == 0:
        ds = ImgLatentDataset(out_dir, latent_norm=True, sample=store_moments)
        print(f"latent stats cached; mean[:4]={ds._latent_mean.ravel()[:4]}")
    barrier("extract_stats_done")
    return out_dir


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--out", default=None, help="override output dir")
    parser.add_argument("--limit", type=int, default=None, help="images over all ranks")
    parser.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain path")
    args = parser.parse_args(argv)
    init_distributed_mode(device=args.device)  # a no-op for one process
    config = LDMAEConfig.from_yaml(args.config)
    return extract(config, args.batch, args.out, args.limit, args.device)


if __name__ == "__main__":
    main()
