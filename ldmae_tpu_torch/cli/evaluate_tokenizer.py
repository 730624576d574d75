"""Tokenizer reconstruction evaluation and latent-noise robustness (port of
``ldmae_tpu/cli/evaluate_tokenizer.py``).

Encodes the images of ``--data_path`` through the tokenizer that
``vae.model_name`` names (``models.tokenizers.build_tokenizer_fns``; an
unknown name or a ``vae.weight_path`` that names no file raises), takes the
posterior mode, optionally adds eps * N(0, 1) * the latent std (the std of
``--latent_stats``' ``latents_stats.pt``, else of the batch), decodes, and
writes the reference and reconstruction PNGs under ``--output_path``
(``reference/`` and ``{model}_{eps}/``); reports rFID between the two
folders, PSNR (per image, from the uint8 pixels), LPIPS and SSIM (means of
the batch means). The VMAE encodes and decodes in bf16 with the ``xla``
attention, the conv VAEs in float32, as the JAX CLI's.

Single process: the JAX CLI's rank interleave and metric all-reduce are
not ported yet, and the PNGs are written with PIL (ROADMAP.md, item 15).

Usage:
    python -m ldmae_tpu_torch.cli.evaluate_tokenizer --config <yaml> --data_path <images> \\
        [--output_path ./rfid] [--epsilon 0.0 0.1] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.config import LDMAEConfig
from ..core.device import resolve_device
from ..data.images import ImageFolderDataset, normalize_uint8_images
from ..data.latent_dataset import _load_stats
from ..eval.fid import calculate_fid_given_paths
from ..eval.metrics import psnr_batch_np, ssim
from ..models.lpips import LPIPS, load_lpips
from ..models.tokenizers import TokenizerFns, build_tokenizer_fns
from ..ops.gaussian import diagonal_gaussian


@torch.no_grad()
def roundtrip(tok: TokenizerFns, lpips_model: LPIPS, imgs_u8: torch.Tensor, epsilon: float = 0.0,
              latent_std=None, generator=None):
    """(B, H, W, 3) uint8 on the model's device -> (reconstructions as
    (B, H, W, 3) uint8, per-image LPIPS, per-image SSIM)."""
    imgs = normalize_uint8_images(imgs_u8)
    moments = tok.encode_moments(tok.model, imgs, compute_dtype=torch.bfloat16)
    latents = diagonal_gaussian(moments, axis=1).mode()
    if epsilon > 0:
        std = latent_std if latent_std is not None else latents.std(dim=(0, 2, 3), keepdim=True, correction=0)
        noise = torch.randn(latents.shape, generator=generator, device=latents.device)
        latents = latents + epsilon * noise * std
    decoded = tok.decode(tok.model, latents, compute_dtype=torch.bfloat16)
    lp = lpips_model(decoded, imgs).reshape(-1)
    ss = ssim(decoded, imgs, data_range=(-1.0, 1.0), per_image=True)
    u8 = torch.clamp(127.5 * decoded + 128.0, 0, 255).permute(0, 2, 3, 1).to(torch.uint8)
    return u8, lp, ss


def _write_pngs(arrs: np.ndarray, paths) -> None:
    from PIL import Image

    for a, p in zip(arrs, paths):
        Image.fromarray(a).save(p, compress_level=1)


def _prune_stale(d: str, keep: int) -> None:
    """Remove PNGs that would enter the folder rFID: this run's names beyond
    its image count (a larger earlier run), other ranks' names and the old
    names without a rank."""
    removed = 0
    for f in os.listdir(d):
        if not f.endswith(".png"):
            continue
        stem = f[:-4]
        if "_rank_" in stem:
            try:
                r, i = int(stem.split("_rank_")[1].split("_")[0]), int(stem.rsplit("_", 1)[-1])
            except (ValueError, IndexError):
                continue
            stale = r != 0 or i >= keep
        else:
            stale = stem.rsplit("_", 1)[-1].isdigit()
        if stale:
            os.remove(os.path.join(d, f))
            removed += 1
    if removed:
        print(f"pruned {removed} stale files in {d}")


def evaluate_tokenizer(config: LDMAEConfig, data_path: str, output_path: str, epsilon: float = 0.0, seed: int = 42,
                       batch: int = 32, limit=None, latent_stats=None, device=None) -> dict:
    device = resolve_device(device)
    ref_path = os.path.join(output_path, "reference")
    save_dir = os.path.join(output_path, f"{config.vae.model_name}_{epsilon}")
    os.makedirs(ref_path, exist_ok=True)
    os.makedirs(save_dir, exist_ok=True)
    tok = build_tokenizer_fns(config.vae.model_name, config.vae.weight_path, config.data.image_size, device,
                              config.train.global_seed + 1)
    lpips_model = load_lpips(device)
    latent_std = None
    if latent_stats and os.path.exists(latent_stats):
        latent_std = torch.from_numpy(_load_stats(latent_stats)["std"]).float().to(device)

    ds = ImageFolderDataset(data_path, config.data.image_size)
    n_total = len(ds) if limit is None else min(limit, len(ds))
    print(f"evaluating tokenizer on {n_total} images (epsilon={epsilon})")
    _prune_stale(ref_path, n_total)
    _prune_stale(save_dir, n_total)
    # the reference images do not depend on epsilon: a sweep writes them once
    write_ref = len([f for f in os.listdir(ref_path) if "_rank_0_" in f]) < n_total

    gen = torch.Generator(device=device).manual_seed(seed)
    lpips_vals, ssim_vals, psnr_vals = [], [], []
    futures, idx = [], 0
    t0, steady = time.time(), None
    with ThreadPoolExecutor(2) as pool:
        for ref_u8, _ in ds.iter_batches(batch, raw_uint8=True):
            if idx >= n_total:
                break
            if idx > 0 and steady is None:
                steady = (time.time(), idx)
            take = min(len(ref_u8), n_total - idx)
            ref_u8 = ref_u8[:take]
            u8, lp, ss = roundtrip(tok, lpips_model, torch.from_numpy(ref_u8).to(device), epsilon, latent_std, gen)
            u8 = u8.cpu().numpy()
            lpips_vals.append(float(lp.mean()))
            ssim_vals.append(float(ss.mean()))
            psnr_vals.extend(psnr_batch_np(ref_u8, u8).tolist())
            if write_ref:
                futures.append(pool.submit(_write_pngs, ref_u8, [
                    os.path.join(ref_path, f"ref_image_rank_0_{idx + i}.png") for i in range(take)]))
            futures.append(pool.submit(_write_pngs, u8, [
                os.path.join(save_dir, f"decoded_image_rank_0_{idx + i}.png") for i in range(take)]))
            idx += take
            if idx % (batch * 10) < batch:
                print(f"{idx}/{n_total} ({idx / (time.time() - t0):.1f} img/s)", flush=True)
    for f in futures:
        f.result()  # a failed PNG write raises here
    rate = idx / max(time.time() - t0, 1e-9)
    if steady is not None and idx > steady[1]:
        rate = (idx - steady[1]) / max(time.time() - steady[0], 1e-9)
    print(f"roundtrip done: {idx} images, {rate:.1f} img/s steady "
          f"(incl. the first batch: {idx / max(time.time() - t0, 1e-9):.1f})")
    report = {
        "rfid": calculate_fid_given_paths([ref_path, save_dir], device=device),
        "psnr": float(np.mean(psnr_vals)),
        "lpips": float(np.mean(lpips_vals)),
        "ssim": float(np.mean(ssim_vals)),
        "epsilon": epsilon,
    }
    print("Final Metrics:")
    for k, v in report.items():
        print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}")
    return report


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--output_path", default="./rfid")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--latent_stats", default=None, help="latents_stats.pt for the exact reference std")
    parser.add_argument("--epsilon", type=float, nargs="+", default=[0.0],
                        help="latent-noise robustness sweep (0 .01 .05 .1 .2 .3 in the reference's script)")
    parser.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain path")
    args = parser.parse_args(argv)
    config = LDMAEConfig.from_yaml(args.config)
    return [evaluate_tokenizer(config, args.data_path, args.output_path, epsilon=eps, seed=args.seed,
                               batch=args.batch, limit=args.limit, latent_stats=args.latent_stats,
                               device=args.device)
            for eps in args.epsilon]


if __name__ == "__main__":
    main()
