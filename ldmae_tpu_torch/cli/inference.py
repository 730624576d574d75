"""Sampling CLI (reduced port of ``ldmae_tpu/cli/inference.py``).

Builds the sampling pipeline from a reference-layout YAML exactly as the JAX
CLI's ``_build_pipeline`` does (half-split RoPE layout, bf16, the
configured attention / adaLN / MLP impls, int8 quantization when
``parallel.quant`` or ``--quant`` asks for it), loads the DiT EMA weights from
``ckpt_path`` (a reference ``.pt``) and the VMAE from ``vae.weight_path``
when those files exist, and otherwise uses seeded random weights. Writes
PNGs (``--demo``: the reference's 2x4 demo grid).

Not ported yet (ROADMAP.md): batch-level resume, ``resume_manifest.json``,
rank interleave across processes, Orbax checkpoints, the non-VMAE
tokenizers, latent statistics computed from shards (only an existing
``latents_stats.pt`` is read).

Usage:
    python -m ldmae_tpu_torch.cli.inference --config configs/imagenet/....yaml [--demo] [--quant w8a8]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..core.config import LDMAEConfig
from ..core.device import resolve_device
from ..eval.sampling import DEMO_LABELS, make_sample_fn
from ..models import (
    VMAE,
    LightningDiT,
    dit_spec,
    permute_qk_for_half_rope,
    production_vmae_spec,
    quantize_dit_,
    seeded_init_,
)
from ..transport import create_transport


def folder_name(config) -> str:
    """The reference's sample-folder naming (inference.py:45-52)."""
    s = config.sample
    stem = str(config.ckpt_path or "random").split("/")[-1].split(".")[0]
    name = (
        f"{config.model.model_type.replace('/', '-')}-ckpt-{stem}"
        f"-{s.sampling_method}-{s.num_sampling_steps}"
    ).lower()
    if s.cfg_scale > 1.0:
        name += f"-interval{(s.cfg_interval_start or 0):.2f}-cfg{s.cfg_scale:.2f}"
        name += f"-shift{(s.timestep_shift or 0):.2f}"
    return name


def _load_checkpoint(path: str, key: str):
    # A checkpoint is a trusted file the user points at, as in the JAX
    # CLI; reference VMAE checkpoints pickle an argparse Namespace, so a
    # weights-only load would refuse them.
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt[key] if key in ckpt else ckpt


def build_pipeline(config: LDMAEConfig, ckpt_path=None, demo: bool = False, device=None):
    """(sample_fn, bundle, spec) for ``config``. ``demo`` applies the
    reference's demo overrides: CFG interval off, timestep shift 0."""
    device = resolve_device(device)
    m, d = config.model, config.data
    spec = dit_spec(
        m.model_type,
        input_size=d.image_size // config.vae.downsample_ratio,
        in_channels=m.in_chans,
        num_classes=d.num_classes,
        class_dropout_prob=0.0 if d.num_classes == 1 else 0.1,
        learn_sigma=m.learn_sigma,
        use_qknorm=m.use_qknorm,
        use_swiglu=m.use_swiglu,
        use_rope=m.use_rope,
        use_rmsnorm=m.use_rmsnorm,
        wo_shift=m.wo_shift,
    )
    seed = config.train.global_seed
    dit = LightningDiT(spec, device=device)
    ckpt = ckpt_path or config.ckpt_path
    if ckpt and os.path.exists(str(ckpt)) and str(ckpt).endswith((".pt", ".pth")):
        sd = _load_checkpoint(str(ckpt), "ema")
    else:
        print(f"no DiT checkpoint at {ckpt!r}: using seeded random weights (seed {seed})")
        sd = seeded_init_(dit, seed).state_dict()
    # sampling always runs in the half-split RoPE layout, quantized after it
    dit.load_state_dict(permute_qk_for_half_rope(sd, spec), strict=True)
    quant = config.parallel.quant
    if quant:
        quantize_dit_(dit)

    if not config.vae.model_name.startswith("vmae"):
        raise NotImplementedError(
            f"tokenizer {config.vae.model_name!r} is not ported yet (VMAE only)"
        )
    vae = VMAE(production_vmae_spec(d.image_size), device=device)
    if config.vae.weight_path and os.path.exists(config.vae.weight_path):
        vae.load_state_dict(_load_checkpoint(config.vae.weight_path, "model"), strict=True)
    else:
        print(f"no VMAE weights at {config.vae.weight_path!r}: using seeded random weights")
        seeded_init_(vae, seed + 1)

    latent_mean = latent_std = None
    stats = os.path.join(d.data_path, "latents_stats.pt")
    if d.latent_norm and os.path.exists(stats):
        raw = torch.load(stats, map_location="cpu", weights_only=True)
        latent_mean, latent_std = raw["mean"].float(), raw["std"].float()

    t = config.transport
    transport = create_transport(t.path_type, t.prediction, t.loss_weight, t.train_eps, t.sample_eps)
    s, par = config.sample, config.parallel
    sample_fn = make_sample_fn(
        spec, transport,
        num_steps=s.num_sampling_steps,
        sampling_method=s.sampling_method,
        timestep_shift=0.0 if demo else s.timestep_shift,
        cfg_scale=s.cfg_scale,
        cfg_interval=not demo,
        cfg_interval_start=s.cfg_interval_start,
        cfg_channels=s.cfg_channels,
        truncation=s.truncation_bound,
        mode=s.mode,
        latent_multiplier=d.latent_multiplier,
        compute_dtype=torch.bfloat16,
        attn_impl=par.attention_impl,
        rope_layout="half",
        adaln_impl=par.adaln_impl,
        quant_mode=quant,
        mlp_impl=par.mlp_impl,
        device=device,
    )
    bundle = {"dit": dit, "vae": vae, "latent_mean": latent_mean, "latent_std": latent_std}
    return sample_fn, bundle, spec


def _write_png(img: np.ndarray, path: str) -> None:
    from PIL import Image

    tmp = path + ".tmp"
    Image.fromarray(img).save(tmp, format="PNG")
    os.replace(tmp, path)


def do_sample(config: LDMAEConfig, demo: bool = False, out_root=None, demo_out=None, device=None):
    device = resolve_device(device)
    sample_fn, bundle, _ = build_pipeline(config, demo=demo, device=device)
    s = config.sample
    seed = config.train.global_seed
    if demo:
        y = torch.tensor(DEMO_LABELS if s.cfg_scale > 1.0 else [0] * 8)
        gen = torch.Generator(device=device).manual_seed(seed)
        imgs = sample_fn(bundle, y, generator=gen).cpu().numpy()
        grid = imgs.reshape(2, 4, *imgs.shape[1:]).transpose(0, 2, 1, 3, 4)
        grid = grid.reshape(2 * imgs.shape[1], 4 * imgs.shape[2], 3)
        demo_dir = demo_out or "demo_images"
        os.makedirs(demo_dir, exist_ok=True)
        ckpt_iter = os.path.basename(str(config.ckpt_path or "random"))
        ckpt_iter = ckpt_iter[:-3] if ckpt_iter.endswith(".pt") else os.path.splitext(ckpt_iter)[0]
        path = os.path.join(
            demo_dir,
            f"{os.path.basename(config.train.exp_name)}_cfg{s.cfg_scale}_{ckpt_iter}_demo_samples.png",
        )
        _write_png(grid, path)
        print(f"demo grid -> {path}")
        return demo_dir

    out_dir = os.path.join(
        out_root or os.path.join(config.train.output_dir, config.train.exp_name), folder_name(config)
    )
    os.makedirs(out_dir, exist_ok=True)
    per_batch = s.per_proc_batch_size
    n_batches = (s.fid_num + per_batch - 1) // per_batch
    rng = np.random.default_rng(seed)
    t0 = time.time()
    done = 0
    for i in range(n_batches):
        y = torch.from_numpy(rng.integers(0, config.data.num_classes, size=per_batch))
        gen = torch.Generator(device=device).manual_seed(seed * 100003 + i)
        imgs = sample_fn(bundle, y, generator=gen).cpu().numpy()
        for j, img in enumerate(imgs):
            idx = i * per_batch + j
            if idx < s.fid_num:
                _write_png(img, os.path.join(out_dir, f"{idx:06d}.png"))
                done += 1
        print(f"batch {i + 1}/{n_batches} ({done} imgs, {done / (time.time() - t0):.2f} img/s)",
              flush=True)
    return out_dir


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--demo", action="store_true")
    parser.add_argument("--demo_out", default=None)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument(
        "--quant", default=None, choices=["w8", "w8a8"],
        help="int8-quantize the DiT for sampling (overrides parallel.quant)",
    )
    parser.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain path")
    args = parser.parse_args(argv)
    config = LDMAEConfig.from_yaml(args.config)
    if args.ckpt:
        config.ckpt_path = args.ckpt
    if args.quant:
        config.parallel.quant = args.quant
    return do_sample(config, demo=args.demo, demo_out=args.demo_out, device=args.device)


if __name__ == "__main__":
    main()
