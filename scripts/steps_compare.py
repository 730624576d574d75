#!/usr/bin/env python3
"""Training steps/s and 10-step w8a8 sampling seconds of one checkout, for
comparing two commits on the same card.

Run from the root of a checkout (it imports that checkout's
``ldmae_tpu_torch`` and ``chip_smoke.py``) on a machine with a CUDA card:

    python3 scripts/steps_compare.py [--label NAME] [--steps 6] [--dtype float32]

It builds the checkout's kernels, then:

* trains LightningDiT-B/1, L/2, XL/2 and 1p6B/1 at full width and depth
  through ``cli.train_dit`` on ``chip_smoke.train_yaml``'s YAML (the
  shipped one's model, transport, optimizer and parallel sections: bf16,
  flash_rope, fused adaLN, remat attn), batch 32, ``--steps`` steps on
  synthetic latent shards, the reference initialisation, the final
  checkpoint's write left out; prints each arch's steady steps/s (steps 2
  onwards, weighted by their seconds);
* runs ``chip_smoke.registry_short_leg`` at L/2 and 1p6B/1 (10 Euler steps,
  batch 8, depth 8, bf16 and w8a8, with its gates) and prints its seconds.

With ``--dtype float32`` it trains B/1 alone, with parallel.compute_dtype
float32 (the fp32 kernels: #1 and #6's fp32 instantiations, #3 in fp32),
and runs no sampling leg.

Its last line is one JSON object ``{"label": ..., "card": ..., "dtype":
..., "train_steps_per_s": {...}, "w8a8_10step": {...}}``. To compare two
commits, unpack the older one (``git archive``) into a git-ignored
directory, copy this script there, and
run parent, change, change, parent in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

TRAIN_ARCHS = ("LightningDiT-B/1", "LightningDiT-L/2", "LightningDiT-XL/2", "LightningDiT-1p6B/1")
SAMPLE_ARCHS = ("LightningDiT-L/2", "LightningDiT-1p6B/1")


def train_steps_per_s(arch: str, tmp: str, data: str, steps: int, dtype: str = "bfloat16") -> float:
    import torch
    import yaml

    import chip_smoke
    from ldmae_tpu_torch.cli import train_dit

    name = arch.split("-")[1].replace("/", "_")
    path = chip_smoke.train_yaml(os.path.join(tmp, f"{name}.yaml"), arch, data, "", tmp, f"{name}_train")
    cfg = yaml.safe_load(open(path))
    cfg["train"]["max_steps"] = steps
    cfg["parallel"]["compute_dtype"] = dtype
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    save = train_dit.save_checkpoint
    train_dit.save_checkpoint = lambda exp_dir, state, **kw: os.path.join(exp_dir, "checkpoints", "not-written")
    try:
        hist = train_dit.main(["--config", path])["history"]
    finally:
        train_dit.save_checkpoint = save
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    steady = hist[1:]
    return sum(h["steps_per_sec"] * h["seconds"] for h in steady) / sum(h["seconds"] for h in steady)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("steps_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from ldmae_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    kernels.build()
    print(f"[{args.label}] build {time.perf_counter() - t0:.2f} s; {smi}", flush=True)
    dev = torch.device("cuda", 0)
    out = {"label": args.label, "card": smi, "dtype": args.dtype, "train_steps_per_s": {}, "w8a8_10step": {}}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "latents")
        chip_smoke.write_latent_shards(data)
        fp32 = args.dtype == "float32"
        for arch in TRAIN_ARCHS[:1] if fp32 else TRAIN_ARCHS:
            out["train_steps_per_s"][arch] = sps = train_steps_per_s(arch, tmp, data, args.steps, args.dtype)
            print(f"[{args.label}] {arch}: {sps:.4f} steps/s at batch 32, {args.dtype}", flush=True)
        for arch in () if fp32 else SAMPLE_ARCHS:
            record, _ = chip_smoke.registry_short_leg(dev, smi, tmp, arch)
            # the seconds of each 10-step chain: {mode: {"kernels_s": ..., "xla_s": ...}}
            out["w8a8_10step"][arch] = {str(mode): {k: v for k, v in r.items() if k.endswith("_s")}
                                        for mode, r in record.items() if isinstance(r, dict)}
            print(f"[{args.label}] {arch}: {out['w8a8_10step'][arch]}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
