"""Positional-embedding resize of a VMAE checkpoint (port of
``ldmae_tpu/cli/pe_reset.py``, stage 2 of ``scripts/train_ae.sh``).

The port's VMAE recomputes its sin-cos tables for any resolution, so its own
training does not need this. For checkpoints read elsewhere (the reference
code loads the ``pos_embed`` / ``decoder_pos_embed`` buffers it finds), it
resizes both buffers of a ``.pth`` bilinearly (``align_corners=False``, no
antialiasing) to the grid of a new resolution and saves ``*_pe.pth``; it
refuses to overwrite its input.

Usage:
    python -m ldmae_tpu_torch.cli.pe_reset --ckpt_dir in.pth [--save_dir out_pe.pth] \\
        --input_size 256 --patch_size 8
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch
import torch.nn.functional as F


def resize_pos_embed(pos_embed: torch.Tensor, new_size: int) -> torch.Tensor:
    """(1, HW, D) -> (1, new_size^2, D) float32, bilinear on the square grid."""
    _, hw, d = pos_embed.shape
    h = int(round(hw**0.5))
    if h * h != hw:
        raise ValueError(f"pos_embed of {hw} rows is not a square grid (a cls row is not resized)")
    grid = pos_embed.float().reshape(1, h, h, d).permute(0, 3, 1, 2)
    out = F.interpolate(grid, size=(new_size, new_size), mode="bilinear", align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1).reshape(1, new_size * new_size, d)


def pe_reset(ckpt_path: str, save_path: str, input_size: int, patch_size: int) -> str:
    # a trusted file the user points at (reference checkpoints pickle an
    # argparse Namespace, which a weights-only load refuses)
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    new_size = input_size // patch_size
    for key in ("pos_embed", "decoder_pos_embed"):
        if key in sd:
            print(f"{key}: {tuple(sd[key].shape)} -> grid {new_size}x{new_size}")
            sd[key] = resize_pos_embed(sd[key], new_size)
    torch.save(ckpt, save_path)
    return save_path


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt_dir", required=True, help="input checkpoint (.pth)")
    p.add_argument("--save_dir", default=None, help="output path (default *_pe.pth)")
    p.add_argument("--input_size", type=int, default=256)
    p.add_argument("--patch_size", type=int, default=8)
    a = p.parse_args(argv)
    if a.save_dir:
        out = a.save_dir
    else:
        stem, ext = os.path.splitext(a.ckpt_dir)
        out = f"{stem}_pe{ext or '.pth'}"
    if os.path.abspath(out) == os.path.abspath(a.ckpt_dir):
        p.error("output path equals the input checkpoint; pass --save_dir")
    path = pe_reset(a.ckpt_dir, out, a.input_size, a.patch_size)
    print(path)
    return path


if __name__ == "__main__":
    main()
