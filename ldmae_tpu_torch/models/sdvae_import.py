"""Diffusers ``AutoencoderKL`` checkpoints onto ``ConvVAE`` (port of
``ldmae_tpu/models/sdvae_import.py``).

The reference's SD-VAE is a diffusers ``AutoencoderKL`` with
block_out_channels (128, 256, 512, 512), no attention in the down and up
blocks, no quant convs and latent 16: ``conv_vae.sdvae_spec``. The renames:

  LDM name                         diffusers name
  encoder.down.{i}.block.{b}.*     encoder.down_blocks.{i}.resnets.{b}.*
  encoder.down.{i}.downsample.conv encoder.down_blocks.{i}.downsamplers.0.conv
  {en,de}coder.mid.block_1/2       {en,de}coder.mid_block.resnets.0/1
  {en,de}coder.mid.attn_1.{q,k,v,proj_out,norm}
                                   {en,de}coder.mid_block.attentions.0.
                                     {to_q,to_k,to_v,to_out.0,group_norm}
                                   (before diffusers 0.17: query, key, value,
                                    proj_attn, norm)
  norm_out / conv_in / conv_out    conv_norm_out / conv_in / conv_out
  decoder.up.{i}.block.{b}         decoder.up_blocks.{n - 1 - i}.resnets.{b}
  nin_shortcut                     conv_shortcut

The attention projections are diffusers ``Linear`` (C, C) weights and LDM
1x1 convolutions: they take the shape (C, C, 1, 1).
"""

from __future__ import annotations

from typing import Dict

import torch

from .conv_vae import ConvVAE, ConvVAESpec, load_ldm_state_dict_, sdvae_spec


def diffusers_to_ldm_state_dict(sd: Dict[str, torch.Tensor], spec: ConvVAESpec) -> Dict[str, torch.Tensor]:
    """The LDM-named state dict of a diffusers one (tensors, or arrays that
    ``torch.as_tensor`` takes); names that are absent stay absent."""
    n_lv = len(spec.ch_mult)
    out: Dict[str, torch.Tensor] = {}

    def copy(dst, src):
        if src in sd:
            out[dst] = torch.as_tensor(sd[src])

    def pair(dst, src):
        copy(f"{dst}.weight", f"{src}.weight")
        copy(f"{dst}.bias", f"{src}.bias")

    def resnet(dst, src):
        for name in ("norm1", "conv1", "norm2", "conv2"):
            pair(f"{dst}.{name}", f"{src}.{name}")
        if f"{src}.conv_shortcut.weight" in sd:
            pair(f"{dst}.nin_shortcut", f"{src}.conv_shortcut")

    def attn(dst, src):
        if f"{src}.group_norm.weight" in sd:
            pair(f"{dst}.norm", f"{src}.group_norm")
            names = (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj_out", "to_out.0"))
        else:
            pair(f"{dst}.norm", f"{src}.norm")
            names = (("q", "query"), ("k", "key"), ("v", "value"), ("proj_out", "proj_attn"))
        for a, b in names:
            w = sd.get(f"{src}.{b}.weight")
            if w is None:
                continue
            w = torch.as_tensor(w)
            out[f"{dst}.{a}.weight"] = w[:, :, None, None] if w.ndim == 2 else w  # Linear -> 1x1 conv
            copy(f"{dst}.{a}.bias", f"{src}.{b}.bias")

    for side in ("encoder", "decoder"):
        pair(f"{side}.conv_in", f"{side}.conv_in")
        resnet(f"{side}.mid.block_1", f"{side}.mid_block.resnets.0")
        resnet(f"{side}.mid.block_2", f"{side}.mid_block.resnets.1")
        attn(f"{side}.mid.attn_1", f"{side}.mid_block.attentions.0")
        pair(f"{side}.norm_out", f"{side}.conv_norm_out")
        pair(f"{side}.conv_out", f"{side}.conv_out")
    for i in range(n_lv):
        for b in range(spec.num_res_blocks):
            resnet(f"encoder.down.{i}.block.{b}", f"encoder.down_blocks.{i}.resnets.{b}")
        pair(f"encoder.down.{i}.downsample.conv", f"encoder.down_blocks.{i}.downsamplers.0.conv")
    for j in range(n_lv):  # diffusers orders the up blocks from the lowest resolution
        i = n_lv - 1 - j
        for b in range(spec.num_res_blocks + 1):
            resnet(f"decoder.up.{i}.block.{b}", f"decoder.up_blocks.{j}.resnets.{b}")
        pair(f"decoder.up.{i}.upsample.conv", f"decoder.up_blocks.{j}.upsamplers.0.conv")
    pair("quant_conv", "quant_conv")
    pair("post_quant_conv", "post_quant_conv")
    return out


def load_sdvae(ckpt_path: str, device=None) -> ConvVAE:
    """An SD-VAE from a torch checkpoint of a diffusers state dict (under
    ``model`` or bare); bf16 tensors load as float32."""
    # a trusted file the user points at (it may pickle more than tensors)
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "model" in raw:
        raw = raw["model"]
    sd = {k: v.float() for k, v in raw.items() if isinstance(v, torch.Tensor)}
    spec = sdvae_spec()
    return load_ldm_state_dict_(ConvVAE(spec, device=device), diffusers_to_ldm_state_dict(sd, spec))
