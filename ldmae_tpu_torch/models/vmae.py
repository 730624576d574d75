"""VMAE tokenizer — the decode side (port of ``ldmae_tpu/models/vmae.py``).

``VMAE`` declares the whole reference ``MaskedAutoencoderViT`` parameter set
(encoder included) under its state-dict keys, so ``vmaef8d16.pth``-style
checkpoints and ``convert.vmae_state_dict_from_jax`` load with
``strict=True``; this slice implements ``decode`` and ``decode_to_images``.
The encoder forward comes with the extraction slice (ROADMAP.md).

The production arch is ``mae_for_ldmae_f8d16_prev``: patch 8, decoder width
192, depth 12, 12 heads (head dim 16), latent 16, ``smooth_output`` (linear
pred + 3x3 conv smoother on RGB).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops import dense, get_2d_sincos_pos_embed, layer_norm, mlp_gelu, multi_head_attention
from ..ops.patchify import patchify, unpatchify


@dataclass(frozen=True)
class VMAESpec:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    decoder_embed_dim: int = 512
    decoder_depth: int = 8
    decoder_num_heads: int = 16
    mlp_ratio: float = 4.0
    latent_dim: int = 32
    ldmae_mode: bool = False
    no_cls: bool = True
    down_nonlinear: bool = False
    kl_loss_weight: Optional[float] = None
    smooth_output: bool = False
    pred_with_conv: bool = False

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid**2

    @property
    def num_extra_tokens(self) -> int:
        return 0 if self.no_cls else 1

    @property
    def encoder_latent_dim(self) -> int:
        return 2 * self.latent_dim if self.kl_loss_weight is not None else self.latent_dim

    @property
    def latent_resolution(self) -> int:
        return self.grid


class VMAEConsts:
    def __init__(self, spec: VMAESpec, device: torch.device):
        def table(dim):
            pe = get_2d_sincos_pos_embed(
                dim, spec.grid, cls_token=not spec.no_cls, extra_tokens=spec.num_extra_tokens
            )
            return torch.from_numpy(pe).to(device)

        self.pos_embed = table(spec.embed_dim)
        self.decoder_pos_embed = table(spec.decoder_embed_dim)


class _PatchEmbed(nn.Module):
    def __init__(self, in_c: int, d: int, p: int, device):
        super().__init__()
        self.proj = nn.Conv2d(in_c, d, kernel_size=p, stride=p, device=device)


class _Attention(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d, device=device)
        self.proj = nn.Linear(d, d, device=device)


class _Mlp(nn.Module):
    def __init__(self, d: int, h: int, device):
        super().__init__()
        self.fc1 = nn.Linear(d, h, device=device)
        self.fc2 = nn.Linear(h, d, device=device)


class VitBlock(nn.Module):
    """Pre-LN ViT block, LayerNorm eps 1e-6, exact GELU."""

    def __init__(self, d: int, mlp_hidden: int, device):
        super().__init__()
        self.norm1 = nn.LayerNorm(d, device=device)
        self.attn = _Attention(d, device)
        self.norm2 = nn.LayerNorm(d, device=device)
        self.mlp = _Mlp(d, mlp_hidden, device)

    def forward(self, x: torch.Tensor, num_heads: int, attn_impl: str) -> torch.Tensor:
        h = layer_norm(x, self.norm1.weight, self.norm1.bias, eps=1e-6)
        x = x + multi_head_attention(h, self.attn, num_heads, impl=attn_impl)
        h = layer_norm(x, self.norm2.weight, self.norm2.bias, eps=1e-6)
        m = self.mlp
        return x + mlp_gelu(h, m.fc1, m.fc2)


class _LatentMLP(nn.Module):
    def __init__(self, d_in: int, h: int, d_out: int, device):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Linear(d_in, h, device=device), nn.GELU(), nn.Linear(h, d_out, device=device)
        )


class _SmoothPred(nn.Module):
    def __init__(self, dd: int, pin: int, pred_with_conv: bool, device):
        super().__init__()
        if pred_with_conv:
            self.conv_smoother = nn.Conv2d(dd, pin, kernel_size=2, device=device)
        else:
            self.linear_pred = nn.Linear(dd, pin, device=device)
            self.conv_smoother = nn.Conv2d(3, 3, kernel_size=3, padding=1, device=device)


def _conv2d_fp32(x: torch.Tensor, conv: nn.Conv2d, padding) -> torch.Tensor:
    """fp32 convolution as the JAX head computes it. cuDNN would run an fp32
    convolution in TF32 by default (about three decimal digits); it is
    turned off for this call."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(F.pad(x.float(), padding), conv.weight.float(), conv.bias.float())


class VMAE(nn.Module):
    def __init__(self, spec: VMAESpec, device=None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        self.consts = VMAEConsts(spec, device)
        d, dd, p = spec.embed_dim, spec.decoder_embed_dim, spec.patch_size
        pin = p * p * spec.in_chans
        self.patch_embed = _PatchEmbed(spec.in_chans, d, p, device)
        self.register_buffer("pos_embed", self.consts.pos_embed[None].clone())
        self.register_buffer("decoder_pos_embed", self.consts.decoder_pos_embed[None].clone())
        if not spec.no_cls:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        if not spec.ldmae_mode:
            self.mask_token = nn.Parameter(torch.zeros(1, 1, dd, device=device))
        self.blocks = nn.ModuleList(
            VitBlock(d, int(d * spec.mlp_ratio), device) for _ in range(spec.depth)
        )
        self.norm = nn.LayerNorm(d, device=device)
        eld = spec.encoder_latent_dim
        if spec.down_nonlinear:
            h = spec.latent_dim * 4
            self.to_latent = _LatentMLP(d, h, eld, device)
            self.from_latent = _LatentMLP(spec.latent_dim, h, d, device)
        else:
            self.to_latent = nn.Linear(d, eld, device=device)
            self.from_latent = nn.Linear(spec.latent_dim, d, device=device)
        self.decoder_embed = nn.Linear(d, dd, device=device)
        self.decoder_blocks = nn.ModuleList(
            VitBlock(dd, int(dd * spec.mlp_ratio), device) for _ in range(spec.decoder_depth)
        )
        self.decoder_norm = nn.LayerNorm(dd, device=device)
        if spec.smooth_output:
            self.decoder_pred = _SmoothPred(dd, pin, spec.pred_with_conv, device)
        else:
            self.decoder_pred = nn.Linear(dd, pin, device=device)

    def _from_latent(self, x: torch.Tensor) -> torch.Tensor:
        fl = self.from_latent
        if self.spec.down_nonlinear:
            l0, l2 = fl.layers[0], fl.layers[2]
            return mlp_gelu(x, l0, l2)
        return dense(x, fl.weight, fl.bias)

    def _decoder_pred(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, dd) -> (B, L, p*p*3)."""
        spec, dp = self.spec, self.decoder_pred
        if not spec.smooth_output:
            return dense(x, dp.weight, dp.bias)
        b, l, _ = x.shape
        h = w = int(round(l**0.5))
        if spec.pred_with_conv:
            grid = x.reshape(b, h, w, -1).permute(0, 3, 1, 2)
            out = _conv2d_fp32(grid, dp.conv_smoother, (0, 1, 0, 1))
            return out.reshape(b, -1, h * w).transpose(1, 2).to(x.dtype)
        out = dense(x, dp.linear_pred.weight, dp.linear_pred.bias)
        img = unpatchify(out.float(), spec.patch_size, 3)
        img = _conv2d_fp32(img, dp.conv_smoother, (1, 1, 1, 1))
        return patchify(img, spec.patch_size).to(x.dtype)

    @torch.no_grad()
    def decode(self, z: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
               attn_impl: str = "xla") -> torch.Tensor:
        """(B, latent_dim, h, w) latents -> (B, 3, H, W) float32 images."""
        spec = self.spec
        b, c, h, w = z.shape
        x = z.reshape(b, c, h * w).transpose(1, 2).to(compute_dtype)
        x = self._from_latent(x)
        x = dense(x, self.decoder_embed.weight, self.decoder_embed.bias)
        pe = self.consts.decoder_pos_embed.to(x.dtype)
        x = x + (pe[None] if spec.no_cls else pe[None, 1:])
        for blk in self.decoder_blocks:
            x = blk(x, spec.decoder_num_heads, attn_impl)
        x = layer_norm(x, self.decoder_norm.weight, self.decoder_norm.bias, eps=1e-6)
        x = self._decoder_pred(x)
        return unpatchify(x.float(), spec.patch_size, 3)

    def decode_to_images(self, z: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
                         attn_impl: str = "xla") -> torch.Tensor:
        """decode -> uint8 (B, H, W, 3): clamp(127.5x + 128, 0, 255)."""
        imgs = torch.clamp(127.5 * self.decode(z, compute_dtype, attn_impl) + 128.0, 0, 255)
        return imgs.permute(0, 2, 3, 1).to(torch.uint8)


_BASE = dict(mlp_ratio=4.0)

_FACTORIES = {
    "mae_for_ldmae": dict(img_size=128, patch_size=8, embed_dim=192, depth=12, num_heads=12, decoder_embed_dim=192, decoder_depth=12, decoder_num_heads=12, latent_dim=32),
    "mae_for_ldmae_f8d32": dict(img_size=128, patch_size=8, embed_dim=192, depth=12, num_heads=12, decoder_embed_dim=192, decoder_depth=12, decoder_num_heads=12, latent_dim=32),
    "mae_for_ldmae_f8d16_prev": dict(patch_size=8, embed_dim=192, depth=12, num_heads=12, decoder_embed_dim=192, decoder_depth=12, decoder_num_heads=12, latent_dim=16),
    "mae_for_ldmae_f8d16_small": dict(patch_size=8, embed_dim=96, depth=12, num_heads=8, decoder_embed_dim=96, decoder_depth=12, decoder_num_heads=8, latent_dim=16),
    "mae_for_ldmae_f8d16_asym_small": dict(patch_size=8, embed_dim=96, depth=12, num_heads=8, decoder_embed_dim=192, decoder_depth=12, decoder_num_heads=12, latent_dim=16),
    "mae_for_ldmae_f8d16_prev_large": dict(patch_size=8, embed_dim=384, depth=12, num_heads=16, decoder_embed_dim=384, decoder_depth=12, decoder_num_heads=16, latent_dim=16),
    "mae_for_ldmae_f8d16": dict(patch_size=8, embed_dim=192, depth=12, num_heads=12, decoder_embed_dim=384, decoder_depth=12, decoder_num_heads=24, latent_dim=16, down_nonlinear=True),
    "mae_for_ldmae_f8d16_flexible": dict(patch_size=8, embed_dim=192, depth=12, num_heads=12, decoder_embed_dim=384, decoder_depth=12, decoder_num_heads=24, latent_dim=16, down_nonlinear=True),
    "mae_for_ldmae_f16d32": dict(img_size=128, patch_size=16, embed_dim=192, depth=12, num_heads=12, decoder_embed_dim=192, decoder_depth=12, decoder_num_heads=12, latent_dim=32),
    "mae_for_ldmae_f16d32_large": dict(img_size=128, patch_size=16, embed_dim=384, depth=12, num_heads=12, decoder_embed_dim=384, decoder_depth=12, decoder_num_heads=12, latent_dim=32),
    "mae_for_ldmae_f8d32_flexible": dict(patch_size=8, embed_dim=192, depth=12, num_heads=12, decoder_embed_dim=192, decoder_depth=12, decoder_num_heads=12, latent_dim=32),
    "mae_for_ldmae_16d": dict(img_size=128, patch_size=8, embed_dim=192, depth=12, num_heads=12, decoder_embed_dim=192, decoder_depth=12, decoder_num_heads=12, latent_dim=16),
    "mae_vit_base_patch16": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12, decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=16),
    "mae_vit_base_patch16_128": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12, decoder_embed_dim=128, decoder_depth=8, decoder_num_heads=16),
    "mae_vit_large_patch16": dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16, decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=16),
    "mae_vit_huge_patch14": dict(patch_size=14, embed_dim=1280, depth=32, num_heads=16, decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=16),
}


def vmae_spec(arch: str, **overrides) -> VMAESpec:
    base = dict(_BASE)
    base.update(_FACTORIES[arch])
    base.update(overrides)
    # callers pass kl_loss_weight=True at inference time
    if base.get("kl_loss_weight") is True:
        base["kl_loss_weight"] = 1.0
    return VMAESpec(**base)


def production_vmae_spec(img_size: int = 256) -> VMAESpec:
    """The tokenizer every ``vmae*`` config name builds
    (``models/tokenizers.build_tokenizer_fns`` in the JAX package)."""
    return vmae_spec(
        "mae_for_ldmae_f8d16_prev", img_size=img_size, ldmae_mode=True, no_cls=True,
        kl_loss_weight=True, smooth_output=True,
    )


def list_archs():
    return sorted(_FACTORIES)
