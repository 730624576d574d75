"""VMAE tokenizer (port of ``ldmae_tpu/models/vmae.py``).

``VMAE`` declares the whole reference ``MaskedAutoencoderViT`` parameter set
under its state-dict keys, so ``vmaef8d16.pth``-style checkpoints and
``convert.vmae_state_dict_from_jax`` load with ``strict=True``. It
implements the docking API (the full-image ``ldmae_encode_moments`` and
``encode``, ``decode``, ``decode_to_images``) and the training forwards:
``forward_vanilla`` (stage 1: the masked encoder, the KL bottleneck, the
mask-token decoder, the visible/masked MSE split, the perceptual term) and
``forward_ldmae`` (stage 3: the full-image round trip through a frozen
encoder, pixel MSE plus the perceptual term). Their two random draws, the
shuffle noise and the posterior's eps, are passed in or drawn from a
``torch.Generator``. ``init_vmae_weights_`` is the reference
initialisation; ``load_vmae_weights_`` merges a checkpoint with
``strict=False`` semantics (the trainer's ``--resume``).

The production arch is ``mae_for_ldmae_f8d16_prev``: patch 8, encoder and
decoder width 192, depth 12, 12 heads (head dim 16), latent 16,
``smooth_output`` (linear pred + 3x3 conv smoother on RGB).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..core.device import resolve_device
from ..ops import dense, get_2d_sincos_pos_embed, layer_norm, mlp_gelu, multi_head_attention
from ..ops.conv import conv2d_fp32
from ..ops.gaussian import DiagonalGaussian, diagonal_gaussian
from ..ops.masking import random_masking, unshuffle_with_mask_tokens
from ..ops.patchify import patch_embed, patchify, unpatchify


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
    # training only
    norm_pix_loss: bool = False
    perceptual_loss_ratio: float = 1.0
    fixed_std: Optional[float] = None
    use_checkpoint: bool = False  # per-block recomputation in the backward

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
    """fp32 convolution as the JAX head computes it (TF32 off)."""
    return conv2d_fp32(F.pad(x.float(), padding), conv.weight, conv.bias)


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

    def _latent_proj(self, x: torch.Tensor, proj: nn.Module) -> torch.Tensor:
        """``to_latent`` / ``from_latent``: a linear, or with
        ``down_nonlinear`` the exact-erf GELU MLP."""
        if self.spec.down_nonlinear:
            return mlp_gelu(x, proj.layers[0], proj.layers[2])
        return dense(x, proj.weight, proj.bias)

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

    def _embed(self, imgs: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
        """Patch embedding (patchify, then ``dense`` on the Conv2d weight
        viewed as a linear) plus the patch tokens' positional table."""
        pe_w = self.patch_embed.proj
        x = patch_embed(imgs.to(compute_dtype), pe_w.weight, pe_w.bias, self.spec.patch_size,
                        compute_dtype=compute_dtype)
        pe = self.consts.pos_embed.to(compute_dtype)
        return x + (pe[None] if self.spec.no_cls else pe[None, 1:])

    def _encode(self, x: torch.Tensor, attn_impl: str) -> torch.Tensor:
        """Embedded tokens -> the cls token (with its table row) -> blocks -> norm."""
        spec = self.spec
        if not spec.no_cls:
            cls = self.cls_token.reshape(-1).to(x.dtype) + self.consts.pos_embed[0].to(x.dtype)
            x = torch.cat([cls.expand(x.shape[0], 1, -1), x], dim=1)
        x = self._run_blocks(x, self.blocks, spec.num_heads, attn_impl)
        return layer_norm(x, self.norm.weight, self.norm.bias, eps=1e-6)

    def _encoder_tokens(self, imgs: torch.Tensor, compute_dtype: torch.dtype, attn_impl: str) -> torch.Tensor:
        """The full-image (unmasked) encoder."""
        return self._encode(self._embed(imgs, compute_dtype), attn_impl)

    def _run_blocks(self, x: torch.Tensor, blocks: nn.ModuleList, num_heads: int, attn_impl: str) -> torch.Tensor:
        """The block stack; with ``spec.use_checkpoint`` under autograd each
        block's activations are recomputed in the backward (the JAX package's
        per-block remat)."""
        remat = self.spec.use_checkpoint and torch.is_grad_enabled()
        for blk in blocks:
            if remat:
                x = torch.utils.checkpoint.checkpoint(blk, x, num_heads, attn_impl, use_reentrant=False)
            else:
                x = blk(x, num_heads, attn_impl)
        return x

    def _decode_tokens(self, x: torch.Tensor, attn_impl: str) -> torch.Tensor:
        """Latent tokens (B, L, latent_dim) in the compute dtype -> the
        patched prediction (B, L, p*p*3): from_latent, decoder_embed, the
        positional table, the decoder blocks, the norm and the pred head."""
        spec = self.spec
        x = self._latent_proj(x, self.from_latent)
        x = dense(x, self.decoder_embed.weight, self.decoder_embed.bias)
        pe = self.consts.decoder_pos_embed.to(x.dtype)
        return self._decode(x + (pe[None] if spec.no_cls else pe[None, 1:]), attn_impl)

    def _decode(self, x: torch.Tensor, attn_impl: str) -> torch.Tensor:
        """Decoder tokens with their positional table -> blocks -> norm -> pred head."""
        x = self._run_blocks(x, self.decoder_blocks, self.spec.decoder_num_heads, attn_impl)
        x = layer_norm(x, self.decoder_norm.weight, self.decoder_norm.bias, eps=1e-6)
        return self._decoder_pred(x)

    @torch.no_grad()
    def ldmae_encode_moments(self, imgs: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
                             attn_impl: str = "xla") -> torch.Tensor:
        """(B, 3, H, W) images in [-1, 1] -> the raw ``to_latent`` output
        (2 latent_dim channels when variational) as (B, C, h, w) float32."""
        x = self._encoder_tokens(imgs, compute_dtype, attn_impl)
        if not self.spec.no_cls:
            x = x[:, 1:]
        x = self._latent_proj(x, self.to_latent)
        r = self.spec.latent_resolution
        return x.transpose(1, 2).reshape(x.shape[0], -1, r, r).float()

    def encode(self, imgs: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
               attn_impl: str = "xla") -> DiagonalGaussian:
        """The posterior over (B, latent_dim, h, w); a point mass (logvar
        -inf) when the arch is not variational."""
        moments = self.ldmae_encode_moments(imgs, compute_dtype, attn_impl)
        if self.spec.kl_loss_weight is not None:
            return diagonal_gaussian(moments, axis=1)
        return DiagonalGaussian(mean=moments, logvar=torch.full_like(moments, -math.inf))

    @torch.no_grad()
    def decode(self, z: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
               attn_impl: str = "xla") -> torch.Tensor:
        """(B, latent_dim, h, w) latents -> (B, 3, H, W) float32 images."""
        b, c, h, w = z.shape
        x = self._decode_tokens(z.reshape(b, c, h * w).transpose(1, 2).to(compute_dtype), attn_impl)
        return unpatchify(x.float(), self.spec.patch_size, 3)

    def decode_to_images(self, z: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
                         attn_impl: str = "xla") -> torch.Tensor:
        """decode -> uint8 (B, H, W, 3): clamp(127.5x + 128, 0, 255)."""
        imgs = torch.clamp(127.5 * self.decode(z, compute_dtype, attn_impl) + 128.0, 0, 255)
        return imgs.permute(0, 2, 3, 1).to(torch.uint8)

    # -- training forwards ---------------------------------------------------

    def forward_encoder(self, imgs: torch.Tensor, mask_ratio: float, mask_noise: torch.Tensor,
                        compute_dtype: torch.dtype = torch.float32, attn_impl: str = "xla"):
        """Masked encoder: the embedded tokens kept by ``random_masking`` of
        ``mask_noise`` (B, L) through the encoder. Returns (x, mask,
        ids_restore)."""
        x, mask, ids_restore = random_masking(self._embed(imgs, compute_dtype), mask_ratio, mask_noise)
        return self._encode(x, attn_impl), mask, ids_restore

    def forward_decoder(self, x: torch.Tensor, ids_restore: torch.Tensor, attn_impl: str = "xla") -> torch.Tensor:
        """Decoder of the kept tokens: decoder_embed, the mask tokens put
        back in place, + PE, blocks, norm, pred head; (B, L, p*p*3)."""
        spec = self.spec
        x = dense(x, self.decoder_embed.weight, self.decoder_embed.bias)
        if spec.no_cls:
            x = unshuffle_with_mask_tokens(x, self.mask_token, ids_restore)
        else:
            x = torch.cat([x[:, :1], unshuffle_with_mask_tokens(x[:, 1:], self.mask_token, ids_restore)], dim=1)
        x = self._decode(x + self.consts.decoder_pos_embed.to(x.dtype)[None], attn_impl)
        return x if spec.no_cls else x[:, 1:]

    def forward_vanilla(
        self, imgs: torch.Tensor, mask_ratio: float = 0.75, visible_loss_ratio: float = 0.5,
        perceptual_loss_fn: Optional[Callable] = None, compute_dtype: torch.dtype = torch.float32,
        attn_impl: str = "xla", mask_noise: Optional[torch.Tensor] = None,
        latent_noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Stage-1 training forward of (B, 3, H, W) float32 images in [-1, 1].

        mask_noise (B, L) uniform and latent_noise (B, latent_dim, L_kept)
        standard normal are the two random draws, taken from ``generator``
        when not given. The loss is (1 - visible_loss_ratio) x the masked
        tokens' MSE + visible_loss_ratio x the kept tokens' (against the
        per-patch normalised pixels with ``norm_pix_loss``), plus
        perceptual_loss_ratio x the mean of ``perceptual_loss_fn(imgs,
        recon)``, plus kl_loss_weight x the KL per token (against
        ``fixed_std`` when set), all in float32."""
        spec = self.spec
        b = imgs.shape[0]
        if mask_noise is None:
            mask_noise = torch.rand(b, spec.num_patches, generator=generator, device=imgs.device)
        latent, mask, ids_restore = self.forward_encoder(imgs, mask_ratio, mask_noise, compute_dtype, attn_impl)
        latent = self._latent_proj(latent, self.to_latent)

        kl_loss = None
        if spec.kl_loss_weight is not None:
            n_tokens = latent.shape[1]
            posterior = diagonal_gaussian(latent.float().transpose(1, 2), axis=1)
            kl = posterior.kl(fixed_std=spec.fixed_std)  # per-sample sum
            kl_loss = kl.sum() / kl.shape[0] / n_tokens
            latent = posterior.sample(latent_noise, generator).transpose(1, 2).to(compute_dtype)

        pred = self.forward_decoder(self._latent_proj(latent, self.from_latent), ids_restore, attn_impl)
        target = patchify(imgs, spec.patch_size)
        if spec.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, unbiased=False, keepdim=True)
            target = (target - mean) / (var + 1e-6) ** 0.5
        loss = ((pred.float() - target) ** 2).mean(dim=-1)  # (B, L)
        mask = mask.float()
        visible_loss = (loss * (1 - mask)).sum() / (1 - mask).sum()
        mask_loss = (loss * mask).sum() / mask.sum()
        loss = (1 - visible_loss_ratio) * mask_loss + visible_loss_ratio * visible_loss
        if perceptual_loss_fn is not None:
            p_loss = perceptual_loss_fn(imgs, unpatchify(pred.float(), spec.patch_size, 3)).mean()
            loss = loss + spec.perceptual_loss_ratio * p_loss
        else:
            p_loss = torch.zeros_like(loss)
        if kl_loss is not None:
            loss = loss + spec.kl_loss_weight * kl_loss
        return {"loss": loss, "pred": pred, "mask": mask, "vis_loss": visible_loss, "mask_loss": mask_loss,
                "kl_loss": kl_loss if kl_loss is not None else torch.zeros_like(loss), "p_loss": p_loss}

    def reconstruct(
        self, imgs: torch.Tensor, latent_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None, use_mode: bool = True,
        compute_dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
    ) -> torch.Tensor:
        """Full-image encode -> decode, the patched prediction (B, L,
        p*p*3). The latent is the posterior's mode, or with ``use_mode``
        False a sample (eps ``latent_noise`` (B, latent_dim, L), else drawn
        from ``generator``). The encoder runs without autograd (the JAX
        package's stop-gradient on the latent: stage 3 tunes the decoder)."""
        spec = self.spec
        with torch.no_grad():
            x = self._encoder_tokens(imgs, compute_dtype, attn_impl)
            if not spec.no_cls:
                x = x[:, 1:]
            latent = self._latent_proj(x, self.to_latent)
            if spec.kl_loss_weight is not None:
                posterior = diagonal_gaussian(latent.float().transpose(1, 2), axis=1)
                z = posterior.mode() if use_mode else posterior.sample(latent_noise, generator)
                latent = z.transpose(1, 2).to(compute_dtype)
        x = self._decode_tokens(latent, attn_impl)
        # as the JAX package's reconstruct (a cls arch's first token goes)
        return x if spec.no_cls else x[:, 1:]

    def forward_ldmae(
        self, imgs: torch.Tensor, perceptual_loss_fn: Optional[Callable] = None,
        compute_dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
        latent_noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
        use_mode: Optional[bool] = None,
    ) -> Dict[str, torch.Tensor]:
        """Stage-3 decoder-tuning forward: ``reconstruct`` with the encoder
        frozen, loss = pixel MSE + perceptual_loss_ratio x the mean of
        ``perceptual_loss_fn(imgs, recon)``. The posterior is sampled, as the
        JAX train step (which passes a key) samples it, unless ``use_mode``
        or neither ``latent_noise`` nor ``generator`` is given."""
        if use_mode is None:
            use_mode = latent_noise is None and generator is None
        pred = self.reconstruct(imgs, latent_noise, generator, use_mode, compute_dtype, attn_impl)
        recon = unpatchify(pred.float(), self.spec.patch_size, 3)
        vis_loss = ((recon - imgs) ** 2).mean()
        if perceptual_loss_fn is not None:
            p_loss = perceptual_loss_fn(imgs, recon).mean()
            loss = vis_loss + self.spec.perceptual_loss_ratio * p_loss
        else:
            p_loss = torch.zeros_like(vis_loss)
            loss = vis_loss
        return {"loss": loss, "pred": pred, "vis_loss": vis_loss, "p_loss": p_loss}


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


def load_production_vmae(weight_path: str, img_size: int = 256, device=None, seed: int = 1) -> VMAE:
    """The production tokenizer, ``load_vmae`` of ``production_vmae_spec``."""
    return load_vmae(production_vmae_spec(img_size), weight_path, device, seed)


def load_vmae(spec: VMAESpec, weight_path: str, device=None, seed: int = 1) -> VMAE:
    """A VMAE of ``spec`` with the reference checkpoint's ``model`` state
    dict at ``weight_path``; an empty path gives seeded random weights
    (``models.seeded_init_``) with a warning, and a path that does not exist
    raises, as the JAX package's ``build_tokenizer_fns`` does."""
    from .init import seeded_init_

    vae = VMAE(spec, device=device)
    if weight_path:
        if not os.path.exists(weight_path):
            raise FileNotFoundError(f"tokenizer checkpoint not found: {weight_path}")
        # a trusted file the user points at; reference checkpoints pickle an
        # argparse Namespace, which a weights-only load refuses
        ckpt = torch.load(weight_path, map_location="cpu", weights_only=False)
        vae.load_state_dict(ckpt.get("model", ckpt), strict=True)
    else:
        print(f"WARNING: no VMAE tokenizer weights given, using seeded random weights (seed {seed})")
        seeded_init_(vae, seed)
    return vae


@torch.no_grad()
def init_vmae_weights_(model: VMAE, generator: torch.Generator) -> VMAE:
    """The reference initialisation (the JAX package's ``init_vmae_params``)
    drawn from ``generator`` on the CPU: xavier-uniform linears with the JAX
    package's fans (qkv as one (D, 3D) matrix; the patch embedding as its
    (p*p*C, D) matmul; a convolution with fan-in C_in k k and fan-out
    C_out: the 3x3 smoother's 27 and 3), zero
    biases, unit LayerNorms and N(0, 0.02) cls and mask tokens. The
    distributions are the JAX package's; the draws are not (the generators
    differ)."""
    def xavier(t: torch.Tensor, fan_in: int, fan_out: int) -> None:
        a = math.sqrt(6.0 / (fan_in + fan_out))
        t.copy_(torch.empty(t.shape).uniform_(-a, a, generator=generator))

    for m in model.modules():
        if isinstance(m, nn.Linear):
            xavier(m.weight, m.in_features, m.out_features)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            # fan-out without the kernel's area (torch's xavier_uniform_ would
            # count it): the smoother's 3, the patch embedding's D
            cout, cin, kh, kw = m.weight.shape
            xavier(m.weight, cin * kh * kw, cout)
            nn.init.zeros_(m.bias)
    for name in ("cls_token", "mask_token"):
        if hasattr(model, name):
            t = getattr(model, name)
            t.copy_(torch.randn(t.shape, generator=generator) * 0.02)
    return model


def load_vmae_weights_(model: VMAE, path: str) -> Dict[str, list]:
    """Merge the ``model`` state dict of a reference-layout checkpoint into
    ``model`` with ``strict=False`` semantics: every tensor whose name and
    shape match is loaded; a missing name or another shape keeps the
    model's value. Returns {"loaded", "missing", "unexpected"} name lists
    (a shape mismatch is listed as missing, with both shapes)."""
    # a trusted file the user points at (reference checkpoints pickle an
    # argparse Namespace, which a weights-only load refuses)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    own = model.state_dict()
    loaded, missing = [], []
    for k, v in own.items():
        if k not in sd:
            missing.append(k)
        elif tuple(sd[k].shape) != tuple(v.shape):
            missing.append(f"{k} (shape {tuple(sd[k].shape)} != {tuple(v.shape)})")
        else:
            loaded.append(k)
    model.load_state_dict({k: sd[k] for k in loaded}, strict=False)
    return {"loaded": loaded, "missing": missing, "unexpected": sorted(k for k in sd if k not in own)}


def list_archs():
    return sorted(_FACTORIES)
