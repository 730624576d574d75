"""LDM convolutional VAE, ``AutoencoderKL`` (port of ``ldmae_tpu/models/conv_vae.py``).

``ConvVAE`` declares the reference LDM parameter set under its state-dict
keys (``encoder.down.{i}.block.{b}.norm1.weight``, ``encoder.mid.attn_1.q``,
``quant_conv``, ...), so a VA-VAE ``state_dict`` or a MAR-VAE ``model`` loads
with ``load_state_dict``. The numerics are the JAX package's on the CPU:

* every convolution in float32 through ``ops.conv.conv2d_fp32`` (TF32 off
  for the call; cuDNN's default would round the operands to TF32);
* group norm in float32, population variance, eps 1e-6;
* the downsample pads (0, 1, 0, 1) and runs a stride-2 3x3 convolution
  without padding; the upsample repeats each pixel 2 x 2 (nearest) before
  a 3x3 convolution;
* the single-head attention block (the mid block's, and the levels' listed
  in ``attn_resolutions``) in float32: logits q^T k c^-1/2, a softmax over
  the keys, and out[b, c, j] = sum_i v[b, c, i] w[b, j, i]. Its head has
  d = C (512 at full size), above the attention kernels' d <= 128, and the
  JAX package runs it outside any Pallas kernel: two float32 ``torch.bmm``
  products (TF32 stays off: PyTorch's default for matmuls).

Specs: ``vavae_spec`` (f16d32), ``marvae_spec`` (f16d16, no decoder
attention) and ``sdvae_spec`` (the SD3-style f8d16 of the reference's
diffusers config, no quant convs). ``init_conv_vae_weights_`` draws the JAX
initialisation's distributions from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.conv import conv2d_fp32
from ..ops.gaussian import DiagonalGaussian, diagonal_gaussian


@dataclass(frozen=True)
class ConvVAESpec:
    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    decoder_attn_resolutions: Tuple[int, ...] = (16,)
    in_channels: int = 3
    resolution: int = 256
    z_channels: int = 16
    embed_dim: int = 16
    double_z: bool = True
    use_variational: bool = True
    use_quant_conv: bool = True
    use_post_quant_conv: bool = True
    num_groups: int = 32


def vavae_spec(embed_dim: int = 32) -> ConvVAESpec:
    """VA-VAE f16d32."""
    return ConvVAESpec(z_channels=embed_dim, embed_dim=embed_dim)


def marvae_spec(embed_dim: int = 16) -> ConvVAESpec:
    """MAR-VAE: the VA-VAE encoder, a decoder without attention."""
    return ConvVAESpec(z_channels=embed_dim, embed_dim=embed_dim, decoder_attn_resolutions=())


def sdvae_spec() -> ConvVAESpec:
    """The SD3-style diffusers VAE: block_out_channels (128, 256, 512, 512)
    = ch_mult (1, 2, 4, 4), no attention in the down and up blocks, no quant
    convs, latent 16."""
    return ConvVAESpec(ch=128, ch_mult=(1, 2, 4, 4), attn_resolutions=(), decoder_attn_resolutions=(),
                       z_channels=16, embed_dim=16, use_quant_conv=False, use_post_quant_conv=False)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def _conv(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1, padding: int = 1) -> torch.Tensor:
    return conv2d_fp32(x, conv.weight, conv.bias, stride=stride, padding=padding)


def _group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """Float32 group norm, population variance, eps 1e-6, back to x's dtype."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias, norm.eps).to(x.dtype)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def _norm(c: int, groups: int, device) -> nn.GroupNorm:
    return nn.GroupNorm(groups, c, eps=1e-6, device=device)


def _conv_module(cin: int, cout: int, k: int, device) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, device=device)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, device):
        super().__init__()
        self.norm1 = _norm(cin, groups, device)
        self.conv1 = _conv_module(cin, cout, 3, device)
        self.norm2 = _norm(cout, groups, device)
        self.conv2 = _conv_module(cout, cout, 3, device)
        if cin != cout:
            self.nin_shortcut = _conv_module(cin, cout, 1, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv(_swish(_group_norm(x, self.norm1)), self.conv1)
        h = _conv(_swish(_group_norm(h, self.norm2)), self.conv2)
        if hasattr(self, "nin_shortcut"):
            x = _conv(x, self.nin_shortcut, padding=0)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over the pixels, 1x1-conv projections."""

    def __init__(self, c: int, groups: int, device):
        super().__init__()
        self.norm = _norm(c, groups, device)
        self.q, self.k, self.v, self.proj_out = (_conv_module(c, c, 1, device) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _group_norm(x, self.norm)
        q, k, v = (_conv(h, m, padding=0) for m in (self.q, self.k, self.v))
        b, c, hh, ww = q.shape
        qf = q.reshape(b, c, hh * ww).transpose(1, 2).float()
        w = torch.softmax(torch.bmm(qf, k.reshape(b, c, hh * ww).float()) * c**-0.5, dim=2)
        out = torch.bmm(v.reshape(b, c, hh * ww).float(), w.transpose(1, 2))
        return x + _conv(out.reshape(b, c, hh, ww).to(x.dtype), self.proj_out, padding=0)


class Downsample(nn.Module):
    def __init__(self, c: int, device):
        super().__init__()
        self.conv = _conv_module(c, c, 3, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(F.pad(x, (0, 1, 0, 1)), self.conv, stride=2, padding=0)


class Upsample(nn.Module):
    def __init__(self, c: int, device):
        super().__init__()
        self.conv = _conv_module(c, c, 3, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(F.interpolate(x, scale_factor=2.0, mode="nearest"), self.conv)


class _Mid(nn.Module):
    def __init__(self, c: int, groups: int, device):
        super().__init__()
        self.block_1 = ResnetBlock(c, c, groups, device)
        self.attn_1 = AttnBlock(c, groups, device)
        self.block_2 = ResnetBlock(c, c, groups, device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


class _Level(nn.Module):
    """One resolution: its resnet blocks, each with an attention block when
    the resolution is listed (``attn``), then the resampling."""

    def __init__(self, cin: int, cout: int, n_blocks: int, with_attn: bool, groups: int, device):
        super().__init__()
        self.block = nn.ModuleList(ResnetBlock(cin if i == 0 else cout, cout, groups, device) for i in range(n_blocks))
        self.attn = nn.ModuleList(AttnBlock(cout, groups, device) for _ in range(n_blocks if with_attn else 0))

    def run_blocks(self, h: torch.Tensor) -> torch.Tensor:
        for i, blk in enumerate(self.block):
            h = blk(h)
            if len(self.attn):
                h = self.attn[i](h)
        return h


class Encoder(nn.Module):
    def __init__(self, spec: ConvVAESpec, device):
        super().__init__()
        g, ch, n_lv = spec.num_groups, spec.ch, len(spec.ch_mult)
        in_mult = (1,) + tuple(spec.ch_mult)
        self.conv_in = _conv_module(spec.in_channels, ch, 3, device)
        self.down = nn.ModuleList()
        res = spec.resolution
        for i in range(n_lv):
            level = _Level(ch * in_mult[i], ch * spec.ch_mult[i], spec.num_res_blocks, res in spec.attn_resolutions,
                           g, device)
            if i != n_lv - 1:
                level.downsample = Downsample(ch * spec.ch_mult[i], device)
                res //= 2
            self.down.append(level)
        c = ch * spec.ch_mult[-1]
        self.mid = _Mid(c, g, device)
        self.norm_out = _norm(c, g, device)
        self.conv_out = _conv_module(c, 2 * spec.z_channels if spec.double_z else spec.z_channels, 3, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv(x, self.conv_in)
        for level in self.down:
            h = level.run_blocks(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return _conv(_swish(_group_norm(h, self.norm_out)), self.conv_out)


class Decoder(nn.Module):
    def __init__(self, spec: ConvVAESpec, device):
        super().__init__()
        g, ch, n_lv = spec.num_groups, spec.ch, len(spec.ch_mult)
        c = ch * spec.ch_mult[-1]
        self.conv_in = _conv_module(spec.z_channels, c, 3, device)
        self.mid = _Mid(c, g, device)
        levels = [None] * n_lv
        res = spec.resolution // 2 ** (n_lv - 1)
        for i in reversed(range(n_lv)):
            cout = ch * spec.ch_mult[i]
            level = _Level(c, cout, spec.num_res_blocks + 1, res in spec.decoder_attn_resolutions, g, device)
            c = cout
            if i != 0:
                level.upsample = Upsample(c, device)
                res *= 2
            levels[i] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = _norm(c, g, device)
        self.conv_out = _conv_module(c, spec.out_ch, 3, device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(_conv(z, self.conv_in))
        for level in reversed(self.up):
            h = level.run_blocks(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return _conv(_swish(_group_norm(h, self.norm_out)), self.conv_out)


class ConvVAE(nn.Module):
    """``AutoencoderKL``: encoder, decoder and the optional 1x1
    ``quant_conv`` / ``post_quant_conv``. Images are (B, 3, H, W) float32 in
    [-1, 1]; latents (B, embed_dim, H / f, W / f)."""

    def __init__(self, spec: ConvVAESpec, device=None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        self.encoder = Encoder(spec, device)
        self.decoder = Decoder(spec, device)
        if spec.use_quant_conv:
            mult = 2 if spec.use_variational else 1
            self.quant_conv = _conv_module(2 * spec.embed_dim, mult * spec.embed_dim, 1, device)
        if spec.use_post_quant_conv:
            self.post_quant_conv = _conv_module(spec.embed_dim, spec.embed_dim, 1, device)

    @torch.no_grad()
    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """The raw posterior moments (B, 2 embed_dim, h, w) float32 (ones for
        the log-variance half when the spec is not variational)."""
        moments = self.encoder(x.float())
        if self.spec.use_quant_conv:
            moments = _conv(moments, self.quant_conv, padding=0)
        if not self.spec.use_variational:
            moments = torch.cat([moments, torch.ones_like(moments)], dim=1)
        return moments

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return diagonal_gaussian(self.encode_moments(x), axis=1)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, embed_dim, h, w) -> (B, 3, H, W) float32 in about [-1, 1]."""
        z = z.float()
        if self.spec.use_post_quant_conv:
            z = _conv(z, self.post_quant_conv, padding=0)
        return self.decoder(z)

    def decode_to_images(self, z: torch.Tensor) -> torch.Tensor:
        """decode -> uint8 (B, H, W, 3): clamp(127.5 x + 128, 0, 255)."""
        imgs = torch.clamp(127.5 * self.decode(z) + 128.0, 0, 255)
        return imgs.permute(0, 2, 3, 1).to(torch.uint8)


@torch.no_grad()
def init_conv_vae_weights_(model: ConvVAE, generator: torch.Generator) -> ConvVAE:
    """The JAX package's initialisation (``init_conv_vae_params``): every
    convolution's weight and bias uniform in +-sqrt(1 / (C_in k k)), group
    norms at scale 1 and bias 0. The draws come from ``generator`` on the
    CPU, in module order; they are not the JAX package's (the generators
    differ)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            cout, cin, kh, kw = m.weight.shape
            a = math.sqrt(1.0 / (cin * kh * kw))
            for t in (m.weight, m.bias):
                t.copy_(torch.empty(t.shape).uniform_(-a, a, generator=generator))
        elif isinstance(m, nn.GroupNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return model


def _torch_load(path: str):
    # a trusted file the user points at; reference checkpoints pickle more
    # than tensors, which a weights-only load refuses
    return torch.load(path, map_location="cpu", weights_only=False)


def load_ldm_state_dict_(model: ConvVAE, sd) -> ConvVAE:
    """Load the model's own keys from an LDM-naming state dict, as the JAX
    package's ``import_conv_vae_state_dict`` reads them: a key the model
    has and ``sd`` lacks raises ``KeyError``; other keys in ``sd`` are
    ignored."""
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"conv VAE checkpoint lacks {missing[:5]}{' ...' if len(missing) > 5 else ''}")
    model.load_state_dict({k: sd[k] for k in own}, strict=True)
    return model


def load_vavae(ckpt_path: str, embed_dim: int = 32, device=None) -> ConvVAE:
    """VA-VAE from a checkpoint's ``state_dict``, its ``loss`` keys dropped."""
    sd = _torch_load(ckpt_path)["state_dict"]
    return load_ldm_state_dict_(ConvVAE(vavae_spec(embed_dim), device=device),
                                {k: v for k, v in sd.items() if "loss" not in k})


def load_marvae(ckpt_path: str, embed_dim: int = 16, device=None) -> ConvVAE:
    """MAR-VAE from a checkpoint's ``model``."""
    return load_ldm_state_dict_(ConvVAE(marvae_spec(embed_dim), device=device), _torch_load(ckpt_path)["model"])
