"""VMAE variants and probes (port of ``ldmae_tpu/models/vmae_variants.py``).

* ``GradualVMAE``, the ``gradual_resol`` model: the patch is half the arch's
  (the caller passes the halved spec, as the reference's constructor halves
  it), the encoder reinserts the mask tokens before its blocks
  (``forward_encoder_with_mask``) and a stride-2 3x3 convolution on the
  token grid (``TokenDownsample``) sits after ``downsample_after`` blocks;
  the decoder runs on the downsampled grid without unshuffling
  (``forward_decoder_without_mask``) with a nearest-x2 upsample and a 3x3
  convolution (``TokenUpsample``) after ``upsample_after`` blocks. The two
  convolutions sit in the ``blocks`` / ``decoder_blocks`` ModuleLists at
  those indices (``blocks.{downsample_after}.conv``), as in the reference's
  checkpoints, which therefore load as they are. The encoder's positional
  table is on the half-patch grid, the decoder's on that grid // 2
  (``GradualConsts``). ``forward_vanilla_gradual`` is its stage-1 training
  forward, ``VMAE.forward_vanilla`` with these encoder and decoder.
* ``vit_block``: the ViT block with LayerScale (``ls1`` / ``ls2``,
  ``add_layer_scale_``) and DropPath (a per-sample residual drop, drawn
  from an explicit ``torch.Generator`` before the block runs, so a
  recomputation under ``use_checkpoint`` sees the same masks; off when the
  block is in eval mode or no generator is given), or with the attention
  maps of ``attention_with_maps`` (the pre-softmax q k^T scale and the
  context).
* The linear probes: ``init_probe_head`` (LayerNorm, then a bias-free
  linear), ``linear_probe`` (global pool of the frozen encoder's latent)
  and ``linear_probe_seg`` (per token).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops import dense, get_2d_sincos_pos_embed, layer_norm, mlp_gelu, multi_head_attention
from ..ops.conv import conv2d_fp32
from ..ops.gaussian import diagonal_gaussian
from ..ops.masking import random_masking, unshuffle_with_mask_tokens
from ..ops.patchify import patch_embed
from .vmae import VMAE, VMAESpec, VitBlock, init_vmae_weights_


# ---------------------------------------------------------------------------
# Block with LayerScale / DropPath / attention maps
# ---------------------------------------------------------------------------


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1e-5, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values), device=device))


def add_layer_scale_(block: VitBlock, init_values: float = 1e-5) -> VitBlock:
    """Give ``block`` the reference's LayerScale on both residual branches
    (``ls1.gamma``, ``ls2.gamma``)."""
    d, dev = block.norm1.weight.shape[0], block.norm1.weight.device
    block.ls1 = LayerScale(d, init_values, dev)
    block.ls2 = LayerScale(d, init_values, dev)
    return block


def drop_path_mask(batch: int, drop_path_rate: float, generator: torch.Generator, device, dtype) -> torch.Tensor:
    """(batch, 1, 1): 1 / keep for a kept sample, 0 for a dropped one, each
    kept with probability keep = 1 - drop_path_rate."""
    keep = 1.0 - drop_path_rate
    u = torch.rand(batch, 1, 1, generator=generator, device=device)
    return (u < keep).to(dtype) / keep


def _block_body(x: torch.Tensor, block: VitBlock, num_heads: int, masks, attn_impl: str, return_attn_map: bool):
    h = layer_norm(x, block.norm1.weight, block.norm1.bias, eps=1e-6)
    maps = None
    if return_attn_map:
        out, maps = attention_with_maps(h, block.attn, num_heads)
    else:
        out = multi_head_attention(h, block.attn, num_heads, impl=attn_impl)
    if hasattr(block, "ls1"):
        out = out * block.ls1.gamma.to(out.dtype)
    x = x + (out if masks is None else out * masks[0])
    h = layer_norm(x, block.norm2.weight, block.norm2.bias, eps=1e-6)
    out = mlp_gelu(h, block.mlp.fc1, block.mlp.fc2)
    if hasattr(block, "ls2"):
        out = out * block.ls2.gamma.to(out.dtype)
    x = x + (out if masks is None else out * masks[1])
    return (x, maps) if return_attn_map else x


def vit_block(x: torch.Tensor, block: VitBlock, num_heads: int, *, drop_path_rate: float = 0.0,
              generator: Optional[torch.Generator] = None, return_attn_map: bool = False, attn_impl: str = "xla",
              use_checkpoint: bool = False):
    """The pre-LN ViT block (eps 1e-6, exact GELU) with LayerScale when the
    block has it and DropPath at ``drop_path_rate`` when the block is in
    training mode and ``generator`` is given (its two masks drawn before the
    block runs). ``return_attn_map``: also [logits, context] of
    ``attention_with_maps``. ``use_checkpoint``: the block's activations are
    recomputed in the backward, with the same masks."""
    masks = None
    if drop_path_rate > 0.0 and generator is not None and block.training:
        masks = [drop_path_mask(x.shape[0], drop_path_rate, generator, x.device, x.dtype) for _ in range(2)]
    if use_checkpoint and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(_block_body, x, block, num_heads, masks, attn_impl, return_attn_map,
                                                 use_reentrant=False)
    return _block_body(x, block, num_heads, masks, attn_impl, return_attn_map)


def attention_with_maps(x: torch.Tensor, attn: nn.Module, num_heads: int):
    """Multi-head attention returning (out, [pre-softmax q k^T scale (B, H,
    N, N), context (B, N, D)]); qkv as a plain product in x's dtype, the
    output projection through ``dense``."""
    b, n, d = x.shape
    hd = d // num_heads
    qkv = (x @ attn.qkv.weight.t().to(x.dtype) + attn.qkv.bias.to(x.dtype)).reshape(b, n, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * hd**-0.5
    ctx = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)
    ctx = ctx.transpose(1, 2).reshape(b, n, d)
    return dense(ctx, attn.proj.weight, attn.proj.bias), [logits, ctx]


# ---------------------------------------------------------------------------
# Token-grid Downsample / Upsample
# ---------------------------------------------------------------------------


def _grid(x: torch.Tensor) -> torch.Tensor:
    b, n, c = x.shape
    h = int(round(n**0.5))
    return x.reshape(b, h, h, c).permute(0, 3, 1, 2).float()


def _tokens(grid: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b, c, h, w = grid.shape
    return grid.reshape(b, c, h * w).transpose(1, 2).to(dtype)


def token_downsample(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """(B, N, C) -> (B, N / 4, C): the (0, 1, 0, 1) pad and a stride-2
    convolution without padding, in float32."""
    out = conv2d_fp32(F.pad(_grid(x), (0, 1, 0, 1)), conv.weight, conv.bias, stride=2)
    return _tokens(out, x.dtype)


def token_upsample(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """(B, N, C) -> (B, 4 N, C): nearest x2, then a 3x3 convolution with
    padding 1, in float32."""
    out = conv2d_fp32(F.interpolate(_grid(x), scale_factor=2.0, mode="nearest"), conv.weight, conv.bias, padding=1)
    return _tokens(out, x.dtype)


class TokenDownsample(nn.Module):
    def __init__(self, c: int, device):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return token_downsample(x, self.conv)


class TokenUpsample(nn.Module):
    def __init__(self, c: int, device):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return token_upsample(x, self.conv)


# ---------------------------------------------------------------------------
# gradual_resol
# ---------------------------------------------------------------------------


class GradualConsts:
    """The positional tables: the encoder's on the half-patch grid, the
    decoder's on grid // 2 (after the downsample)."""

    def __init__(self, spec: VMAESpec, device):
        self.pos_embed = torch.from_numpy(get_2d_sincos_pos_embed(spec.embed_dim, spec.grid)).to(device)
        self.decoder_pos_embed = torch.from_numpy(
            get_2d_sincos_pos_embed(spec.decoder_embed_dim, spec.grid // 2)).to(device)


class GradualVMAE(VMAE):
    """The ``gradual_resol`` VMAE. ``spec`` carries the halved patch;
    ``downsample_after`` defaults to depth // 2 (the reference's
    ``finetune_downsample_layer`` overrides it) and ``upsample_after`` to
    decoder_depth - downsample_after."""

    def __init__(self, spec: VMAESpec, downsample_after: Optional[int] = None, upsample_after: Optional[int] = None,
                 device=None):
        super().__init__(spec, device)
        device = self.pos_embed.device
        self.downsample_after = spec.depth // 2 if downsample_after is None else downsample_after
        self.upsample_after = spec.decoder_depth - self.downsample_after if upsample_after is None else upsample_after
        self.consts = GradualConsts(spec, device)
        self.pos_embed = self.consts.pos_embed[None].clone()
        self.decoder_pos_embed = self.consts.decoder_pos_embed[None].clone()
        if not hasattr(self, "mask_token"):
            self.mask_token = nn.Parameter(torch.zeros(1, 1, spec.decoder_embed_dim, device=device))
        blocks = list(self.blocks)
        blocks.insert(self.downsample_after, TokenDownsample(spec.embed_dim, device))
        self.blocks = nn.ModuleList(blocks)
        blocks = list(self.decoder_blocks)
        blocks.insert(self.upsample_after, TokenUpsample(spec.decoder_embed_dim, device))
        self.decoder_blocks = nn.ModuleList(blocks)

    def _run_blocks(self, x: torch.Tensor, blocks: nn.ModuleList, num_heads: int, attn_impl: str) -> torch.Tensor:
        """The ViT blocks (recomputed in the backward with
        ``spec.use_checkpoint``) and the token convolution among them."""
        for blk in blocks:
            if isinstance(blk, (TokenDownsample, TokenUpsample)):
                x = blk(x)
            else:
                x = super()._run_blocks(x, [blk], num_heads, attn_impl)
        return x

    def forward_encoder_with_mask(self, imgs: torch.Tensor, mask_ratio: float, mask_noise: torch.Tensor,
                                  compute_dtype: torch.dtype = torch.float32, attn_impl: str = "xla"):
        """Patchify, mask by ``mask_noise``, reinsert the mask tokens, + PE,
        the blocks (with the downsample), the norm. Returns (x on the /2
        grid, mask (B, L), ids_restore)."""
        spec = self.spec
        pe_w = self.patch_embed.proj
        x = patch_embed(imgs.to(compute_dtype), pe_w.weight, pe_w.bias, spec.patch_size, compute_dtype=compute_dtype)
        x, mask, ids_restore = random_masking(x, mask_ratio, mask_noise)
        x = unshuffle_with_mask_tokens(x, self.mask_token, ids_restore)
        x = x + self.consts.pos_embed.to(x.dtype)[None]
        x = self._run_blocks(x, self.blocks, spec.num_heads, attn_impl)
        return layer_norm(x, self.norm.weight, self.norm.bias, eps=1e-6), mask, ids_restore

    def forward_decoder_without_mask(self, x: torch.Tensor, attn_impl: str = "xla") -> torch.Tensor:
        """decoder_embed, + the /2 grid's PE, the blocks (with the
        upsample), the norm and the pred head: (B, L, p*p*3)."""
        x = dense(x, self.decoder_embed.weight, self.decoder_embed.bias)
        return self._decode(x + self.consts.decoder_pos_embed.to(x.dtype)[None], attn_impl)

    # ``VMAE.forward_vanilla`` runs these two: it is the gradual stage-1 forward
    forward_encoder = forward_encoder_with_mask

    def forward_decoder(self, x: torch.Tensor, ids_restore: torch.Tensor, attn_impl: str = "xla") -> torch.Tensor:
        return self.forward_decoder_without_mask(x, attn_impl)


def forward_vanilla_gradual(model: GradualVMAE, imgs: torch.Tensor, **kw) -> Dict[str, torch.Tensor]:
    """Stage-1 training forward of the gradual model: ``VMAE.forward_vanilla``
    (its arguments, losses and outputs) through ``forward_encoder_with_mask``
    and ``forward_decoder_without_mask``; the latent noise is (B,
    latent_dim, L / 4)."""
    if not isinstance(model, GradualVMAE):
        raise TypeError(f"forward_vanilla_gradual needs a GradualVMAE, not {type(model).__name__}")
    return model.forward_vanilla(imgs, **kw)


@torch.no_grad()
def init_gradual_weights_(model: GradualVMAE, generator: torch.Generator) -> GradualVMAE:
    """``init_vmae_weights_``, then the two token convolutions as the JAX
    package draws them: weights normal x 1 / sqrt(9 C), zero biases."""
    init_vmae_weights_(model, generator)
    for blk in (model.blocks[model.downsample_after], model.decoder_blocks[model.upsample_after]):
        w = blk.conv.weight
        w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(9 * w.shape[0]))
        nn.init.zeros_(blk.conv.bias)
    return model


# ---------------------------------------------------------------------------
# Linear probes
# ---------------------------------------------------------------------------


class ProbeHead(nn.Module):
    def __init__(self, latent_dim: int, num_classes: int, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(latent_dim, device=device)
        self.linear = nn.Linear(latent_dim, num_classes, bias=False, device=device)


@torch.no_grad()
def init_probe_head(latent_dim: int, num_classes: int, generator: torch.Generator, device=None) -> ProbeHead:
    """A unit LayerNorm and a bias-free linear with weights normal x
    latent_dim^-1/2."""
    head = ProbeHead(latent_dim, num_classes, device)
    w = head.linear.weight
    w.copy_(torch.randn(w.shape, generator=generator) * latent_dim**-0.5)
    return head


def _probe_tokens(model: VMAE, images: torch.Tensor) -> torch.Tensor:
    """The frozen encoder's latent (the posterior's mode when variational)
    as (B, N, latent_dim) tokens."""
    z = model.ldmae_encode_moments(images)
    if model.spec.kl_loss_weight is not None:
        z = diagonal_gaussian(z, axis=1).mode()
    b, c, h, w = z.shape
    return z.reshape(b, c, h * w).transpose(1, 2)


def linear_probe(model: VMAE, head: ProbeHead, images: torch.Tensor) -> torch.Tensor:
    """Classification probe: encode, mean over the tokens, LayerNorm, the
    bias-free linear. (B, num_classes)."""
    x = _probe_tokens(model, images).mean(dim=1)
    return dense(layer_norm(x, head.norm.weight, head.norm.bias), head.linear.weight)


def linear_probe_seg(model: VMAE, head: ProbeHead, images: torch.Tensor) -> torch.Tensor:
    """Segmentation probe, per token: (B N, num_classes)."""
    x = _probe_tokens(model, images)
    x = x.reshape(-1, x.shape[-1])
    return dense(layer_norm(x, head.norm.weight, head.norm.bias), head.linear.weight)
