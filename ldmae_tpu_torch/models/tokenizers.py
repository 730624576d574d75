"""Tokenizer dispatch and wrapper classes (port of ``ldmae_tpu/models/tokenizers.py``).

``build_tokenizer_fns(model_name, weight_path, img_size)`` is what the
sampling, extraction and tokenizer-evaluation CLIs build from
``vae.model_name``, by the reference's family rule
``model_name.split("_")[0]``: ``vmae*`` the production VMAE f8d16_prev;
``ae``, ``dae``, ``vae`` and ``sdv3`` the SD-VAE; ``vavae`` and ``marvae``
the conv VAEs. Any other name raises ``ValueError``; a ``weight_path`` that
is given and names no file raises ``FileNotFoundError``; an empty one means
seeded random weights (with a warning). The VMAE's functions take
``compute_dtype`` and ``attn_impl``; the conv VAEs ignore both and run in
float32, as the JAX package does.

The wrappers ``VMAE_Tokenizer``, ``VA_VAE``, ``MAR_VAE`` and ``SD_VAE``
(``build_tokenizer``) are the reference's user-facing API:
``img_transform``, ``encode_images`` (a posterior sample with fresh noise
from the wrapper's seeded ``torch.Generator`` on each call; the SD-VAE's
mode) and ``decode_to_images`` (uint8 HWC numpy).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import resolve_device

# the reference's SD-VAE family names
SDVAE_NAMES = ("ae", "dae", "vae", "sdv3")


class _Base:
    def __init__(self, model, img_size: int, device: torch.device, latent_dim: int):
        self.model, self.img_size, self.device, self.latent_dim = model, img_size, device, latent_dim
        # the posterior noise: fresh on every encode, from one seeded
        # generator (the JAX package splits a key on each call)
        self._gen = torch.Generator(device=device).manual_seed(0)

    def img_transform(self, p_hflip: float = 0, img_size: Optional[int] = None,
                      seed: Optional[int] = None) -> Callable:
        """fn(PIL image) -> (3, S, S) float32 in [-1, 1]: the ADM center
        crop, a horizontal flip with probability ``p_hflip`` (from a numpy
        generator seeded with ``seed``), Normalize(0.5, 0.5)."""
        from ..data.images import center_crop_arr

        size = img_size or self.img_size
        rng = np.random.default_rng(seed)

        def tf(pil_image) -> np.ndarray:
            from PIL import Image

            img = center_crop_arr(pil_image, size)
            if p_hflip > 0 and rng.uniform() < p_hflip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
            return ((arr - 0.5) / 0.5).transpose(2, 0, 1)

        return tf

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images, dtype=torch.float32, device=self.device)


class VMAE_Tokenizer(_Base):
    """A VMAE tokenizer (the production arch unless ``arch`` names another)
    in the docking configuration; encode and decode in bf16, ``xla``
    attention."""

    def __init__(self, weight_path: Optional[str] = None, img_size: int = 256,
                 arch: str = "mae_for_ldmae_f8d16_prev", device=None, seed: int = 1):
        from .vmae import load_vmae, vmae_spec

        device = resolve_device(device)
        spec = vmae_spec(arch, img_size=img_size, ldmae_mode=True, no_cls=True, kl_loss_weight=True,
                         smooth_output=True)
        super().__init__(load_vmae(spec, weight_path or "", device, seed), img_size, device, spec.latent_dim)

    def encode_images(self, images, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.model.encode(self._images(images), compute_dtype=torch.bfloat16).sample(
            generator=generator or self._gen)

    def decode_to_images(self, z) -> np.ndarray:
        return self.model.decode_to_images(self._images(z), compute_dtype=torch.bfloat16).cpu().numpy()


class _ConvVAEWrapper(_Base):
    def __init__(self, model, img_size: int, device: torch.device):
        super().__init__(model, img_size, device, model.spec.embed_dim)

    def encode_images(self, images, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.model.encode(self._images(images)).sample(generator=generator or self._gen)

    def decode_to_images(self, z) -> np.ndarray:
        return self.model.decode_to_images(self._images(z)).cpu().numpy()


class VA_VAE(_ConvVAEWrapper):
    """VA-VAE f16d32."""

    def __init__(self, ckpt_path: Optional[str] = None, img_size: int = 256, embed_dim: int = 32, device=None,
                 seed: int = 1):
        from . import conv_vae as cv

        device = resolve_device(device)
        model = _load_or_init(ckpt_path, lambda p: cv.load_vavae(p, embed_dim, device),
                              lambda: _seeded_conv(cv.vavae_spec(embed_dim), device, seed), "VA-VAE")
        super().__init__(model, img_size, device)


class MAR_VAE(_ConvVAEWrapper):
    """MAR-VAE f16d16 (no decoder attention)."""

    def __init__(self, ckpt_path: Optional[str] = None, img_size: int = 256, embed_dim: int = 16, device=None,
                 seed: int = 1):
        from . import conv_vae as cv

        device = resolve_device(device)
        model = _load_or_init(ckpt_path, lambda p: cv.load_marvae(p, embed_dim, device),
                              lambda: _seeded_conv(cv.marvae_spec(embed_dim), device, seed), "MAR-VAE")
        super().__init__(model, img_size, device)


class SD_VAE(_ConvVAEWrapper):
    """The diffusers SD3-config VAE; ``encode_images`` is the posterior's
    mode, as the reference's diffusers wrapper takes it."""

    def __init__(self, ckpt_path: Optional[str] = None, img_size: int = 256, device=None, seed: int = 1):
        from . import conv_vae as cv
        from .sdvae_import import load_sdvae

        device = resolve_device(device)
        model = _load_or_init(ckpt_path, lambda p: load_sdvae(p, device),
                              lambda: _seeded_conv(cv.sdvae_spec(), device, seed), "SD-VAE")
        super().__init__(model, img_size, device)

    def encode_images(self, images, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.model.encode(self._images(images)).mode()


class TokenizerFns:
    """The functional tokenizer interface of the CLIs. Every function takes
    the tokenizer's module first (``model``, where the JAX package passes
    its parameter tree) and ``compute_dtype`` / ``attn_impl`` keywords,
    which the conv VAEs ignore:

    - ``encode_moments(model, x)`` -> (B, 2 latent_dim, h, w) float32 raw
      posterior moments of (B, 3, H, W) images in [-1, 1];
    - ``decode(model, z)`` -> (B, 3, H, W) float32 in about [-1, 1];
    - ``decode_to_images(model, z)`` -> (B, H, W, 3) uint8.
    """

    def __init__(self, name, model, latent_dim, encode_moments, decode, decode_to_images):
        self.name = name
        self.model = model
        self.latent_dim = latent_dim
        self.encode_moments = encode_moments
        self.decode = decode
        self.decode_to_images = decode_to_images


def _load_or_init(weight_path, load_fn, init_fn, what):
    """A path that is given and names no file raises; an empty one means
    seeded random weights."""
    if weight_path:
        if not os.path.exists(weight_path):
            raise FileNotFoundError(f"tokenizer checkpoint not found: {weight_path}")
        return load_fn(weight_path)
    print(f"WARNING: no {what} tokenizer weights given, using seeded random weights")
    return init_fn()


def _seeded_conv(spec, device, seed: int):
    from .conv_vae import ConvVAE, init_conv_vae_weights_

    return init_conv_vae_weights_(ConvVAE(spec, device=device), torch.Generator().manual_seed(seed))


def build_tokenizer_fns(model_name: str, weight_path: str = "", img_size: int = 256, device=None,
                        seed: int = 1) -> TokenizerFns:
    """The tokenizer ``model_name`` names (family ``model_name.split("_")[0]``),
    its weights from ``weight_path`` or seeded from ``seed``."""
    family = model_name.split("_")[0]
    device = resolve_device(device)
    if family == "vmae":
        from .vmae import load_production_vmae

        # every vmae* name builds the production arch, as the reference does
        vae = load_production_vmae(weight_path, img_size, device, seed)
        return TokenizerFns(
            model_name, vae, vae.spec.latent_dim,
            encode_moments=lambda m, x, compute_dtype=torch.bfloat16, attn_impl="xla":
                m.ldmae_encode_moments(x, compute_dtype, attn_impl),
            decode=lambda m, z, compute_dtype=torch.bfloat16, attn_impl="xla": m.decode(z, compute_dtype, attn_impl),
            decode_to_images=lambda m, z, compute_dtype=torch.bfloat16, attn_impl="xla":
                m.decode_to_images(z, compute_dtype, attn_impl),
        )

    from . import conv_vae as cv

    if family in SDVAE_NAMES:
        from .sdvae_import import load_sdvae

        spec, load, what = cv.sdvae_spec(), lambda p: load_sdvae(p, device), "SD-VAE"
    elif family == "vavae":
        spec, load, what = cv.vavae_spec(), lambda p: cv.load_vavae(p, device=device), "VA-VAE"
    elif family == "marvae":
        spec, load, what = cv.marvae_spec(), lambda p: cv.load_marvae(p, device=device), "MAR-VAE"
    else:
        raise ValueError(f"unknown tokenizer {model_name!r}")
    model = _load_or_init(weight_path, load, lambda: _seeded_conv(spec, device, seed), what)
    return TokenizerFns(
        model_name, model, spec.embed_dim,
        encode_moments=lambda m, x, compute_dtype=None, attn_impl=None: m.encode_moments(x),
        decode=lambda m, z, compute_dtype=None, attn_impl=None: m.decode(z),
        decode_to_images=lambda m, z, compute_dtype=None, attn_impl=None: m.decode_to_images(z),
    )


def build_tokenizer(model_name: str, weight_path: str = "", img_size: int = 256, device=None):
    """The reference's tokenizer factory: ``vmae`` / ``vmae_f8d16`` the
    production VMAE, ``vmae_<arch>`` or ``<arch>`` of the VMAE registry that
    arch (another ``vmae*`` name raises), ``vavae``, ``marvae``, and the
    SD-VAE names."""
    if model_name.startswith("vmae"):
        from .vmae import _FACTORIES

        arch = "mae_for_ldmae_f8d16_prev"
        if model_name not in ("vmae", "vmae_f8d16"):
            cand = model_name[len("vmae_"):] if model_name.startswith("vmae_") else model_name
            if cand not in _FACTORIES:
                raise ValueError(f"unknown VMAE tokenizer arch {model_name!r}")
            arch = cand
        return VMAE_Tokenizer(weight_path, img_size, arch=arch, device=device)
    if model_name == "vavae":
        return VA_VAE(weight_path, img_size, device=device)
    if model_name == "marvae":
        return MAR_VAE(weight_path, img_size, device=device)
    if model_name in SDVAE_NAMES:
        return SD_VAE(weight_path, img_size, device=device)
    raise ValueError(f"unknown tokenizer {model_name!r}")
