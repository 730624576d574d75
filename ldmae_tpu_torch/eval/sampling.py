"""End-to-end class-conditional sampling (port of ``ldmae_tpu/eval/sampling.py``).

The ODE (Euler, Heun, RK4 or adaptive dopri5) or the SDE (Euler-Maruyama
or Heun, then the ``sde_last_step`` rule) with CFG batch doubling, the
latent denormalisation ``samples * latent_std / latent_multiplier +
latent_mean`` and the decode to uint8 images: by the VMAE, or by any
tokenizer through ``vae_decode_images_fn``
(``models.tokenizers.build_tokenizer_fns``). Phased CFG (Euler ODE only, as
in the JAX package): below ``cfg_interval_start`` guidance is inactive, so
the leading steps of the static Euler grid run at single batch and the
batch doubles at the phase boundary ``n1``. Every other method doubles the
batch over the whole grid.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.lightningdit import DiTSpec
from ..transport.samplers import Sampler, forward_with_cfg
from ..transport.transport import Transport

DEMO_LABELS = (975, 3, 207, 387, 388, 88, 979, 279)


def make_sample_fn(
    spec: DiTSpec,
    transport: Transport,
    *,
    num_steps: int = 250,
    sampling_method: str = "euler",
    timestep_shift: float = 0.0,
    cfg_scale: float = 1.0,
    cfg_interval: bool = True,
    cfg_interval_start: float = 0.10,
    cfg_channels: int = 3,
    truncation: Optional[float] = None,
    mode: str = "ODE",
    sde_last_step: Optional[str] = "Mean",
    latent_multiplier: float = 1.0,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "xla",
    rope_layout: str = "interleaved",
    adaln_impl: str = "xla",
    quant_mode: Optional[str] = None,
    mlp_impl: str = "xla",
    cfg_phase_split: bool = True,
    vae_decode_images_fn: Optional[Callable] = None,
    device=None,
) -> Callable[..., torch.Tensor]:
    """Build sample_fn(bundle, y, z=None, generator=None) -> uint8 images
    (B, H, W, 3) when the bundle has a VAE, else denormalised latents
    (B, C, h, w) in float32.

    bundle: {"dit": LightningDiT, "vae": VMAE, a tokenizer's module or None,
             "latent_mean": (1, C, 1, 1) tensor or None, "latent_std": ...}
    ``vae_decode_images_fn(vae, latents)`` -> uint8 images decodes with
    bundle["vae"] when given (the sampling CLI passes its tokenizer's
    ``decode_to_images``); otherwise the VMAE decodes in ``compute_dtype``
    with ``attn_impl``.
    y: (B,) int labels; CFG doubles the batch internally when cfg_scale > 1,
    with the null label num_classes. ``z`` overrides the initial noise,
    otherwise it is drawn in float32 from ``generator``. ``mode="SDE"``
    draws its per-step noise from ``generator`` after z (a batch sampled
    from a generator seeded alike is the same batch), or takes it from
    ``sde_noise``: num_steps - 1 draws of the integrated state's shape
    (the doubled batch under CFG) in ``compute_dtype``. ``quant_mode``
    ('w8' | 'w8a8') needs a DiT transformed by ``models.quantize_dit_``.
    """
    device = resolve_device(device)
    sampler = Sampler(transport)
    use_cfg = cfg_scale > 1.0
    sde = mode.upper() == "SDE"
    if sde:
        integrate = sampler.sample_sde(
            sampling_method=sampling_method.capitalize(), num_steps=num_steps, last_step=sde_last_step
        )
    else:
        integrate = sampler.sample_ode(
            sampling_method=sampling_method, num_steps=num_steps, timestep_shift=timestep_shift
        )
    phase1_fn = phase2_fn = None
    if (
        not sde and cfg_phase_split and use_cfg and cfg_interval
        and sampling_method == "euler" and cfg_interval_start is not None
    ):
        grid = sampler.ode_time_grid(num_steps, timestep_shift)
        n1 = int(np.searchsorted(grid[:-1], cfg_interval_start))
        if 0 < n1 < num_steps - 1:
            phase1_fn = sampler.sample_ode(sampling_method="euler", t_grid=grid[: n1 + 1])
            phase2_fn = sampler.sample_ode(sampling_method="euler", t_grid=grid[n1:])

    @torch.inference_mode()
    def sample_fn(
        bundle: Dict[str, Any],
        y: torch.Tensor,
        z: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        sde_noise=None,
    ) -> torch.Tensor:
        dit = bundle["dit"]

        def model_fn(x, t, y):
            return dit(
                x, t, y, compute_dtype=compute_dtype, attn_impl=attn_impl,
                rope_layout=rope_layout, adaln_impl=adaln_impl, mlp_impl=mlp_impl,
                quant_mode=quant_mode,
            ).to(x.dtype)

        def guided_fn(x, t, y):
            return forward_with_cfg(
                model_fn, x, t, y, cfg_scale, cfg_interval=cfg_interval,
                cfg_interval_start=cfg_interval_start, cfg_channels=cfg_channels,
            )

        y = y.to(device)
        b, h = y.shape[0], spec.input_size
        if z is not None:
            z = torch.as_tensor(z, dtype=torch.float32).to(device).to(compute_dtype)
        else:
            z = torch.empty(b, spec.in_channels, h, h, dtype=torch.float32, device=device)
            if truncation is not None:
                # limiting law of the reference's resample-until-in-bounds loop
                torch.nn.init.trunc_normal_(z, a=-truncation, b=truncation, generator=generator)
            else:
                z.normal_(generator=generator)
            z = z.to(compute_dtype)

        def run(z0, fn, y_arg):
            if sde:
                return integrate(z0, fn, noise=sde_noise, generator=generator, y=y_arg)
            return integrate(z0, fn, y=y_arg)

        if use_cfg:
            y_all = torch.cat([y, torch.full_like(y, spec.num_classes)], dim=0)
            if phase1_fn is not None:
                z1 = phase1_fn(z, model_fn, y=y)  # sub-threshold steps, cond only
                samples = phase2_fn(torch.cat([z1, z1], dim=0), guided_fn, y=y_all)[:b]
            else:
                samples = run(torch.cat([z, z], dim=0), guided_fn, y_all)[:b]
        else:
            samples = run(z, model_fn, y)

        samples = samples.float()
        if bundle.get("latent_std") is not None:
            samples = samples * bundle["latent_std"].to(device) / latent_multiplier
        if bundle.get("latent_mean") is not None:
            samples = samples + bundle["latent_mean"].to(device)
        vae = bundle.get("vae")
        if vae is None:
            return samples
        if vae_decode_images_fn is not None:
            return vae_decode_images_fn(vae, samples)
        return vae.decode_to_images(samples, compute_dtype=compute_dtype, attn_impl=attn_impl)

    return sample_fn


def demo_labels(device=None) -> torch.Tensor:
    """The reference's fixed 8-class demo grid."""
    return torch.tensor(DEMO_LABELS, dtype=torch.int64, device=resolve_device(device))
