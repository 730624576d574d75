"""ODE samplers and classifier-free guidance (port of
``ldmae_tpu/transport/samplers.py``; the SDE samplers and dopri5 come later).

Numerics kept from the JAX package:
  * grid = linspace(t0, t1, num_steps) in float64, optionally warped by
    t' = s*t / (1 + (s-1)*t), then float32; dt is the float32 difference;
  * t is passed to the model rounded to the state's dtype (bf16 in
    production), as ``jnp.full((B,), t, dtype=x.dtype)`` does;
  * each Euler/Heun update runs in float32 and is cast back to the state's
    dtype (in JAX the float32 dt promotes the bf16 state; in PyTorch a bf16
    tensor is not promoted by a float32 scalar, so the upcast is explicit).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

DriftFn = Callable[[torch.Tensor, float], torch.Tensor]  # (x, t_scalar) -> dx


def make_time_grid(
    t0: float, t1: float, num_steps: int, timestep_shift: float = 0.0
) -> np.ndarray:
    t = np.linspace(t0, t1, num_steps, dtype=np.float64)
    if timestep_shift > 0:
        s = timestep_shift
        t = s * t / (1 + (s - 1) * t)
    return t.astype(np.float32)


def ode_sample(
    drift: DriftFn, x: torch.Tensor, t_grid: np.ndarray, method: str = "euler"
) -> torch.Tensor:
    """Integrate dx/dt = drift(x, t) over t_grid with a fixed-step scheme;
    len(t_grid) - 1 steps (Euler: one drift evaluation each)."""
    t_grid = np.asarray(t_grid, dtype=np.float32)
    dts = t_grid[1:] - t_grid[:-1]
    dtype = x.dtype
    for t, dt in zip(t_grid[:-1], dts):
        t, dt = np.float32(t), float(dt)
        if method == "euler":
            x = (x.float() + dt * drift(x, t).float()).to(dtype)
        elif method == "heun":
            k1 = drift(x, t)
            k2 = drift((x.float() + dt * k1.float()).to(dtype), np.float32(t + np.float32(dt)))
            x = (x.float() + (dt * 0.5) * (k1 + k2).float()).to(dtype)
        else:
            raise NotImplementedError(f"ODE method {method!r} is not ported (euler/heun)")
    return x


def forward_with_cfg(
    model_fn: Callable[..., torch.Tensor],
    x: torch.Tensor,
    t: torch.Tensor,
    y: torch.Tensor,
    cfg_scale: float,
    cfg_interval: bool = False,
    cfg_interval_start: Optional[float] = None,
    cfg_channels: int = 3,
) -> torch.Tensor:
    """Classifier-free guidance with batch doubling, guiding only the first
    ``cfg_channels`` channels (the reference's quirk). ``x`` is [z; z], ``y``
    is [labels; null]. Below ``cfg_interval_start`` (compared in t's dtype)
    the conditional output is used unguided."""
    half = x[: x.shape[0] // 2]
    model_out = model_fn(torch.cat([half, half], dim=0), t, y)
    eps, rest = model_out[:, :cfg_channels], model_out[:, cfg_channels:]
    cond_eps, uncond_eps = eps.chunk(2, dim=0)
    half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
    if cfg_interval:
        if cfg_interval_start is None:
            raise ValueError("cfg_interval needs cfg_interval_start")
        start = torch.tensor(cfg_interval_start, dtype=t.dtype, device=t.device)
        half_eps = torch.where(t[0] < start, cond_eps, half_eps)
    return torch.cat([torch.cat([half_eps, half_eps], dim=0), rest], dim=1)


class Sampler:
    """Sampler facade (ODE side) matching ``transport.Sampler``."""

    def __init__(self, transport):
        self.transport = transport
        self.drift = transport.get_drift()

    def ode_time_grid(
        self, num_steps: int, timestep_shift: float = 0.0, reverse: bool = False
    ) -> np.ndarray:
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps,
            sde=False, eval=True, reverse=reverse, last_step_size=0.0,
        )
        return make_time_grid(t0, t1, num_steps, timestep_shift)

    def sample_ode(
        self,
        *,
        sampling_method: str = "euler",
        num_steps: int = 50,
        reverse: bool = False,
        timestep_shift: float = 0.0,
        t_grid: Optional[np.ndarray] = None,
    ):
        """Return sample_fn(x, model_fn, **model_kwargs) -> final state.
        ``t_grid`` overrides the grid (the phased-CFG pipeline integrates
        sub-ranges of the full grid)."""
        if sampling_method not in ("euler", "heun"):
            raise NotImplementedError(
                f"ODE method {sampling_method!r} is not ported yet (euler/heun; dopri5 "
                "and rk4 come later)"
            )
        base_drift = self.drift
        if reverse:
            def drift(x, t, model, **kw):
                return base_drift(x, 1 - t, model, **kw)
        else:
            drift = base_drift
        if t_grid is None:
            t_grid = self.ode_time_grid(num_steps, timestep_shift, reverse)

        def sample_fn(x, model_fn, **model_kwargs):
            def _drift(xc, t_scalar):
                t = torch.full((xc.shape[0],), float(t_scalar), dtype=xc.dtype, device=xc.device)
                return drift(xc, t, model_fn, **model_kwargs)

            return ode_sample(_drift, x, t_grid, method=sampling_method)

        return sample_fn
