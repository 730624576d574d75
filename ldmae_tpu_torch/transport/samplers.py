"""ODE and SDE samplers and classifier-free guidance (port of
``ldmae_tpu/transport/samplers.py``; the adaptive dopri5 solver is in
``adaptive.py``).

Numerics kept from the JAX package:
  * grid = linspace(t0, t1, num_steps) in float64, optionally warped by
    t' = s*t / (1 + (s-1)*t), then float32; dt is the float32 difference;
  * t is passed to the model rounded to the state's dtype (bf16 in
    production), as ``jnp.full((B,), t, dtype=x.dtype)`` does;
  * each update, and each stage state of Heun, RK4 and the SDE steps, runs
    in float32 and is cast back to the state's dtype (in JAX the float32 dt
    promotes a bf16 state and ``ode_sample`` casts back; in PyTorch a bf16
    tensor is not promoted by a float32 scalar, so the upcast is explicit).
    Sums of drift evaluations, such as RK4's k1 + 2 k2 + 2 k3 + k4, stay in
    the state's dtype, as in JAX.

The JAX package's ``sde_sample`` casts nothing back: its float32 dt turns a
bf16 state into float32 and ``lax.scan`` refuses the change of carry type,
so the JAX sampler runs the SDE in float32 only. Here a bf16 state is cast
back after each step, the rule of ``ode_sample``.

The SDE's normal draws have the state's shape and dtype, one a step; they
come from ``generator`` in step order, or are passed in (``noise``): the
tests inject the JAX draws, since the two packages' generators differ.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .adaptive import dopri5

DriftFn = Callable[[torch.Tensor, float], torch.Tensor]  # (x, t_scalar) -> dx


def make_time_grid(
    t0: float, t1: float, num_steps: int, timestep_shift: float = 0.0
) -> np.ndarray:
    t = np.linspace(t0, t1, num_steps, dtype=np.float64)
    if timestep_shift > 0:
        s = timestep_shift
        t = s * t / (1 + (s - 1) * t)
    return t.astype(np.float32)


def t_like(t_scalar, x: torch.Tensor) -> torch.Tensor:
    """(B,) t in x's dtype on x's device from a float (the fixed grids) or a
    0-d float32 tensor (dopri5's device-side time)."""
    if isinstance(t_scalar, torch.Tensor):
        return t_scalar.reshape(1).to(device=x.device, dtype=x.dtype).repeat(x.shape[0])
    return torch.full((x.shape[0],), float(t_scalar), dtype=x.dtype, device=x.device)


def ode_sample(
    drift: DriftFn, x: torch.Tensor, t_grid: np.ndarray, method: str = "euler"
) -> torch.Tensor:
    """Integrate dx/dt = drift(x, t) over t_grid with a fixed-step scheme;
    len(t_grid) - 1 steps of 1 (Euler), 2 (Heun) or 4 (RK4) drift
    evaluations each."""
    if method not in ("euler", "heun", "rk4"):
        raise NotImplementedError(
            f"ODE method {method!r} not implemented (euler/heun/rk4; the "
            "reference's production config uses fixed-step euler)"
        )
    t_grid = np.asarray(t_grid, dtype=np.float32)
    dts = t_grid[1:] - t_grid[:-1]
    dtype = x.dtype

    def stage(k, c):  # x + c k in float32, cast back to the state's dtype
        return (x.float() + c * k.float()).to(dtype)

    for t, dt in zip(t_grid[:-1], dts):
        if method == "euler":
            x = stage(drift(x, t), float(dt))
        elif method == "heun":
            k1 = drift(x, t)
            k2 = drift(stage(k1, float(dt)), t + dt)
            x = stage(k1 + k2, float(dt * np.float32(0.5)))
        else:
            half, th = dt * np.float32(0.5), t + np.float32(0.5) * dt
            k1 = drift(x, t)
            k2 = drift(stage(k1, float(half)), th)
            k3 = drift(stage(k2, float(half)), th)
            k4 = drift(stage(k3, float(dt)), t + dt)
            x = stage(k1 + 2 * k2 + 2 * k3 + k4, float(dt / np.float32(6.0)))
    return x


def sde_sample(
    drift: DriftFn,
    diffusion: Callable[[torch.Tensor, float], torch.Tensor],
    x: torch.Tensor,
    t_grid: np.ndarray,
    method: str = "Euler",
    last_step_fn: Optional[Callable[[torch.Tensor, float], torch.Tensor]] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Euler-Maruyama / Heun SDE integration over t_grid[:-1] (dt the first
    interval), then ``last_step_fn`` at t_grid[-1]. ``noise``: the
    len(t_grid) - 1 standard normal draws of x's shape, else drawn from
    ``generator`` one a step in x's dtype."""
    if method not in ("Euler", "Heun"):
        raise NotImplementedError(f"SDE method {method!r}")
    t_grid = np.asarray(t_grid, dtype=np.float32)
    n = len(t_grid) - 1
    if noise is not None and len(noise) != n:
        raise ValueError(f"sde_sample: {len(noise)} noise draws for {n} steps")
    dt = t_grid[1] - t_grid[0]
    sqrt_dt = float(np.sqrt(dt))
    dtype = x.dtype
    for i, t in enumerate(t_grid[:-1]):
        if noise is None:
            w = torch.randn(x.shape, generator=generator, device=x.device, dtype=dtype)
        else:
            w = torch.as_tensor(noise[i]).to(device=x.device, dtype=dtype)
        dw = w.float() * sqrt_dt
        if method == "Euler":
            d = drift(x, t)
            diff = diffusion(x, t)
            mean_x = x.float() + d.float() * float(dt)
            x = (mean_x + torch.sqrt(2 * diff).float() * dw).to(dtype)
        else:
            diff = diffusion(x, t)
            xhat = (x.float() + torch.sqrt(2 * diff).float() * dw).to(dtype)
            k1 = drift(xhat, t)
            xp = (xhat.float() + float(dt) * k1.float()).to(dtype)
            k2 = drift(xp, t + dt)
            x = (xhat.float() + float(np.float32(0.5) * dt) * (k1 + k2).float()).to(dtype)
    if last_step_fn is not None:
        x = last_step_fn(x, t_grid[-1])
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
    """Sampler facade matching ``transport.Sampler``."""

    def __init__(self, transport):
        self.transport = transport
        self.drift = transport.get_drift()
        self.score = transport.get_score()

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
        sampling_method: str = "dopri5",
        num_steps: int = 50,
        atol: float = 1e-6,
        rtol: float = 1e-3,
        reverse: bool = False,
        timestep_shift: float = 0.0,
        t_grid: Optional[np.ndarray] = None,
    ):
        """Return sample_fn(x, model_fn, **model_kwargs) -> final state.
        ``t_grid`` overrides the grid (the phased-CFG pipeline integrates
        sub-ranges of the full grid). dopri5 integrates adaptively from the
        grid's first node to its last (``adaptive.dopri5``, rtol/atol); the
        fixed-step methods ignore atol/rtol."""
        base_drift = self.drift
        if reverse:
            def drift(x, t, model, **kw):
                return base_drift(x, 1 - t, model, **kw)
        else:
            drift = base_drift
        if t_grid is None:
            t_grid = self.ode_time_grid(num_steps, timestep_shift, reverse)
        if sampling_method not in ("dopri5", "euler", "heun", "rk4"):
            raise NotImplementedError(f"ODE method {sampling_method!r} not implemented (dopri5/euler/heun/rk4)")

        def sample_fn(x, model_fn, **model_kwargs):
            def _drift(xc, t_scalar):
                return drift(xc, t_like(t_scalar, xc), model_fn, **model_kwargs)

            if sampling_method == "dopri5":
                return dopri5(_drift, x, float(t_grid[0]), float(t_grid[-1]), rtol=rtol, atol=atol)
            return ode_sample(_drift, x, t_grid, method=sampling_method)

        return sample_fn

    def sample_sde(
        self,
        *,
        sampling_method: str = "Euler",
        diffusion_form: str = "SBDM",
        diffusion_norm: float = 1.0,
        last_step: Optional[str] = "Mean",
        last_step_size: float = 0.04,
        num_steps: int = 250,
    ):
        """Return sample_fn(x, model_fn, noise=None, generator=None,
        **model_kwargs) -> final state: ``num_steps - 1`` SDE steps of
        ``sampling_method``, then the ``last_step`` rule (Mean, Tweedie,
        Euler or None) over ``last_step_size``. Each SDE drift evaluation
        runs the model once (``Transport.get_drift_and_score``)."""
        if last_step not in (None, "Mean", "Tweedie", "Euler"):
            raise NotImplementedError(last_step)
        if last_step is None:
            last_step_size = 0.0
        path = self.transport.path_sampler
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps,
            diffusion_form=diffusion_form, sde=True, eval=True, reverse=False,
            last_step_size=last_step_size,
        )
        t_grid = make_time_grid(t0, t1, num_steps, 0.0)
        drift_and_score = self.transport.get_drift_and_score()

        def sample_fn(x, model_fn, noise=None, generator=None, **model_kwargs):
            def _diffusion(xc, t_scalar):
                return path.compute_diffusion(xc, t_like(t_scalar, xc), form=diffusion_form, norm=diffusion_norm)

            def _sde_drift(xc, t_scalar):
                t = t_like(t_scalar, xc)
                drift, score = drift_and_score(xc, t, model_fn, **model_kwargs)
                return drift + path.compute_diffusion(xc, t, form=diffusion_form, norm=diffusion_norm) * score

            def _last(xc, t_scalar):
                t = t_like(t_scalar, xc)
                if last_step is None:
                    return xc
                if last_step == "Mean":
                    return xc + _sde_drift(xc, t_scalar) * last_step_size
                if last_step == "Tweedie":
                    t_end = torch.tensor(t1, dtype=torch.float32, device=xc.device)
                    a = path.compute_alpha_t(t_end)[0]
                    s = path.compute_sigma_t(t_end)[0]
                    return xc / a + (s**2) / a * self.score(xc, t, model_fn, **model_kwargs)
                return xc + self.drift(xc, t, model_fn, **model_kwargs) * last_step_size

            return sde_sample(_sde_drift, _diffusion, x, t_grid, method=sampling_method,
                              last_step_fn=_last, noise=noise, generator=generator)

        return sample_fn
