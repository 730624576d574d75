"""Adaptive Dormand-Prince (dopri5) ODE solver and likelihood estimation
(port of ``ldmae_tpu/transport/adaptive.py``).

``dopri5`` is ``sample_ode(sampling_method="dopri5")``; ``make_likelihood_fn``
is the reference's ``Sampler.sample_ode_likelihood``: the probability-flow
ODE integrated from data to noise with the Hutchinson divergence estimator
on Rademacher probes.

The JAX solver is a ``lax.while_loop``; here it is a plain loop whose
accept test reads one device value a step (one host sync per attempted
step). Time, step size, error norm and the step-size update stay 0-d
float32 tensors on the device, computed in the JAX package's order, so
float32 runs take the same accept/reject decisions. ``dopri5.accepted``
and ``dopri5.rejected`` count the solver's steps, as the kernel wrappers'
``launches`` count theirs; each attempted step evaluates the drift six
times, plus once at the start.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

# Dormand-Prince RK45 Butcher tableau
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], np.float32)
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0], np.float32)
_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40], np.float32)


def dopri5(
    drift: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    t0: float,
    t1: float,
    rtol: float = 1e-3,
    atol: float = 1e-6,
    max_steps: int = 1000,
    initial_step: float = 0.01,
) -> torch.Tensor:
    """Integrate dx/dt = drift(x, t) from t0 to t1 adaptively; returns x(t1)
    (or x where ``max_steps`` attempted steps end it). ``drift`` gets t as a
    0-d float32 tensor on x0's device.

    Error norm and step control as the JAX package's (torchdiffeq's
    defaults): mixed rtol/atol RMS norm, 0.9 safety, exponent 0.2, factor
    clipped to [0.2, 10], h to [1e-6, 1]. FSAL: k7, evaluated at (x5, t+h),
    is the next step's k1. Stage states and the accepted state are computed
    in float32 and cast to x0's dtype (the JAX solver refuses a bf16 state:
    its float32 step promotes the ``while_loop`` carry). A decreasing
    interval (t1 < t0) is integrated by the time reflection tau = -t."""
    if float(t1) < float(t0):
        return dopri5(
            lambda x, tau: -drift(x, -tau), x0, -float(t0), -float(t1),
            rtol=rtol, atol=atol, max_steps=max_steps, initial_step=initial_step,
        )
    dev, dtype = x0.device, x0.dtype

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    c, b5, b4 = f32(_C), f32(_B5), f32(_B4)
    t, t_end, h = f32(t0), f32(t1), f32(initial_step)
    x, k1 = x0, drift(x0, t)
    going = bool(np.float32(t0) < np.float32(t1))
    steps = 0
    while going and steps < max_steps:
        h = torch.minimum(h, t_end - t)
        xf = x.float()
        ks = [k1]
        for i in range(1, 7):
            xi = xf
            for j, aij in enumerate(_A[i]):
                xi = xi + h * aij * ks[j].float()
            ks.append(drift(xi.to(dtype), t + h * c[i]))
        k = torch.stack([kj.float() for kj in ks])
        x5 = xf + h * torch.tensordot(b5, k, dims=1)
        x4 = xf + h * torch.tensordot(b4, k, dims=1)
        scale = atol + rtol * torch.maximum(xf.abs(), x5.abs())
        err_norm = torch.sqrt(torch.mean(((x5 - x4) / scale) ** 2))
        accept_t = err_norm <= 1.0
        factor = torch.clamp(0.9 * (1.0 / torch.clamp_min(err_norm, 1e-10)) ** 0.2, 0.2, 10.0)
        t_next = torch.where(accept_t, t + h, t)
        accept, going = torch.stack([accept_t, t_next < t_end]).tolist()  # the step's one sync
        if accept:
            x, k1 = x5.to(dtype), ks[6]
            dopri5.accepted += 1
        else:
            dopri5.rejected += 1
        t, h = t_next, torch.clamp(h * factor, 1e-6, 1.0)
        steps += 1
    return x


dopri5.accepted = 0
dopri5.rejected = 0


def prior_logp(z: torch.Tensor) -> torch.Tensor:
    """Standard-normal log density per sample, in float32."""
    n = math.prod(z.shape[1:])
    const = np.float32(-n / 2.0) * np.log(np.float32(2 * np.pi))
    return float(const) - z.reshape(z.shape[0], -1).float().pow(2).sum(dim=1) / 2.0


def make_likelihood_fn(transport, num_steps: int = 50, method: str = "rk4"):
    """Log-likelihood through the probability-flow ODE, exact in
    expectation: (x, logp) integrated from data to noise over the unshifted
    ODE grid with the drift at 1 - t and the Hutchinson divergence
    eps^T J eps on Rademacher eps. Returns
    fn(x, model_fn, eps=None, generator=None, module=None, **kwargs) ->
    (logp (B,) float32, z).

    JAX forms J eps with ``jax.jvp``; the port's kernel Functions have no
    forward-mode rule, so the same estimator is taken in reverse mode,
    grad((f(x) * eps).sum(), x) . eps = eps^T J^T eps = eps^T J eps, the
    reference's own form. ``fn`` needs autograd: it runs under
    ``torch.enable_grad()`` with x the one leaf that requires grad; pass the
    model as ``module`` and its parameters stop requiring grad for the call
    (the backward then computes no weight gradients), restored afterwards.
    ``eps`` (x's shape, +-1) is drawn from ``generator`` when not given.
    Stage states are computed in float32 and cast to x's dtype; logp
    accumulates in float32."""
    from .samplers import make_time_grid, t_like

    if method not in ("rk4", "euler"):
        raise NotImplementedError(f"likelihood method {method!r} (rk4/euler)")
    drift = transport.get_drift()
    t0, t1 = transport.check_interval(
        transport.train_eps, transport.sample_eps, sde=False, eval=True,
        reverse=False, last_step_size=0.0,
    )
    grid = make_time_grid(t0, t1, num_steps)

    def fn(x, model_fn, eps=None, generator=None, module=None, **kwargs):
        if torch.is_inference_mode_enabled():
            raise RuntimeError("the likelihood differentiates the model: call it outside torch.inference_mode()")
        if eps is None:
            eps = torch.randint(0, 2, x.shape, generator=generator, device=x.device).to(x.dtype) * 2 - 1
        # copies, so that x and eps may come from torch.inference_mode() (a
        # sampler's output): autograd saves neither an inference tensor
        x, eps = x.detach().clone(), torch.as_tensor(eps).to(device=x.device, dtype=x.dtype).clone()
        b, dtype = x.shape[0], x.dtype

        def ode_func(xc, t_scalar):
            t_rev = t_like(np.float32(1) - t_scalar, xc)
            with torch.enable_grad():
                xg = xc.detach().requires_grad_(True)
                fx = drift(xg, t_rev, model_fn, **kwargs)
                if not fx.requires_grad:  # a field that does not depend on x
                    return -fx.detach(), torch.zeros(b, dtype=torch.float32, device=xc.device)
                (vjp,) = torch.autograd.grad((fx * eps).sum(), xg)
            return -fx.detach(), (vjp * eps).reshape(b, -1).sum(dim=1).float()

        def stage(xc, c, k):
            return (xc.float() + c * k.float()).to(dtype)

        frozen = [p for p in module.parameters() if p.requires_grad] if module is not None else []
        for p in frozen:
            p.requires_grad_(False)
        try:
            xc, lp = x, torch.zeros(b, dtype=torch.float32, device=x.device)
            for t, dt in zip(grid[:-1], grid[1:] - grid[:-1]):
                if method == "rk4":
                    half, th = dt * np.float32(0.5), t + np.float32(0.5) * dt
                    k1x, k1l = ode_func(xc, t)
                    k2x, k2l = ode_func(stage(xc, float(half), k1x), th)
                    k3x, k3l = ode_func(stage(xc, float(half), k2x), th)
                    k4x, k4l = ode_func(stage(xc, float(dt), k3x), t + dt)
                    sixth = float(dt / np.float32(6.0))
                    xc = stage(xc, sixth, k1x + 2 * k2x + 2 * k3x + k4x)
                    lp = lp + sixth * (k1l + 2 * k2l + 2 * k3l + k4l)
                else:
                    dx, dlp = ode_func(xc, t)
                    xc, lp = stage(xc, float(dt), dx), lp + float(dt) * dlp
        finally:
            for p in frozen:
                p.requires_grad_(True)
        return prior_logp(xc) - lp, xc

    return fn
