"""Coupling-plan path math (port of ``ldmae_tpu/transport/paths.py``): the
linear interpolant, which is what velocity prediction on the Linear path
needs. The VP and GVP plans come with the training slice."""

from __future__ import annotations

import torch


def expand_t_like_x(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], *([1] * (x.dim() - 1)))


class ICPlan:
    """Linear coupling plan: x_t = t*x1 + (1-t)*x0, u_t = x1 - x0."""

    def __init__(self, sigma: float = 0.0):
        self.sigma = sigma

    def compute_alpha_t(self, t):
        return t, torch.ones_like(t)

    def compute_sigma_t(self, t):
        return 1 - t, -torch.ones_like(t)

    def compute_d_alpha_alpha_ratio_t(self, t):
        return 1 / t

    def compute_drift(self, x, t):
        """Score-parametrised drift; returns (-drift_mean, diffusion)."""
        t = expand_t_like_x(t, x)
        alpha_ratio = self.compute_d_alpha_alpha_ratio_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        return -alpha_ratio * x, alpha_ratio * (sigma_t**2) - sigma_t * d_sigma_t
