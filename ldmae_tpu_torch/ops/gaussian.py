"""Diagonal Gaussian posterior of the VMAE bottleneck (port of
``ldmae_tpu/ops/gaussian.py``).

Parameters are split into (mean, logvar) along ``axis``; logvar is clipped
to [-30, 20]. ``kl`` has the JAX package's three variants: the VMAE
training form 0.5 sum(var - 1 - logvar) (the default), with the mean^2 term
(``include_mean``), and against a fixed std.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std * eps, eps the given N(0, 1) ``noise`` or drawn from
        ``generator`` (the two packages' generators differ, so parity tests
        pass the noise)."""
        if noise is None:
            eps = torch.randn(self.mean.shape, generator=generator, dtype=self.mean.dtype,
                              device=self.mean.device)
        else:
            eps = noise.to(self.mean.dtype)
        return self.mean + self.std * eps

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, include_mean: bool = False, fixed_std: Optional[float] = None) -> torch.Tensor:
        """Per-sample KL, summed over every non-batch dim."""
        dims = tuple(range(1, self.mean.ndim))
        if fixed_std is not None:
            fixed_var = torch.tensor(fixed_std, dtype=torch.float32) ** 2
            term = self.var / fixed_var - 1.0 - self.logvar + torch.log(fixed_var)
        elif include_mean:
            term = self.mean.square() + self.var - 1.0 - self.logvar
        else:
            term = self.var - 1.0 - self.logvar
        return 0.5 * term.sum(dim=dims)


def diagonal_gaussian(parameters: torch.Tensor, axis: int = 1) -> DiagonalGaussian:
    mean, logvar = parameters.chunk(2, dim=axis)
    return DiagonalGaussian(mean=mean, logvar=logvar.clamp(-30.0, 20.0))

