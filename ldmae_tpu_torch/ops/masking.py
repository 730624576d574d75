"""MAE random masking (port of ``ldmae_tpu/ops/masking.py``).

Per sample, the tokens are shuffled by the argsort of a uniform noise and the
first ``int(L * (1 - mask_ratio))`` are kept. The noise is always passed in
(the two packages' generators differ). The sorts are stable, so tied noise
values order as ``jnp.argsort`` orders them.
"""

from __future__ import annotations

import torch


def random_masking(
    x: torch.Tensor, mask_ratio: float, noise: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x_masked, mask, ids_restore).

    x: (N, L, D); noise: (N, L). mask: (N, L) in x's dtype, 0 = kept, 1 =
    removed; ids_restore (N, L) int64 undoes the shuffle."""
    n, length, d = x.shape
    len_keep = int(length * (1 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(n, len_keep, d))
    mask = torch.ones(n, length, dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0
    return x_masked, torch.gather(mask, 1, ids_restore), ids_restore


def unshuffle_with_mask_tokens(
    x: torch.Tensor, mask_token: torch.Tensor, ids_restore: torch.Tensor
) -> torch.Tensor:
    """Append mask tokens to the kept ones and undo the shuffle.

    x: (N, len_keep, D); mask_token: D values (any shape); ids_restore: (N, L)."""
    n, len_keep, d = x.shape
    length = ids_restore.shape[1]
    tokens = mask_token.reshape(1, 1, d).to(x.dtype).expand(n, length - len_keep, d)
    x_full = torch.cat([x, tokens], dim=1)
    return torch.gather(x_full, 1, ids_restore[:, :, None].expand(n, length, d))
