"""2-D sin-cos positional embeddings (numpy copy of ``ldmae_tpu/ops/sincos.py``).

Matches the fixed (non-learned) positional-embedding tables used by both the
VMAE tokenizer and LightningDiT in the reference implementation
(LDMAE/models/lightningdit.py:444-491 and VMAE/util/pos_embed.py). Built
host-side with numpy; the models keep them as constant buffers.

Layout convention (must match exactly for PyTorch weight import):
  * grid built with ``meshgrid(w, h)`` — w varies fastest
  * the first half of the embedding channels encodes grid[0] (the *w*-indexed
    component per the meshgrid order), the second half grid[1]
  * each 1-D half is ``[sin | cos]`` concatenated
  * omega computed in float64 (the reference DiT copy uses float64; the VMAE
    copy uses the same numerics at float64 resolution once cast to float32)
"""

from __future__ import annotations

import numpy as np


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim) with [sin | cos] halves."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = pos.reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed_from_grid(embed_dim: int, grid: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_sincos_pos_embed(
    embed_dim: int,
    grid_size: int,
    cls_token: bool = False,
    extra_tokens: int = 0,
) -> np.ndarray:
    """Return (grid_size**2 [+ extra], embed_dim) float32 table.

    When ``cls_token`` is set, ``extra_tokens`` zero rows are prepended (the
    reference prepends ``extra_tokens`` rows only when both are set; VMAE
    passes ``cls_token=True`` with the default ``extra_tokens=0`` producing no
    extra rows — we mirror that by treating cls_token alone as one extra row
    only if extra_tokens > 0).
    """
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
    pos_embed = get_2d_sincos_pos_embed_from_grid(embed_dim, grid)
    if cls_token and extra_tokens > 0:
        pos_embed = np.concatenate(
            [np.zeros([extra_tokens, embed_dim]), pos_embed], axis=0
        )
    return pos_embed.astype(np.float32)


def timestep_embedding_freqs(dim: int, max_period: float = 10000.0) -> np.ndarray:
    """Frequency vector for DiT's sinusoidal timestep embedding.

    matches lightningdit.py:119-123: exp(-log(max_period) * arange(half)/half).
    """
    half = dim // 2
    return np.exp(
        -np.log(max_period) * np.arange(half, dtype=np.float32) / half
    ).astype(np.float32)
