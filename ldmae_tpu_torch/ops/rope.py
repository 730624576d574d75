"""EVA-02 style 2-D axial rotary position embedding (port of
``ldmae_tpu/ops/rope.py``).

The tables are numpy (host-side constants). Convention: ``build_rope_table``
takes ``head_dim // 2``; per-axis frequencies are repeated twice
*interleaved*; rows give the first half of the channels, columns the second.
``rope_channel_permutation`` moves q/k channels from the interleaved pair
layout to half-split, where rotate-half is two contiguous slices; logits are
invariant under the shared permutation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def build_rope_table(
    half_head_dim: int,
    pt_seq_len: int,
    ft_seq_len: Optional[int] = None,
    theta: float = 10000.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (cos, sin), each (ft_seq_len**2, 2*half_head_dim) float32."""
    dim = half_head_dim
    freqs = 1.0 / (
        theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim)
    )
    if ft_seq_len is None:
        ft_seq_len = pt_seq_len
    t = np.arange(ft_seq_len, dtype=np.float64) / ft_seq_len * pt_seq_len
    angles = np.repeat(np.einsum("n,f->nf", t, freqs), 2, axis=-1)  # (S, dim)
    s = ft_seq_len
    full = np.concatenate(
        [
            np.broadcast_to(angles[:, None, :], (s, s, dim)),
            np.broadcast_to(angles[None, :, :], (s, s, dim)),
        ],
        axis=-1,
    ).reshape(s * s, 2 * dim)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


def rope_channel_permutation(head_dim: int) -> np.ndarray:
    """perm such that x_half[i] = x_interleaved[perm[i]]."""
    return np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])


def to_half_layout(table: np.ndarray) -> np.ndarray:
    """Permute a (N, head_dim) cos/sin table to the half-split layout."""
    return table[:, rope_channel_permutation(table.shape[-1])]


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation: (x0,x1,x2,x3,...) -> (-x1,x0,-x3,x2,...)."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved layout, computed in x's dtype. x: (..., N, hd); cos/sin: (N, hd)."""
    return x * cos.to(x.dtype) + rotate_half(x) * sin.to(x.dtype)


def rotate_half_split(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """apply_rope for half-split channels and tables, in x's dtype."""
    return x * cos.to(x.dtype) + rotate_half_split(x) * sin.to(x.dtype)
