"""3D rotary position embedding (counterpart of wanq_tpu/models/rope.py).

The (f, h, w) angle tables are computed once per grid in float64 numpy and
stored float32, exactly as the JAX package does, so both packages rotate
with identical tables. The pair swap of the ``x*ca + pairswap(x)*sb`` form
is an element swap here, not a permutation matmul.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _rope_freqs_1d(max_len: int, dim: int, theta: float = 10000.0) -> np.ndarray:
    pos = np.arange(max_len, dtype=np.float64)
    inv = 1.0 / np.power(theta, np.arange(0, dim, 2, dtype=np.float64) / dim)
    return np.outer(pos, inv)


@functools.lru_cache(maxsize=8)
def rope_tables(grid: Tuple[int, int, int], head_dim: int,
                max_len: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) [F*H*W, head_dim//2] float32 for an (F, H, W) patch grid:
    the f axis gets c - 2*(c//3) frequencies, h and w c//3 each."""
    f, h, w = grid
    c = head_dim // 2
    parts = (c - 2 * (c // 3), c // 3, c // 3)
    ang_f = _rope_freqs_1d(max_len, 2 * parts[0])[:f]
    ang_h = _rope_freqs_1d(max_len, 2 * parts[1])[:h]
    ang_w = _rope_freqs_1d(max_len, 2 * parts[2])[:w]
    ang = np.concatenate(
        [
            np.broadcast_to(ang_f[:, None, None, :], (f, h, w, parts[0])),
            np.broadcast_to(ang_h[None, :, None, :], (f, h, w, parts[1])),
            np.broadcast_to(ang_w[None, None, :, :], (f, h, w, parts[2])),
        ],
        axis=-1,
    ).reshape(f * h * w, c)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=8)
def rope_tables_interleaved(grid: Tuple[int, int, int], head_dim: int,
                            max_len: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """(ca, sb) [seq, head_dim] for out = x*ca + pairswap(x)*sb:
    ca[:, 2i] = ca[:, 2i+1] = cos, sb[:, 2i] = -sin, sb[:, 2i+1] = sin."""
    cos, sin = rope_tables(grid, head_dim, max_len)
    ca = np.repeat(cos, 2, axis=1)
    sb = np.repeat(sin, 2, axis=1)
    sb[:, 0::2] = -sb[:, 0::2]
    ca.setflags(write=False)
    sb.setflags(write=False)
    return ca, sb


def pad_tables(ca: torch.Tensor, sb: torch.Tensor, valid_len: int,
               seq_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extend [valid, D] tables to [seq_len, D] with the identity rotation
    (ca=1, sb=0): the zero-padding tail passes through unrotated."""
    pad = seq_len - valid_len
    if pad <= 0:
        return ca[:seq_len], sb[:seq_len]
    d = ca.shape[1]
    ones = torch.ones((pad, d), dtype=ca.dtype, device=ca.device)
    return (torch.cat([ca[:valid_len], ones]),
            torch.cat([sb[:valid_len], torch.zeros_like(ones)]))


def _pairswap(x: torch.Tensor) -> torch.Tensor:
    """Swap adjacent features (2i <-> 2i+1) along the last axis."""
    return x.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)


def rope_apply_interleaved(x: torch.Tensor, ca: torch.Tensor, sb: torch.Tensor,
                           valid_len: int, scale: float = 1.0) -> torch.Tensor:
    """Rope on [B, S, N, D]: f32 compute, output in x's dtype. Tables are
    padded to S with the identity; ``scale`` multiplies both tables (folds
    the softmax scale into q)."""
    b, s, n, d = x.shape
    ca, sb = pad_tables(ca, sb, valid_len, s)
    if scale != 1.0:
        ca = ca * scale
        sb = sb * scale
    xf = x.float()
    out = xf * ca[None, :, None, :] + _pairswap(xf) * sb[None, :, None, :]
    return out.to(x.dtype)
