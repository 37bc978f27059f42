"""SVDQuant-style low-rank outlier absorption (counterpart of
wanq_tpu/quant/svd.py; arXiv:2411.05007).

The (smoothed) weight splits into a 16-bit low-rank branch and a quantized
residual, W = L1 @ L2 + R, and a layer computes

    y = (x @ L1) @ L2 + Q(x) @ Q(R)

The dominant singular directions, which carry the weight's outliers after
SmoothQuant's migration, stay in the bf16 branch, so R is flatter and
quantizes with less error. The split runs after the channel mask and the
rotation, in the GEMM's input space: the branch's input is the transformed
activation (qlinear._maybe_lowrank).

The truncated SVD is randomized (Halko et al. 2011, arXiv:0909.4061): a
Gaussian sketch, power iterations stabilized by QR, then the small exact
SVD, all in f32 on the weight's device (cuBLAS and cuSOLVER on the card).
"""

from __future__ import annotations

from typing import Tuple

import torch


def gaussian_sketch(n: int, r: int, seed: int, device) -> torch.Tensor:
    """The [n, r] f32 N(0, 1) test matrix, drawn by a torch.Generator seeded
    with ``seed`` on ``device`` (the JAX package draws jax.random's, so the
    two packages' factors differ where the top singular values are close;
    their products agree where the spectrum separates)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, r), generator=gen, device=device, dtype=torch.float32)


def svd_lowrank(w: torch.Tensor, rank: int, *, n_iter: int = 4, oversample: int = 8,
                seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best rank-``rank`` split of ``w`` [K, N] -> (L1 [K, r], L2 [r, N]),
    f32, with the singular values folded into L1 (L2 has orthonormal rows)."""
    k, n = w.shape
    r = min(rank + oversample, k, n)
    wf = w.float()
    q = torch.linalg.qr(wf @ gaussian_sketch(n, r, seed, wf.device)).Q  # [K, r]
    for _ in range(n_iter):
        q = torch.linalg.qr(wf.t() @ q).Q  # [N, r]
        q = torch.linalg.qr(wf @ q).Q  # [K, r]
    u_b, s, vt = torch.linalg.svd(q.t() @ wf, full_matrices=False)  # [r, N], exact
    return (q @ u_b)[:, :rank] * s[None, :rank], vt[:rank]


def lowrank_split(w: torch.Tensor, rank: int, *, seed: int = 0):
    """(L1, L2, residual) with ``w = L1 @ L2 + residual`` up to f32 round-off:
    the residual is taken by subtraction, whatever the truncation error."""
    l1, l2 = svd_lowrank(w, rank, seed=seed)
    return l1, l2, w.float() - l1 @ l2
