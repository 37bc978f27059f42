"""Hadamard / QuaRot rotations (counterpart of wanq_tpu/quant/hadamard.py).

A rotation of in_features n = K * 2^m is Q = diag(s) * H_n / sqrt(n): random
signs s from ``np.random.default_rng(seed)`` (the JAX package's draw), the
fast Walsh-Hadamard butterflies for the 2^m factor, then the K x K base
matrix, built by the Paley type-I construction (every base order the Wan
widths need: 1536 = 12 * 128, 5120 = 20 * 256, 8960 = 140 * 64,
13824 = 108 * 128).

Everything runs in PyTorch on the tensor's device. The weight-side rotation
(``rotate_weight_fwht``) and the dense activation-side matrix
(``rotation_for_dim``) are computed in float64, the card's own f64 units in
production, and cast to f32; the JAX package moves that f64 work to the
host only because a TPU has no f64.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from wanq_tpu_torch.ops.fused import true_div


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n % 2 == 0:
        return n == 2
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


@functools.lru_cache(maxsize=None)
def paley_hadamard(order: int) -> np.ndarray:
    """Hadamard matrix of the given order by the Paley type-I construction:
    q = order - 1 must be a prime with q = 3 (mod 4). An int8 +-1 matrix H
    with H @ H.T == order * I."""
    q = order - 1
    if not (_is_prime(q) and q % 4 == 3):
        raise ValueError(
            f"Paley-I construction needs order-1 prime = 3 (mod 4); got order={order}")
    # quadratic-residue character chi(x): +1 for a nonzero residue mod q,
    # -1 for a non-residue, 0 at 0; Jacobsthal matrix Q[i, j] = chi(i - j)
    residues = {(i * i) % q for i in range(1, q)}
    chi = np.zeros(q, dtype=np.int8)
    for x in range(1, q):
        chi[x] = 1 if x in residues else -1
    idx = (np.arange(q)[:, None] - np.arange(q)[None, :]) % q
    # H = S + I with skew S = [[0, 1...1], [-1...-1, Q]]: its core is Q + I
    h = np.ones((order, order), dtype=np.int8)
    h[1:, 0] = -1
    h[1:, 1:] = chi[idx] + np.eye(q, dtype=np.int8)
    if not np.array_equal(h @ h.T.astype(np.int64), order * np.eye(order, dtype=np.int64)):
        raise AssertionError(f"Paley construction of order {order} is not Hadamard")
    return h


@functools.lru_cache(maxsize=None)
def get_hadK(n: int) -> Tuple[Optional[np.ndarray], int]:
    """n = K * 2^m -> (base matrix or None, K): K = odd(n) * 2^j for the
    smallest j >= 2 that Paley-I constructs (K = 1 when n is a power of
    two)."""
    if is_pow2(n):
        return None, 1
    odd = n
    while odd % 2 == 0:
        odd //= 2
    k = odd * 4  # Hadamard orders > 2 are multiples of 4
    while k <= n:
        if _is_prime(k - 1) and (k - 1) % 4 == 3:
            return paley_hadamard(k), k
        k *= 2
    raise ValueError(f"no Paley-I constructible Hadamard base for n={n} (odd part {odd})")


def matmul_hadU(x: torch.Tensor) -> torch.Tensor:
    """x @ H_n / sqrt(n) over the last axis, in x's dtype and on its device:
    butterflies (a + b, a - b over adjacent pairs) down to K, then the K x K
    base matrix blockwise, then a true division by sqrt(n)."""
    n = x.shape[-1]
    hadk, k = get_hadK(n)
    inp = x.reshape(-1, n, 1)
    length = n
    while length > k:
        inp = inp.reshape(inp.shape[0], length // 2, 2, inp.shape[-1])
        inp = torch.stack([inp[:, :, 0] + inp[:, :, 1], inp[:, :, 0] - inp[:, :, 1]], dim=2)
        length //= 2
        inp = inp.reshape(inp.shape[0], length, -1)
    if k > 1:
        inp = torch.from_numpy(hadk).to(device=x.device, dtype=x.dtype) @ inp
    return true_div(inp.reshape(x.shape), math.sqrt(n))


def derived_rotation_seed(size: int, seed: int = 0) -> int:
    """Per-dimension rotation seed: every layer of one in_features shares a
    rotation."""
    return (seed * 1000003 + size) & 0x7FFFFFFF


def rotation_signs(size: int, seed: int) -> np.ndarray:
    """The +-1 diagonal of the randomized rotation (f64, host numpy)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=size).astype(np.float64) * 2.0 - 1.0


def random_hadamard_matrix(size: int, seed: int, device="cuda") -> torch.Tensor:
    """Q = diag(s) * H / sqrt(n), orthonormal, f64 [size, size] on
    ``device``."""
    s = torch.from_numpy(rotation_signs(size, seed)).to(device)
    return matmul_hadU(torch.diag(s))


def rotate_weight_fwht(w_in_out: torch.Tensor, size_seed: int) -> torch.Tensor:
    """Weight-side rotation Q^T W of a [C_in, C_out] weight, f32 out.
    Q^T W = M diag(s) W is the transform run down each weight column, in f64
    on the weight's device: O(C_in log C_in C_out) where the dense product
    is O(C_in^2 C_out)."""
    s = torch.from_numpy(rotation_signs(w_in_out.shape[0], size_seed)).to(w_in_out.device)
    return matmul_hadU((s[:, None] * w_in_out.double()).t()).float().t().contiguous()


def rotation_for_dim(size: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """The activation-side rotation of every layer with ``size`` input
    features: dense f32 [size, size] on ``device``, built in f64."""
    return random_hadamard_matrix(size, derived_rotation_seed(size, seed), device).float()
