"""GPTQ: Hessian-aware, error-compensated weight rounding (counterpart of
wanq_tpu/quant/gptq.py).

Round-to-nearest (RTN) rounds every weight on its own. GPTQ (Frantar et
al., 2023) walks the input dimension row by row and spreads each row's
rounding error onto the rows not yet quantized through the upper Cholesky
factor U of the inverse input Hessian (H = X^T X, U^T U = H^-1), which
minimizes the layer's output error tr(dW^T H dW) on the calibration
distribution greedily in a fixed order.

The solve is plain in-place tensor code on the weight's device: a row-by-row
sweep inside each block of 128 rows, then one product that carries the
block's error to every later row. Ragged K is padded with an identity
Hessian block, which is a no-op (padded rows quantize to 0 with no error).
The Hessian's transform and the factorization run in f64 (the JAX package's
in f32): the damped Hessian of a site whose energy sits in a few channels
has a condition number near its cap, 100 x C_in, where an f32 Cholesky can
break down; the row sweep runs in f32, as the JAX package's.

The grid is the weight quantizers' (quantizers.py): per-output-channel
(delta, zp) from the (method-transformed) weight up front, codes
clamp(round(w / delta) - zp), so the state is a drop-in for the sim, int8
and packed-int4 routes. A failed Cholesky raises (torch.linalg.LinAlgError);
nothing falls back to RTN.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from wanq_tpu_torch.quant.quantizers import QuantizerCfg, n_levels_for, weight_quant_params


def _code_bounds(cfg: QuantizerCfg) -> Tuple[int, int]:
    """Integer code range: the int kernels' container range for 4 and 8
    bits, the fake-quant clamp for the other (sim-only) bitwidths."""
    bits = cfg.active_bits
    if bits == 4:
        return -8, 7
    if bits == 8:
        return -128, 127
    nl = n_levels_for(bits, cfg.sym)
    return -nl - 1, nl


def transform_hessian(hess: torch.Tensor, channel_mask: Optional[torch.Tensor] = None,
                      act_rotation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The raw-input Hessian H = X^T X in the space the GEMM contracts in:
    qlinear feeds it (x * mask) @ Q, whose Hessian is Q^T diag(m) H diag(m) Q
    (f64)."""
    h = hess.double()
    if channel_mask is not None:
        m = channel_mask.double()
        h = h * m[:, None] * m[None, :]
    if act_rotation is not None:
        q = act_rotation.double()
        h = q.t() @ h @ q
    return h


def _inverse_hessian_cholesky(hess: torch.Tensor, percdamp: float) -> torch.Tensor:
    """U upper-triangular with H^-1 = U^T U (in H's dtype, f64 from
    gptq_quantize), after diagonal damping of ``percdamp`` x the mean
    diagonal. A dead input channel (H_ii <= 0: it never fired in
    calibration) gets a unit diagonal and no coupling, so its row quantizes
    on its own."""
    k = hess.shape[0]
    eye = torch.eye(k, dtype=torch.bool, device=hess.device)
    diag = torch.diagonal(hess)
    dead = diag <= 0.0
    hess = torch.where((dead[:, None] | dead[None, :]) & ~eye, 0.0, hess)
    hess = hess + torch.diag(torch.where(dead, 1.0 - diag, 0.0))
    hess = hess + percdamp * torch.mean(torch.diagonal(hess)) * eye
    hinv = torch.cholesky_inverse(torch.linalg.cholesky(hess))
    # H^-1 = L L^T with L lower, so U = L^T
    return torch.linalg.cholesky(hinv).t()


def _gptq_solve(w: torch.Tensor, u: torch.Tensor, delta: torch.Tensor, zp: torch.Tensor,
                block: int, lo: int, hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked GPTQ sweep over a padded [Kp, N] f32 weight: (dequantized
    weight [Kp, N] f32, codes [Kp, N] int8)."""
    w = w.clone()
    kp, n = w.shape
    codes = torch.empty((kp, n), dtype=torch.int8, device=w.device)
    err = torch.empty((block, n), dtype=torch.float32, device=w.device)
    for i0 in range(0, kp, block):
        i1 = i0 + block
        wb, ub = w[i0:i1], u[i0:i1, i0:i1]
        for i in range(block):
            row = wb[i]
            q = torch.clamp(torch.round(row / delta) - zp, lo, hi)
            wq = (q + zp) * delta
            err[i] = (row - wq) / ub[i, i]
            # rank-1 update of the block's later rows
            wb[i + 1:].addr_(ub[i, i + 1:], err[i], alpha=-1.0)
            wb[i] = wq
            codes[i0 + i] = q.to(torch.int8)
        if i1 < kp:
            # the block's error onto every later row: one product
            w[i1:].addmm_(u[i0:i1, i1:].t(), err, alpha=-1.0)
    return w, codes


def gptq_quantize(w: torch.Tensor, hess: torch.Tensor, cfg: QuantizerCfg, block: int = 128,
                  percdamp: float = 0.01, act_order: bool = False):
    """Error-compensated quantization of a [C_in, C_out] weight against the
    input Hessian ``hess`` [C_in, C_in] (already in the GEMM's input space,
    :func:`transform_hessian`), on the weight's device.

    Returns ``(w_q, codes, delta, zp)``: the dequantized weight [C_in, C_out]
    f32 (sim mode), int8-container codes [C_in, C_out] (the JAX package's
    layout: transpose for the port's K-major int weights) and the
    per-output-channel grid [C_out] each, as ``weight_int_quant`` makes it.

    ``act_order`` quantizes rows by descending Hessian diagonal (a stable
    sort, as jnp.argsort: dead channels tie at 0) and puts them back in
    their order after."""
    k, n = w.shape
    if tuple(hess.shape) != (k, k):
        raise ValueError(f"hessian {tuple(hess.shape)} vs weight K={k}")
    wf = w.float()
    hess = hess.to(device=wf.device, dtype=torch.float64)
    delta, zp = weight_quant_params(wf, cfg)
    lo, hi = _code_bounds(cfg)
    inv_perm = None
    if act_order:
        perm = torch.argsort(-torch.diagonal(hess), stable=True)
        inv_perm = torch.argsort(perm)
        wf, hess = wf[perm], hess[perm][:, perm]
    block = min(block, k)
    kp = -(-k // block) * block
    if kp != k:
        wf = F.pad(wf, (0, 0, 0, kp - k))
        h = torch.zeros((kp, kp), dtype=torch.float64, device=wf.device)
        h[:k, :k] = hess
        pad = torch.arange(k, kp, device=wf.device)
        h[pad, pad] = 1.0
        hess = h
    u = _inverse_hessian_cholesky(hess, percdamp).float()
    wq, codes = _gptq_solve(wf, u, delta, zp, block, lo, hi)
    wq, codes = wq[:k], codes[:k]
    if inv_perm is not None:
        wq, codes = wq[inv_perm], codes[inv_perm]
    return wq, codes, delta, zp
