"""Plain reference of the flow-matching UniPC sampler (Zhao et al. 2023,
"UniPC", bh2 variant, data prediction), as the Wan2.1 release drives it:
``solver_order`` 2 with the last step of order 1, the corrector on every step
after the first, sigmas shifted by ``shift``. The scalar coefficients are
f64 on the host; the updates are f32 tensor arithmetic. :func:`replay` feeds
it the velocities a program produced and returns the latents it should
have produced after each step."""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch


def sigmas_and_timesteps(steps: int, shift: float, n_train: int = 1000):
    """(sigmas [steps + 1] ending in 0, integer timesteps [steps])."""
    s_max = 1.0 - 1.0 / n_train            # the training schedule's ends
    s_min = 0.0
    base = np.linspace(s_max, s_min, steps + 1)[:-1]
    sig = shift * base / (1 + (shift - 1) * base)
    return np.concatenate([sig, [0.0]]), (sig * n_train).astype(np.int64)


def _lam(sigma: float) -> float:
    """log(alpha / sigma) with alpha = 1 - sigma (sigma floored at 1e-12)."""
    return math.log(1.0 - sigma) - math.log(max(sigma, 1e-12))


def _update(x, m_hist: List[torch.Tensor], sig: np.ndarray, s: int, t: int, order: int,
            m_new=None):
    """x at sigma[s] -> x at sigma[t] from the data predictions m_hist (the
    newest last; m_hist[-1] at sigma[s], m_hist[-2] one step earlier). With
    ``m_new`` (the data prediction at sigma[t]) this is the corrector."""
    sig_t, sig_s = float(sig[t]), float(sig[s])
    alpha_t = 1.0 - sig_t
    lam_s = _lam(sig_s)
    h = _lam(sig_t) - lam_s
    hh = -h
    h_phi_1 = math.expm1(hh)
    b_h = math.expm1(hh)
    # the order-k system of the bh2 variant
    rks, d1 = [], []
    for i in range(1, order):
        rk = (_lam(float(sig[s - i])) - lam_s) / h
        rks.append(rk)
        d1.append((m_hist[-(i + 1)] - m_hist[-1]) / rk)
    rks.append(1.0)
    r_mat, b_vec = [], []
    h_phi_k = h_phi_1 / hh - 1
    fact = 1.0
    for i in range(1, order + 1):
        r_mat.append(np.power(np.asarray(rks), i - 1))
        b_vec.append(h_phi_k * fact / b_h)
        fact *= i + 1
        h_phi_k = h_phi_k / hh - 1 / fact
    r_mat, b_vec = np.stack(r_mat), np.asarray(b_vec)
    x_t = (sig_t / sig_s) * x - (alpha_t * h_phi_1) * m_hist[-1]
    if m_new is None:
        if not d1:
            return x_t
        rhos = [0.5] if order == 2 else np.linalg.solve(r_mat[:-1, :-1], b_vec[:-1])
        return x_t - alpha_t * b_h * sum(float(r) * d for r, d in zip(rhos, d1))
    rhos = [0.5] if order == 1 else np.linalg.solve(r_mat, b_vec)
    res = sum(float(r) * d for r, d in zip(rhos[:-1], d1)) if d1 else 0.0
    return x_t - alpha_t * b_h * (res + float(rhos[-1]) * (m_new - m_hist[-1]))


def replay(x0: torch.Tensor, velocities: Sequence[torch.Tensor], steps: int, shift: float,
           order: int = 2, dtype=torch.float32) -> List[torch.Tensor]:
    """The sampler run from x0 with ``velocities[i]`` as the model's output at
    step i (the first len(velocities) steps): the latents after each step.
    ``dtype`` is the precision of the tensor updates (the control's is lower)."""
    sig, _ = sigmas_and_timesteps(steps, shift)
    x = x0.to(dtype)
    hist: List[torch.Tensor] = []
    last = None          # the corrected sample of the previous step
    last_order = 1
    out = []
    for i, v in enumerate(velocities):
        m = (x - float(sig[i]) * v.to(dtype)).to(dtype)      # data prediction
        if i > 0:
            x = _update(last, hist, sig, i - 1, i, last_order, m_new=m).to(dtype)
        hist = (hist + [m])[-order:]
        this = min(order, steps - i, i + 1)
        last = x
        x = _update(x, hist, sig, i, i + 1, this).to(dtype)
        last_order = this
        out.append(x)
    return out
