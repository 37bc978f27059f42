"""Quantization-fidelity metrics (counterpart of wanq_tpu/utils/metrics.py):
PSNR, relative error and cosine between an FP output set and a quantized
one, computed in float64 on ``device`` (the card unless the caller asks
for the CPU). Inputs are numpy arrays or tensors.

:func:`quant_fidelity_report`'s ``psnr_db`` is :func:`latent_psnr`: its
range is the FP set's max - min, not the 2.0 of a [-1, 1] video that
:func:`psnr` defaults to.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is; an array (or anything numpy reads) as a tensor."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def as_f64(x, device="cuda") -> torch.Tensor:
    return as_tensor(x).to(device=device, dtype=torch.float64)


def psnr(a, b, data_range: float = 2.0, device="cuda") -> float:
    """Peak signal-to-noise ratio in dB (default range 2.0 for [-1,1] video)."""
    mse = float(torch.mean((as_f64(a, device) - as_f64(b, device)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def latent_psnr(a, b, device="cuda") -> float:
    """PSNR with the range of the FP set ``a`` (max - min; 1.0 if constant)."""
    a = as_f64(a, device)
    rng = float(a.max() - a.min()) or 1.0
    return psnr(a, b, data_range=rng, device=device)


def relative_error(a, b, device="cuda") -> float:
    a, b = as_f64(a, device), as_f64(b, device)
    denom = float(a.abs().max()) or 1.0
    return float((a - b).abs().max()) / denom


def cosine_similarity(a, b, device="cuda") -> float:
    a, b = as_f64(a, device).reshape(-1), as_f64(b, device).reshape(-1)
    # norms as sqrt(a . a), numpy's: a set against itself reads 1 to an ulp
    na, nb = math.sqrt(float(torch.dot(a, a))), math.sqrt(float(torch.dot(b, b)))
    if na == 0 or nb == 0:
        return 1.0 if na == nb else 0.0
    return float(torch.dot(a, b)) / (na * nb)


def quant_fidelity_report(fp, quant, device="cuda") -> Dict[str, float]:
    """psnr_db (latent_psnr), rel_err and cosine of ``quant`` against
    ``fp``; where either holds a non-finite value, also how many
    (nonfinite_quant, nonfinite_fp)."""
    fp, quant = as_f64(fp, device), as_f64(quant, device)
    rep = {
        "psnr_db": latent_psnr(fp, quant, device),
        "rel_err": relative_error(fp, quant, device),
        "cosine": cosine_similarity(fp, quant, device),
    }
    nonfinite = int(quant.numel() - int(torch.isfinite(quant).sum()))
    fp_nonfinite = int(fp.numel() - int(torch.isfinite(fp).sum()))
    if nonfinite or fp_nonfinite:
        rep["nonfinite_quant"] = float(nonfinite)
        rep["nonfinite_fp"] = float(fp_nonfinite)
    return rep
