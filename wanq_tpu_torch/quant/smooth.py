"""SmoothQuant channel scaling (counterpart of wanq_tpu/quant/smooth.py).

channel_mask = |w_absmax|^alpha / |a_absmax|^(1-alpha)   per input channel.

The activation is multiplied by the mask before its quantizer and the
weight divided by it (per input channel) before its quantizer, so the FP
product is unchanged while outlier energy moves from activations into
weights. Both divisions are tensor by tensor, true IEEE divisions on every
device.
"""

from __future__ import annotations

import torch


def channel_mask(w_in_out: torch.Tensor, act_absmax: torch.Tensor, alpha: float) -> torch.Tensor:
    """Per-input-channel mask [C_in] of a [C_in, C_out] weight; ``act_absmax``
    [C_in] is the calibration absmax, clamped >= 1e-3 upstream
    (``ptq.reduce_calib``)."""
    w_absmax = w_in_out.float().abs().amax(dim=1)
    return w_absmax.abs().pow(alpha) / act_absmax.float().abs().pow(1.0 - alpha)


def clamp_act_absmax(act_absmax: torch.Tensor, floor: float = 1e-3) -> torch.Tensor:
    """Calibration absmax clamped to >= ``floor``."""
    return torch.clamp_min(act_absmax, floor)
