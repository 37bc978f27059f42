"""Pure-function quantizers (counterpart of wanq_tpu/quant/quantizers.py,
the subset the W8A8 path needs).

symmetric:  n_levels = 2**(b-1) - 1, delta = absmax / n_levels, zp = 0
asymmetric: n_levels = 2**b, delta = (max(x,0) - min(x,0)) / (n_levels - 1),
            zp = round(min(x,0) / delta) + n_levels / 2
int value:  clamp(round(x / delta) - zp), dequant (q + zp) * delta
Rounding is half to even (torch.round), as jnp.round.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

_EPS_SYM = 1e-6
_EPS_ASYM = 1e-8


@dataclasses.dataclass(frozen=True)
class QuantizerCfg:
    """Static quantizer configuration; ``n_bits`` may be a tuple (mixed
    precision) with ``i_bitwidth`` selecting the active entry."""

    n_bits: Union[int, Tuple[int, ...]] = 8
    sym: bool = False
    i_bitwidth: int = 0
    dynamic: bool = True

    @property
    def is_mixed(self) -> bool:
        return isinstance(self.n_bits, (tuple, list))

    @property
    def active_bits(self) -> int:
        if self.is_mixed:
            return int(self.n_bits[self.i_bitwidth])
        return int(self.n_bits)

    def with_bitwidth(self, i_bitwidth: int) -> "QuantizerCfg":
        return dataclasses.replace(self, i_bitwidth=i_bitwidth)


def n_levels_for(n_bits: int, sym: bool) -> int:
    return 2 ** (n_bits - 1) - 1 if sym else 2**n_bits


def compute_quant_params(x: torch.Tensor, n_bits: int, sym: bool):
    """Per-row (delta, zero_point) of x [G, -1], each shaped [G, 1]."""
    if x.ndim != 2:
        raise ValueError(f"expected [G, -1], got {tuple(x.shape)}")
    nl = n_levels_for(n_bits, sym)
    xf = x.float()
    if sym:
        delta = xf.abs().amax(dim=1) / nl
        delta = torch.where(delta < _EPS_SYM, torch.full_like(delta, _EPS_SYM), delta)
        zp = torch.zeros_like(delta)
    else:
        x_max = torch.clamp_min(xf.amax(dim=1), 0.0)
        x_min = torch.clamp_max(xf.amin(dim=1), 0.0)
        delta = (x_max - x_min) / (nl - 1)
        delta = torch.where(delta < _EPS_ASYM, torch.full_like(delta, _EPS_ASYM), delta)
        zp = torch.round(x_min / delta) + (nl / 2)
    return delta[:, None], zp[:, None]


def params_from_minmax(x_max: torch.Tensor, x_min: torch.Tensor, cfg: QuantizerCfg):
    """Static (delta, zp) [G, 1] from accumulated min/max."""
    nl = n_levels_for(cfg.active_bits, cfg.sym)
    if cfg.sym:
        absmax = torch.maximum(x_max.abs(), x_min.abs())
        d = absmax / nl
        delta = torch.where(d < _EPS_SYM, torch.full_like(d, _EPS_SYM), d)
        zp = torch.zeros_like(delta)
    else:
        delta = (x_max - x_min) / (nl - 1)
        delta = torch.where(delta < _EPS_ASYM, torch.full_like(delta, _EPS_ASYM), delta)
        zp = torch.round(x_min / delta) + (nl / 2)
    return delta[:, None], zp[:, None]


def weight_quant_params(w_in_out: torch.Tensor, cfg: QuantizerCfg):
    """Per-output-channel (delta, zp), each [C_out], of a [C_in, C_out]
    weight (the JAX package's param layout, kept by the port's params)."""
    d, z = compute_quant_params(w_in_out.t(), cfg.active_bits, cfg.sym)
    return d[:, 0], z[:, 0]


def weight_int_quant(w_in_out: torch.Tensor, cfg: QuantizerCfg):
    """(w_int8 [C_out, C_in], scale [C_out], zp [C_out]) of a [C_in, C_out]
    weight, int = clamp(round(w / scale) - zp, -128, 127), dequant
    (int + zp) * scale. The codes come out K-major (transposed from the JAX
    package's [C_in, C_out]) for the int8 GEMM kernel."""
    if cfg.active_bits != 8:
        raise NotImplementedError(
            "int4 weight export (W4A8 packing) is not ported yet "
            "(ROADMAP Queue 1 item 7, kernel K8)")
    d, z = weight_quant_params(w_in_out, cfg)
    q = torch.round(w_in_out.t().float() / d[:, None]) - z[:, None]
    return torch.clamp(q, -128, 127).to(torch.int8).contiguous(), d, z


def act_dynamic_int_quant(x: torch.Tensor, sym: bool = True):
    """Dynamic per-token int8 quant: (x_int8, scale [...], sum [...]) with
    sum = scale * sum(q) (the GEMM's zero-point correction input)."""
    if not sym:
        raise NotImplementedError("asymmetric activation int quant not used by Wan")
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, _EPS_SYM)
    q = torch.clamp(torch.round(xf / scale[..., None]), -128, 127).to(torch.int8)
    return q, scale, scale * q.float().sum(dim=-1)
