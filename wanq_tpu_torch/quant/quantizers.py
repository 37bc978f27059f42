"""Pure-function quantizers (counterpart of wanq_tpu/quant/quantizers.py):
the int exports of the W8A8, W4A8 and W4A4 kernel routes and the
fake-quant forms (quantize then dequantize in floating point) of sim mode
and of the simulated attention quantizers.

symmetric:  n_levels = 2**(b-1) - 1, delta = absmax / n_levels, zp = 0
asymmetric: n_levels = 2**b, delta = (max(x,0) - min(x,0)) / (n_levels - 1),
            zp = round(min(x,0) / delta) + n_levels / 2
int value:  clamp(round(x / delta) - zp), dequant (q + zp) * delta
Rounding is half to even (torch.round), as jnp.round, and divisions by a
constant are true IEEE divisions on every device (``ops.fused.true_div``).

Int weights are K-major, [C_out, C_in], where the JAX package stores
[C_in, C_out]. Packed int4 weights are int8 [C_out, C_in / 2]: byte j of
row n holds k = 2j in its low nibble and k = 2j + 1 in its high nibble, so
they are the transpose of the JAX package's [C_in / 2, C_out] bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from wanq_tpu_torch.ops.fused import true_div

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
        delta = true_div(xf.abs().amax(dim=1), nl)
        delta = torch.where(delta < _EPS_SYM, torch.full_like(delta, _EPS_SYM), delta)
        zp = torch.zeros_like(delta)
    else:
        zero = xf.new_zeros(())  # jnp.maximum / minimum: a tie splits the gradient
        x_max = torch.maximum(xf.amax(dim=1), zero)
        x_min = torch.minimum(xf.amin(dim=1), zero)
        delta = true_div(x_max - x_min, nl - 1)
        delta = torch.where(delta < _EPS_ASYM, torch.full_like(delta, _EPS_ASYM), delta)
        zp = torch.round(x_min / delta) + (nl / 2)
    return delta[:, None], zp[:, None]


def params_from_minmax(x_max: torch.Tensor, x_min: torch.Tensor, cfg: QuantizerCfg):
    """Static (delta, zp) [G, 1] from accumulated min/max."""
    nl = n_levels_for(cfg.active_bits, cfg.sym)
    if cfg.sym:
        absmax = torch.maximum(x_max.abs(), x_min.abs())
        d = true_div(absmax, nl)
        delta = torch.where(d < _EPS_SYM, torch.full_like(d, _EPS_SYM), d)
        zp = torch.zeros_like(delta)
    else:
        delta = true_div(x_max - x_min, nl - 1)
        delta = torch.where(delta < _EPS_ASYM, torch.full_like(delta, _EPS_ASYM), delta)
        zp = torch.round(x_min / delta) + (nl / 2)
    return delta[:, None], zp[:, None]


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Straight-through round: round half to even in the forward, the
    identity in the backward (QLoRA and QAT train through the quantizers)."""
    return x + (torch.round(x) - x).detach()


def quantize(x: torch.Tensor, delta: torch.Tensor, zp: torch.Tensor, n_bits: int,
             sym: bool) -> torch.Tensor:
    """q = clamp(round(x / delta) - zp, -nl - 1, nl), in f32. The clamp is
    jnp.clip's maximum-then-minimum, whose gradient splits evenly at a bound
    (torch.clamp would pass all of it); the gradient also flows through a
    dynamic ``delta``, as in ``wanq_tpu``."""
    nl = n_levels_for(n_bits, sym)
    q = round_ste(x.float() / delta) - zp
    lo = torch.full((), -nl - 1, dtype=q.dtype, device=q.device)
    return torch.minimum(torch.maximum(q, lo), lo.new_full((), nl))


def dequantize(q: torch.Tensor, delta: torch.Tensor, zp: torch.Tensor) -> torch.Tensor:
    """x' = (q + zp) * delta."""
    return (q + zp) * delta


def fake_quant(x: torch.Tensor, delta: torch.Tensor, zp: torch.Tensor, n_bits: int,
               sym: bool) -> torch.Tensor:
    """Quantize then dequantize with the given params (f32 out)."""
    return dequantize(quantize(x, delta, zp, n_bits, sym), delta, zp)


def dynamic_fake_quant(x: torch.Tensor, cfg: QuantizerCfg) -> torch.Tensor:
    """Per-call params from x itself; x [G, -1] (one group per row), the
    output keeps x's dtype."""
    n_bits = cfg.active_bits
    delta, zp = compute_quant_params(x, n_bits, cfg.sym)
    return fake_quant(x, delta, zp, n_bits, cfg.sym).to(x.dtype)


def weight_quant_params(w_in_out: torch.Tensor, cfg: QuantizerCfg):
    """Per-output-channel (delta, zp), each [C_out], of a [C_in, C_out]
    weight (the JAX package's param layout, kept by the port's params)."""
    d, z = compute_quant_params(w_in_out.t(), cfg.active_bits, cfg.sym)
    return d[:, 0], z[:, 0]


def weight_fake_quant(w_in_out: torch.Tensor, cfg: QuantizerCfg) -> torch.Tensor:
    """Static fake-quant of a [C_in, C_out] weight, one group per output
    channel; the output keeps the weight's dtype and layout."""
    d, z = weight_quant_params(w_in_out, cfg)
    return fake_quant(w_in_out, d[None, :], z[None, :], cfg.active_bits,
                      cfg.sym).to(w_in_out.dtype)


def weight_int_quant(w_in_out: torch.Tensor, cfg: QuantizerCfg):
    """(codes [C_out, C_in] int8, scale [C_out], zp [C_out]) of a [C_in,
    C_out] weight, codes = clamp(round(w / scale) - zp) into [-128, 127]
    (8-bit) or [-8, 7] (4-bit), dequant (codes + zp) * scale. The codes come
    out K-major for the int GEMM kernels; :func:`pack_int4` packs 4-bit
    codes two per byte."""
    if cfg.active_bits not in (4, 8):
        raise ValueError(f"int export supports 4/8-bit weights, not {cfg.active_bits}")
    d, z = weight_quant_params(w_in_out, cfg)
    q = torch.round(w_in_out.t().float() / d[:, None]) - z[:, None]
    lo, hi = (-8, 7) if cfg.active_bits == 4 else (-128, 127)
    return torch.clamp(q, lo, hi).to(torch.int8).contiguous(), d, z


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 codes (int8 containers in [-8, 7]) [N, K] -> [N, K / 2] int8:
    k = 2j in the low nibble of byte j, k = 2j + 1 in the high nibble."""
    if q.shape[-1] % 2:
        raise ValueError(f"K={q.shape[-1]} must be even to pack int4 pairs")
    lo = q[..., 0::2].to(torch.int32) & 0xF
    hi = q[..., 1::2].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8).contiguous()


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[N, K / 2] packed int8 -> [N, K] int8 in [-8, 7]; the low nibble
    sign-extends as (b << 4) >> 4 and the high one as b >> 4."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], 2 * packed.shape[-1])


GROUP_SIZE_W4A4 = 128


def act_group_int4_quant(x: torch.Tensor, group: int = GROUP_SIZE_W4A4):
    """Dynamic symmetric per-(token, K-group) int4 quant of x [M, K]:
    (q int8 [M, K] in [-8, 7], scale f32 [M, K / group])."""
    m, k = x.shape
    if k % group:
        raise ValueError(f"group {group} must divide K={k}")
    xf = x.float().reshape(m, k // group, group)
    scale = torch.clamp_min(true_div(xf.abs().amax(dim=-1), 7.0), _EPS_SYM)
    q = torch.clamp(torch.round(xf / scale[..., None]), -8, 7).to(torch.int8)
    return q.reshape(m, k), scale


def weight_group_int4_quant(w_in_out: torch.Tensor, group: int = GROUP_SIZE_W4A4):
    """Static symmetric per-(K-group, out-channel) int4 quant of a [K, N]
    weight: (codes int8 [N, K] K-major in [-8, 7], scale f32 [K / group, N])."""
    k, n = w_in_out.shape
    if k % group:
        raise ValueError(f"group {group} must divide K={k}")
    wf = w_in_out.float().reshape(k // group, group, n)
    scale = torch.clamp_min(true_div(wf.abs().amax(dim=1), 7.0), _EPS_SYM)
    q = torch.clamp(torch.round(wf / scale[:, None, :]), -8, 7).to(torch.int8)
    return q.reshape(k, n).t().contiguous(), scale
