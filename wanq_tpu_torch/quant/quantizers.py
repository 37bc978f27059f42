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


# elements of one row chunk of the straight-through fake-quant's passes: each
# f32 transient of its forward and backward stays at 256 MiB, and each chunk
# costs a dozen launches a pass
STE_CHUNK = 1 << 26


def row_chunks(m: int, c: int):
    """[start, stop) row ranges of an [m, c] tensor, about STE_CHUNK elements
    each and of near-equal rows (no short tail: a reduction along a row then
    runs in the same order as over the whole tensor)."""
    n = max(1, -(-m * c // STE_CHUNK))
    step = -(-m // n)
    return [(i, min(m, i + step)) for i in range(0, m, step)]


class _SymFakeQuantSTE(torch.autograd.Function):
    """Symmetric fake-quant of x [M, C] with the straight-through round, the
    function of ``fake_quant(x, *compute_quant_params(x, n_bits, True), ...)``
    (``delta`` None: per row, the gradient through the absmax) or of
    ``fake_quant(x, delta, zp, ...)`` (static), with that autograd chain's
    gradients. It keeps x as it came and the per-row delta [M, 1]; the
    backward rebuilds the f32 intermediates a chunk of rows at a time."""

    @staticmethod
    def forward(ctx, x, delta, zp, n_bits, out_dtype):
        if zp is not None and zp.requires_grad:
            raise ValueError("the zero point takes no gradient")
        nl = n_levels_for(n_bits, True)
        m, c = x.shape
        out = torch.empty((m, c), dtype=out_dtype, device=x.device)
        dyn = delta is None
        d_rows = torch.empty((m, 1), dtype=torch.float32, device=x.device) if dyn else None
        for i, j in row_chunks(m, c):
            xf = x[i:j].float()
            if dyn:
                d = true_div(xf.abs().amax(dim=1), nl)
                d = torch.where(d < _EPS_SYM, torch.full_like(d, _EPS_SYM), d)[:, None]
                d_rows[i:j] = d
                z = 0.0
            else:
                d, z = delta, zp
            # round(u) is u + (round(u) - u) bit for bit (the difference is
            # exact), and clamp is maximum-then-minimum's value; q + zp turns
            # a -0 code into +0 as the chain does
            q = torch.clamp(torch.round(xf / d) - z, -nl - 1, nl)
            out[i:j] = (q + z) * d
        ctx.nl, ctx.dyn = nl, dyn
        ctx.save_for_backward(x, d_rows if dyn else delta, zp)
        return out

    @staticmethod
    def backward(ctx, g):
        x, delta, zp = ctx.saved_tensors
        nl, dyn = ctx.nl, ctx.dyn
        want_x, want_d = ctx.needs_input_grad[:2]
        m, c = x.shape
        gx = torch.empty_like(x) if want_x else None
        # a static delta's gradient is a sum over the whole tensor: its two
        # terms are kept whole, so that each sums in the chain's order
        if want_d:
            whole = [torch.empty((m, c), device=x.device) for _ in range(2)]
        for i, j in row_chunks(m, c):
            if dyn and not want_x:
                break
            xf, gf = x[i:j].float(), g[i:j].float()
            d = delta[i:j] if dyn else delta
            z = 0.0 if dyn else zp
            u = xf / d
            q = torch.round(u) - z
            gq = gf * d
            # the STE passes the gradient; the clamp's maximum / minimum halve
            # it at a bound and stop it outside
            gu = torch.where((q == -nl - 1) | (q == nl), gq / 2, gq).masked_fill_(
                (q < -nl - 1) | (q > nl), 0.0)
            # delta's gradient: through (q + zp) * delta and through x / delta,
            # each term's sum as the chain's mul and div backwards take it
            if dyn or want_d:
                d_out = gf * (torch.clamp(q, -nl - 1, nl) + z)
                d_div = -gu * (u / d)
            if dyn:
                # delta = where(absmax / nl < eps, eps, absmax / nl): nothing on
                # the eps branch; torch.amax shares its gradient evenly among
                # the tied maxima; abs passes it times sgn(x). A row's sums do
                # not depend on the chunk (row_chunks keeps chunks long)
                gd = d_out.sum(dim=1, keepdim=True) + d_div.sum(dim=1, keepdim=True)
                a = xf.abs()
                amax = a.amax(dim=1, keepdim=True)
                ga = true_div(gd.masked_fill(true_div(amax, nl) < _EPS_SYM, 0.0), nl)
                tied = a == amax
                gabs = (ga / tied.sum(dim=1, keepdim=True)) * tied
                gx[i:j] = (gu / d + gabs * xf.sgn()).to(x.dtype)
                continue
            if want_x:
                gx[i:j] = (gu / d).to(x.dtype)
            if want_d:
                whole[0][i:j], whole[1][i:j] = d_out, d_div
        gdelta = None
        if want_d:
            gdelta = (whole[0].sum() + whole[1].sum()).expand(delta.shape).clone()
        return gx, gdelta, None, None, None


def fake_quant_ste(x: torch.Tensor, n_bits: int, delta: torch.Tensor = None,
                   zp: torch.Tensor = None, out_dtype=torch.float32) -> torch.Tensor:
    """Symmetric straight-through fake-quant of x [M, C] as one autograd
    Function: per row from x's absmax (``delta`` None) or with a static
    ``delta`` / ``zp`` (shape [1]; zp takes no gradient). The values of the
    ``quantize`` / ``dequantize`` chain, cast to ``out_dtype`` (the trainable
    linear asks bf16, its product's operand); its gradients; x is kept in
    its own dtype and no [M, C] f32 tensor outlives a call."""
    return _SymFakeQuantSTE.apply(x, delta, zp, n_bits, out_dtype)


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
