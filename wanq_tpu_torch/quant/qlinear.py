"""Quantized linear application + QuantCtx (counterpart of
wanq_tpu/quant/qlinear.py).

The model calls :func:`qlinear` at every linear site with the layer's path
name; a :class:`QuantCtx` decides the behaviour from resolved per-layer
policies and an explicit quant state:

  fp     plain matmul in the param dtype
  calib  plain matmul + per-channel input statistics into ``ctx.collect``
  sim    simulated quantization: fake-quant activations (dynamic per token,
         static per tensor, or W4A4's per-(token, group) int4) times the
         fake-quant weight ``w_q``, through fp_linear's arithmetic
  int8   the int kernel routes:
         W8A8  per-token int8 activations (K7) x int8 weights (K2)
         W4A8  per-token int8 activations (K7) x packed int4 weights (K8)
         (an ffn.0 in front of an ffn.2 with a static scale: the GEMM's
         GELU + quant mode, K2's or K8's)
         W4A4  per-(token, 128-group) int4 activations x per-group int4
               weights (Atom, K9)

Layer state entries (``quant/ptq.py``): ``w_q`` [C_in, C_out] (sim);
``w_int8`` [C_out, C_in] (K-major;
the JAX package stores [C_in, C_out]) or packed ``w_int4`` [C_out, C_in/2],
``scale_w``/``zp_w_int`` [C_out] export params, ``delta_w``/``zp_w`` and,
for static activations, ``delta_a``/``zp_a``; W4A4 layers hold only packed
``w_int4g`` [C_out, C_in/2] and ``scale_wg`` [C_in/128, C_out].

SmoothQuant, QuaRot and ViDiT-Q layers transform the activation before its
quantizer, in sim and int8 mode alike: ``x * channel_mask`` [C_in], then
``@ ctx.rotations[C_in]``, an f32 product (TF32 off, as the CLIs set it).
A mask-only site in int8 mode hands the mask to K7 as its ``channel_scale``
(the same function); a rotated site quantizes the f32 rotated rows in K7.
A site with an SVDQuant low-rank branch (``lowrank_a`` [C_in, r],
``lowrank_b`` [r, C_out], bf16) adds ``(x' @ L1) @ L2`` to its quantized
output in both modes, x' the transformed activation, as fp_linear
multiplies (bf16 operands, f32 products); the fused producers refuse such
sites. Calibration with ``QuantCtx.hessian_regex`` also collects each
matching site's input Hessian ``<name>.hess`` = x^T x [C_in, C_in] over
every token, summed in f64.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

import torch

from wanq_tpu_torch.ops.fused import quant_sum
from wanq_tpu_torch.ops.qgemm import (
    w4a4_linear,
    w4a8_linear,
    w4a8_linear_gelu_quant,
    w8a8_linear,
    w8a8_linear_gelu_quant,
)
from wanq_tpu_torch.quant.config import FP_POLICY, LayerPolicy
from wanq_tpu_torch.quant.quantizers import (
    act_group_int4_quant,
    dynamic_fake_quant,
    fake_quant,
)

Params = Dict[str, Any]

MODES = ("fp", "calib", "sim", "int8")


@dataclasses.dataclass
class QuantCtx:
    """Carried through the model forward (a plain dataclass)."""

    mode: str = "fp"
    policies: Dict[str, LayerPolicy] = dataclasses.field(default_factory=dict)
    state: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(default_factory=dict)
    # activation-side rotations {C_in: f32 [C_in, C_in]} of quarot / viditq
    # layers (quant.ptq.prepare_quant_state, rebuild_rotations)
    rotations: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    # attention quantization: quant.attn.AttnQuantCfg instances or None
    attn: Any = None
    cross_attn: Any = None
    # per-layer attn-map reorder tables {layer: [H, S] int64}
    attn_perms: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # calibration outputs: layer path -> per-channel absmax [C_in] of the
    # input seen this call (plus .act_max/.act_min with collect_minmax)
    collect: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    collect_minmax: bool = False
    # calib: the sites (re.search) whose input Hessian is collected for GPTQ
    hessian_regex: Optional[str] = None
    # pool factor of the post-softmax self-attention map capture (0 = off) and
    # its reduce: "max" feeds reorder tables, "mean" (mass-preserving) feeds
    # select_temporal_windows. Set in calibration, or on a copy of a deployed
    # ctx by WanT2V.capture_attn_maps
    attn_map_pool: int = 0
    attn_map_reduce: str = "max"
    # sliding temporal-window self-attention (K4's band mode): an int radius
    # in latent frames, a per-head tuple (a negative entry = dense for that
    # head), or a models.attention.TemporalWindow; dit_forward resolves the
    # first two against the latent grid. None = dense.
    attn_window: Any = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown quant mode {self.mode!r}")
        if self.attn_map_reduce not in ("max", "mean"):
            raise ValueError(f"attn_map_reduce must be 'max' or 'mean', "
                             f"got {self.attn_map_reduce!r}")

    def policy(self, name: str) -> LayerPolicy:
        return self.policies.get(name, FP_POLICY)


def fp_linear(params: Params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ w + b with operands rounded to ``compute_dtype``, products
    summed into and returned as f32 (wanq_tpu's
    ``preferred_element_type=float32``), bias added in f32. On the card a
    16-bit GEMM writes its f32 accumulator directly
    (``torch.mm(..., out_dtype=float32)``); the CPU has no such overload,
    so there the rounded operands are multiplied in f32. The values are the
    same on both; only the order of the f32 sums differs."""
    a, w = x.to(compute_dtype), params["w"].to(compute_dtype)
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda and compute_dtype != torch.float32:
        y = torch.mm(a2, w, out_dtype=torch.float32)
    else:
        y = torch.mm(a2.float(), w.float())
    y = y.reshape(*a.shape[:-1], w.shape[-1])
    if params.get("b") is not None:
        y = y + params["b"].float()
    return y


def resolves_fp(ctx: Optional[QuantCtx], name: str) -> bool:
    """True iff qlinear(ctx, name, ...) would run the plain FP matmul with no
    side effects (calib mode collects statistics, so it is not)."""
    if ctx is None or ctx.mode == "fp":
        return True
    if ctx.mode == "calib":
        return False
    return not ctx.policy(name).is_quantized


def _check_int8_policy(policy: LayerPolicy, name: str) -> None:
    if policy.act is None or not policy.act.sym:
        raise NotImplementedError(
            f"{name}: the int path implements symmetric activations only")
    if policy.is_w4a4:
        return
    if policy.weight is None or policy.weight.active_bits not in (4, 8):
        raise NotImplementedError(
            f"{name}: the int path implements 4- and 8-bit weights only")
    if policy.act.active_bits != 8:
        raise NotImplementedError(
            f"{name}: the int path implements 8-bit activations, or W4A4")


def qlinear(ctx: Optional[QuantCtx], name: str, params: Params, x: torch.Tensor,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Quant-aware linear. x [B, N, C_in] -> [B, N, C_out] f32."""
    if ctx is None or ctx.mode == "fp":
        return fp_linear(params, x, compute_dtype)

    if ctx.mode == "calib":
        xf = x.float()
        lead = tuple(range(xf.ndim - 1))
        ctx.collect[name] = xf.abs().amax(dim=lead)
        if ctx.collect_minmax:
            ctx.collect[f"{name}.act_max"] = xf.amax(dim=lead)
            ctx.collect[f"{name}.act_min"] = xf.amin(dim=lead)
        if ctx.hessian_regex and re.search(ctx.hessian_regex, name):
            # f64 sums: at T2V-1.3B a few massive channels put most of a
            # site's energy in one direction, and an f32 sum over a sweep's
            # tokens errs by ~2e-5 of the top eigenvalue, more than GPTQ's
            # damping (1% of the mean diagonal: down to 6.5e-6 of the top
            # eigenvalue at C = 1536), which made the damped Hessian of
            # blocks.29.self_attn.o indefinite
            x2 = xf.reshape(-1, xf.shape[-1]).double()
            ctx.collect[f"{name}.hess"] = x2.t() @ x2
        return fp_linear(params, x, compute_dtype)

    policy = ctx.policy(name)
    if not policy.is_quantized:
        return fp_linear(params, x, compute_dtype)
    st = ctx.state[name]
    b, n, c = x.shape
    bias = params.get("b")
    if ctx.mode == "sim":
        xt = _transformed(ctx, policy, st, x)
        return _maybe_lowrank(st, xt, _sim_linear(policy, st, bias, xt, compute_dtype))
    _check_int8_policy(policy, name)
    if policy.is_w4a4:
        # x [B, N, C] -> [B*N, C] is a view; the act quant runs inside
        xt = _transformed(ctx, policy, st, x)
        y = w4a4_linear(xt.reshape(b * n, c), st["w_int4g"], st["scale_wg"],
                        None if bias is None else bias.float(), group=policy.group)
        return _maybe_lowrank(st, xt, y.reshape(b, n, -1))
    if not policy.act.dynamic:
        # the transformed input, as sim mode quantizes it (the weight was
        # divided by the mask and rotated)
        scale = st["delta_a"].reshape(())
        xt = _transformed(ctx, policy, st, x).float()
        q = torch.clamp(torch.round(xt / scale), -128, 127).to(torch.int8)
        s_a = scale.expand(b, n).contiguous()
        sum_a = s_a * q.float().sum(dim=-1)
    elif policy.uses_rotation:
        xt = _transformed(ctx, policy, st, x)
        q, s_a, sum_a = quant_sum(xt)  # K7 on the f32 rows
    else:
        # K7 without GELU on the card; a SmoothQuant mask is its
        # channel_scale, so x * mask is made only for a low-rank branch
        xt = _transformed(ctx, policy, st, x) if "lowrank_a" in st else None
        q, s_a, sum_a = quant_sum(x, channel_scale=st.get("channel_mask"))
    return _maybe_lowrank(st, xt, _int_linear(st, q, s_a, sum_a, bias, torch.float32))


def _maybe_lowrank(st, xt: Optional[torch.Tensor], y: torch.Tensor) -> torch.Tensor:
    """y + (xt @ L1) @ L2 where the layer has an SVDQuant branch: two rank-r
    products of bf16 operands into f32, as fp_linear takes them, on the
    transformed activation ``xt`` (the space the residual was split in)."""
    if "lowrank_a" not in st:
        return y
    h = fp_linear({"w": st["lowrank_a"]}, xt)
    return y + fp_linear({"w": st["lowrank_b"]}, h)


def _transformed(ctx: QuantCtx, policy: LayerPolicy, st, x: torch.Tensor) -> torch.Tensor:
    """The method's activation transform, f32 [B, N, C]: ``x * mask`` for
    smooth_quant / viditq, then ``@ rotation`` for quarot / viditq; x as
    given for the other methods."""
    if not (policy.uses_channel_mask or policy.uses_rotation):
        return x
    xf = x.float()
    if policy.uses_channel_mask:
        xf = xf * st["channel_mask"]
    if policy.uses_rotation:
        b, n, c = xf.shape
        xf = torch.mm(xf.reshape(b * n, c), ctx.rotations[c]).reshape(b, n, c)
    return xf


def _sim_linear(policy: LayerPolicy, st, bias, x: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    """Simulated quantization of one linear: the (transformed) activation is
    fake-quantized in f32, rounded to ``compute_dtype`` with the fake-quant
    weight ``w_q``, and multiplied as fp_linear multiplies (f32 sums, f32
    bias)."""
    b, n, c = x.shape
    xf = x.float()
    if policy.is_w4a4:
        # Atom W4A4: per-(token, K-group) int4 activations against the
        # group-dequantized weight, the math of the K9 kernel up to the
        # order of the f32 sums
        g = policy.group
        q4, s4 = act_group_int4_quant(xf.reshape(b * n, c), g)
        xq = (q4.float().reshape(b * n, c // g, g) * s4[..., None]).reshape(b, n, c)
    elif policy.act is not None and not policy.act.dynamic:
        xq = fake_quant(xf, st["delta_a"], st["zp_a"], policy.act.active_bits,
                        policy.act.sym)
    elif policy.act is not None:
        xq = dynamic_fake_quant(xf.reshape(b * n, c), policy.act).reshape(b, n, c)
    else:
        xq = xf
    return fp_linear({"w": st["w_q"], "b": bias}, xq, compute_dtype)


def _int_linear(st, q, s_a, sum_a, bias, out_dtype):
    """Int GEMM on the exported weight: W8A8 (K2) for ``w_int8`` state,
    W4A8 (K8) for packed ``w_int4`` state."""
    gemm, w = ((w4a8_linear, st["w_int4"]) if "w_int4" in st
               else (w8a8_linear, st["w_int8"]))
    return gemm(q, w, s_a, st["scale_w"], sum_a, st["zp_w_int"],
                None if bias is None else bias.float(), out_dtype=out_dtype)


def int8_fusable(ctx: Optional[QuantCtx], names, allow_mask: bool = False) -> bool:
    """True when every site can take the fused int8 fast path: 4- or 8-bit
    weight + dynamic symmetric 8-bit act, no rotation/mask, int state
    (``w_int8`` or packed ``w_int4``)."""
    if ctx is None or ctx.mode != "int8":
        return False
    for nm in names:
        pol = ctx.policy(nm)
        if not pol.is_quantized or pol.uses_rotation:
            return False
        if pol.uses_channel_mask and not allow_mask:
            return False
        if pol.weight is None or pol.weight.active_bits not in (4, 8):
            return False
        if pol.act is None or not pol.act.sym or pol.act.active_bits != 8:
            return False
        if not pol.act.dynamic:
            return False
        st = ctx.state.get(nm)
        if st is None or ("w_int8" not in st and "w_int4" not in st):
            return False
        if "lora_a" in st or "lowrank_a" in st:
            return False
    return True


def int8_static_fusable(ctx: Optional[QuantCtx], name: str) -> bool:
    """True when a site can consume a static-scale fused producer."""
    if ctx is None or ctx.mode != "int8":
        return False
    pol = ctx.policy(name)
    if not pol.is_quantized or pol.uses_rotation or pol.uses_channel_mask:
        return False
    if pol.weight is None or pol.weight.active_bits not in (4, 8):
        return False
    if pol.act is None or not pol.act.sym or pol.act.active_bits != 8:
        return False
    if pol.act.dynamic:
        return False
    st = ctx.state.get(name)
    return (st is not None and "delta_a" in st and "lora_a" not in st
            and "lowrank_a" not in st and ("w_int8" in st or "w_int4" in st))


def w8a8_from_prequant(ctx: QuantCtx, name: str, params: Params, q8: torch.Tensor,
                       s_a: torch.Tensor, ssum: torch.Tensor,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Int GEMM (K2, or K8 for packed int4 weights) from an already
    quantized activation. q8 [B, N, C] int8; s_a/ssum [B, N]."""
    _check_int8_policy(ctx.policy(name), name)
    return _int_linear(ctx.state[name], q8, s_a, ssum, params.get("b"), out_dtype)


def ffn0_gelu_quant_from_prequant(ctx: QuantCtx, site0: str, site2: str, params0: Params,
                                  q8: torch.Tensor, s_a: torch.Tensor, ssum: torch.Tensor):
    """The int GEMM at ``site0`` (ffn.0) from an already quantized
    activation, then tanh-GELU and the int8 quant that ``site2`` (ffn.2)
    consumes. Returns ffn.2's (codes [B, N, C_out] int8, scale [B, N], scaled
    code sum [B, N]). Under a static ffn.2 scale (``int8_static_fusable``)
    the whole chain runs in the GEMM's GELU + quant mode, K2's for int8 weights
    and K8's for packed int4 weights, so the bf16 intermediate never reaches
    device memory. Under a dynamic ffn.2 scale the GEMM's bf16 output goes
    through K7."""
    _check_int8_policy(ctx.policy(site0), site0)
    st0, st2 = ctx.state[site0], ctx.state[site2]
    bias = params0.get("b")
    if int8_static_fusable(ctx, site2):
        gemm, w = ((w4a8_linear_gelu_quant, st0["w_int4"]) if "w_int4" in st0
                   else (w8a8_linear_gelu_quant, st0["w_int8"]))
        return gemm(q8, w, s_a, st0["scale_w"], st2["delta_a"], ssum, st0["zp_w_int"],
                    None if bias is None else bias.float())
    h = _int_linear(st0, q8, s_a, ssum, bias, torch.bfloat16)
    return quant_sum(h, gelu=True, channel_scale=st2.get("channel_mask"))
