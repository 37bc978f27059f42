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
         with ``QuantCtx.trainable`` (set by ``dit_forward(training=True)``)
         the W8A8 / W4A8 state trains instead: the codes are dequantized
         for the moment of the product, ``(codes + zp) * scale``, the
         activation is fake-quantized with the straight-through round, and
         one differentiable bf16 product with an f32 result replaces the
         int kernels (W4A4 has no such route and raises)

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
every token, summed in f64. Under a sharding plan (``QuantCtx.collect_groups``,
set by ``dit_forward``) each statistic is reduced over the ranks that hold the
site's other rows: absmax and ``act_max`` by MAX, ``act_min`` by MIN, the f64
Hessian by SUM (float64 on the wire too).

A QLoRA adapter in a layer's state (``lora_a`` [C_in, r], ``lora_b`` [r,
C_out], alpha/r folded into ``lora_b`` by ``training/lora.py``) adds ``(x @
lora_a) @ lora_b`` in f32 on the raw layer input after every quantized route
(sim, int8, trainable); the fused producers refuse adapted sites, so they
take these routes.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

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
    fake_quant_ste,
    row_chunks,
    unpack_int4,
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
    # the QLoRA / QAT route of int8 mode: int-at-rest weights dequantized for a
    # differentiable bf16 product, the activations fake-quantized with the
    # straight-through round. dit_forward(training=True) sets it
    trainable: bool = False
    # calib under a sharding plan (dit_forward sets it): the process groups
    # over which a site's statistics reduce, (fed by this rank's tokens, fed
    # by the text context or the timesteps); a None entry reduces nothing
    collect_groups: Optional[tuple] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown quant mode {self.mode!r}")
        if self.attn_map_reduce not in ("max", "mean"):
            raise ValueError(f"attn_map_reduce must be 'max' or 'mean', "
                             f"got {self.attn_map_reduce!r}")

    def policy(self, name: str) -> LayerPolicy:
        return self.policies.get(name, FP_POLICY)


_REDUCE_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN, "sum": dist.ReduceOp.SUM}


def reduce_stat(ctx: QuantCtx, t: torch.Tensor, op: str) -> torch.Tensor:
    """A calibration statistic of this rank's rows, reduced in place by
    ``op`` ('max', 'min', 'sum') over ``ctx.collect_groups[0]``; as it is
    without one."""
    group = None if ctx.collect_groups is None else ctx.collect_groups[0]
    if group is not None:
        dist.all_reduce(t, op=_REDUCE_OPS[op], group=group)
    return t


def context_rows(ctx: Optional[QuantCtx]) -> Optional[QuantCtx]:
    """``ctx`` for a site fed by the text context or the timesteps, which
    every rank of the token axes holds whole: its statistics reduce over the
    second group of ``collect_groups`` (the batch's)."""
    if ctx is None or ctx.collect_groups is None:
        return ctx
    group = ctx.collect_groups[1]
    return dataclasses.replace(ctx, collect=ctx.collect, collect_groups=(group, group))


class _MmF32(torch.autograd.Function):
    """a [M, K] @ w [K, N] of 16-bit operands into an f32 result on the card
    (``torch.mm(..., out_dtype=float32)``), differentiable: each operand's
    gradient is the product of the other with the cotangent rounded to the
    operands' dtype, summed in f32 and rounded to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.mm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g16 = g.to(a.dtype)
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g16, w.t(), out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(a.t(), g16, out_dtype=torch.float32).to(w.dtype)
        return ga, gw


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
        y = _MmF32.apply(a2, w)
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
        ctx.collect[name] = reduce_stat(ctx, xf.abs().amax(dim=lead), "max")
        if ctx.collect_minmax:
            ctx.collect[f"{name}.act_max"] = reduce_stat(ctx, xf.amax(dim=lead), "max")
            ctx.collect[f"{name}.act_min"] = reduce_stat(ctx, xf.amin(dim=lead), "min")
        if ctx.hessian_regex and re.search(ctx.hessian_regex, name):
            # f64 sums: at T2V-1.3B a few massive channels put most of a
            # site's energy in one direction, and an f32 sum over a sweep's
            # tokens errs by ~2e-5 of the top eigenvalue, more than GPTQ's
            # damping (1% of the mean diagonal: down to 6.5e-6 of the top
            # eigenvalue at C = 1536), which made the damped Hessian of
            # blocks.29.self_attn.o indefinite
            x2 = xf.reshape(-1, xf.shape[-1]).double()
            ctx.collect[f"{name}.hess"] = reduce_stat(ctx, x2.t() @ x2, "sum")
        return fp_linear(params, x, compute_dtype)

    policy = ctx.policy(name)
    if not policy.is_quantized:
        return fp_linear(params, x, compute_dtype)
    st = ctx.state[name]
    b, n, c = x.shape
    bias = params.get("b")
    if ctx.mode == "sim":
        xt = _transformed(ctx, policy, st, x)
        return _maybe_lora(st, x, _maybe_lowrank(st, xt, _sim_linear(policy, st, bias, xt,
                                                                     compute_dtype)))
    _check_int8_policy(policy, name)
    if policy.is_w4a4:
        if ctx.trainable:
            raise NotImplementedError(f"{name}: W4A4 has no trainable dequant route; QLoRA "
                                      "trains over W4A8 / W8A8 bases")
        # x [B, N, C] -> [B*N, C] is a view; the act quant runs inside
        xt = _transformed(ctx, policy, st, x)
        y = w4a4_linear(xt.reshape(b * n, c), st["w_int4g"], st["scale_wg"],
                        None if bias is None else bias.float(), group=policy.group)
        return _maybe_lora(st, x, _maybe_lowrank(st, xt, y.reshape(b, n, -1)))
    if ctx.trainable:
        xt = _transformed(ctx, policy, st, x)
        return _maybe_lora(st, x, _maybe_lowrank(st, xt, _trainable_linear(policy, st, bias, xt)))
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
    return _maybe_lora(st, x, _maybe_lowrank(st, xt, _int_linear(st, q, s_a, sum_a, bias,
                                                                 torch.float32)))


def _dequant_bf16(src, zp, scale, packed: bool) -> torch.Tensor:
    """W8 codes or packed W4 codes dequantized to the bf16 operand, ``((codes +
    zp) * scale)`` [C_out, C_in] rounded once to bf16; made a chunk of rows at
    a time, so no f32 copy of the weight is whole."""
    n = src.shape[0]
    w = torch.empty((n, src.shape[1] * (2 if packed else 1)), dtype=torch.bfloat16,
                    device=src.device)
    for i, j in row_chunks(n, w.shape[1]):
        codes = unpack_int4(src[i:j]) if packed else src[i:j]
        w[i:j] = (codes.float() + zp[i:j, None]) * scale[i:j, None]
    return w


class _DequantMm(torch.autograd.Function):
    """a [M, K] bf16 @ the frozen codes dequantized for the moment
    (:func:`_dequant_bf16`, transposed) into f32, as fp_linear
    multiplies on each device (the card: ``torch.mm(..., out_dtype=float32)``;
    the CPU: the rounded operands in f32). The weight takes no gradient, so
    nothing is kept but the state's own tensors: the backward makes the bf16
    weight again for a's gradient, which is fp_linear's."""

    @staticmethod
    def forward(ctx, a, src, zp, scale, packed):
        w = _dequant_bf16(src, zp, scale, packed).t()
        ctx.packed = packed
        ctx.save_for_backward(src, zp, scale)
        if a.is_cuda:
            return torch.mm(a, w, out_dtype=torch.float32)
        return torch.mm(a.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        w = _dequant_bf16(*ctx.saved_tensors, ctx.packed)  # [N, K]: the operand, transposed
        if g.is_cuda:
            ga = torch.mm(g.to(torch.bfloat16), w, out_dtype=torch.float32)
        else:
            ga = torch.mm(g, w.float())
        return ga.to(torch.bfloat16), None, None, None, None


def _trainable_linear(policy: LayerPolicy, st, bias, x: torch.Tensor) -> torch.Tensor:
    """The int kernels' function, differentiable: the (transformed)
    activation fake-quantized to 8 bits (static ``delta_a``, or per token with
    the gradient through its absmax) times the codes dequantized for the
    moment, ``(codes + zp) * scale``, as one bf16 product with f32 sums and
    bias (``wanq_tpu`` computes it as a plain dot, outside its kernels). The
    fake-quant keeps x in its own dtype and writes the bf16 operand; the
    product keeps nothing (:class:`_DequantMm`)."""
    b, n, c = x.shape
    dyn = policy.act.dynamic
    xq = fake_quant_ste(x.reshape(b * n, c), 8, None if dyn else st["delta_a"],
                        None if dyn else st["zp_a"], out_dtype=torch.bfloat16)
    packed = "w_int4" in st
    y = _DequantMm.apply(xq, st["w_int4"] if packed else st["w_int8"], st["zp_w_int"],
                         st["scale_w"], packed).reshape(b, n, -1)
    return y if bias is None else y + bias.float()


class _LoraF32(torch.autograd.Function):
    """(x @ a) @ b in f32 on the raw layer input x [M, C_in]: the products of
    ``(x.float() @ a.float()) @ b.float()``, keeping x in its own dtype (the
    cast to f32 is exact, so the backward makes it again) and the rank-r
    h = x @ a. Each product is the chain's own call, so its bits are too."""

    @staticmethod
    def forward(ctx, x, a, b):
        h = x.float() @ a
        ctx.save_for_backward(x, a, b, h)
        return h @ b

    @staticmethod
    def backward(ctx, g):
        x, a, b, h = ctx.saved_tensors
        want_x, want_a, want_b = ctx.needs_input_grad
        gx = ga = gb = None
        gh = g @ b.t() if want_x or want_a else None
        if want_b:
            gb = h.t() @ g
        if want_a:
            ga = x.float().t() @ gh
        if want_x:
            gx = (gh @ a.t()).to(x.dtype)
        return gx, ga, gb


def _maybe_lora(st, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + (x @ lora_a) @ lora_b in f32 on the raw layer input ``x`` where
    the layer carries a QLoRA adapter (alpha/r already in ``lora_b``)."""
    if "lora_a" not in st:
        return y
    x2 = x.reshape(-1, x.shape[-1])
    lo = _LoraF32.apply(x2, st["lora_a"].float(), st["lora_b"].float())
    return y + lo.reshape(*x.shape[:-1], -1)


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
