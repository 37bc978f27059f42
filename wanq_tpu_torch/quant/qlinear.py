"""Quantized linear application + QuantCtx (counterpart of
wanq_tpu/quant/qlinear.py).

The model calls :func:`qlinear` at every linear site with the layer's path
name; a :class:`QuantCtx` decides the behaviour from resolved per-layer
policies and an explicit quant state:

  fp     plain matmul in the param dtype
  calib  plain matmul + per-channel input statistics into ``ctx.collect``
  int8   W8A8: per-token int8 activations x int8 weights, kernel K2

Layer state entries (``quant/ptq.py``): ``w_int8`` [C_out, C_in] (K-major;
the JAX package stores [C_in, C_out]), ``scale_w``/``zp_w_int`` [C_out]
export params, ``delta_w``/``zp_w`` and, for static activations,
``delta_a``/``zp_a``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from wanq_tpu_torch.ops.qgemm import w8a8_linear
from wanq_tpu_torch.quant.config import FP_POLICY, LayerPolicy
from wanq_tpu_torch.quant.quantizers import act_dynamic_int_quant

Params = Dict[str, Any]

MODES = ("fp", "calib", "int8")


@dataclasses.dataclass
class QuantCtx:
    """Carried through the model forward (a plain dataclass)."""

    mode: str = "fp"
    policies: Dict[str, LayerPolicy] = dataclasses.field(default_factory=dict)
    state: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(default_factory=dict)
    # attention-map quantization sections (raise: kernel K10 not ported)
    attn: Any = None
    cross_attn: Any = None
    # calibration outputs: layer path -> per-channel absmax [C_in] of the
    # input seen this call (plus .act_max/.act_min with collect_minmax)
    collect: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    collect_minmax: bool = False
    # sliding temporal-window attention (raises: not ported)
    attn_window: Any = None

    def __post_init__(self):
        if self.mode == "sim":
            raise NotImplementedError(
                "sim (fake-quant) mode is not ported yet (ROADMAP Queue 1 "
                "item 3, sim mode); use mode='int8' (--hardware)")
        if self.mode not in MODES:
            raise ValueError(f"unknown quant mode {self.mode!r}")
        if self.attn is not None or self.cross_attn is not None:
            raise NotImplementedError(
                "attention-map quantization is not ported yet (ROADMAP Queue 1 "
                "item 8, kernel K10)")
        if self.attn_window is not None:
            raise NotImplementedError(
                "temporal-window attention is not ported yet (ROADMAP Queue 1 item 6)")

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
    if policy.uses_rotation or policy.uses_channel_mask:
        raise NotImplementedError(
            f"{name}: {policy.method} (SmoothQuant/Hadamard) is not ported yet "
            "(ROADMAP Queue 1 item 5)")
    if policy.is_w4a4 or (policy.weight is not None and policy.weight.active_bits != 8):
        raise NotImplementedError(
            f"{name}: 4-bit weights are not ported yet (ROADMAP Queue 1 item 7, "
            "kernels K8/K9)")
    if policy.act is None or not policy.act.sym or policy.act.active_bits != 8:
        raise NotImplementedError(
            f"{name}: the int8 path implements symmetric 8-bit activations only")


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
        return fp_linear(params, x, compute_dtype)

    policy = ctx.policy(name)
    if not policy.is_quantized:
        return fp_linear(params, x, compute_dtype)
    _check_int8_policy(policy, name)
    st = ctx.state[name]
    b, n, _ = x.shape
    xf = x.float()
    if not policy.act.dynamic:
        scale = st["delta_a"].reshape(())
        q = torch.clamp(torch.round(xf / scale), -128, 127).to(torch.int8)
        s_a = scale.expand(b, n).contiguous()
        sum_a = s_a * q.float().sum(dim=-1)
    else:
        q, s_a, sum_a = act_dynamic_int_quant(xf, sym=True)
    return _int_linear(st, q, s_a, sum_a, params.get("b"), torch.float32)


def _int_linear(st, q, s_a, sum_a, bias, out_dtype):
    return w8a8_linear(q, st["w_int8"], s_a, st["scale_w"], sum_a, st["zp_w_int"],
                       None if bias is None else bias.float(), out_dtype=out_dtype)


def int8_fusable(ctx: Optional[QuantCtx], names, allow_mask: bool = False) -> bool:
    """True when every site can take the fused int8 fast path: 8-bit
    weight + dynamic symmetric 8-bit act, no rotation/mask, int8 state."""
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
    """int8 GEMM (K2) from an already-quantized activation. q8 [B, N, C]
    int8; s_a/ssum [B, N]."""
    _check_int8_policy(ctx.policy(name), name)
    return _int_linear(ctx.state[name], q8, s_a, ssum, params.get("b"), out_dtype)
