"""Full-model PTQ by round-to-nearest (counterpart of
wanq_tpu/quant/ptq.py): weights + calibration statistics -> quant state.

    state: {layer_path: {delta_w, zp_w, (delta_a, zp_a for static
                         activations),
              sim:  w_q [C_in, C_out], the fake-quant weight (the JAX
                    package's layout: fp_linear's ``x @ w``)
              int8: w_int8 [C_out, C_in] or packed w_int4 [C_out, C_in/2]
                    (4-bit weights), scale_w, zp_w_int}}
    W4A4:  {layer_path: {sim: w_q, the group-dequantized weight;
                         int8: w_int4g [C_out, C_in/2],
                               scale_wg [C_in/g, C_out]}}

``targets`` ("sim", "int8" or "both") chooses which deployed weights are
made. 4-bit codes pack two per byte along C_in; a layer with an odd C_in
keeps them unpacked in ``w_int8``, as the JAX package does.
SmoothQuant/ViDiT-Q masks, Hadamard rotations, GPTQ and SVDQuant low-rank
are not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from wanq_tpu_torch.quant.config import LayerPolicy, QuantConfig
from wanq_tpu_torch.quant.quantizers import (
    pack_int4,
    params_from_minmax,
    weight_fake_quant,
    weight_group_int4_quant,
    weight_int_quant,
    weight_quant_params,
)

Params = Dict[str, Any]

TARGETS = ("sim", "int8", "both")


def params_get(params: Params, path: str):
    """Navigate a params tree by dotted reference-style path."""
    node = params
    for part in path.split("."):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return node


def reduce_calib(calib: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """[T, C] per-step stacks -> per-channel max over steps, clamped >= 1e-3.
    ``.act_min`` entries reduce with min and skip the clamp; attention
    captures (``.attn_*``) reduce with max and skip it."""
    out = {}
    for name, arr in calib.items():
        if name.endswith(".hess"):
            raise NotImplementedError(
                "GPTQ Hessians are not ported yet (ROADMAP Queue 1 item 7)")
        a = np.asarray(arr, dtype=np.float32)
        if name.endswith(".act_min"):
            out[name] = a.min(axis=0) if a.ndim == 2 else a
        elif name.endswith(".act_max"):
            out[name] = a.max(axis=0) if a.ndim == 2 else a
        elif ".attn_" in name:
            out[name] = a.max(axis=0) if a.ndim >= 2 else a
        else:
            if a.ndim == 2:
                a = a.max(axis=0)
            out[name] = np.maximum(a, 1e-3)
    return out


def prepare_layer_state(
    policy: LayerPolicy,
    w: torch.Tensor,
    act_minmax: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    targets: str = "both",
) -> Dict[str, torch.Tensor]:
    """Quant state for one layer by round-to-nearest. w [C_in, C_out] f32."""
    if targets not in TARGETS:
        raise ValueError(f"targets must be one of {TARGETS}, got {targets!r}")
    wcfg = policy.weight
    if wcfg is None:
        raise ValueError("quantized layer without a weight quantizer")
    if policy.uses_channel_mask or policy.uses_rotation:
        raise NotImplementedError(
            f"{policy.method} (SmoothQuant/Hadamard) is not ported yet "
            "(ROADMAP Queue 1 item 5)")
    if policy.lowrank > 0:
        raise NotImplementedError(
            "SVDQuant low-rank is not ported yet (ROADMAP Queue 1 item 7)")
    st: Dict[str, torch.Tensor] = {}
    wf = w.float()
    if policy.is_w4a4:
        # Atom W4A4: symmetric int4 group quant along K for both operands;
        # the activation side quantizes per (token, group) inside qlinear
        if policy.gptq:
            raise ValueError(
                "GPTQ rounding operates on the per-output-channel grid; the W4A4 "
                "route quantizes per K-group, and the two do not combine")
        if not policy.act.dynamic:
            raise ValueError("W4A4 activations quantize per (token, group) "
                             "dynamically; static A4 is not supported")
        g = policy.group
        if wf.shape[0] % g:
            raise ValueError(
                f"W4A4 group size {g} must divide in_features {wf.shape[0]}; set "
                "act.group in the quant YAML to a common divisor of every quantized "
                "layer's input dim")
        codes4, scale_g = weight_group_int4_quant(wf, g)
        if targets in ("sim", "both"):
            # codes4 is K-major [C_out, C_in]; w_q is [C_in, C_out]
            k, n = wf.shape
            st["w_q"] = (codes4.t().float().reshape(k // g, g, n)
                         * scale_g[:, None, :]).reshape(k, n)
        if targets in ("int8", "both"):
            st["w_int4g"] = pack_int4(codes4)
            st["scale_wg"] = scale_g
        return st
    if policy.gptq:
        raise NotImplementedError("GPTQ is not ported yet (ROADMAP Queue 1 item 7)")
    if targets in ("sim", "both"):
        st["w_q"] = weight_fake_quant(wf, wcfg)
    d, z = weight_quant_params(wf, wcfg)
    st["delta_w"] = d
    st["zp_w"] = z
    if wcfg.active_bits in (4, 8) and targets in ("int8", "both"):
        codes, d, z = weight_int_quant(wf, wcfg)
        if wcfg.active_bits == 4 and codes.shape[1] % 2 == 0:
            st["w_int4"] = pack_int4(codes)
        else:
            st["w_int8"] = codes
        st["scale_w"] = d
        st["zp_w_int"] = z
    _finish_static_act(st, policy, act_minmax, device=wf.device)
    return st


def _finish_static_act(st, policy: LayerPolicy, act_minmax, device=None) -> None:
    """Static activations: one per-tensor (delta_a, zp_a) from the sweep's
    running min/max."""
    if policy.act is None or policy.act.dynamic:
        return
    if policy.uses_channel_mask or policy.uses_rotation:
        raise ValueError(
            "static activation quant cannot combine with "
            f"{policy.method}: calibration min/max are collected on the raw input")
    if act_minmax is None:
        raise ValueError("static act quant needs calibration min/max (run "
                         "get_calib_data with --collect_minmax)")
    amax, amin = act_minmax
    x_max = torch.tensor([np.maximum(np.max(amax), 0.0)], dtype=torch.float32, device=device)
    x_min = torch.tensor([np.minimum(np.min(amin), 0.0)], dtype=torch.float32, device=device)
    d_a, zp_a = params_from_minmax(x_max, x_min, policy.act)
    st["delta_a"] = d_a[:, 0]
    st["zp_a"] = zp_a[:, 0]


def prepare_quant_state(
    params: Params,
    layer_names,
    qcfg: QuantConfig,
    calib: Optional[Mapping[str, np.ndarray]] = None,
    targets: str = "both",
):
    """Full-model RTN PTQ. ``targets``: which deployed weights to make,
    'sim' (fake-quant ``w_q``), 'int8' (int codes + export params) or
    'both'. Returns (policies, state, rotations); rotations stay empty
    (Hadamard rotation is not ported)."""
    policies = {name: qcfg.resolve(name) for name in layer_names}
    calib_max = reduce_calib(calib) if calib is not None else {}
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, policy in policies.items():
        if not policy.is_quantized:
            continue
        act_minmax = None
        if f"{name}.act_max" in calib_max:
            act_minmax = (calib_max[f"{name}.act_max"], calib_max[f"{name}.act_min"])
        state[name] = prepare_layer_state(policy, params_get(params, name)["w"], act_minmax,
                                          targets)
    return policies, state, {}
