"""Full-model PTQ, RTN int8 subset (counterpart of wanq_tpu/quant/ptq.py):
weights + calibration statistics -> quant state.

    state: {layer_path: {delta_w, zp_w, w_int8 [C_out, C_in], scale_w,
                         zp_w_int, (delta_a, zp_a for static activations)}}

SmoothQuant/ViDiT-Q masks, Hadamard rotations, GPTQ, W4 packing and the
simulated-quant ``w_q`` are not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from wanq_tpu_torch.quant.config import LayerPolicy, QuantConfig
from wanq_tpu_torch.quant.quantizers import (
    params_from_minmax,
    weight_int_quant,
    weight_quant_params,
)

Params = Dict[str, Any]


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
) -> Dict[str, torch.Tensor]:
    """Quant state for one layer by round-to-nearest. w [C_in, C_out] f32."""
    wcfg = policy.weight
    if wcfg is None:
        raise ValueError("quantized layer without a weight quantizer")
    if policy.uses_channel_mask or policy.uses_rotation:
        raise NotImplementedError(
            f"{policy.method} (SmoothQuant/Hadamard) is not ported yet "
            "(ROADMAP Queue 1 item 5)")
    if policy.lowrank > 0 or policy.gptq or policy.is_w4a4:
        raise NotImplementedError(
            "SVDQuant low-rank, GPTQ and W4A4 are not ported yet "
            "(ROADMAP Queue 1 item 7)")
    st: Dict[str, torch.Tensor] = {}
    wf = w.float()
    d, z = weight_quant_params(wf, wcfg)
    st["delta_w"] = d
    st["zp_w"] = z
    codes, d, z = weight_int_quant(wf, wcfg)
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
):
    """Full-model RTN PTQ to int8 deployment state (the JAX package's
    ``targets="int8"``). Returns (policies, state, rotations); rotations
    stay empty (Hadamard rotation is not ported)."""
    policies = {name: qcfg.resolve(name) for name in layer_names}
    calib_max = reduce_calib(calib) if calib is not None else {}
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, policy in policies.items():
        if not policy.is_quantized:
            continue
        act_minmax = None
        if f"{name}.act_max" in calib_max:
            act_minmax = (calib_max[f"{name}.act_max"], calib_max[f"{name}.act_min"])
        state[name] = prepare_layer_state(policy, params_get(params, name)["w"], act_minmax)
    return policies, state, {}
