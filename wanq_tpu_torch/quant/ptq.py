"""Full-model PTQ (counterpart of wanq_tpu/quant/ptq.py): weights +
calibration statistics -> quant state, its npz artifact, and the importers
of the original repository's ``.pth`` artifacts.

    state: {layer_path: {delta_w, zp_w, (channel_mask for smooth_quant and
                         viditq), (delta_a, zp_a for static activations),
              sim:  w_q [C_in, C_out], the fake-quant weight (the JAX
                    package's layout: fp_linear's ``x @ w``)
              int8: w_int8 [C_out, C_in] or packed w_int4 [C_out, C_in/2]
                    (4-bit weights), scale_w, zp_w_int}}
    W4A4:  {layer_path: {sim: w_q, the group-dequantized weight;
                         int8: w_int4g [C_out, C_in/2],
                               scale_wg [C_in/g, C_out]}}
    rotations: {C_in: f32 [C_in, C_in] orthonormal matrix, on the weights'
                device}

``targets`` ("sim", "int8" or "both") chooses which deployed weights are
made. 4-bit codes pack two per byte along C_in; a layer with an odd C_in
keeps them unpacked in ``w_int8``, as the JAX package does. The methods:
RTN (``base``), SmoothQuant (``smooth_quant``: a per-input-channel mask),
QuaRot (``quarot``: a seeded Hadamard rotation per input width) and
ViDiT-Q (``viditq``: both). On the transformed weight, two optional steps:
the SVDQuant low-rank split (``weight.lowrank_rank``: bf16 ``lowrank_a``
[C_in, r] and ``lowrank_b`` [r, C_out], both modes read them) and GPTQ
rounding of the (residual) weight against the layer's calibration Hessian
``<layer>.hess`` (``weight.gptq``; RTN where no Hessian was collected).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from wanq_tpu_torch.models.params import INT_WEIGHTS, quant_state_from_numpy
from wanq_tpu_torch.quant.config import LayerPolicy, QuantConfig
from wanq_tpu_torch.quant.gptq import gptq_quantize, transform_hessian
from wanq_tpu_torch.quant.hadamard import (
    derived_rotation_seed,
    rotate_weight_fwht,
    rotation_for_dim,
)
from wanq_tpu_torch.quant.quantizers import (
    fake_quant,
    pack_int4,
    params_from_minmax,
    weight_fake_quant,
    weight_group_int4_quant,
    weight_int_quant,
    weight_quant_params,
)
from wanq_tpu_torch.quant.smooth import channel_mask, clamp_act_absmax
from wanq_tpu_torch.quant.svd import lowrank_split

Params = Dict[str, Any]

TARGETS = ("sim", "int8", "both")


def params_get(params: Params, path: str):
    """Navigate a params tree by dotted reference-style path."""
    node = params
    for part in path.split("."):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return node


def reduce_calib(calib: Mapping[str, Any]) -> Dict[str, Any]:
    """[T, C] per-step stacks -> per-channel max over steps, clamped >= 1e-3.
    ``.act_min`` entries reduce with min and skip the clamp; attention
    captures (``.attn_*``) reduce with max and skip it. An input Hessian
    ``.hess`` stays as it is, [C, C] (numpy, or a tensor on its device), or
    a [T, C, C] stack is summed where it lies."""
    out = {}
    for name, arr in calib.items():
        if name.endswith(".hess"):
            out[name] = arr.sum(0) if arr.ndim == 3 else arr
            continue
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
            out[name] = clamp_act_absmax(torch.tensor(a)).numpy()
    return out


def prepare_layer_state(
    policy: LayerPolicy,
    w: torch.Tensor,
    act_absmax: Optional[np.ndarray] = None,
    rotation_seed: Optional[int] = None,
    targets: str = "both",
    act_minmax: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    hessian=None,
    act_rotation: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Quant state for one layer. w [C_in, C_out]. Weight side per method:

      base    w_q = FQ(w)
      sq      w_q = FQ(w / mask)
      quarot  w_q = FQ(rot(w))
      viditq  w_q = FQ(rot(FQ(w / mask)))   (the original's double fake-quant)

    ``rot`` is the f64 transform on the weight's device. Then, on that
    transformed weight: a low-rank policy splits off L1 @ L2 and quantizes
    the residual; a GPTQ policy with a ``hessian`` (the raw input's [C_in,
    C_in], taken into the GEMM's space with the mask and ``act_rotation``)
    rounds by GPTQ instead of RTN, on the same grid."""
    if targets not in TARGETS:
        raise ValueError(f"targets must be one of {TARGETS}, got {targets!r}")
    wcfg = policy.weight
    if wcfg is None:
        raise ValueError("quantized layer without a weight quantizer")
    st: Dict[str, torch.Tensor] = {}
    wf = w.float()
    if policy.uses_channel_mask:
        if act_absmax is None:
            raise ValueError(f"{policy.method} needs calibration data")
        mask = channel_mask(wf, torch.as_tensor(act_absmax, dtype=torch.float32,
                                                device=wf.device), policy.alpha)
        st["channel_mask"] = mask
        wf = wf / mask[:, None]
    if policy.method == "viditq":
        wf = weight_fake_quant(wf, wcfg)
    if policy.uses_rotation:
        if rotation_seed is None:
            raise ValueError(f"{policy.method} needs a rotation seed")
        wf = rotate_weight_fwht(wf, rotation_seed)
    if policy.lowrank > 0:
        # the branch lives in the GEMM's input space; only the residual is
        # quantized below
        l1, l2, wf = lowrank_split(wf, policy.lowrank)
        st["lowrank_a"] = l1.bfloat16()
        st["lowrank_b"] = l2.bfloat16()
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
    codes = None
    if policy.gptq and hessian is not None:
        hq = transform_hessian(torch.as_tensor(hessian, device=wf.device),
                               channel_mask=st.get("channel_mask"), act_rotation=act_rotation)
        w_gq, codes, d, z = gptq_quantize(wf, hq, wcfg, act_order=policy.gptq_act_order)
        codes = codes.t().contiguous()  # K-major, as weight_int_quant's
        if targets in ("sim", "both"):
            st["w_q"] = w_gq
    else:
        if targets in ("sim", "both"):
            st["w_q"] = weight_fake_quant(wf, wcfg)
        d, z = weight_quant_params(wf, wcfg)
    st["delta_w"] = d
    st["zp_w"] = z
    if wcfg.active_bits in (4, 8) and targets in ("int8", "both"):
        if codes is None:
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


def _layer_state(policy: LayerPolicy, name: str, w: torch.Tensor, calib_max, seed: int,
                 targets: str, rotations: Dict[int, torch.Tensor]):
    """One layer's quant state after the calibration-key check. A rotated
    layer adds its C_in's activation rotation to ``rotations`` (built once
    per width, on the weight's device), which the runtime uses and a GPTQ
    Hessian is transformed with. A GPTQ layer without ``<name>.hess`` in the
    calibration rounds by RTN (the YAML's regex may cover a subset)."""
    rot_seed = act_rotation = None
    if policy.uses_rotation:
        c_in = int(w.shape[0])
        if c_in not in rotations:
            rotations[c_in] = rotation_for_dim(c_in, seed, device=w.device)
        act_rotation = rotations[c_in]
        rot_seed = derived_rotation_seed(c_in, seed)
    act_absmax = calib_max.get(name)
    if policy.uses_channel_mask and act_absmax is None:
        raise ValueError(f"layer {name} uses {policy.method} but no calibration data "
                         f"was provided (expected key '{name}')")
    act_minmax = None
    if f"{name}.act_max" in calib_max:
        act_minmax = (calib_max[f"{name}.act_max"], calib_max[f"{name}.act_min"])
    hessian = calib_max.get(f"{name}.hess") if policy.gptq else None
    return prepare_layer_state(policy, w, act_absmax, rot_seed, targets, act_minmax=act_minmax,
                               hessian=hessian, act_rotation=act_rotation)


def prepare_quant_state(
    params: Params,
    layer_names,
    qcfg: QuantConfig,
    calib: Optional[Mapping[str, np.ndarray]] = None,
    seed: int = 0,
    targets: str = "both",
):
    """Full-model PTQ. ``targets``: which deployed weights to make, 'sim'
    (fake-quant ``w_q``), 'int8' (int codes + export params) or 'both';
    ``seed`` keys the rotations. Returns (policies, state, rotations)."""
    policies = qcfg.resolve_all(layer_names)
    calib_max = reduce_calib(calib) if calib is not None else {}
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    rotations: Dict[int, torch.Tensor] = {}
    for name, policy in policies.items():
        if not policy.is_quantized:
            continue
        state[name] = _layer_state(policy, name, params_get(params, name)["w"], calib_max,
                                   seed, targets, rotations)
    return policies, state, rotations


# ---------------------------------------------------------------------------
# the artifact: wanq_tpu's npz, readable by either package
# ---------------------------------------------------------------------------


def strip_quantized_weights(params: Params, policies) -> Params:
    """Replace the FP weight of every quantized layer with a [1, 1]
    placeholder of its dtype and device: the sim and int8 paths read the
    quant state, never ``params[...]["w"]``, so the FP copies are freed
    while biases and FP layers stay. Returns a new tree, shallow-copied
    along the stripped paths (list-form ``blocks``)."""
    out = copy.copy(params)
    for name, pol in policies.items():
        if not pol.is_quantized:
            continue
        parts = name.split(".")
        node = out
        for part in parts:
            key = int(part) if isinstance(node, list) else part
            node[key] = copy.copy(node[key])
            node = node[key]
        w = node["w"]
        node["w"] = torch.zeros((1, 1), dtype=w.dtype, device=w.device)
    return out


def save_quant_state(path: str, state: Dict[str, Dict[str, torch.Tensor]], seed: int = 0):
    """Write the quant state as wanq_tpu's artifact: one npz with keys
    ``name|key`` (``name|key|bf16`` for bf16 entries, stored as their uint16
    bits) and ``__seed__``, the int weights in the JAX package's [C_in,
    C_out] / [C_in/2, C_out] layout, so the file loads in either package.
    Rotations are not stored: ``rebuild_rotations`` makes them from the
    seed."""
    flat = {"__seed__": np.asarray(seed)}
    for name, st in state.items():
        for key, val in st.items():
            t = val.detach().cpu()
            if key in INT_WEIGHTS:
                t = t.t()
            t = t.contiguous()
            if t.dtype == torch.bfloat16:
                flat[f"{name}|{key}|bf16"] = t.view(torch.int16).numpy().view(np.uint16)
            else:
                flat[f"{name}|{key}"] = t.numpy()
    np.savez(path, **flat)


# the keys only one mode reads: sim multiplies by the fake-quant ``w_q``,
# int8 by the codes and their export scales
SIM_ONLY = ("w_q",)
INT8_ONLY = (*INT_WEIGHTS, "scale_w", "zp_w_int", "scale_wg")


def load_quant_state(path: str, device="cuda",
                     targets: str = "both") -> Tuple[Dict[str, Dict[str, torch.Tensor]], int]:
    """Read an npz written by :func:`save_quant_state` or by wanq_tpu's:
    (state on ``device``, with the port's K-major int weights; seed).
    ``targets`` 'sim' or 'int8' leaves out what the other mode alone reads
    (a ``targets='both'`` artifact holds the f32 ``w_q`` beside the int
    codes), and raises if a layer keeps no deployed weight for the mode."""
    if targets not in TARGETS:
        raise ValueError(f"targets must be one of {TARGETS}, got {targets!r}")
    skip = {"sim": INT8_ONLY, "int8": SIM_ONLY, "both": ()}[targets]
    arrays: Dict[str, Dict[str, np.ndarray]] = {}
    bf16: Dict[Tuple[str, str], np.ndarray] = {}
    seed = 0
    with np.load(path) as data:
        for key in data.files:
            if key == "__seed__":
                seed = int(data[key])
                continue
            parts = key.split("|")
            arrays.setdefault(parts[0], {})
            if parts[1] in skip:
                continue
            if len(parts) == 3 and parts[2] == "bf16":
                bf16[parts[0], parts[1]] = data[key]
            else:
                arrays[parts[0]][parts[1]] = data[key]
    if targets != "both":
        wanted = SIM_ONLY if targets == "sim" else INT_WEIGHTS
        for name, st in arrays.items():
            if not any(k in st or (name, k) in bf16 for k in wanted):
                raise KeyError(f"{path} holds no deployed {targets} weight for {name}")
    state = quant_state_from_numpy(arrays, device)
    for (name, key), bits in bf16.items():
        state[name][key] = torch.from_numpy(
            bits.astype(np.uint16).view(np.int16)).view(torch.bfloat16).to(device)
    return state, seed


def rebuild_rotations(state: Dict[str, Dict[str, torch.Tensor]],
                      policies: Mapping[str, LayerPolicy], seed: int) -> Dict[int, torch.Tensor]:
    """The activation-side rotations of a loaded quant state, on its device.
    C_in comes from the deployed weight: ``w_q`` [C_in, C_out], K-major
    ``w_int8`` [C_out, C_in], packed ``w_int4`` / ``w_int4g`` [C_out, C_in/2]."""
    rotations: Dict[int, torch.Tensor] = {}
    for name, st in state.items():
        pol = policies.get(name)
        if pol is None or not pol.uses_rotation:
            continue
        if "w_q" in st:
            w, c_in = st["w_q"], st["w_q"].shape[0]
        elif "w_int8" in st:
            w, c_in = st["w_int8"], st["w_int8"].shape[1]
        elif "w_int4" in st or "w_int4g" in st:
            w = st.get("w_int4", st.get("w_int4g"))
            c_in = 2 * w.shape[1]
        else:
            raise KeyError(f"no deployed weight entry in quant state for {name}")
        if c_in not in rotations:
            rotations[int(c_in)] = rotation_for_dim(int(c_in), seed, device=w.device)
    return rotations


# ---------------------------------------------------------------------------
# the original repository's artifacts (calib_data .pth, quant_params.pth)
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def load_reference_calib(path: str) -> Dict[str, np.ndarray]:
    """A calib_data .pth of the original repository ({layer: [N_calls, C]}
    absmax stacks) as numpy arrays."""
    d = torch.load(path, map_location="cpu", weights_only=False)
    return {k: _np(v) for k, v in d.items()}


def load_reference_quant_params(path_or_dict) -> Dict[str, Dict[str, np.ndarray]]:
    """Import the original repository's ``quant_params.pth`` (one entry per
    quantizer module, ``<layer>.w_quantizer`` / ``<layer>.a_quantizer``,
    each {'delta', 'zero_point'[, 'channel_mask'][, 'rotation_matrix']})
    into this package's per-layer scale dict: ``{layer: {delta_w, zp_w[,
    channel_mask][, delta_a, zp_a][, rotated]}}`` as numpy arrays. Weight
    deltas [C_out, 1] flatten to [C_out]; activation entries import only
    when per-tensor (a frozen static scale; dynamic ones are per call). A
    rotation slot is marked ``rotated``: the original draws its rotation
    from torch's global RNG at load, which the artifact cannot give back."""
    d = (torch.load(path_or_dict, map_location="cpu", weights_only=False)
         if isinstance(path_or_dict, (str, bytes)) else path_or_dict)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for full_name, entry in d.items():
        # artifacts saved under FSDP carry wrapper prefixes
        full_name = full_name.replace("_fsdp_wrapped_module.", "")
        for suffix, dkey, zkey in ((".w_quantizer", "delta_w", "zp_w"),
                                   (".a_quantizer", "delta_a", "zp_a")):
            if not full_name.endswith(suffix):
                continue
            delta, zp = _np(entry["delta"]), _np(entry["zero_point"])
            if suffix == ".a_quantizer" and delta.size != 1:
                break  # a dynamic quantizer's per-call params
            st = out.setdefault(full_name[: -len(suffix)], {})
            st[dkey] = delta.reshape(-1)
            st[zkey] = zp.reshape(-1)
            if entry.get("channel_mask") is not None:
                st["channel_mask"] = _np(entry["channel_mask"]).reshape(-1)
            if "rotation_matrix" in entry:
                st["rotated"] = np.asarray(True)
            break
    return out


def state_from_reference_params(params: Params, policies: Mapping[str, LayerPolicy],
                                imported: Mapping[str, Mapping[str, np.ndarray]],
                                targets: str = "both") -> Dict[str, Dict[str, torch.Tensor]]:
    """Deploy from an imported ``quant_params.pth``: each quantized layer's
    deployed weights rebuilt from its FP weight and the artifact's grids, on
    the weight's device. Rotated layers raise: their matrices are not in the
    artifact; run PTQ here instead."""
    if targets not in TARGETS:
        raise ValueError(f"targets must be one of {TARGETS}, got {targets!r}")
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, policy in policies.items():
        if not policy.is_quantized:
            continue
        if name not in imported:
            raise KeyError(f"reference artifact has no entry for quantized layer {name}: "
                           "was it quantized with a different remain_fp_regex?")
        imp = imported[name]
        if imp.get("rotated") is not None and bool(imp["rotated"]):
            raise ValueError(
                f"{name}: the reference artifact used a rotation (quarot/viditq) whose "
                "matrix the original draws from torch's global RNG at load; it cannot "
                "be recovered from the artifact, so run PTQ here for rotated methods")
        wcfg = policy.weight
        if wcfg is None:
            raise ValueError(f"{name}: quantized layer without a weight quantizer")
        wf = params_get(params, name)["w"].float()

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=wf.device)

        st: Dict[str, torch.Tensor] = {}
        if "channel_mask" in imp:
            st["channel_mask"] = dev(imp["channel_mask"])
            wf = wf / st["channel_mask"][:, None]
        d, z = dev(imp["delta_w"]), dev(imp["zp_w"])
        st["delta_w"], st["zp_w"] = d, z
        if targets in ("sim", "both"):
            st["w_q"] = fake_quant(wf, d[None, :], z[None, :], wcfg.active_bits, wcfg.sym)
        if wcfg.active_bits in (4, 8) and targets in ("int8", "both"):
            lo, hi = (-8, 7) if wcfg.active_bits == 4 else (-128, 127)
            q = torch.clamp(torch.round(wf.t() / d[:, None]) - z[:, None], lo, hi)
            q = q.to(torch.int8).contiguous()
            if wcfg.active_bits == 4 and q.shape[1] % 2 == 0:
                st["w_int4"] = pack_int4(q)
            else:
                st["w_int8"] = q
            st["scale_w"] = d
            st["zp_w_int"] = z
        if "delta_a" in imp and policy.act is not None and not policy.act.dynamic:
            st["delta_a"], st["zp_a"] = dev(imp["delta_a"]), dev(imp["zp_a"])
        state[name] = st
    return state


def compare_scale_dicts(ours: Mapping[str, Mapping[str, Any]],
                        theirs: Mapping[str, Mapping[str, np.ndarray]],
                        rtol: float = 1e-3) -> Dict[str, Any]:
    """Scale-dict parity between this package's quant state and an imported
    reference artifact: every key present on both sides per layer (delta_w,
    zp_w, channel_mask, delta_a, zp_a) -> ``{'layers': {layer: {key:
    max_rel_err}}, 'worst': (layer, key, err), 'pass': bool}``."""
    report: Dict[str, Any] = {"layers": {}, "worst": None, "pass": True}
    worst = ("", "", -1.0)
    for layer, tstate in theirs.items():
        if layer not in ours:
            continue
        ostate = ours[layer]
        errs = {}
        for key in ("delta_w", "zp_w", "channel_mask", "delta_a", "zp_a"):
            if key not in tstate or key not in ostate:
                continue
            a = _np(ostate[key]).astype(np.float64).reshape(-1)
            b = np.asarray(tstate[key], np.float64).reshape(-1)
            if a.shape != b.shape:
                errs[key] = float("inf")
            else:
                errs[key] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-8)))
            if errs[key] > worst[2]:
                worst = (layer, key, errs[key])
            if errs[key] > rtol:
                report["pass"] = False
        report["layers"][layer] = errs
    report["worst"] = worst
    return report


# the state leaves split on the output channels under FSDP, and the dim that
# holds them: w_q [C_in, C_out] and the W4A4 scale plane [C_in / 128, C_out] on
# their last dim; the K-major codes [C_out, ...] and the per-C_out vectors on
# their first. Everything else (SmoothQuant masks, static activation scales,
# low-rank factors, adapters) rides replicated.
_STATE_SPLIT = {"w_q": -1, "scale_wg": -1, "w_int8": 0, "w_int4": 0, "w_int4g": 0,
                "delta_w": 0, "zp_w": 0, "scale_w": 0, "zp_w_int": 0}


def quant_state_shardings(state, mesh, full_shard: bool = False):
    """{layer: {key: LeafShard or None}}: ``wanq_tpu``'s quant_state_shardings
    on the port's layouts. A packed int4 row holds two C_in codes (pack_int4
    packs along C_in), so a split on C_out never cuts a byte."""
    from wanq_tpu_torch.parallel.sharding import LeafShard, storage_axes

    _, fs = storage_axes(mesh, full_shard)

    def spec(key, leaf):
        dim = _STATE_SPLIT.get(key)
        if dim is None or not torch.is_tensor(leaf) or leaf.ndim == 0:
            return None
        dim %= leaf.ndim
        return LeafShard(dim, fs) if leaf.shape[dim] % fs == 0 else None

    return {name: {k: spec(k, v) for k, v in st.items()} for name, st in state.items()}


def shard_quant_state(state, plan):
    """This rank's storage of a quant state under ``plan`` (its storage axes):
    the leaves of :func:`quant_state_shardings` cut to the rank's slice and
    packed one block a pack (``blocks.i.*``) plus one for the rest, so a
    block's state gathers in one collective beside its weights."""
    from wanq_tpu_torch.parallel.sharding import pack_shards, slice_leaf

    specs = quant_state_shardings(state, plan.mesh, plan.full_shard)
    _, _, index = plan.storage()
    out = {name: {k: slice_leaf(v, specs[name][k], index) for k, v in st.items()}
           for name, st in state.items()}
    groups: Dict[str, Dict[str, Any]] = {}
    for name, st in out.items():
        key = ".".join(name.split(".")[:2]) if name.startswith("blocks.") else ""
        groups.setdefault(key, {})[name] = st
    for group in groups.values():
        pack_shards(group)
    return out
