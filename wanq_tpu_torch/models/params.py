"""Converters from the JAX package's artifacts to the port's.

The JAX package's param pytree and quant state are plain nested
dicts/lists of arrays. Given them as numpy arrays (``np.asarray`` on every
leaf; this module imports no JAX), these functions build the port's
tensors:

* params keep the JAX layout, linear ``w`` [C_in, C_out];
* quant state int weights become the port's K-major layout, what the int8
  tensor-core MMA wants for B: ``w_int8`` [C_in, C_out] -> [C_out, C_in],
  and the packed int4 ``w_int4`` / ``w_int4g`` [C_in/2, C_out] ->
  [C_out, C_in/2]. Each JAX byte (i, n) holds k = 2i (low nibble) and
  k = 2i + 1 (high nibble) of column n, so the port's byte (n, j) is the
  same byte: a plain transpose;
* the W4A4 weight scales ``scale_wg`` keep JAX's [C_in/group, C_out]: the
  K9 kernel reads one contiguous row of it per K group;
* the sim-mode weight ``w_q`` keeps JAX's [C_in, C_out]: sim mode multiplies
  through ``fp_linear``, which computes ``x @ w`` like the FP path;
* attention reorder tables (``QuantCtx.attn_perms``) become int64 tensors.

Every converter puts its tensors on ``device``, the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 has no torch counterpart in from_numpy: go
        # through its bit pattern
        bits = np.array(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """JAX param pytree (numpy leaves, ``w`` [C_in, C_out]) -> port params."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if tree is None:
        return None
    return _tensor(tree, device)


def quant_state_from_numpy(state: Mapping[str, Mapping[str, Any]],
                           device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX quant state -> port quant state; the int weights (``w_int8``,
    ``w_int4``, ``w_int4g``) are transposed to K-major, everything else
    (``w_q`` included) keeps its layout."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, st in state.items():
        layer = {}
        for key, val in st.items():
            arr = np.asarray(val)
            if key in ("w_int8", "w_int4", "w_int4g"):
                arr = np.ascontiguousarray(arr.T)
            layer[key] = _tensor(arr, device)
        out[name] = layer
    return out


def attn_perms_from_numpy(perms: Mapping[str, Any],
                          device="cuda") -> Dict[str, torch.Tensor]:
    """{layer: [H, S] integer reorder table} -> int64 tensors, the form
    ``QuantCtx.attn_perms`` holds (the JAX package keeps int32 arrays)."""
    return {name: torch.from_numpy(np.asarray(p).astype(np.int64)).to(device)
            for name, p in perms.items()}
