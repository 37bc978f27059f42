"""Converters from the JAX package's artifacts to the port's.

The JAX package's param pytree and quant state are plain nested
dicts/lists of arrays. Given them as numpy arrays (``np.asarray`` on every
leaf; this module imports no JAX), these functions build the port's
tensors:

* params keep the JAX layout, linear ``w`` [C_in, C_out];
* quant state ``w_int8`` is transposed to the port's K-major [C_out, C_in].
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


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """JAX param pytree (numpy leaves, ``w`` [C_in, C_out]) -> port params."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if tree is None:
        return None
    return _tensor(tree, device)


def quant_state_from_numpy(state: Mapping[str, Mapping[str, Any]],
                           device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX quant state -> port quant state; ``w_int8`` [C_in, C_out] becomes
    [C_out, C_in]. Packed int4 and rotation/mask entries are not ported."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, st in state.items():
        layer = {}
        for key, val in st.items():
            if key in ("w_int4", "w_int4g", "scale_wg"):
                raise NotImplementedError(
                    f"{name}.{key}: packed int4 state is not ported yet "
                    "(ROADMAP Queue 1 item 7)")
            arr = np.asarray(val)
            if key == "w_int8":
                arr = np.ascontiguousarray(arr.T)
            layer[key] = _tensor(arr, device)
        out[name] = layer
    return out
