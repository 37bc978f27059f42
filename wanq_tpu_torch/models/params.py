"""Converters into the port's params: from a Wan2.1 checkpoint dir and from
the JAX package's artifacts.

A Wan2.1 checkpoint (sharded safetensors with the reference's key names and
torch layouts) loads with :func:`load_wan_checkpoint`: linear weights
[C_out, C_in] become the port's ``w`` [C_in, C_out], the 5-D patch
embedding its dense per-patch ``w``.

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

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

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


# the int weight entries of a quant state: K-major in the port, [C_in(/2),
# C_out] in the JAX package and in the npz artifact
INT_WEIGHTS = ("w_int8", "w_int4", "w_int4g")


def quant_state_from_numpy(state: Mapping[str, Mapping[str, Any]],
                           device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX quant state -> port quant state; the int weights (``w_int8``,
    ``w_int4``, ``w_int4g``) are transposed to K-major, everything else
    (``w_q`` included) keeps its layout."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, st in state.items():
        layer = {}
        for key, val in st.items():
            t = _tensor(val, device)
            # the transpose runs on the device (a host int8 transpose of a 14B
            # state takes seconds)
            layer[key] = t.t().contiguous() if key in INT_WEIGHTS else t
        out[name] = layer
    return out


def attn_perms_from_numpy(perms: Mapping[str, Any],
                          device="cuda") -> Dict[str, torch.Tensor]:
    """{layer: [H, S] integer reorder table} -> int64 tensors, the form
    ``QuantCtx.attn_perms`` holds (the JAX package keeps int32 arrays)."""
    return {name: torch.from_numpy(np.asarray(p).astype(np.int64)).to(device)
            for name, p in perms.items()}


# ---------------------------------------------------------------------------
# Wan2.1 checkpoints
# ---------------------------------------------------------------------------

INDEX_FILE = "diffusion_pytorch_model.safetensors.index.json"


def _set(tree: Dict[str, Any], path: str, leaf):
    parts = path.split(".")
    node = tree
    i = 0
    while i < len(parts) - 1:
        if parts[i] == "blocks":
            idx = int(parts[i + 1])
            lst = node.setdefault("blocks", [])
            while len(lst) <= idx:
                lst.append({})
            node = lst[idx]
            i += 2
        else:
            node = node.setdefault(parts[i], {})
            i += 1
    node[parts[-1]] = leaf


def convert_tensor(key: str, v: torch.Tensor,
                   dtype) -> Optional[Tuple[str, torch.Tensor, torch.dtype]]:
    """One reference-layout tensor -> (param path, tensor in the port's
    layout, dtype), or None for a tensor the port recomputes (the rope
    ``freqs``)."""
    if key == "patch_embedding.weight":
        # [dim, in_dim, pt, ph, pw] -> [in_dim*pt*ph*pw, dim]
        return "patch_embedding.w", v.reshape(v.shape[0], -1).t(), dtype
    if key == "patch_embedding.bias":
        return "patch_embedding.b", v, torch.float32
    if re.search(r"\bmodulation$", key):
        return key, v, torch.float32
    if re.search(r"norm_q\.weight$|norm_k\.weight$|norm_k_img\.weight$", key):
        return key.rsplit(".", 1)[0], v, torch.float32
    if re.search(r"norm3\.(weight|bias)$", key):
        leaf = "w" if key.endswith("weight") else "b"
        return key.rsplit(".", 1)[0] + "." + leaf, v, torch.float32
    if key.endswith(".weight") and v.dim() == 2:
        return key[: -len(".weight")] + ".w", v.t(), dtype
    if key.endswith(".weight") and v.dim() == 1:  # the layer norms of img_emb
        return key[: -len(".weight")] + ".w", v, torch.float32
    if key.endswith(".bias"):
        return key[: -len(".bias")] + ".b", v, torch.float32
    if key == "freqs":
        return None  # the rope tables are recomputed (models/rope.py)
    # an unknown auxiliary tensor: kept, so that it shows
    return key, v, torch.float32


def _convert_into(params: Dict[str, Any], items, dtype, device, plan=None) -> Dict[str, Any]:
    """Convert (key, tensor) pairs one at a time into ``params`` on ``device``;
    under ``plan`` each keeps only this rank's storage slice."""
    if plan is not None:
        from wanq_tpu_torch.parallel.sharding import leaf_sharding, slice_leaf

        _, _, index = plan.storage()
    for key, val in items:
        conv = convert_tensor(key, torch.as_tensor(val), dtype)
        if conv is not None:
            path, v, leaf_dtype = conv
            if plan is not None:
                spec = leaf_sharding(plan.mesh, path.rsplit(".", 1)[-1], v.dim(),
                                     tuple(v.shape), plan.full_shard)
                v = slice_leaf(v, spec, index)
                if not torch.is_tensor(v):
                    v.local = v.local.to(device=device, dtype=leaf_dtype)
                    _set(params, path, v)
                    continue
            _set(params, path, v.to(device=device, dtype=leaf_dtype).contiguous())
    return params


def convert_state_dict(sd: Mapping[str, torch.Tensor], dtype=torch.bfloat16,
                       device="cuda") -> Dict[str, Any]:
    """Reference-layout state dict {name: tensor} -> port params on ``device``."""
    return _convert_into({}, sd.items(), dtype, device)


def load_wan_checkpoint(ckpt_dir: str, dtype=torch.bfloat16, device="cuda",
                        plan=None) -> Dict[str, Any]:
    """Load a Wan2.1 checkpoint dir: sharded safetensors and their index
    JSON (the format WanModel.from_pretrained reads), or every
    ``*.safetensors`` file in it without an index. Each tensor is read by
    ``safe_open(..., framework="pt", device=...)`` straight onto ``device``,
    converted there and kept, one at a time: the host never holds the model
    (T2V-14B is 28.6 GB in bf16). Under ``plan`` (a ShardingPlan) each tensor
    keeps only this rank's storage slice (``parallel.sharding.leaf_sharding``)
    as it is read, and the slices are packed as ``shard_params`` packs them."""
    from safetensors import safe_open

    index_path = os.path.join(ckpt_dir, INDEX_FILE)
    if os.path.exists(index_path):
        with open(index_path) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files in {ckpt_dir}")
    dev = torch.device(device)
    params: Dict[str, Any] = {}
    for fname in files:
        with safe_open(os.path.join(ckpt_dir, fname), framework="pt", device=str(dev)) as f:
            _convert_into(params, ((k, f.get_tensor(k)) for k in f.keys()), dtype, dev, plan)
    if plan is not None:
        from wanq_tpu_torch.parallel.sharding import pack_params

        pack_params(params)
    return params
