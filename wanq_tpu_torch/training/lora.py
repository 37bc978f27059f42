"""LoRA adapters for the Wan DiT (counterpart of wanq_tpu/training/lora.py).

Adapters live in their own dict, ``{"__scale__": alpha / r (an f32 scalar,
a constant), layer path: {"a": [C_in, r], "b": [r, C_out]}}``, f32. Two ways
to use them:

* FP LoRA: :func:`apply_lora` merges ``w + scale * a @ b`` into a copy of the
  param tree (differentiable in a and b);
* QLoRA: :func:`merge_lora_into_quant_state` attaches them to the quant
  state (``lora_a``, and ``lora_b`` with the scale folded in), and
  ``qlinear`` adds ``(x @ lora_a) @ lora_b`` on the raw layer input after
  every quantized route.

The npz of :func:`save_lora` (keys ``<layer>|a``, ``<layer>|b``,
``__scale__``) is ``wanq_tpu``'s: either package reads the other's. The
optimizer state of a training checkpoint is a ``torch.save`` file
(``utils/checkpoint.py``); ``wanq_tpu`` writes an orbax directory, so that
file does not cross between the packages. ``wanq_tpu``'s ``stack_lora`` and
``merge_lora_into_scan_ctx`` serve its scan over blocks, which the port does
not have.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from wanq_tpu_torch.parallel.sharding import Shard
from wanq_tpu_torch.quant.planner import block_linear_dims
from wanq_tpu_torch.quant.ptq import params_get

DEFAULT_TARGETS = r"self_attn\.(q|k|v|o)|ffn\.(0|2)"
SCALE = "__scale__"


def lora_layer_names(layer_names, targets: str = DEFAULT_TARGETS):
    pat = re.compile(targets)
    return [n for n in layer_names if pat.search(n)]


def lora_scale(lora) -> float:
    """alpha / r, a constant: never a trained leaf."""
    scale = lora.get(SCALE, 1.0)
    return float(scale) if torch.is_tensor(scale) else scale


def adapters(lora) -> Dict[str, Dict[str, torch.Tensor]]:
    """The adapter entries, without the scale."""
    return {k: v for k, v in lora.items() if k != SCALE}


def _draw(rng, c_in: int, c_out: int, rank: int, device) -> Dict[str, torch.Tensor]:
    a = (rng.standard_normal((c_in, rank)) / np.sqrt(rank)).astype(np.float32)
    return {"a": torch.from_numpy(a).to(device),
            "b": torch.zeros((rank, c_out), dtype=torch.float32, device=device)}


def init_lora(params: Any, layer_names, rank: int = 16, targets: str = DEFAULT_TARGETS,
              seed: int = 0, alpha: Optional[float] = None):
    """Adapters of the target layers, a ~ N(0, 1/r) from
    ``np.random.default_rng(seed)`` in layer order (``wanq_tpu``'s draws), b = 0
    (the adapted model starts as the base); on each weight's device."""
    rng = np.random.default_rng(seed)
    lora: Dict[str, Any] = {SCALE: torch.tensor((alpha or rank) / rank, dtype=torch.float32)}
    for name in lora_layer_names(layer_names, targets):
        w = params_get(params, name)["w"]
        lora[name] = _draw(rng, *w.shape, rank, w.device)
    return lora


def init_lora_from_cfg(cfg, rank: int = 16, targets: str = DEFAULT_TARGETS, seed: int = 0,
                       alpha: Optional[float] = None, device="cuda"):
    """The same adapters from the model config's shapes alone, for a base
    whose FP weights are stripped; in ``wanq_tpu``'s order (by block linear
    class, then by block)."""
    rng = np.random.default_rng(seed)
    pat = re.compile(targets)
    lora: Dict[str, Any] = {SCALE: torch.tensor((alpha or rank) / rank, dtype=torch.float32)}
    for sfx, (c_in, c_out) in block_linear_dims(cfg).items():
        for i in range(cfg.num_layers):
            name = f"blocks.{i}.{sfx}"
            if pat.search(name):
                lora[name] = _draw(rng, c_in, c_out, rank, device)
    return lora


def apply_lora(params: Any, lora) -> Any:
    """A copy of the param tree with ``w + scale * a @ b`` (the product in
    f32, the sum in the weight's dtype) at each adapted layer; only the dicts
    along adapted paths are copied. A weight stored split (a sharding plan's
    ``Shard``, FSDP) keeps its storage and takes the sum into the whole
    weight at each gather."""
    scale = lora_scale(lora)
    out = dict(params)
    copied = {id(out)}
    for name, ab in adapters(lora).items():
        parts = name.split(".")
        node = out
        for part in parts[:-1]:
            key = int(part) if isinstance(node, list) else part
            if id(node[key]) not in copied:  # copy each container on the path once
                node[key] = list(node[key]) if isinstance(node[key], list) else dict(node[key])
                copied.add(id(node[key]))
            node = node[key]
        leaf = dict(node[parts[-1]])
        w = leaf["w"]
        merge = lambda whole, a=ab["a"], b=ab["b"]: whole + (
            scale * (a.float() @ b.float())).to(whole.dtype)
        leaf["w"] = w.merged(merge) if isinstance(w, Shard) else merge(w)
        node[parts[-1]] = leaf
    return out


def merge_lora_into_quant_state(state, lora):
    """QLoRA: a copy of the quant state whose adapted layers carry ``lora_a``
    and ``lora_b`` (times alpha/r). Every adapted layer must be quantized;
    adapt FP layers through :func:`apply_lora`."""
    scale = lora_scale(lora)
    out = dict(state)
    for name, ab in adapters(lora).items():
        if name not in out:
            raise KeyError(f"QLoRA target {name} has no quant-state entry: adapt FP layers "
                           "through apply_lora, or extend the quant config")
        out[name] = {**out[name], "lora_a": ab["a"], "lora_b": ab["b"] * scale}
    return out


def save_lora(path: str, lora) -> str:
    """The npz both packages read: ``<layer>|a``, ``<layer>|b``, ``__scale__``."""
    flat = {SCALE: np.asarray(lora_scale(lora), np.float32)}
    for name, ab in adapters(lora).items():
        flat[f"{name}|a"] = ab["a"].detach().float().cpu().numpy()
        flat[f"{name}|b"] = ab["b"].detach().float().cpu().numpy()
    np.savez(path, **flat)
    return path


def load_lora(path: str, device="cuda"):
    data = np.load(path)
    lora: Dict[str, Any] = {}
    for key in data.files:
        if key == SCALE:
            lora[SCALE] = torch.tensor(float(data[key]), dtype=torch.float32)
            continue
        name, leaf = key.split("|")
        lora.setdefault(name, {})[leaf] = torch.from_numpy(data[key]).to(device)
    return lora


def save_lora_checkpoint(output_dir: str, step: int, lora, opt_state=None,
                         rank: Optional[int] = None, alpha: Optional[float] = None,
                         targets: str = DEFAULT_TARGETS) -> str:
    """``<output_dir>/lora-checkpoint-<step>/``: the adapters
    (``lora_weights.npz``), the optimizer's state dict if given
    (``lora_optimizer.pt``) and ``lora_config.json`` (step, rank, alpha,
    targets)."""
    from wanq_tpu_torch.utils.checkpoint import save_checkpoint

    save_dir = os.path.join(output_dir, f"lora-checkpoint-{step}")
    os.makedirs(save_dir, exist_ok=True)
    save_lora(os.path.join(save_dir, "lora_weights.npz"), lora)
    if opt_state is not None:
        save_checkpoint(os.path.join(save_dir, "lora_optimizer.pt"), opt_state)
    r = rank if rank is not None else int(next(iter(adapters(lora).values()))["a"].shape[1])
    cfg = {"step": step, "lora_params": {
        "lora_rank": r,
        "lora_alpha": float(alpha) if alpha is not None else lora_scale(lora) * r,
        "target_modules": targets}}
    with open(os.path.join(save_dir, "lora_config.json"), "w") as f:
        json.dump(cfg, f, indent=4)
    return save_dir


def resume_lora_checkpoint(checkpoint_dir: str, opt_state_target=None, device="cuda"):
    """(lora, optimizer state or None, step, config) of a checkpoint dir. With
    ``opt_state_target`` (an optimizer over the loaded adapters) the saved
    state is loaded into it and it is returned."""
    from wanq_tpu_torch.utils.checkpoint import load_checkpoint

    with open(os.path.join(checkpoint_dir, "lora_config.json")) as f:
        cfg = json.load(f)
    lora = load_lora(os.path.join(checkpoint_dir, "lora_weights.npz"), device=device)
    opt_state = None
    opt_path = os.path.join(checkpoint_dir, "lora_optimizer.pt")
    if os.path.exists(opt_path):
        opt_state = load_checkpoint(opt_path, target=opt_state_target, device=device)
    return lora, opt_state, int(cfg["step"]), cfg
