"""Capacity-aware bitwidth planner (counterpart of wanq_tpu/quant/planner.py).

Given a device byte budget for the quantized weight state, picks which
linear classes get the wider bitwidth (W8) and which stay at the packed base
(W4). The plan is a config dict in the reference's mixed-precision schema
(an n_bits list and one regex list per index), so ``QuantConfig.from_dict``
and ``prepare_quant_state`` run it unchanged; ``quant_generate
--auto_bits_gib`` deploys it.

A class (a linear name such as ``ffn.2``) takes one bitwidth in every block.
``wanq_tpu`` chose that because its scan over blocks stacks the per-block
state; the port's blocks are a loop, but the plan (``CapacityPlan.report``,
the config dict) is ``wanq_tpu``'s user-visible contract, so it keeps the
granularity.

Priority comes from measured per-class weight quantization error when given
(:func:`measure_class_errors`), else from the sensitivity order of the W4 PTQ
literature (down- and output projections first).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

# Upgrade preference when no measured errors are supplied: output-side
# projections (whose error lands directly on the residual stream) and the
# ffn down-projection first; k-projections last (their error is softened
# by the softmax).
DEFAULT_PRIORITY: Tuple[str, ...] = (
    "ffn.2",
    "self_attn.o",
    "cross_attn.o",
    "ffn.0",
    "self_attn.v",
    "cross_attn.v",
    "cross_attn.q",
    "self_attn.q",
    "self_attn.k",
    "cross_attn.k",
)


def block_linear_dims(cfg) -> Dict[str, Tuple[int, int]]:
    """(C_in, C_out) per block-linear class for a WanConfig."""
    d, f = cfg.dim, cfg.ffn_dim
    dims = {
        "self_attn.q": (d, d), "self_attn.k": (d, d),
        "self_attn.v": (d, d), "self_attn.o": (d, d),
        "cross_attn.q": (d, d), "cross_attn.k": (d, d),
        "cross_attn.v": (d, d), "cross_attn.o": (d, d),
        "ffn.0": (d, f), "ffn.2": (f, d),
    }
    if getattr(cfg, "model_type", "t2v") == "i2v":
        dims["cross_attn.k_img"] = (d, d)
        dims["cross_attn.v_img"] = (d, d)
    return dims


def class_weight_bytes(cfg, n_bits: int) -> Dict[str, int]:
    """Total quantized-weight bytes per class across all blocks.

    int8 stores K*N bytes; int4 packs two per byte along K (``pack_int4``).
    Per-output-channel scale and zero point ride along at 8 f32 bytes a
    channel either way.
    """
    out = {}
    for name, (cin, cout) in block_linear_dims(cfg).items():
        per = cin * cout if n_bits == 8 else math.ceil(cin / 2) * cout
        per += 8 * cout  # scale_w + zp_w_int, f32 per channel
        out[name] = per * cfg.num_layers
    return out


def measure_class_errors(
    weights: Mapping[str, "np.ndarray"],
    base_bits: int = 4,
    hi_bits: int = 8,
    sym: bool = False,
) -> Dict[str, Tuple[float, float]]:
    """Per-class weight quant relative error at (base_bits, hi_bits).

    ``weights`` maps class name -> a representative [C_in, C_out] weight (a
    numpy array or a tensor on any device, e.g. one block's). Uses the
    fake-quant that PTQ applies (``weight_fake_quant``), in f32 where the
    weight lies, so the ranking reflects the deployed quantizer.
    """
    from wanq_tpu_torch.quant.quantizers import QuantizerCfg, weight_fake_quant

    errs: Dict[str, Tuple[float, float]] = {}
    for name, w in weights.items():
        wf = (w if torch.is_tensor(w) else torch.from_numpy(np.asarray(w))).float()
        norm = float(torch.linalg.norm(wf)) or 1.0
        pair = []
        for bits in (base_bits, hi_bits):
            wq = weight_fake_quant(wf, QuantizerCfg(n_bits=bits, sym=sym))
            pair.append(float(torch.linalg.norm(wf - wq)) / norm)
        errs[name] = (pair[0], pair[1])
    return errs


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    budget_bytes: int
    base_bits: int
    hi_bits: int
    upgraded: Tuple[str, ...]     # classes at hi_bits
    base: Tuple[str, ...]         # classes at base_bits
    total_bytes: int              # planned weight-state bytes
    config: Dict                  # QuantConfig.from_dict-ready

    def report(self) -> str:
        gib = self.total_bytes / 2**30
        bud = self.budget_bytes / 2**30
        return (
            f"capacity plan: W{self.hi_bits} on {list(self.upgraded)}, "
            f"W{self.base_bits} on {list(self.base)} — "
            f"{gib:.2f} GiB of {bud:.2f} GiB budget"
        )


def plan_capacity_bits(
    cfg,
    budget_bytes: int,
    *,
    base_bits: int = 4,
    hi_bits: int = 8,
    errors: Optional[Mapping[str, Tuple[float, float]]] = None,
    remain_fp_regex: str = (
        r"text_embedding|time_embedding|time_projection|head\.head"
    ),
    act: Optional[Dict] = None,
    priority: Sequence[str] = DEFAULT_PRIORITY,
) -> CapacityPlan:
    """Greedy W{base}->W{hi} upgrades under a weight-state byte budget.

    With ``errors`` (from measure_class_errors): upgrades by error
    reduction per upgrade byte, the classic knapsack-greedy. Without:
    upgrades in ``priority`` order. Classes the budget cannot fit are
    skipped (a later, cheaper class may still fit — greedy continues).
    """
    base_cost = class_weight_bytes(cfg, base_bits)
    hi_cost = class_weight_bytes(cfg, hi_bits)
    classes = list(base_cost)

    if errors is not None:
        def score(c):
            e = errors.get(c)
            if e is None:
                return 0.0
            gain = max(e[0] - e[1], 0.0)
            return gain * base_cost[c] / max(hi_cost[c] - base_cost[c], 1)
        order = sorted(classes, key=score, reverse=True)
    else:
        order = [c for c in priority if c in base_cost]
        order += [c for c in classes if c not in order]

    total = sum(base_cost.values())
    upgraded: List[str] = []
    for c in order:
        extra = hi_cost[c] - base_cost[c]
        if total + extra <= budget_bytes:
            upgraded.append(c)
            total += extra
    base = [c for c in classes if c not in upgraded]

    def _alt(names: List[str]) -> str:
        return "|".join(rf"{n.replace('.', chr(92) + '.')}$" for n in names)

    config = {
        "remain_fp_regex": remain_fp_regex,
        "weight": {"n_bits": [base_bits, hi_bits], "sym": False},
        "act": dict(act) if act else {"n_bits": 8, "sym": True},
        "mixed_precision": {
            "weight": {
                # idx 0 = FP override (unused), idx 1 -> base, idx 2 -> hi
                "layer_name_regex": ["", _alt(base), _alt(upgraded)],
            },
        },
    }
    return CapacityPlan(
        budget_bytes=int(budget_bytes),
        base_bits=base_bits,
        hi_bits=hi_bits,
        upgraded=tuple(upgraded),
        base=tuple(base),
        total_bytes=int(total),
        config=config,
    )
