"""Quant-config schema + per-layer policy resolution (counterpart of
wanq_tpu/quant/config.py).

The YAML schema and the regex semantics are the JAX package's: ``re.search``
(substring match), an empty method regex matches every layer, empty
strings inside mixed_precision lists are skipped.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import yaml

from wanq_tpu_torch.quant.quantizers import QuantizerCfg

Method = str  # 'fp' | 'base' | 'smooth_quant' | 'quarot' | 'viditq'


def load_yaml(path: str) -> Any:
    with open(path) as f:
        return yaml.safe_load(f)


def _tuplify(n_bits: Any) -> Union[int, Tuple[int, ...]]:
    if isinstance(n_bits, (list, tuple)):
        return tuple(int(b) for b in n_bits)
    return int(n_bits)


@dataclasses.dataclass(frozen=True)
class LayerPolicy:
    """Immutable per-layer quantization policy."""

    method: Method = "fp"
    weight: Optional[QuantizerCfg] = None
    act: Optional[QuantizerCfg] = None
    alpha: float = 0.5
    quant_mode: bool = True
    gptq: bool = False
    gptq_act_order: bool = False
    group: int = 128
    lowrank: int = 0

    @property
    def is_quantized(self) -> bool:
        return self.method != "fp" and self.quant_mode

    @property
    def is_w4a4(self) -> bool:
        return (self.is_quantized and self.weight is not None and self.act is not None
                and self.weight.active_bits == 4 and self.act.active_bits == 4)

    @property
    def uses_channel_mask(self) -> bool:
        return self.method in ("smooth_quant", "viditq")

    @property
    def uses_rotation(self) -> bool:
        return self.method in ("quarot", "viditq")


FP_POLICY = LayerPolicy(method="fp")


class QuantConfig:
    """Parsed quant config; resolves a LayerPolicy per layer path."""

    def __init__(self, raw: Mapping[str, Any]):
        self.raw = dict(raw)
        self.remain_fp_regex: Optional[str] = raw.get("remain_fp_regex")
        cd = raw.get("calib_data") or {}
        self.calib_save_path: Optional[str] = cd.get("save_path")

        w = raw.get("weight")
        self.weight_cfg = (
            QuantizerCfg(n_bits=_tuplify(w["n_bits"]), sym=bool(w.get("sym", False)))
            if w else None
        )
        self.weight_gptq = bool(w.get("gptq", False)) if w else False
        self.weight_gptq_act_order = bool(w.get("gptq_act_order", False)) if w else False
        self.weight_lowrank = int(w.get("lowrank_rank", 0)) if w else 0
        a = raw.get("act")
        self.act_cfg = (
            QuantizerCfg(n_bits=_tuplify(a["n_bits"]), sym=bool(a.get("sym", False)),
                         dynamic=bool(a.get("dynamic", True)))
            if a else None
        )
        self.act_static_regex: Optional[str] = a.get("static_regex") if a else None
        self.act_group = int(a.get("group", 128)) if a else 128

        self.methods: Dict[str, Dict[str, Any]] = {}
        for m in ("smooth_quant", "quarot", "viditq"):
            if raw.get(m) is not None:
                self.methods[m] = dict(raw[m])
        self.mixed_precision: Optional[Dict[str, Any]] = raw.get("mixed_precision")
        # attention-map quantization sections: kept raw; the int8 path
        # raises on them (kernel K10 is not ported)
        self.attn_cfg = raw.get("attn")
        self.cross_attn_cfg = raw.get("cross_attn")
        self._re_cache: Dict[str, "re.Pattern"] = {}

    def _search(self, pattern: str, name: str):
        pat = self._re_cache.get(pattern)
        if pat is None:
            pat = self._re_cache[pattern] = re.compile(pattern)
        return pat.search(name)

    @classmethod
    def from_yaml(cls, path: str) -> "QuantConfig":
        return cls(load_yaml(path))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "QuantConfig":
        return cls(d)

    def resolve(self, full_name: str) -> LayerPolicy:
        """The policy of a layer path like 'blocks.0.self_attn.q'."""
        method: Method = "base"
        alpha = 0.5
        for m in ("smooth_quant", "quarot", "viditq"):
            if m in self.methods:
                regex = self.methods[m].get("layer_name_regex", "")
                if regex is None:
                    regex = ""
                if self._search(regex, full_name):
                    method = m
                    alpha = float(self.methods[m].get("alpha", alpha))

        if self.remain_fp_regex and self._search(self.remain_fp_regex, full_name):
            return FP_POLICY

        w_cfg, a_cfg = self.weight_cfg, self.act_cfg
        if (self.act_static_regex and a_cfg is not None and a_cfg.dynamic
                and self._search(self.act_static_regex, full_name)):
            a_cfg = dataclasses.replace(a_cfg, dynamic=False)
        quant_mode = True

        if self.mixed_precision is not None:
            w_list: List[str] = list(
                (self.mixed_precision.get("weight") or {}).get("layer_name_regex", []))
            a_list: List[str] = list(
                (self.mixed_precision.get("act") or {}).get("layer_name_regex", []))
            for idx, regex in enumerate(w_list):
                if len(regex) == 0:
                    continue
                if self._search(regex, full_name):
                    if idx == 0:
                        quant_mode = False
                    elif w_cfg is not None:
                        w_cfg = w_cfg.with_bitwidth(idx - 1)
            for idx, regex in enumerate(a_list):
                if len(regex) == 0:
                    continue
                if self._search(regex, full_name):
                    if idx == 0:
                        quant_mode = False
                    elif a_cfg is not None:
                        a_cfg = a_cfg.with_bitwidth(idx - 1)

        return LayerPolicy(
            method=method, weight=w_cfg, act=a_cfg, alpha=alpha,
            quant_mode=quant_mode, gptq=self.weight_gptq,
            gptq_act_order=self.weight_gptq_act_order, group=self.act_group,
            lowrank=self.weight_lowrank,
        )
