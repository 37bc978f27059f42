"""A quantization scheme (one of ``bench_h100/schemes/*.yaml``) read as the
Q-Diffusion-style configs define it: a layer whose name matches
``remain_fp_regex`` stays in floating point; every other linear takes the
weight quantizer (per output channel, ``weight.n_bits``, ``weight.sym``) and
the activation quantizer (per token, or per tensor from calibration where the
name matches ``act.static_regex``). A list of bit widths selects its entry
by ``mixed_precision.<side>.layer_name_regex`` (entry i of the regex list
picks ``n_bits[i - 1]``; the last match wins). Plain Python: the benchmark's
reference and its arithmetic read it, never the program."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

import yaml


@dataclasses.dataclass(frozen=True)
class SitePolicy:
    quantized: bool
    w_bits: int = 0
    w_sym: bool = False
    a_bits: int = 0
    a_sym: bool = True
    static: bool = False


def _bits(side: dict, mixed: Optional[dict], name: str) -> int:
    n = side["n_bits"]
    if not isinstance(n, (list, tuple)):
        return int(n)
    pick = 0
    for i, rx in enumerate((mixed or {}).get("layer_name_regex", [])):
        if i and rx and re.search(rx, name):
            pick = i - 1
    return int(n[pick])


def load_scheme(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def site_policy(scheme: dict, name: str) -> SitePolicy:
    fp = scheme.get("remain_fp_regex")
    if fp and re.search(fp, name):
        return SitePolicy(quantized=False)
    w, a = scheme["weight"], scheme["act"]
    mixed = scheme.get("mixed_precision") or {}
    static_rx = a.get("static_regex")
    return SitePolicy(quantized=True, w_bits=_bits(w, mixed.get("weight"), name),
                      w_sym=bool(w.get("sym", False)), a_bits=_bits(a, mixed.get("act"), name),
                      a_sym=bool(a.get("sym", True)),
                      static=bool(static_rx and re.search(static_rx, name)))


def block_sites() -> List[str]:
    """The linears of one Wan block, by their names inside the block."""
    return ["self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o",
            "cross_attn.q", "cross_attn.k", "cross_attn.v", "cross_attn.o", "ffn.0", "ffn.2"]


def policies(scheme: dict, num_layers: int) -> Dict[str, SitePolicy]:
    names = ["text_embedding.0", "text_embedding.2", "time_embedding.0", "time_embedding.2",
             "time_projection.1", "head.head"]
    names += [f"blocks.{i}.{s}" for i in range(num_layers) for s in block_sites()]
    return {n: site_policy(scheme, n) for n in names}
