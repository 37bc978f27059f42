"""The yardstick's arithmetic: the operations and bytes of the model's work
and of each kernel call, computed from a cell's shapes and scheme alone, so
they read the same whatever implements them; and the published peaks of one
NVIDIA H100 SXM (dense, at the 700 W limit): bytes/s of its HBM and
operations/s by precision.

Conventions (PERF.md §6's): a matrix product of [M, K] by [K, N] is 2MKN
operations; attention is 4 * B * H * Sq * Sk * D (QK^T and PV); a kernel's
bytes count each input read once and each output written once. The model's
work (``mfu``) counts the valid tokens only; a kernel's bound counts what
its launch is given, the query rows padded to the program's sequence
length included."""

from __future__ import annotations

import math
from typing import Dict, List

from reference.scheme import SitePolicy, block_sites, site_policy

HBM_BPS = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def attention_ops(b: int, h: int, sq: int, sk: int, d: int) -> float:
    return 4.0 * b * h * sq * sk * d


def attention_bytes(b: int, h: int, sq: int, sk: int, d: int, elt: int = 2) -> float:
    """q and o of Sq rows, k and v of Sk rows."""
    return float(elt * b * h * d * (2 * sq + 2 * sk))


def gemm_ops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def int_gemm_bytes(m: int, k: int, n: int, w_bits: int, out_bytes: int) -> float:
    """int8 activations [M, K] with their scale and code sum, the packed
    weight with its scale and zero point, the output [M, N]."""
    return float(m * k + m * 8 + k * n * w_bits // 8 + n * 8 + m * n * out_bytes)


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    """The least time of a call: the slower of its operations at the
    precision's peak and its bytes at the HBM rate."""
    return max(ops / PEAK_OPS[precision], nbytes / HBM_BPS)


def seq_tokens(cfg: Dict, traffic: Dict):
    """(valid tokens, the program's padded sequence length) of one video."""
    st, ps = cfg["vae_stride"], cfg["patch_size"]
    f = (traffic["frames"] - 1) // st[0] + 1
    h, w = traffic["height"] // st[1], traffic["width"] // st[2]
    valid = (f // ps[0]) * (h // ps[1]) * (w // ps[2])
    align = traffic.get("seq_align", 1)
    return valid, int(math.ceil(valid / align)) * align


def self_pairs(cfg: Dict, traffic: Dict, rows: int) -> float:
    """(query, key) pairs of one head's self-attention, averaged over the
    heads, for ``rows`` query rows (the valid tokens, or the padded length:
    a pad row sees the whole valid prefix). Dense: rows x valid keys; under
    the traffic's ``ctx.attn_window`` (+-r latent frames, an int or one r a
    head, negative dense) a valid row sees the keys of the frames in its
    head's band."""
    valid, _ = seq_tokens(cfg, traffic)
    aw = traffic.get("ctx", {}).get("attn_window")
    if aw is None or (not isinstance(aw, (list, tuple)) and int(aw) < 0):
        return float(rows) * valid
    st, ps, h = cfg["vae_stride"], cfg["patch_size"], cfg["num_heads"]
    frames = ((traffic["frames"] - 1) // st[0] + 1) // ps[0]
    tpf = valid // frames
    radii = list(aw) if isinstance(aw, (list, tuple)) else [int(aw)] * h
    total = 0.0
    for r in radii:
        r = frames if r < 0 else int(r)
        total += sum(min(f + r, frames - 1) - max(f - r, 0) + 1 for f in range(frames)) * tpf
    return total * tpf / len(radii) + float(rows - valid) * valid


# the output of each int GEMM site of a block, as the model consumes it: q, k,
# v and cross q feed attention in bf16, o and ffn.2 add to the residual in
# f32, ffn.0 hands ffn.2 its int8 codes when ffn.2's scale is static
_OUT_BYTES = {"self_attn.q": 2, "self_attn.k": 2, "self_attn.v": 2, "self_attn.o": 4,
              "cross_attn.q": 2, "cross_attn.o": 4, "ffn.0": 2, "ffn.2": 4}


def block_linears(cfg: Dict, scheme: dict, batch: int, rows: int) -> List[Dict]:
    """The linears of block 0 for a batch of ``batch`` sequences of ``rows``
    tokens: site, M, K, N, precision ('int8' or 'bf16'), weight bits, output
    bytes, and whether it runs the GELU + quant mode."""
    d, ffn, text = cfg["dim"], cfg["ffn_dim"], cfg["text_len"]
    shapes = {"ffn.0": (d, ffn), "ffn.2": (ffn, d)}
    out = []
    ffn2 = site_policy(scheme, "blocks.0.ffn.2")
    for site in block_sites():
        k, n = shapes.get(site, (d, d))
        m = batch * (text if site in ("cross_attn.k", "cross_attn.v") else rows)
        pol: SitePolicy = site_policy(scheme, f"blocks.0.{site}")
        mode = site == "ffn.0" and pol.quantized and ffn2.quantized and ffn2.static
        out.append({"site": site, "m": m, "k": k, "n": n,
                    "precision": "int8" if pol.quantized else "bf16", "w_bits": pol.w_bits,
                    "out_bytes": 1 if mode else _OUT_BYTES.get(site, 2), "gelu_quant": mode})
    return out


def forward_work(cfg: Dict, scheme: dict, traffic: Dict, batch: int) -> Dict[str, float]:
    """Operations of one forward of ``batch`` sequences over the valid tokens,
    by precision: attention and FP linears at bf16, quantized linears at int8
    (the embeddings, time MLP and head included)."""
    valid, _ = seq_tokens(cfg, traffic)
    d, h, hd, text = cfg["dim"], cfg["num_heads"], cfg["dim"] // cfg["num_heads"], cfg["text_len"]
    layers = cfg["num_layers"]
    work = {"bf16": 0.0, "int8": 0.0, "f32": 0.0}
    work["bf16"] += layers * (attention_ops(batch, h, self_pairs(cfg, traffic, valid), 1, hd)
                              + attention_ops(batch, h, valid, text, hd))
    for lin in block_linears(cfg, scheme, batch, valid):
        work[lin["precision"]] += layers * gemm_ops(lin["m"], lin["k"], lin["n"])
    patch = math.prod(cfg["patch_size"])
    work["bf16"] += gemm_ops(batch * valid, patch * cfg["in_dim"], d)       # patch embedding
    work["bf16"] += gemm_ops(batch * text, cfg["text_dim"], d) + gemm_ops(batch * text, d, d)
    work["bf16"] += gemm_ops(batch * valid, d, patch * cfg["out_dim"])      # head
    work["f32"] += gemm_ops(batch, cfg["freq_dim"], d) + gemm_ops(batch, d, d) \
        + gemm_ops(batch, d, 6 * d)                                         # time MLP
    return work


def least_time_s(work: Dict[str, float]) -> float:
    return sum(ops / PEAK_OPS[p] for p, ops in work.items())


def attention_calls(cfg: Dict, traffic: Dict, batch: int) -> List[Dict]:
    """K4's launches of one forward: self (padded q rows, valid keys, the
    pairs of the traffic's band if it has one) and cross (512 text keys),
    one of each a block."""
    valid, padded = seq_tokens(cfg, traffic)
    h, hd, text = cfg["num_heads"], cfg["dim"] // cfg["num_heads"], cfg["text_len"]
    calls = []
    for part, sk in (("self", valid), ("cross", text)):
        pairs = self_pairs(cfg, traffic, padded) if part == "self" else float(padded) * sk
        ops = attention_ops(batch, h, pairs, 1, hd)
        nbytes = attention_bytes(batch, h, padded, sk, hd)
        calls.append({"ops": ops, "bytes": nbytes, "bound_s": bound_s(ops, nbytes, "bf16"),
                      "count": cfg["num_layers"]})
    return calls


def int_gemm_calls(cfg: Dict, scheme: dict, traffic: Dict, batch: int) -> List[Dict]:
    """The int GEMM launches (K2 / K8) of one forward over the padded rows."""
    _, padded = seq_tokens(cfg, traffic)
    calls = []
    for lin in block_linears(cfg, scheme, batch, padded):
        if lin["precision"] != "int8":
            continue
        ops = gemm_ops(lin["m"], lin["k"], lin["n"])
        nbytes = int_gemm_bytes(lin["m"], lin["k"], lin["n"], lin["w_bits"], lin["out_bytes"])
        calls.append({**lin, "ops": ops, "bytes": nbytes,
                      "bound_s": bound_s(ops, nbytes, "int8"), "count": cfg["num_layers"]})
    return calls


# -- training (QLoRA distillation: the trainable route runs every product on
# bf16 operands, so all of its work is priced at the bf16 peak) -------------


def forward_ops(cfg: Dict, traffic: Dict, batch: int) -> float:
    fp = {"remain_fp_regex": ".*", "weight": {"n_bits": 16}, "act": {"n_bits": 16}}
    return sum(forward_work(cfg, fp, traffic, batch).values())


def train_step_work(cfg: Dict, traffic: Dict) -> float:
    """Operations of one QLoRA distillation step: the teacher's two forwards,
    the student's forward, and the backward's input gradients (every linear
    on the token rows, not the text or time ones nor the patch embedding;
    self-attention's dP, dQ, dK, dV, cross-attention's dP, dQ) and the
    adapters' three products a site; the backward's recomputation excluded."""
    b = traffic["batch"]
    valid, _ = seq_tokens(cfg, traffic)
    d, h, hd, text = cfg["dim"], cfg["num_heads"], cfg["dim"] // cfg["num_heads"], cfg["text_len"]
    layers = cfg["num_layers"]
    fwd = forward_ops(cfg, traffic, b)
    bwd = layers * (2 * attention_ops(b, h, valid, valid, hd)
                    + attention_ops(b, h, valid, text, hd))
    fp = {"remain_fp_regex": ".*", "weight": {"n_bits": 16}, "act": {"n_bits": 16}}
    for lin in block_linears(cfg, fp, b, valid):
        if lin["site"] not in ("cross_attn.k", "cross_attn.v"):
            bwd += layers * gemm_ops(lin["m"], lin["k"], lin["n"])
    bwd += gemm_ops(b * valid, d, math.prod(cfg["patch_size"]) * cfg["out_dim"])   # head
    import re

    r, pat = traffic["rank"], re.compile(traffic["targets"])
    lora = sum(3 * 2.0 * lin["m"] * r * (lin["k"] + lin["n"]) for lin in block_linears(
        cfg, fp, b, valid) if pat.search(f"blocks.0.{lin['site']}")) * layers
    return 3 * fwd + bwd + lora


def train_attention_calls(cfg: Dict, traffic: Dict) -> List[Dict]:
    """The attention kernels' launches of one QLoRA step (remat): K4 plain for
    the teacher's two forwards, K4's residual mode for the student's forward
    and its recompute, K12 (dq: QK^T, dP, dQ) at self and cross, K11 (dk, dv:
    QK^T, dP, dV, dK) at self; each with the bytes of its operands read once
    (the residual mode's and the backward's row statistics included)."""
    b = traffic["batch"]
    valid, _ = seq_tokens(cfg, traffic)
    h, hd, text, layers = cfg["num_heads"], cfg["dim"] // cfg["num_heads"], cfg["text_len"], \
        cfg["num_layers"]
    calls = []

    def add(kind, ops, nbytes, count):
        calls.append({"kind": kind, "ops": ops, "bytes": nbytes,
                      "bound_s": bound_s(ops, nbytes, "bf16"), "count": count})

    rows = b * h * valid * 4                                # f32 statistics a query row
    for part, sk in (("self", valid), ("cross", text)):
        fwd, act = attention_ops(b, h, valid, sk, hd), attention_bytes(b, h, valid, sk, hd)
        add(f"fwd.{part}", fwd, act, 2 * layers)                # the teacher
        add(f"fwd_lse.{part}", fwd, act + rows, 2 * layers)     # student forward and recompute
        add(f"bwd_dq.{part}", 1.5 * fwd, 2 * b * h * hd * (3 * valid + 2 * sk) + 2 * rows,
            layers)
    fwd = attention_ops(b, h, valid, valid, hd)
    add("bwd_dkv.self", 2 * fwd, 2 * b * h * hd * 6 * valid + 2 * rows, layers)
    return calls
