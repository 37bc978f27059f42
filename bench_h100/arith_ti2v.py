"""The bytes of the block's memory-bound passes around the per-frame
modulation table: K1 (LayerNorm + modulate + int8 quant) and K13 (the gated
residual updates), each call counted from its shapes as ``arith.py`` counts
(each input read once, each output written once), for
``modulate_roofline.serve``. A call's table rows are read once: [B, R, C] f32
a modulation operand, R the latent frames where the operand is a per-frame
row (self-attention's and the ffn's shift, scale and gate) and 1 where it is
one row a sample (cross-attention's norm3)."""

from __future__ import annotations

from typing import Dict, List

from arith import HBM_BPS, seq_tokens
from reference.scheme import site_policy


def latent_frames(cfg: Dict, traffic: Dict) -> int:
    return ((traffic["frames"] - 1) // cfg["vae_stride"][0] + 1) // cfg["patch_size"][0]


def k1_bytes(m: int, c: int, x_bytes: int, rows: int) -> float:
    """x [M, C] in, int8 codes [M, C] and f32 scale and sum [M] out, shift
    and scale rows [rows, C] f32 in."""
    return float(m * c * x_bytes + m * c + m * 8 + 2 * rows * c * 4)


def k13_bytes(m: int, c: int, x_bytes: int, gate_rows: int, bias: bool) -> float:
    """x [M, C] and f32 y [M, C] in, out [M, C] in x's dtype, gate rows
    [gate_rows, C] f32 and the bias [C] f32 in."""
    return float(m * c * (2 * x_bytes + 4) + gate_rows * c * 4 + (c * 4 if bias else 0))


def modulate_calls(cfg: Dict, scheme: dict, traffic: Dict, batch: int) -> List[Dict]:
    """K1's three and K13's three launches of a block in one forward of
    ``batch`` sequences over the padded tokens, each with its bytes and bound
    (bytes over the HBM rate) and its count (the layers). An o projection
    that runs FP leaves its bias to K13."""
    _, padded = seq_tokens(cfg, traffic)
    c, m = cfg["dim"], batch * padded
    xb = 2 if cfg.get("residual_dtype") == "bfloat16" else 4
    f = latent_frames(cfg, traffic)
    fp_o = {sa: not site_policy(scheme, f"blocks.0.{sa}.o").quantized
            for sa in ("self_attn", "cross_attn")}
    calls = [("K1 self", k1_bytes(m, c, xb, batch * f)),
             ("K1 cross", k1_bytes(m, c, xb, batch)),
             ("K1 ffn", k1_bytes(m, c, xb, batch * f)),
             ("K13 self", k13_bytes(m, c, xb, batch * f, fp_o["self_attn"])),
             ("K13 cross", k13_bytes(m, c, xb, 0, fp_o["cross_attn"])),
             ("K13 ffn", k13_bytes(m, c, xb, batch * f, False))]
    return [{"call": name, "bytes": nbytes, "bound_s": nbytes / HBM_BPS,
             "count": cfg["num_layers"]} for name, nbytes in calls]
