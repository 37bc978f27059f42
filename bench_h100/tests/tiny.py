"""A Wan-shaped model small enough for the CPU: 4 blocks of width 256, two
heads of 128 (so the program takes its fused paths), 32 text tokens of width
256, a 64 x 64 x 5 video (32 tokens)."""

import json
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent

CONFIG = {"name": "tiny", "dim": 256, "ffn_dim": 512, "num_heads": 2, "num_layers": 4,
          "text_len": 32, "text_dim": 256, "freq_dim": 256, "patch_size": [1, 2, 2], "in_dim": 16,
          "out_dim": 16, "z_dim": 16, "vae_stride": [4, 8, 8], "eps": 1e-6, "qk_norm": True,
          "cross_attn_norm": True, "param_dtype": "bfloat16", "residual_dtype": "bfloat16",
          "num_train_timesteps": 1000, "window_size": [-1, -1]}
TRAFFIC = {"width": 64, "height": 64, "frames": 5}


def cell(name: str, steps=6):
    spec = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    spec["traffic"] = {**spec["traffic"], **TRAFFIC}
    if steps is not None:
        spec["traffic"]["steps"] = steps
    return spec


def job(name: str, seed: int = 2**31 + 11, seconds: float = 0.0, steps=6):
    import run

    run.OUT.mkdir(exist_ok=True)
    return run.Job(cell(name, steps), CONFIG, seed, seconds, False, time.time(), device="cpu")
