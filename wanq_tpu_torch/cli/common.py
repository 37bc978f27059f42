"""Shared CLI plumbing (counterpart of wanq_tpu/cli/common.py, the subset
the calibration -> int8 inference chain needs).

The runs are checkpoint-free: ``--random_init`` weights from a seed, and
text states random or from ``--context_file`` (checkpoints, T5 and the
prompt flags come with the T5 port).
The multi-device flags are accepted for command-line parity and raise when
set: multi-GPU is not ported yet.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Tuple

import numpy as np
import torch

from wanq_tpu_torch.configs import SIZE_CONFIGS, SUPPORTED_SIZES, WAN_CONFIGS

_MULTI_DEVICE_FLAGS = ("ulysses_size", "ring_size", "dp_size", "fsdp_size")


def add_common_args(p: argparse.ArgumentParser, default_steps: int = 50):
    p.add_argument("--task", type=str, default="t2v-1.3B", choices=list(WAN_CONFIGS))
    p.add_argument("--size", type=str, default="832*480", choices=list(SIZE_CONFIGS))
    p.add_argument("--frame_num", type=int, default=81, help="4n+1 frames")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="Wan2.1 checkpoint dir (not ported yet: use --random_init)")
    p.add_argument("--random_init", action="store_true",
                   help="random weights from --base_seed instead of a checkpoint")
    p.add_argument("--context_file", type=str, default=None,
                   help="npz with precomputed 'context'/'context_null' "
                        "text-encoder states")
    p.add_argument("--base_seed", type=int, default=42)
    p.add_argument("--sample_steps", type=int, default=default_steps)
    p.add_argument("--sample_shift", type=float, default=5.0)
    p.add_argument("--sample_guide_scale", type=float, default=5.0)
    p.add_argument("--save_file", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' runs the hand-written kernels, "
                        "'cpu' their plain PyTorch versions (tests, tiny runs)")
    for flag in _MULTI_DEVICE_FLAGS:
        p.add_argument(f"--{flag}", type=int, default=1,
                       help="multi-GPU (not ported yet; must stay 1)")
    p.add_argument("--dit_fsdp", action="store_true", help="multi-GPU (not ported yet)")
    p.add_argument("--attn_window", type=str, default="-1",
                   help="sliding temporal-window self-attention: band of +-N latent frames "
                        "(K4's band mode skips the kv tiles outside it). -1 = dense; a comma "
                        "list gives one radius per head (a negative entry is dense for that "
                        "head), e.g. from quant.attn.per_head_window_radii. Does not compose "
                        "with an attn: section")
    return p


def parse_attn_window(args):
    """``--attn_window`` -> None (dense) | int radius | per-head tuple. Takes
    "R" or a comma list "r0,r1,..." (one per head; a trailing comma and
    spaces are tolerated, negative entries stay); a negative scalar is
    dense."""
    val = getattr(args, "attn_window", None)
    if val is None:
        return None
    s = str(val).strip()
    if not s:
        return None
    if "," in s:
        parts = [x.strip() for x in s.split(",") if x.strip()]
        return tuple(int(x) for x in parts) if parts else None
    r = int(s)
    return r if r >= 0 else None


def validate_args(args):
    if args.frame_num % 4 != 1:
        raise SystemExit("frame_num must be 4n+1")
    if args.size not in SUPPORTED_SIZES[args.task]:
        raise SystemExit(f"size {args.size} unsupported for {args.task}: "
                         f"{SUPPORTED_SIZES[args.task]}")
    if any(getattr(args, f) != 1 for f in _MULTI_DEVICE_FLAGS) or args.dit_fsdp:
        raise NotImplementedError(
            "multi-GPU runs are not ported yet (ROADMAP Queue 1 item 10)")
    if args.ckpt_dir is not None:
        raise NotImplementedError(
            "checkpoint loading and the T5 encoder are not ported yet "
            "(ROADMAP Queue 1 item 4); use --random_init")
    if not args.random_init:
        raise SystemExit("need --random_init (checkpoint loading is not ported yet)")
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda but torch sees no CUDA device")
        # f32 matmuls stay full f32 (no TF32), as in the JAX reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def setup_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] %(levelname)s: %(message)s",
        handlers=[logging.StreamHandler(stream=sys.stdout)],
        force=True,
    )


def load_contexts(args, cfg) -> Tuple[np.ndarray, np.ndarray]:
    """Text-encoder states: from --context_file, else random from
    --base_seed (the same draw as wanq_tpu's load_contexts)."""
    if args.context_file:
        data = np.load(args.context_file)
        return data["context"], data["context_null"]
    rng = np.random.default_rng(args.base_seed)
    shape = (1, cfg.text_len, cfg.text_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def load_params(args, cfg):
    """--random_init weights on ``args.device``. init_params zero-inits
    head.head (the reference's from-scratch semantics), which would make
    the output identically zero, so it is redrawn: normal * 0.02 from
    numpy seed base_seed + 1 (wanq_tpu draws it with jax.random, so that
    one tensor differs between the packages)."""
    from wanq_tpu_torch.models.dit import init_params

    params = init_params(cfg, args.base_seed, device=args.device)
    hw = params["head"]["head"]["w"]
    rng = np.random.default_rng(args.base_seed + 1)
    params["head"]["head"]["w"] = torch.from_numpy(
        (0.02 * rng.standard_normal(tuple(hw.shape))).astype(np.float32)
    ).to(device=hw.device, dtype=hw.dtype)
    return params
