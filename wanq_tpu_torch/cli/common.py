"""Shared CLI plumbing (counterpart of wanq_tpu/cli/common.py, the subset
the calibration -> int8 inference chain needs).

The runs are checkpoint-free: ``--random_init`` weights from a seed (drawn
on the card for a CUDA ``--device``), and text states random or from
``--context_file`` (checkpoints, T5 and the prompt flags come with the T5
port). The step-cache flags and a quant YAML's ``cache:`` section become a
policy through :func:`cache_policy_from_args`.
The multi-device flags are accepted for command-line parity and raise when
set: multi-GPU is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Tuple

import numpy as np
import torch

from wanq_tpu_torch.configs import SIZE_CONFIGS, SUPPORTED_SIZES, WAN_CONFIGS

_MULTI_DEVICE_FLAGS = ("ulysses_size", "ring_size", "dp_size", "fsdp_size")
# what an unset cache flag means when no YAML section supplies it
CACHE_DEFAULTS = {"warmup": 4, "tail": 4, "order": 0}


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
    p.add_argument("--cfg_mode", type=str, default="batched", choices=["batched", "sequential"],
                   help="classifier-free guidance: 'batched' runs cond + uncond as one [2B] "
                        "forward; 'sequential' as two [B] forwards (the same math, half the "
                        "peak activation memory: T2V-14B at 720p)")
    # step caching; unset flags (None) leave a quant YAML's cache: section in force
    p.add_argument("--cfg_cache_interval", type=int, default=1,
                   help="refresh the uncond branch every K-th model evaluation; between "
                        "refreshes only the cond branch runs. 1 = off")
    p.add_argument("--reuse_interval", type=int, default=1,
                   help="run the model every R-th step, reuse the last noise prediction "
                        "between. 1 = off")
    p.add_argument("--cache_warmup", type=int, default=None,
                   help=f"always-full steps at the start (default {CACHE_DEFAULTS['warmup']}, "
                        "or the YAML's)")
    p.add_argument("--cache_tail", type=int, default=None,
                   help=f"always-full steps at the end (default {CACHE_DEFAULTS['tail']}, "
                        "or the YAML's)")
    p.add_argument("--cache_threshold", type=float, default=None,
                   help="adaptive step reuse: skip the model while the accumulated per-step "
                        "input drift (through --cache_poly) stays below this; composes with "
                        "--cfg_cache_interval, overrides --reuse_interval. 0 = off, and also "
                        "turns off a quant YAML's cache: section")
    p.add_argument("--cache_poly", type=str, default=None,
                   help="comma-separated np.polyval coefficients rescaling the drift "
                        "(pipelines.text2video.fit_drift_poly); default identity")
    p.add_argument("--cache_order", type=int, default=None, choices=[0, 1, 2],
                   help="forecast order on skipped steps: 0 reuses the last prediction, "
                        "1 / 2 extrapolate through the last 2 / 3 executed ones")
    return p


def _parse_poly(text: str) -> Tuple[float, ...]:
    return tuple(float(c) for c in text.split(",")) if text.strip() else (1.0, 0.0)


def cache_policy_from_config(qcfg):
    """The step-cache policy of a quant config's ``cache:`` section (the
    scale-tuned defaults shipped beside the quant scheme: the 14B YAMLs
    carry a fitted drift polynomial and an output-space threshold); None
    without a section or when it is inactive."""
    sec = getattr(qcfg, "cache", None)
    if not sec:
        return None
    from wanq_tpu_torch.pipelines.text2video import AdaptiveCachePolicy, StepCachePolicy

    common = dict(warmup=int(sec.get("warmup", CACHE_DEFAULTS["warmup"])),
                  tail=int(sec.get("tail", CACHE_DEFAULTS["tail"])),
                  cfg_interval=int(sec.get("cfg_interval", 1)),
                  order=int(sec.get("order", CACHE_DEFAULTS["order"])))
    if sec.get("threshold"):
        poly = tuple(float(c) for c in sec.get("poly", (1.0, 0.0)))
        return AdaptiveCachePolicy(threshold=float(sec["threshold"]), poly=poly, **common)
    pol = StepCachePolicy(reuse_interval=int(sec.get("reuse_interval", 1)), **common)
    return pol if pol.active else None


def cache_policy_from_args(args, qcfg=None):
    """The step-cache policy of the CLI flags, None when inactive. A
    ``--cache_threshold`` > 0 selects the adaptive policy, else the static
    schedule of ``--reuse_interval`` / ``--cfg_cache_interval``. With none
    of those three given, the quant config's ``cache:`` section applies, and
    an explicit ``--cache_warmup`` / ``--cache_tail`` / ``--cache_order`` /
    ``--cache_poly`` replaces its value. An explicit ``--cache_threshold 0``
    turns the section off. (wanq_tpu cannot tell an explicit 0 from unset,
    and drops the explicit values when it falls back to the section.)"""
    from wanq_tpu_torch.pipelines.text2video import AdaptiveCachePolicy, StepCachePolicy

    thresh = getattr(args, "cache_threshold", None)
    reuse = getattr(args, "reuse_interval", 1)
    cfg_interval = getattr(args, "cfg_cache_interval", 1)
    given = {k: getattr(args, f"cache_{k}", None) for k in ("warmup", "tail", "order")}
    poly = getattr(args, "cache_poly", None)
    if thresh is None and reuse <= 1 and cfg_interval <= 1:
        pol = cache_policy_from_config(qcfg) if qcfg is not None else None
        if pol is None:
            return None
        fields = {k: v for k, v in given.items() if v is not None}
        if poly is not None and isinstance(pol, AdaptiveCachePolicy):
            fields["poly"] = _parse_poly(poly)
        return dataclasses.replace(pol, **fields)
    common = {k: CACHE_DEFAULTS[k] if v is None else v for k, v in given.items()}
    if thresh is not None and thresh > 0.0:
        return AdaptiveCachePolicy(threshold=thresh, cfg_interval=cfg_interval,
                                   poly=_parse_poly(poly or ""), **common)
    pol = StepCachePolicy(cfg_interval=cfg_interval, reuse_interval=reuse, **common)
    return pol if pol.active else None


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
    """--random_init weights on ``args.device``: drawn on the card by
    ``init_params_on_device`` for a CUDA device (no host copy: T2V-14B is
    28.6 GB), by the host numpy draw of ``init_params`` otherwise (the same
    weights as wanq_tpu's from the same seed). init_params zero-inits
    head.head (the reference's from-scratch semantics), which would make
    the output identically zero, so it is redrawn: normal * 0.02 from seed
    base_seed + 1, by a torch.Generator on the card or numpy on the host
    (wanq_tpu draws it with jax.random, so that one tensor differs between
    the packages)."""
    from wanq_tpu_torch.models.dit import init_params, init_params_on_device

    hw_shape = (cfg.dim, int(np.prod(cfg.patch_size)) * cfg.out_dim)
    if torch.device(args.device).type == "cuda":
        params = init_params_on_device(cfg, args.base_seed, device=args.device)
        gen = torch.Generator(device=args.device).manual_seed(args.base_seed + 1)
        head = torch.empty(hw_shape, device=args.device).normal_(0.0, 0.02, generator=gen)
    else:
        params = init_params(cfg, args.base_seed, device=args.device)
        rng = np.random.default_rng(args.base_seed + 1)
        head = torch.from_numpy((0.02 * rng.standard_normal(hw_shape)).astype(np.float32))
    params["head"]["head"]["w"] = head.to(device=args.device, dtype=cfg.dtype)
    return params
