r"""Calibration CLI (counterpart of wanq_tpu/cli/get_calib_data.py).

Runs an FP denoise sweep and saves per-layer activation statistics
{layer: [T, C]} (absmax; with --collect_minmax also .act_max/.act_min) --
the input to PTQ. With --attn_map_pool P it also saves each layer's pooled
post-softmax self-attention map ``<layer>.attn_map`` [T, H, S/P, S/P] and the
pool factor ``attn_map_pool``, from which quant.attn.select_temporal_windows
chooses window radii (--attn_map_reduce mean). With --collect_hessian
REGEX it also saves each matching layer's input Hessian ``<layer>.hess``
[C, C], summed in f64 over the steps on the device and saved as f32, for
GPTQ rounding.
--calib_rounds N runs N sweeps from seeds base_seed + i: the Hessians sum,
the [T, ...] stacks concatenate. The sweep runs dense: --attn_window is
ignored.

Under torchrun the mesh flags (--ulysses_size, --ring_size, --dp_size,
--fsdp_size or --dit_fsdp, --full_shard, --t5_fsdp) shard the sweep as
quant_generate's forward is sharded; each statistic is reduced over the ranks
that split its rows, so the artifact is the one-process sweep's (at the same
sequence length: the sequence rounds up to a multiple of ulysses x ring), and
only rank 0 writes it:

    torchrun --nproc_per_node 8 -m wanq_tpu_torch.cli.get_calib_data --task t2v-14B \
        --random_init --collect_minmax --sample_steps 1 --ulysses_size 4 --dit_fsdp

    python -m wanq_tpu_torch.cli.get_calib_data --task t2v-1.3B --size 832*480 \
        --frame_num 81 --random_init --collect_minmax --sample_steps 1 \
        --quant_config quant_configs/wan_w8a8_speed.yaml

    python -m wanq_tpu_torch.cli.get_calib_data --task t2v-1.3B --random_init \
        --quant_config quant_configs/wan_w4a8_gptq.yaml --collect_minmax \
        --collect_hessian 'self_attn|cross_attn\.(q|o)|ffn\.0' --calib_rounds 3
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from wanq_tpu_torch.cli.common import (
    add_common_args,
    build_mesh_and_plan,
    conditioning,
    denoise_pipeline,
    load_contexts,
    load_params,
    require_t2v,
    setup_logging,
    validate_args,
)
from wanq_tpu_torch.configs import SIZE_CONFIGS, WAN_CONFIGS
from wanq_tpu_torch.parallel.launch import is_main_rank
from wanq_tpu_torch.quant import QuantConfig
from wanq_tpu_torch.quant.qlinear import QuantCtx


def parse_args(argv=None):
    p = argparse.ArgumentParser("wanq_tpu_torch get_calib_data")
    add_common_args(p, default_steps=30)
    p.add_argument("--quant_config", type=str, default=None,
                   help="quant YAML; its calib_data.save_path is the default output")
    p.add_argument("--calib_save_path", type=str, default=None,
                   help="output npz (overrides the YAML's calib_data.save_path; "
                        "default calib_data.npz)")
    p.add_argument("--collect_minmax", action="store_true",
                   help="also collect per-channel act min/max (static A8)")
    p.add_argument("--attn_map_pool", type=int, default=0,
                   help="pool factor of the post-softmax attention-map capture (0 = off)")
    p.add_argument("--attn_map_reduce", type=str, default="max", choices=["max", "mean"],
                   help="pooling of the captured maps: 'max' feeds reorder tables, 'mean' "
                        "(mass-preserving) the choice of window radii")
    p.add_argument("--collect_hessian", type=str, default=None, metavar="REGEX",
                   help="also sum the input Hessian X^T X of the layers matching REGEX "
                        "(GPTQ rounding); [C_in, C_in] f32 each, on the device")
    p.add_argument("--calib_rounds", type=int, default=1,
                   help="sweeps from seeds base_seed + i merged into one artifact: "
                        "Hessians sum, the other stacks concatenate")
    return p.parse_args(argv)


def generate(args):
    """Run the sweep and write the npz; returns its path (None on the ranks
    other than 0)."""
    setup_logging()
    validate_args(args)
    require_t2v(args, "get_calib_data")
    cfg = WAN_CONFIGS[args.task]
    size = SIZE_CONFIGS[args.size]

    save_path = args.calib_save_path
    if save_path is None and args.quant_config:
        save_path = QuantConfig.from_yaml(args.quant_config).calib_save_path
    save_path = save_path or "calib_data.npz"
    if save_path.endswith(".pth"):
        save_path = save_path[:-4] + ".npz"

    plan = build_mesh_and_plan(args)
    params = load_params(args, cfg, plan)
    context, context_null = load_contexts(args, cfg, plan)
    pipe = denoise_pipeline(args, cfg, params, QuantCtx(
        mode="calib", collect_minmax=args.collect_minmax, attn_map_pool=args.attn_map_pool,
        attn_map_reduce=args.attn_map_reduce, hessian_regex=args.collect_hessian), plan)
    t0 = time.time()
    rounds = max(1, args.calib_rounds)
    stats = {}
    for rnd in range(rounds):
        one = pipe.collect_calibration(
            torch.from_numpy(context), torch.from_numpy(context_null),
            size=size, frame_num=args.frame_num, shift=args.sample_shift,
            sample_solver=args.sample_solver, sampling_steps=args.sample_steps,
            guide_scale=args.sample_guide_scale,
            seed=args.base_seed + rnd, **conditioning(cfg, size, args.base_seed + rnd),
        )
        for k, v in one.items():
            if k not in stats:
                stats[k] = v
            elif k.endswith(".hess"):
                stats[k] = stats[k] + v
            else:
                stats[k] = np.concatenate([stats[k], v], axis=0)
    logging.info("calibration sweep done in %.2fs: %d entries (%d Hessians) x %d steps x %d "
                 "rounds", time.time() - t0, len(stats),
                 sum(k.endswith(".hess") for k in stats), args.sample_steps, rounds)
    if not is_main_rank():
        return None
    # the Hessians' f64 sums are saved as f32, as wanq_tpu saves them
    stats = {k: v.float().cpu().numpy() if isinstance(v, torch.Tensor) else v
             for k, v in stats.items()}
    if args.attn_map_pool:
        # the pool factor maps pooled cells back to token indices
        stats["attn_map_pool"] = np.asarray(args.attn_map_pool)
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    np.savez(save_path, **stats)
    logging.info("saved %s", save_path)
    return save_path


if __name__ == "__main__":
    generate(parse_args())
