"""Quantized inference CLI (counterpart of wanq_tpu/cli/quant_generate.py):
the int8 kernel path (--hardware). Simulated quant is not ported yet.

    python -m wanq_tpu_torch.cli.quant_generate --task t2v-1.3B --size 832*480 \
        --frame_num 81 --random_init --quant_config quant_configs/wan_w8a8_speed.yaml \
        --calib_data quant_data/calib_data.npz --hardware --sample_steps 3
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from wanq_tpu_torch.cli.common import (
    add_common_args,
    load_contexts,
    load_params,
    setup_logging,
    validate_args,
)
from wanq_tpu_torch.configs import SIZE_CONFIGS, WAN_CONFIGS
from wanq_tpu_torch.models.dit import linear_layer_names
from wanq_tpu_torch.pipelines.text2video import WanT2V
from wanq_tpu_torch.quant import QuantConfig
from wanq_tpu_torch.quant.ptq import prepare_quant_state
from wanq_tpu_torch.quant.qlinear import QuantCtx


def parse_args(argv=None):
    p = argparse.ArgumentParser("wanq_tpu_torch quant_generate")
    add_common_args(p)
    p.add_argument("--quant_config", type=str, required=True)
    p.add_argument("--calib_data", type=str, default=None,
                   help="get_calib_data npz (needed for static activations)")
    p.add_argument("--hardware", action="store_true",
                   help="int8 kernel path (required: simulated quant is not ported yet)")
    return p.parse_args(argv)


def generate(args, on_step=None):
    """Quantize the weights (RTN + calibration scales), run the int8
    denoise loop and save the latents; returns the npz path.
    ``on_step(i, t, latents)`` runs after each solver step."""
    setup_logging()
    validate_args(args)
    if not args.hardware:
        raise NotImplementedError(
            "simulated quantization is not ported yet (ROADMAP Queue 1 item 3, "
            "sim mode); pass --hardware")
    cfg = WAN_CONFIGS[args.task]
    size = SIZE_CONFIGS[args.size]
    qcfg = QuantConfig.from_yaml(args.quant_config)
    params = load_params(args, cfg)
    calib = dict(np.load(args.calib_data)) if args.calib_data else None
    t0 = time.time()
    policies, state, _ = prepare_quant_state(params, linear_layer_names(cfg), qcfg,
                                             calib=calib)
    logging.info("computed quant state: %d layers in %.2fs", len(state), time.time() - t0)
    ctx = QuantCtx(mode="int8", policies=policies, state=state,
                   attn=qcfg.attn_cfg, cross_attn=qcfg.cross_attn_cfg)

    context, context_null = load_contexts(args, cfg)
    pipe = WanT2V(cfg, params, quant_ctx=ctx, device=args.device)
    t0 = time.time()
    latents = pipe.generate(
        torch.from_numpy(context), torch.from_numpy(context_null), size=size,
        frame_num=args.frame_num, shift=args.sample_shift,
        sampling_steps=args.sample_steps, guide_scale=args.sample_guide_scale,
        seed=args.base_seed, on_step=on_step,
    )
    if latents.is_cuda:
        torch.cuda.synchronize()
    logging.info("int8 denoise done in %.2fs", time.time() - t0)
    save_file = args.save_file or (
        f"quant_int8_{args.task}_{args.size.replace('*', 'x')}_seed{args.base_seed}.npz")
    np.savez(save_file, latents=latents.cpu().numpy())
    logging.info("saved %s", save_file)
    return save_file


if __name__ == "__main__":
    generate(parse_args())
