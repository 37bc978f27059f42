"""Quantized inference CLI (counterpart of wanq_tpu/cli/quant_generate.py):
simulated quantization (fake-quant, the default) or the int kernel path
(--hardware) for W8A8, W4A8 and W4A4 configs. A quant YAML's ``attn:``
section switches self-attention to the int8 flash kernel under --hardware
and to the simulated attention quantizers without it; a ``cross_attn:``
section runs the simulated quantizers on cross-attention in both modes.

    python -m wanq_tpu_torch.cli.quant_generate --task t2v-1.3B --size 832*480 \
        --frame_num 81 --random_init --quant_config quant_configs/wan_w8a8_speed.yaml \
        --calib_data quant_data/calib_data.npz --hardware --sample_steps 3

--calib_data is needed only for static activations (the W8A8 speed
config's ffn.2); wan_w4a8_mixed.yaml and wan_w4a4.yaml run without it.
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


CACHE_IGNORED = ("%s: the cache: section is ignored (the step caches are not ported yet); "
                 "every denoise step runs the full forward")


def parse_args(argv=None):
    p = argparse.ArgumentParser("wanq_tpu_torch quant_generate")
    add_common_args(p)
    p.add_argument("--quant_config", type=str, required=True)
    p.add_argument("--calib_data", type=str, default=None,
                   help="get_calib_data npz (needed for static activations)")
    p.add_argument("--hardware", action="store_true",
                   help="int kernel path; default is simulated quantization")
    return p.parse_args(argv)


def generate(args, on_step=None):
    """Quantize the weights (RTN + calibration scales), run the simulated
    or int denoise loop and save the latents; returns the npz path.
    ``on_step(i, t, latents)`` runs after each solver step."""
    setup_logging()
    validate_args(args)
    mode = "int8" if args.hardware else "sim"
    cfg = WAN_CONFIGS[args.task]
    size = SIZE_CONFIGS[args.size]
    qcfg = QuantConfig.from_yaml(args.quant_config)
    if qcfg.cache is not None:
        logging.info(CACHE_IGNORED, args.quant_config)
    params = load_params(args, cfg)
    calib = dict(np.load(args.calib_data)) if args.calib_data else None
    t0 = time.time()
    policies, state, _ = prepare_quant_state(params, linear_layer_names(cfg), qcfg,
                                             calib=calib, targets=mode)
    logging.info("computed quant state: %d layers in %.2fs", len(state), time.time() - t0)
    ctx = QuantCtx(mode=mode, policies=policies, state=state,
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
    logging.info("quant (%s) denoise done in %.2fs", mode, time.time() - t0)
    save_file = args.save_file or (
        f"quant_{mode}_{args.task}_{args.size.replace('*', 'x')}_seed{args.base_seed}.npz")
    np.savez(save_file, latents=latents.cpu().numpy())
    logging.info("saved %s", save_file)
    return save_file


if __name__ == "__main__":
    generate(parse_args())
