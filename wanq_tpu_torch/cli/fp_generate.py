"""FP inference CLI (counterpart of wanq_tpu/cli/fp_generate.py): the bf16
denoise loop and, with --ckpt_dir, the VAE decode of its latents (in
--vae_dtype), saved as 'latents' and 'video' in one npz.

    python -m wanq_tpu_torch.cli.fp_generate --task t2v-1.3B --size 832*480 \
        --ckpt_dir Wan2.1-T2V-1.3B --prompt "..." --save_file fp.npz

    python -m wanq_tpu_torch.cli.fp_generate --task t2v-1.3B --random_init \
        --sample_steps 3 --save_file fp_latents.npz

    torchrun --nproc_per_node 8 -m wanq_tpu_torch.cli.fp_generate --task t2v-14B \
        --ckpt_dir Wan2.1-T2V-14B --ulysses_size 8 --dit_fsdp --t5_fsdp ...
"""

from __future__ import annotations

import argparse
import logging

import torch

from wanq_tpu_torch.cli.common import (
    add_common_args,
    build_mesh_and_plan,
    cache_policy_from_args,
    decode_video,
    free_device_memory,
    load_contexts,
    load_params,
    load_vae,
    parse_attn_window,
    require_t2v,
    save_outputs,
    setup_logging,
    synced_time,
    validate_args,
)
from wanq_tpu_torch.configs import SIZE_CONFIGS, WAN_CONFIGS
from wanq_tpu_torch.parallel.launch import is_main_rank
from wanq_tpu_torch.pipelines.text2video import WanT2V
from wanq_tpu_torch.quant.qlinear import QuantCtx


def parse_args(argv=None):
    p = argparse.ArgumentParser("wanq_tpu_torch fp_generate")
    add_common_args(p)
    return p.parse_args(argv)


def generate(args, on_step=None):
    """Denoise, decode where the checkpoint dir has a VAE, save; returns
    the npz path (None on a rank other than 0, which writes nothing).
    ``on_step(i, t, latents)`` runs after each solver step."""
    validate_args(args)
    require_t2v(args, "fp_generate")
    plan = build_mesh_and_plan(args)
    setup_logging()
    cfg = WAN_CONFIGS[args.task]
    logging.info("loading params (%s)", "random" if args.random_init else args.ckpt_dir)
    t0 = synced_time(args.device)
    params = load_params(args, cfg, plan)
    t1 = synced_time(args.device)
    context, context_null = load_contexts(args, cfg, plan)
    logging.info("params in %.2fs; text states in %.2fs", t1 - t0,
                 synced_time(args.device) - t1)
    win = parse_attn_window(args)
    # an fp-mode ctx carries only the temporal window
    qctx = QuantCtx(mode="fp", attn_window=win) if win is not None else None
    pipe = WanT2V(cfg, params, quant_ctx=qctx, device=args.device, shardings=plan)
    t0 = synced_time(args.device)
    latents = pipe.generate(
        torch.from_numpy(context), torch.from_numpy(context_null),
        size=SIZE_CONFIGS[args.size], frame_num=args.frame_num, shift=args.sample_shift,
        sample_solver=args.sample_solver, sampling_steps=args.sample_steps,
        guide_scale=args.sample_guide_scale, seed=args.base_seed,
        cache_policy=cache_policy_from_args(args), cfg_mode=args.cfg_mode, on_step=on_step)
    logging.info("denoise done in %.2fs, latents %s", synced_time(args.device) - t0,
                 tuple(latents.shape))
    if not is_main_rank():
        return None
    out = {"latents": latents.cpu().numpy()}
    vae = load_vae(args, cfg) if args.ckpt_dir else None
    if vae is not None:
        del pipe, params  # the decode gets the DiT's memory
        free_device_memory(args.device)
        out["video"] = decode_video(vae, latents, args.device)
    save_file = args.save_file or (
        f"fp_{args.task}_{args.size.replace('*', 'x')}_seed{args.base_seed}.npz")
    return save_outputs(save_file, out, cfg.sample_fps)


if __name__ == "__main__":
    generate(parse_args())
