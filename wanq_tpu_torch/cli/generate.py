"""Unified generation CLI (counterpart of wanq_tpu/cli/generate.py): t2v, t2i
(a one-frame t2v) and i2v, FP or quantized (``--quant_config`` with the
``--quant_params`` artifact of ptq, simulated or ``--hardware``), then the
VAE decode of the latents in --vae_dtype when --ckpt_dir holds a VAE.

    python -m wanq_tpu_torch.cli.generate --task t2v-1.3B --size 832*480 \
        --ckpt_dir Wan2.1-T2V-1.3B --prompt "..." \
        --quant_config quant_configs/wan_w8a8_speed.yaml \
        --quant_params quant_params.npz --hardware --save_file gen.npz

    python -m wanq_tpu_torch.cli.generate --task i2v-14B --size 832*480 \
        --ckpt_dir Wan2.1-I2V-14B-480P --image input.jpg --prompt "..." \
        --sample_solver dpm++ --vae_dtype bfloat16

i2v: ``--image`` is read with imageio; the dir's CLIP encodes it and its VAE
encodes it as the first frame (``--vae_dtype``, which the decode uses too),
and ``--size`` sets the pixel area the image's aspect is fitted into. Without
--ckpt_dir the CLIP features and the VAE latents are seeded random draws.

ti2v-5B (Wan2.2 TI2V-5B) runs image-to-video on a seeded random conditioning
latent (latent frame 0 held, its tokens at t = 0):

    python -m wanq_tpu_torch.cli.generate --task ti2v-5B --size 1280*704 \
        --frame_num 121 --random_init --quant_config ... --hardware

The Wan2.2 VAE (48 channels, 16x spatial), which would encode ``--image`` and
decode the video, is not in the repository: ``--image`` is refused, and the
npz holds the latents only.

``--prompt_file`` serves one prompt per line from one process: the DiT and
its quant state load once, one T5 encoder encodes every prompt and is freed
before the first denoise, and each prompt gets its own npz (and video file).

Under torchrun the mesh flags shard the DiT (t2v and i2v alike; an FP
checkpoint is cut as it is read, a quantized run quantizes the whole model
and then keeps its storage slice); only rank 0 decodes and writes.
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
    cache_policy_from_args,
    conditioning,
    decode_video,
    denoise_pipeline,
    free_device_memory,
    load_contexts,
    load_params,
    load_vae,
    parse_attn_window,
    save_outputs,
    setup_logging,
    synced_time,
    t5_plan,
    validate_args,
)
from wanq_tpu_torch.configs import MAX_AREA_CONFIGS, SIZE_CONFIGS, WAN_CONFIGS
from wanq_tpu_torch.models.dit import CLIP_TOKENS
from wanq_tpu_torch.parallel.launch import is_main_rank
from wanq_tpu_torch.parallel.sharding import shard_params
from wanq_tpu_torch.pipelines.image2video import WanI2V, i2v_latent_size
from wanq_tpu_torch.pipelines.text2video import WanT2V
from wanq_tpu_torch.quant.ptq import shard_quant_state
from wanq_tpu_torch.quant.qlinear import QuantCtx


def parse_args(argv=None):
    p = argparse.ArgumentParser("wanq_tpu_torch generate")
    add_common_args(p)
    p.add_argument("--image", type=str, default=None, help="input image (i2v)")
    p.add_argument("--quant_config", type=str, default=None)
    p.add_argument("--quant_params", type=str, default=None,
                   help="quant-state npz from the ptq stage (either package's), or a "
                        "reference quant_params.pth; needed with --quant_config")
    p.add_argument("--hardware", action="store_true",
                   help="int kernel path; default is simulated quantization")
    p.add_argument("--prompt_file", type=str, default=None,
                   help="serving loop: one prompt per line, every video from one process "
                        "(t2v/t2i). The prompts are T5-encoded up front by one encoder, "
                        "freed before the denoise; without --ckpt_dir or "
                        "--context_file each line gets seeded random states")
    return p.parse_args(argv)


def _load_image(path: str) -> np.ndarray:
    """An image file -> float32 [3, H, W] in [-1, 1] (gray is repeated to
    three channels, an alpha channel dropped)."""
    import imageio

    img = np.asarray(imageio.imread(path), dtype=np.float32) / 127.5 - 1.0
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return np.ascontiguousarray(img[..., :3].transpose(2, 0, 1))


def _quant_config(args):
    from wanq_tpu_torch.quant import QuantConfig

    return QuantConfig.from_yaml(args.quant_config) if args.quant_config else None


def _maybe_quant_ctx(args, cfg, params, qcfg):
    """The QuantCtx of --quant_config / --quant_params (sim, or int8 with
    --hardware); an fp-mode ctx that only carries --attn_window; or None."""
    win = parse_attn_window(args)
    if qcfg is None:
        return QuantCtx(mode="fp", attn_window=win) if win is not None else None
    if not args.quant_params:
        raise SystemExit("--quant_config needs --quant_params (run ptq)")
    from wanq_tpu_torch.cli.quant_generate import quantize_or_load

    mode = "int8" if args.hardware else "sim"
    policies, state, rotations = quantize_or_load(args, params, cfg, qcfg, mode)
    return QuantCtx(mode=mode, policies=policies, state=state, rotations=rotations,
                    attn=qcfg.attn_cfg, cross_attn=qcfg.cross_attn_cfg, attn_window=win)


def _prompt_contexts(args, cfg, prompts, plan=None):
    """[n, text_len, text_dim] states for the prompts: the first n rows of
    --context_file, else the checkpoint's T5 (one encoder for all), else seeded
    random."""
    n = len(prompts)
    if args.context_file:
        data = np.load(args.context_file)
        ctx, ctx_null = data["context"], data["context_null"]
        if ctx.shape[0] < n:
            raise SystemExit(f"--context_file has {ctx.shape[0]} rows < {n} prompts")
        return ctx, ctx_null
    if args.ckpt_dir:
        from wanq_tpu_torch.models.t5 import encode_prompts

        return encode_prompts(args.ckpt_dir, cfg, prompts, [args.neg_prompt] * n,
                              on_cpu=args.t5_cpu, device=args.device, **t5_plan(args, plan))
    rng = np.random.default_rng(args.base_seed)
    shape = (n, cfg.text_len, cfg.text_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _serving_loop(args, cfg, pipe, common, vae, on_step, plan=None):
    """One npz (and video file) per line of --prompt_file, from one process."""
    with open(args.prompt_file) as f:
        prompts = [ln.strip() for ln in f if ln.strip()]
    if not prompts:
        raise SystemExit(f"no prompts in {args.prompt_file}")
    ctx_all, ctxn_all = _prompt_contexts(args, cfg, prompts, plan)
    base = args.save_file or f"gen_{args.task}_{args.size.replace('*', 'x')}.npz"
    saved = []
    for i, prompt in enumerate(prompts):
        t0 = time.time()
        latents = pipe.generate(
            torch.from_numpy(ctx_all[i:i + 1]), torch.from_numpy(ctxn_all[i:i + 1]),
            size=SIZE_CONFIGS[args.size], on_step=on_step, **common)
        if not is_main_rank():
            continue
        out = {"latents": latents.cpu().numpy(), "prompt": np.asarray(prompt)}
        if vae is not None:
            out["video"] = decode_video(vae, latents, args.device)
        saved.append(save_outputs(base.replace(".npz", f"_p{i}.npz"), out, cfg.sample_fps))
        logging.info("prompt %d/%d in %.1fs -> %s", i + 1, len(prompts), time.time() - t0,
                     saved[-1])
    return saved


def _i2v_latents(args, cfg, params, qctx, image, context, context_null, common, on_step,
                 plan):
    """(latents, the VAE) of an i2v run: CLIP and the VAE from --ckpt_dir, or
    seeded random conditioning without it (the VAE then None)."""
    img = torch.as_tensor(image if image is not None else _load_image(args.image),
                          dtype=torch.float32)
    vae = clip = None
    kw = {}
    if args.ckpt_dir:
        from wanq_tpu_torch.models.clip import CLIPModel

        t0 = synced_time(args.device)
        vae = load_vae(args, cfg)
        clip = CLIPModel(checkpoint_path=os.path.join(args.ckpt_dir, cfg.clip_checkpoint),
                         device=args.device)
        logging.info("VAE and CLIP in %.2fs", synced_time(args.device) - t0)
    else:
        lat_h, lat_w = i2v_latent_size(cfg, tuple(img.shape[1:]), MAX_AREA_CONFIGS[args.size])
        lat_f = (args.frame_num - 1) // cfg.vae_stride[0] + 1
        rng = np.random.default_rng(args.base_seed)
        kw["clip_fea"] = torch.from_numpy(
            rng.normal(size=(1, CLIP_TOKENS, cfg.clip_dim)).astype(np.float32))
        kw["y"] = torch.from_numpy(rng.normal(
            size=(cfg.in_dim - cfg.z_dim, lat_f, lat_h, lat_w)).astype(np.float32))
    pipe = WanI2V(cfg, params, quant_ctx=qctx, device=args.device, vae=vae, clip=clip,
                  shardings=plan)
    latents = pipe.generate(img, torch.from_numpy(context), torch.from_numpy(context_null),
                            max_area=MAX_AREA_CONFIGS[args.size], on_step=on_step, **common,
                            **kw)
    return latents, vae


def _ti2v_latents(args, cfg, params, qctx, context, context_null, common, on_step):
    """The latents of a ti2v run: image-to-video on a seeded N(0, 1)
    conditioning latent [z_dim, 1, h, w] in place of the Wan2.2 VAE's."""
    size = SIZE_CONFIGS[args.size]
    pipe = denoise_pipeline(args, cfg, params, qctx)
    return pipe.generate(torch.from_numpy(context), torch.from_numpy(context_null), size=size,
                         on_step=on_step, **conditioning(cfg, size, args.base_seed), **common)


def generate(args, on_step=None, image=None):
    """Returns the npz path (a list of them with --prompt_file).
    ``on_step(i, t, latents)`` runs after each solver step. ``image``: an
    i2v task's [3, H, W] image in [-1, 1] (an array or tensor) in place of
    reading --image. None on a rank other than 0, which writes nothing."""
    validate_args(args)
    plan = build_mesh_and_plan(args)
    setup_logging()
    cfg = WAN_CONFIGS[args.task]
    i2v = cfg.model_type == "i2v"
    ti2v = cfg.model_type == "ti2v"
    if ti2v and (args.image or image is not None):
        raise SystemExit(f"--task {args.task} --image needs the Wan2.2 VAE (48 channels, 16x "
                         "spatial) to encode the image, which this repository does not have yet; "
                         "without --image the conditioning latent is a seeded random draw")
    if ti2v and (plan is not None or args.prompt_file):
        raise SystemExit(f"--task {args.task} runs on one card, one prompt a process: its "
                         "per-frame timesteps have no sharded (sp / ring / dp / fsdp) path and "
                         "the serving loop is for t2v / t2i")
    if args.task.startswith("t2i"):
        args.frame_num = 1
    if i2v and args.prompt_file:
        raise SystemExit("--prompt_file serves t2v / t2i (i2v needs an --image per prompt; "
                         "run one process per pair)")
    if i2v and image is None and not args.image:
        raise SystemExit(f"--task {args.task} needs --image")
    # the YAML is read once: its quant state and its cache: section (the
    # step-cache fallback) serve every prompt
    qcfg = _quant_config(args)
    t0 = synced_time(args.device)
    # an FP run cuts the checkpoint as it is read; a quantized one takes the
    # whole weights into its quant state first
    params = load_params(args, cfg, plan if qcfg is None else None)
    logging.info("params (%s) in %.2fs", "random" if args.random_init else args.ckpt_dir,
                 synced_time(args.device) - t0)
    context = context_null = None
    if not args.prompt_file:  # the serving loop encodes its own batch
        t0 = synced_time(args.device)
        context, context_null = load_contexts(args, cfg, plan)
        logging.info("text states in %.2fs", synced_time(args.device) - t0)
    qctx = _maybe_quant_ctx(args, cfg, params, qcfg)
    if plan is not None and qcfg is not None:
        params = shard_params(params, plan)
        qctx.state = shard_quant_state(qctx.state, plan)
    common = dict(frame_num=args.frame_num, shift=args.sample_shift,
                  sample_solver=args.sample_solver, sampling_steps=args.sample_steps,
                  guide_scale=args.sample_guide_scale, seed=args.base_seed,
                  cfg_mode=args.cfg_mode, cache_policy=cache_policy_from_args(args, qcfg))
    if i2v:
        # the pipeline (and CLIP) are freed on return, so the decode below
        # gets their memory
        t0 = synced_time(args.device)
        latents, vae = _i2v_latents(args, cfg, params, qctx, image, context, context_null,
                                    common, on_step, plan)
        pipe = None
    elif ti2v:
        t0 = synced_time(args.device)
        latents = _ti2v_latents(args, cfg, params, qctx, context, context_null, common, on_step)
        pipe = vae = None
    else:
        pipe = WanT2V(cfg, params, quant_ctx=qctx, device=args.device, shardings=plan)
        vae = load_vae(args, cfg) if args.ckpt_dir and is_main_rank() else None
        if args.prompt_file:
            return _serving_loop(args, cfg, pipe, common, vae, on_step, plan)
        t0 = synced_time(args.device)
        latents = pipe.generate(torch.from_numpy(context), torch.from_numpy(context_null),
                                size=SIZE_CONFIGS[args.size], on_step=on_step, **common)
    logging.info("denoise (%s) done in %.2fs, latents %s", qctx.mode if qctx else "fp",
                 synced_time(args.device) - t0, tuple(latents.shape))
    if not is_main_rank():
        return None
    out = {"latents": latents.cpu().numpy()}
    if vae is not None:
        del pipe, qctx, params  # the decode gets the DiT's memory (T2V-14B at 720p)
        free_device_memory(args.device)
        out["video"] = decode_video(vae, latents, args.device)
    save_file = args.save_file or f"gen_{args.task}_{args.size.replace('*', 'x')}.npz"
    return save_outputs(save_file, out, cfg.sample_fps)


if __name__ == "__main__":
    generate(parse_args())
