"""Shared CLI plumbing (counterpart of wanq_tpu/cli/common.py).

The DiT's weights come from a Wan2.1 checkpoint dir (``--ckpt_dir``) or
from a seed (``--random_init``, drawn on the card for a CUDA ``--device``;
with both flags the DiT is random and the VAE and T5 come from the dir).
The text states come from ``--context_file``, else from the dir's umT5
encoder run on ``--prompt`` / ``--neg_prompt``, else from a seed. The
step-cache flags and a quant YAML's ``cache:`` section become a policy
through :func:`cache_policy_from_args`. ``--use_prompt_extend`` rewrites
``--prompt`` before it is encoded (:func:`maybe_extend_prompt`).

Multi-GPU serving: under torchrun the mesh flags (``--ulysses_size``,
``--ring_size``, ``--dp_size``, ``--fsdp_size`` or ``--dit_fsdp``,
``--full_shard``) make a ShardingPlan (:func:`build_mesh_and_plan`) over the
process group, and ``--t5_fsdp`` stores the umT5 encoder over ``fsdp``; only
rank 0 writes files and logs at INFO. ``get_calib_data`` takes them too; PTQ
refuses them (``wanq_tpu``'s ptq has no mesh).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import logging
import os
import sys
import time
from typing import Tuple

import numpy as np
import torch

from wanq_tpu_torch.configs import SAMPLE_NEG_PROMPT, SIZE_CONFIGS, SUPPORTED_SIZES, WAN_CONFIGS

_MULTI_DEVICE_FLAGS = ("ulysses_size", "ring_size", "dp_size", "fsdp_size")
# what an unset cache flag means when no YAML section supplies it
CACHE_DEFAULTS = {"warmup": 4, "tail": 4, "order": 0}
EXAMPLE_PROMPT = (
    "Two anthropomorphic cats in comfy boxing gear and bright gloves fight "
    "intensely on a spotlighted stage."
)


def add_common_args(p: argparse.ArgumentParser, default_steps: int = 50):
    p.add_argument("--task", type=str, default="t2v-1.3B", choices=list(WAN_CONFIGS))
    p.add_argument("--size", type=str, default="832*480", choices=list(SIZE_CONFIGS))
    p.add_argument("--frame_num", type=int, default=81, help="4n+1 frames")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="Wan2.1 checkpoint dir: the DiT's sharded safetensors and their "
                        "index JSON, Wan2.1_VAE.pth, models_t5_umt5-xxl-enc-bf16.pth and "
                        "the google/umt5-xxl tokenizer files")
    p.add_argument("--random_init", action="store_true",
                   help="random DiT weights from --base_seed instead of the checkpoint's "
                        "(the VAE and T5 still come from --ckpt_dir when it is given)")
    p.add_argument("--prompt", type=str, default=EXAMPLE_PROMPT)
    p.add_argument("--neg_prompt", type=str, default=SAMPLE_NEG_PROMPT)
    p.add_argument("--context_file", type=str, default=None,
                   help="npz with precomputed 'context'/'context_null' "
                        "text-encoder states (skips T5)")
    p.add_argument("--base_seed", type=int, default=42)
    p.add_argument("--sample_solver", type=str, default="unipc", choices=["unipc", "dpm++"])
    p.add_argument("--sample_steps", type=int, default=default_steps)
    p.add_argument("--sample_shift", type=float, default=5.0)
    p.add_argument("--sample_guide_scale", type=float, default=5.0)
    p.add_argument("--save_file", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' runs the hand-written kernels, "
                        "'cpu' their plain PyTorch versions (tests, tiny runs)")
    p.add_argument("--ulysses_size", type=int, default=1,
                   help="Ulysses sequence parallelism: heads over this many ranks in "
                        "self-attention, tokens elsewhere")
    p.add_argument("--ring_size", type=int, default=1,
                   help="ring context parallelism: k/v shards rotate over this many ranks")
    p.add_argument("--dp_size", type=int, default=1,
                   help="data parallelism: the CFG pair's rows over this many ranks")
    p.add_argument("--fsdp_size", type=int, default=1,
                   help="FSDP: the DiT's linear weights stored over this many ranks")
    p.add_argument("--dit_fsdp", action="store_true",
                   help="FSDP over the ranks the other mesh sizes leave (world // (ulysses x "
                        "ring x dp)) unless --fsdp_size is given")
    p.add_argument("--full_shard", action="store_true",
                   help="store the DiT's weights over every non-dp mesh axis (the reference's "
                        "--dit_fsdp with --ulysses_size on the same ranks)")
    p.add_argument("--t5_fsdp", action="store_true",
                   help="store the umT5 encoder's weights over the fsdp ranks")
    p.add_argument("--t5_cpu", action="store_true",
                   help="run the T5 encoder on the host CPU (the card's memory stays free "
                        "for the DiT)")
    p.add_argument("--offload_model", type=str, default=None,
                   help="accepted for the reference CLI's sake and ignored: T5 is freed "
                        "before the denoise, the DiT stays on the card")
    p.add_argument("--vae_dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="VAE compute dtype (the reference's WanVAE(dtype=...)): bfloat16 "
                        "halves the weights' and activations' bytes; the video stays float32")
    p.add_argument("--use_prompt_extend", action="store_true",
                   help="rewrite --prompt by an LM before it is encoded (utils/prompt_extend.py; "
                        "a failed extension keeps the prompt, with a warning)")
    p.add_argument("--prompt_extend_method", type=str, default="local_qwen",
                   choices=["dashscope", "local_qwen"])
    p.add_argument("--prompt_extend_model", type=str, default=None)
    p.add_argument("--prompt_extend_target_lang", type=str, default="en", choices=["en", "zh"])
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


def maybe_extend_prompt(args, logger=None) -> str:
    """Under --use_prompt_extend, replace args.prompt by the expander's
    rewrite (--prompt_extend_method: the DashScope API, or a local LM on
    --device) and return it. A failed extension keeps the original prompt
    and logs a warning, as the reference does."""
    if not getattr(args, "use_prompt_extend", False):
        return args.prompt
    from wanq_tpu_torch.utils import prompt_extend as pe

    if args.prompt_extend_method == "dashscope":
        expander = pe.DashScopePromptExpander(model_name=args.prompt_extend_model or "qwen-plus")
    else:
        expander = pe.LocalPromptExpander(
            model_name=args.prompt_extend_model or "Qwen/Qwen2.5-3B-Instruct",
            device=args.device)
    out = expander(args.prompt, tar_lang=args.prompt_extend_target_lang, seed=args.base_seed)
    if out.status and out.prompt:
        if logger is not None:
            logger.info("extended prompt: %s", out.prompt)
        args.prompt = out.prompt
    elif logger is not None:
        logger.warning("prompt extension failed: %s; using the original", out.message)
    return args.prompt


def validate_args(args, mesh: bool = True):
    """``mesh``: whether the CLI runs under a mesh; one that does not (PTQ, as
    ``wanq_tpu``'s) refuses the mesh flags."""
    if args.frame_num % 4 != 1:
        raise SystemExit("frame_num must be 4n+1")
    if args.size not in SUPPORTED_SIZES[args.task]:
        raise SystemExit(f"size {args.size} unsupported for {args.task}: "
                         f"{SUPPORTED_SIZES[args.task]}")
    if any(getattr(args, f) < 1 for f in _MULTI_DEVICE_FLAGS):
        raise SystemExit("the mesh sizes must be >= 1")
    if not mesh and (any(getattr(args, f) != 1 for f in _MULTI_DEVICE_FLAGS)
                     or args.dit_fsdp or args.t5_fsdp or args.full_shard):
        raise SystemExit(
            "cli.ptq runs in one process, as wanq_tpu's ptq (it has no mesh): drop the mesh "
            "flags (--ulysses_size, --ring_size, --dp_size, --fsdp_size, --dit_fsdp, "
            "--t5_fsdp, --full_shard)")
    if args.ckpt_dir is None and not args.random_init and args.context_file is None:
        raise SystemExit("need --ckpt_dir, or --random_init (+ optional --context_file) "
                         "for checkpoint-free runs")
    check_device(args.device)


def check_device(device: str) -> None:
    """A CUDA ``device`` without a card raises (nothing falls back to the
    CPU); with one, f32 matmuls and convolutions stay full f32 (TF32 off),
    as in the JAX reference."""
    if device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda but torch sees no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def require_t2v(args, cli: str) -> None:
    """fp_generate, quant_generate and get_calib_data drive the text-to-video
    pipeline (ti2v's image-to-video through :func:`denoise_pipeline`), as
    wanq_tpu's do: an i2v task runs through cli.generate."""
    if WAN_CONFIGS[args.task].model_type == "i2v":
        raise SystemExit(f"{cli} serves t2v / t2i tasks; run {args.task} through "
                         "cli.generate --image")


def denoise_pipeline(args, cfg, params, quant_ctx, plan=None):
    """The pipeline fp_generate, quant_generate and get_calib_data drive:
    WanT2V, or for a ti2v task WanTI2V, which runs image-to-video when given
    :func:`conditioning`'s latent (one card: a sharding plan refuses)."""
    if cfg.model_type == "ti2v":
        if plan is not None:
            raise SystemExit(f"--task {args.task} runs on one card: its per-frame timesteps "
                             "have no sharded (sp / ring / dp / fsdp) path")
        from wanq_tpu_torch.pipelines.textimage2video import WanTI2V

        return WanTI2V(cfg, params, quant_ctx=quant_ctx, device=args.device)
    from wanq_tpu_torch.pipelines.text2video import WanT2V

    return WanT2V(cfg, params, quant_ctx=quant_ctx, device=args.device, shardings=plan)


def conditioning(cfg, size, seed: int) -> dict:
    """``generate``'s conditioning keywords: for a ti2v task the image's
    latent [z_dim, 1, h, w] as a seeded N(0, 1) draw, in place of the Wan2.2
    VAE's encoding (that VAE is not in the repository); none for the other
    tasks."""
    if cfg.model_type != "ti2v":
        return {}
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(cfg.z_dim, 1, size[1] // cfg.vae_stride[1], size[0] // cfg.vae_stride[2]))
    return {"cond_latent": torch.from_numpy(z.astype(np.float32))}


def setup_logging():
    """INFO on rank 0 (and without a process group), warnings only elsewhere."""
    from wanq_tpu_torch.parallel.launch import is_main_rank

    logging.basicConfig(
        level=logging.INFO if is_main_rank() else logging.WARNING,
        format="[%(asctime)s] %(levelname)s: %(message)s",
        handlers=[logging.StreamHandler(stream=sys.stdout)],
        force=True,
    )


def load_contexts(args, cfg, plan=None) -> Tuple[np.ndarray, np.ndarray]:
    """Text-encoder states: from --context_file, else the checkpoint's T5 on
    --prompt (extended first under --use_prompt_extend) / --neg_prompt (on
    the host with --t5_cpu; stored over the plan's fsdp ranks with
    --t5_fsdp), else random from --base_seed (the same draw as wanq_tpu's
    load_contexts)."""
    if args.context_file:
        data = np.load(args.context_file)
        return data["context"], data["context_null"]
    if getattr(args, "use_prompt_extend", False):
        maybe_extend_prompt(args, logging.getLogger())
    if getattr(args, "ckpt_dir", None):
        from wanq_tpu_torch.models.t5 import encode_prompts

        return encode_prompts(args.ckpt_dir, cfg, [args.prompt], [args.neg_prompt],
                              on_cpu=args.t5_cpu, device=args.device, **t5_plan(args, plan))
    rng = np.random.default_rng(args.base_seed)
    shape = (1, cfg.text_len, cfg.text_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def t5_plan(args, plan):
    """{"plan": plan} where the umT5 encoder is stored over the mesh
    (--t5_fsdp on a mesh, the encoder on the card), else {}."""
    if plan is None or not args.t5_fsdp:
        return {}
    if args.t5_cpu:
        logging.warning("--t5_cpu keeps the whole encoder on the host: --t5_fsdp ignored")
        return {}
    return {"plan": plan}


def build_mesh_and_plan(args):
    """The ShardingPlan of the mesh flags over the process group that
    :func:`init_distributed` joins (torchrun's environment), or None on one
    process without mesh flags. The world must equal dp x fsdp x
    ulysses x ring; --dit_fsdp without --fsdp_size takes fsdp = world //
    (ulysses x ring x dp), as ``wanq_tpu`` does over its devices."""
    from wanq_tpu_torch.parallel import ShardingPlan, init_distributed, make_mesh

    world = init_distributed(args.device)
    sp, ring, dp = args.ulysses_size, args.ring_size, args.dp_size
    fsdp = args.fsdp_size if args.fsdp_size > 1 else (
        max(1, world // (sp * ring * dp)) if args.dit_fsdp else 1)
    if dp * fsdp * sp * ring != world:
        raise SystemExit(f"the mesh dp {dp} x fsdp {fsdp} x ulysses {sp} x ring {ring} does "
                         f"not fill the world of {world} processes")
    if world == 1:
        return None
    mesh = make_mesh(dp, fsdp, sp, ring)
    logging.info("mesh: %s over %d ranks%s", mesh.shape, world,
                 " (weights stored over every non-dp axis)" if args.full_shard else "")
    return ShardingPlan(mesh, full_shard=args.full_shard)


def load_params(args, cfg, plan=None):
    """The DiT's weights on ``args.device``: the checkpoint's with
    --ckpt_dir and no --random_init, else drawn on the card by
    ``init_params_on_device`` for a CUDA device (no host copy: T2V-14B is
    28.6 GB), by the host numpy draw of ``init_params`` otherwise (the same
    weights as wanq_tpu's from the same seed). init_params zero-inits
    head.head (the reference's from-scratch semantics), which would make
    the output identically zero, so it is redrawn: normal * 0.02 from seed
    base_seed + 1, by a torch.Generator on the card or numpy on the host
    (wanq_tpu draws it with jax.random, so that one tensor differs between
    the packages). ``plan``: this rank's storage of them under the plan (the
    checkpoint's tensors cut as they are read)."""
    if getattr(args, "ckpt_dir", None) and not args.random_init:
        from wanq_tpu_torch.models.params import load_wan_checkpoint

        return load_wan_checkpoint(args.ckpt_dir, dtype=cfg.dtype, device=args.device,
                                   plan=plan)
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
    if plan is not None:
        from wanq_tpu_torch.parallel.sharding import shard_params

        params = shard_params(params, plan)
    return params


def synced_time(device) -> float:
    """time.time() after the device's queued work has finished."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.time()


def free_device_memory(device) -> None:
    """Return the cached blocks of freed tensors to the card."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def load_vae(args, cfg):
    """The VAE of --ckpt_dir in --vae_dtype on --device; None, with a
    warning, when the dir holds no VAE file (the latents are saved alone)."""
    from wanq_tpu_torch.models.vae import WanVAE

    try:
        return WanVAE(vae_pth=os.path.join(args.ckpt_dir, cfg.vae_checkpoint),
                      compute_dtype=getattr(torch, args.vae_dtype), device=args.device)
    except FileNotFoundError as e:
        logging.warning("VAE decode skipped: %s", e)
        return None


def decode_video(vae, latents, device) -> np.ndarray:
    """VAE-decode latents to a float32 [B, 3, T, H, W] video in [-1, 1]."""
    t0 = synced_time(device)
    video = vae.decode(latents).cpu().numpy()
    logging.info("VAE decode (%s) done in %.2fs, video %s", vae.compute_dtype,
                 time.time() - t0, video.shape)
    return video


def save_outputs(save_file: str, out, fps: int) -> str:
    """np.savez(save_file, **out), then, where ``out`` holds a 'video', the
    video file beside it (an mp4, or a GIF where imageio has no mp4
    backend). Without imageio no video file is written and the log says
    so; the npz holds the frames either way (wanq_tpu's generate stops
    there instead)."""
    from wanq_tpu_torch.utils.video import cache_video

    if not save_file.endswith(".npz"):
        save_file += ".npz"  # np.savez appends it anyway; log the real path
    np.savez(save_file, **out)
    logging.info("saved %s", save_file)
    if "video" in out:
        try:
            written = cache_video(out["video"], save_file[:-len(".npz")] + ".mp4", fps=fps)
        except ImportError as e:
            logging.warning("no video file written: %s", e)
        else:
            logging.info("wrote %s", written)
    return save_file
