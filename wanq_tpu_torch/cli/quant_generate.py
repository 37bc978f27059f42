"""Quantized inference CLI (counterpart of wanq_tpu/cli/quant_generate.py):
simulated quantization (fake-quant, the default) or the int kernel path
(--hardware) for W8A8, W4A8 and W4A4 configs. A quant YAML's ``attn:``
section switches self-attention to the int8 flash kernel under --hardware
and to the simulated attention quantizers without it; a ``cross_attn:``
section runs the simulated quantizers on cross-attention in both modes.
``--attn_window R`` (or one radius per head, ``r0,r1,...``) bands
self-attention to +-R latent frames: K4's band mode on the card. A quant
YAML's ``cache:`` section (the 14B YAMLs ship the adaptive step cache
fitted at 14B) or the cache flags cache steps (``--cache_threshold 0``
turns the section off); the action counts are logged and, with the adaptive
trace, saved beside the latents (``cache_stats``, ``cache_trace``: JSON).
``--cfg_mode sequential`` runs the CFG pair as two forwards, as T2V-14B at
720p needs on one card:

    python -m wanq_tpu_torch.cli.quant_generate --task t2v-14B --size 1280*720 \
        --random_init --quant_config quant_configs/wan_w4a8_14b.yaml \
        --calib_data calib_14b.npz --hardware --strip_fp --cfg_mode sequential

    python -m wanq_tpu_torch.cli.quant_generate --task t2v-1.3B --size 832*480 \
        --frame_num 81 --random_init --quant_config quant_configs/wan_w8a8_speed.yaml \
        --calib_data quant_data/calib_data.npz --hardware --sample_steps 3

--calib_data is needed only for static activations (the W8A8 speed
config's ffn.2) and for SmoothQuant masks; wan_w4a8_mixed.yaml and
wan_w4a4.yaml run without it. ``--quant_params`` deploys a saved artifact
instead of quantizing on the fly: the npz of ``cli.ptq`` (or of wanq_tpu's
ptq; the rotations are rebuilt from its seed), or a reference
``quant_params.pth``:

    python -m wanq_tpu_torch.cli.quant_generate --task t2v-1.3B --random_init \
        --quant_config quant_configs/config.yaml --quant_params quant_params.npz \
        --hardware --strip_fp

Under torchrun the mesh flags shard the run (every rank quantizes the whole
model from the same seed, then keeps its storage slice of the weights and of
the quant state; only rank 0 writes the latents):

    torchrun --nproc_per_node 8 -m wanq_tpu_torch.cli.quant_generate \
        --task t2v-14B --random_init --quant_config quant_configs/wan_w4a8_14b.yaml \
        --calib_data calib_14b.npz --hardware --ulysses_size 8 --dit_fsdp

``--auto_bits_gib GIB`` plans the weight bitwidths instead (``quant/planner.py``):
each block-linear class at W4 or W8, greedy under GIB of weight state, the
plan's config dict deployed as a quant config. Only the ``act`` section of
``--quant_config`` is read then (default: 8-bit symmetric, static ffn.2); the
rest of that YAML, its ``cache:`` section too, is dropped:

    python -m wanq_tpu_torch.cli.quant_generate --task t2v-14B --random_init \
        --auto_bits_gib 9.5 --quant_config quant_configs/wan_w4a8_14b.yaml \
        --calib_data calib_14b.npz --hardware --strip_fp

``--lora`` deploys QLoRA adapters (the npz of ``training/lora.py::save_lora``,
either package's, or a ``lora-checkpoint-N`` dir): they are merged into the
quant state before the denoise loop, and the adapted sites take ``qlinear``'s
int routes with the adapter added (the fused producers refuse them).
"""

from __future__ import annotations

import argparse
import json
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
    denoise_pipeline,
    load_contexts,
    load_params,
    parse_attn_window,
    require_t2v,
    setup_logging,
    validate_args,
)
from wanq_tpu_torch.configs import SIZE_CONFIGS, WAN_CONFIGS
from wanq_tpu_torch.models.dit import linear_layer_names
from wanq_tpu_torch.parallel.launch import is_main_rank
from wanq_tpu_torch.parallel.sharding import shard_params
from wanq_tpu_torch.quant import QuantConfig
from wanq_tpu_torch.quant.ptq import (
    load_quant_state,
    load_reference_quant_params,
    prepare_quant_state,
    rebuild_rotations,
    shard_quant_state,
    state_from_reference_params,
    strip_quantized_weights,
)
from wanq_tpu_torch.quant.qlinear import QuantCtx
from wanq_tpu_torch.training.lora import load_lora, merge_lora_into_quant_state


def parse_args(argv=None):
    p = argparse.ArgumentParser("wanq_tpu_torch quant_generate")
    add_common_args(p)
    p.add_argument("--quant_config", type=str, default=None)
    p.add_argument("--auto_bits_gib", type=float, default=None,
                   help="capacity-aware mixed W4/W8: plan the bitwidths under this "
                        "weight-state budget in GiB (quant/planner.py) instead of "
                        "--quant_config's weight section; only its act section is read")
    p.add_argument("--calib_data", type=str, default=None,
                   help="get_calib_data npz (needed for static activations and "
                        "SmoothQuant masks when quantizing on the fly)")
    p.add_argument("--quant_params", type=str, default=None,
                   help="quant-state npz from the ptq stage (either package's), or a "
                        "reference quant_params.pth; quantized on the fly if omitted")
    p.add_argument("--hardware", action="store_true",
                   help="int kernel path; default is simulated quantization")
    p.add_argument("--strip_fp", action="store_true",
                   help="free the FP copies of the quantized weights (the sim and int "
                        "paths read the quant state only); logs the device memory held "
                        "before and after")
    p.add_argument("--lora", type=str, default=None,
                   help="QLoRA adapters (a save_lora npz or a lora-checkpoint-N dir) merged "
                        "into the quant state")
    return p.parse_args(argv)


# the activation section of a capacity plan when --quant_config gives none
PLAN_ACT = {"n_bits": 8, "sym": True, "static_regex": r"ffn\.2"}


def quant_config_from_args(args, cfg) -> QuantConfig:
    """The run's QuantConfig: ``--auto_bits_gib``'s capacity plan (its report
    logged; the act section from ``--quant_config`` or ``PLAN_ACT``), else
    ``--quant_config``. Neither flag is an error."""
    if args.auto_bits_gib is not None:
        from wanq_tpu_torch.quant.planner import plan_capacity_bits

        base = QuantConfig.from_yaml(args.quant_config).raw if args.quant_config else {}
        plan = plan_capacity_bits(cfg, int(args.auto_bits_gib * 2**30),
                                  act=base.get("act") or PLAN_ACT)
        logging.info("%s", plan.report())
        return QuantConfig.from_dict(plan.config)
    if args.quant_config:
        return QuantConfig.from_yaml(args.quant_config)
    raise SystemExit("need --quant_config or --auto_bits_gib")


def quantize_or_load(args, params, cfg, qcfg, mode: str):
    """(policies, state, rotations) of ``mode`` ('sim' or 'int8'): from
    ``--quant_params`` (the npz of either package's ptq, the rotations rebuilt
    from its seed; or a reference ``quant_params.pth``, whose rotated layers
    raise: it holds no matrices), else quantized on the fly from
    ``--calib_data``."""
    names = linear_layer_names(cfg)
    t0 = time.time()
    if args.quant_params and args.quant_params.endswith(".pth"):
        policies = qcfg.resolve_all(names)
        state = state_from_reference_params(
            params, policies, load_reference_quant_params(args.quant_params), targets=mode)
        rotations = {}
        logging.info("deployed from reference artifact %s: %d layers", args.quant_params,
                     len(state))
    elif args.quant_params:
        policies = qcfg.resolve_all(names)
        state, seed = load_quant_state(args.quant_params, device=args.device, targets=mode)
        rotations = rebuild_rotations(state, policies, seed)
        logging.info("loaded quant state %s: %d layers (seed %d) in %.2fs", args.quant_params,
                     len(state), seed, time.time() - t0)
    else:
        calib = dict(np.load(args.calib_data)) if args.calib_data else None
        policies, state, rotations = prepare_quant_state(params, names, qcfg, calib=calib,
                                                         targets=mode)
        logging.info("computed quant state: %d layers in %.2fs", len(state), time.time() - t0)
    return policies, state, rotations


def generate(args, on_step=None):
    """Quantize the weights (or load a saved quant state), run the
    simulated or int denoise loop and save the latents; returns the npz
    path (None on a rank other than 0, which writes nothing).
    ``on_step(i, t, latents)`` runs after each solver step."""
    validate_args(args)
    require_t2v(args, "quant_generate")
    plan = build_mesh_and_plan(args)
    setup_logging()
    mode = "int8" if args.hardware else "sim"
    cfg = WAN_CONFIGS[args.task]
    size = SIZE_CONFIGS[args.size]
    qcfg = quant_config_from_args(args, cfg)
    cache_policy = cache_policy_from_args(args, qcfg)
    logging.info("step cache: %s", cache_policy or "off")
    params = load_params(args, cfg)
    policies, state, rotations = quantize_or_load(args, params, cfg, qcfg, mode)
    if args.strip_fp:
        held = _held_gib(args.device)
        params = strip_quantized_weights(params, policies)
        logging.info("stripped the FP copies of the quantized weights; device memory held "
                     "%s -> %s GiB (peak so far %s GiB)", held, _held_gib(args.device),
                     _held_gib(args.device, peak=True))
    if args.lora:
        path = args.lora
        if os.path.isdir(path):
            path = os.path.join(path, "lora_weights.npz")
        state = merge_lora_into_quant_state(state, load_lora(path, device=args.device))
        logging.info("merged QLoRA adapters from %s", args.lora)
    if plan is not None:
        # quantized from the whole weights, then this rank's storage of both
        params, state = shard_params(params, plan), shard_quant_state(state, plan)
    ctx = QuantCtx(mode=mode, policies=policies, state=state, rotations=rotations,
                   attn=qcfg.attn_cfg, cross_attn=qcfg.cross_attn_cfg,
                   attn_window=parse_attn_window(args))

    context, context_null = load_contexts(args, cfg, plan)
    pipe = denoise_pipeline(args, cfg, params, ctx, plan)
    t0 = time.time()
    latents = pipe.generate(
        torch.from_numpy(context), torch.from_numpy(context_null), size=size,
        frame_num=args.frame_num, shift=args.sample_shift, sample_solver=args.sample_solver,
        sampling_steps=args.sample_steps, guide_scale=args.sample_guide_scale,
        seed=args.base_seed, cache_policy=cache_policy, cfg_mode=args.cfg_mode,
        on_step=on_step, **conditioning(cfg, size, args.base_seed),
    )
    if latents.is_cuda:
        torch.cuda.synchronize()
    logging.info("quant (%s) denoise done in %.2fs (%s CFG; peak device memory %s GiB)", mode,
                 time.time() - t0, args.cfg_mode, _held_gib(args.device, peak=True))
    if not is_main_rank():
        return None
    record = {}
    if pipe.last_cache_stats is not None:
        logging.info("step cache actions: %s", pipe.last_cache_stats)
        record["cache_stats"] = json.dumps(pipe.last_cache_stats)
    if pipe.last_adaptive_trace is not None:
        logging.info("adaptive trace: %s", pipe.last_adaptive_trace)
        record["cache_trace"] = json.dumps(pipe.last_adaptive_trace)
    save_file = args.save_file or (
        f"quant_{mode}_{args.task}_{args.size.replace('*', 'x')}_seed{args.base_seed}.npz")
    np.savez(save_file, latents=latents.cpu().numpy(), **record)
    logging.info("saved %s", save_file)
    return save_file


def _held_gib(device, peak: bool = False) -> str:
    """Device memory allocated now (or its peak), in GiB; 'n/a' off the card."""
    if torch.device(device).type != "cuda":
        return "n/a"
    n = torch.cuda.max_memory_allocated() if peak else torch.cuda.memory_allocated()
    return f"{n / 2**30:.2f}"


if __name__ == "__main__":
    generate(parse_args())
