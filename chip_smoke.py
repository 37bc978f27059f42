#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (wanq_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its numbers on its own lines; any failure exits
non-zero:

0. environment: card name and power limit (nvidia-smi), torch / CUDA / nvcc
   versions, whether PyYAML imports;
1. build: nvcc compiles wanq_tpu_torch/csrc/*.cu for sm_90a (one process
   per source, in parallel) into wanq_tpu_torch/_build/; cuobjdump then
   counts the wgmma (HGMMA, IGMMA) and TMA (UTMALDG, UTMASTG) instructions
   of the attention kernels (K4, K10, and K11 and K12 of the backward) and
   the three wgmma int GEMMs (K2, K8, K9) in the library, which must hold no
   mma.sync product (IMMA, HMMA), and the build log gives every kernel's
   registers and spills (no spill allowed in the wgmma kernels, K1, K3, K7,
   K10a's two and K13); the SASS instruction counts and TMA copy counts (UBLKCP,
   UTMALDG) of K3's, K7's and K10a's kernels are printed (K10a must have
   tensor-map loads);
2. each kernel against its plain PyTorch version on the card at the main
   paths' shapes (T2V-1.3B, 832x480x81, batched CFG: B=2, seq 32768 with
   32760 valid tokens, M = 65536 token rows), with the warm median of
   CUDA-event timings of both, ragged-M tails for the int GEMMs, the GELU +
   quant mode of K2 and K8 against its plain chain, and each kernel's bound: the larger
   of its bytes (inputs read once, outputs written once) over 3.35 TB/s and
   its operations over the card's peak for their type. Where one PyTorch call computes the same function it is
   timed beside the kernel (scaled_dot_product_attention for K4); the port
   never calls it. torch._int_mm is timed as a note beside the int GEMMs,
   whose fused epilogues no single call computes. K4's band mode (the
   temporal window) is held against the plain version with the band mask at
   radii 0, 1, 2 and one per-head vector, with planted pad and out-of-band
   k/v, and timed at radii 0, 1, 2, 4, 8 beside its bound, its visited-tile
   fraction and scaled_dot_product_attention with the band as a boolean mask;
   a band that covers every frame is timed next to the dense launch (12
   rounds of dense, band, band, dense: the median round's ratio within 5%).
   The T2V-14B shapes (dim 5120, ffn 13824, 40 heads) too: K1 at C = 5120, K2
   and K8 at 5120 -> 5120 and 5120 -> 13824 (bf16 out, and the GELU + quant
   mode) and 13824 -> 5120 (f32 out) with a ragged M, K3 at C = 5120 (rope,
   and the cross-q split), K7 on the 5120-wide o input and the 13824-wide
   GELU input, K4 with 40 heads: dense self-attention at 480p (S 32768) and
   720p (S 75776, 75600 valid; its plain version timed in one call) and
   cross-attention at 480p (B 2) and 720p (B 1, as sequential CFG runs it),
   and K10a at 720p's [2, 40, 75776, 128]. The 14B shapes this script added
   with T2V-14B (all but K3's rope, K7's GELU and K10a) are printed, not
   summed into the kernels line, so its totals keep the shapes of earlier
   runs; and K7's GELU table on all 65536 bf16 inputs bit for bit
   against the kernels' gelu_tanh. Beside K3, K7 and K10a a plain clone of
   the same bytes gives the card's practical memory rate, and beside K10a the
   bytes it really moves (v read twice) are printed next to its bound's. At
   the viditq path's shape: K7 on f32 rows without GELU, with and without a
   channel_scale (codes and scales equal), K1 with a channel_scale (these
   three printed, not summed into the kernels line, whose K7 and K1 totals
   keep the shapes of earlier runs), the f32
   rotation product x @ Q (torch.mm, TF32 off) against its bound, one whole
   viditq site through qlinear, and PTQ's f64 weight rotation on the card
   (equal to the CPU's); K13 (the block's residual update x + (y + bias) *
   gate) at [2, 32768, 1536] and [2, 32768, 5120], every combination of gate
   and bias equal bit for bit to the plain chain, each update the paths run
   timed beside the plain chain and its bound (8 bytes an element), the 1.3B
   self-attention update summed into the kernels line; K1 and K13 reading a
   per-frame table (Wan2.2 TI2V-5B's modulation at [2, 27648, 3072], 31 rows
   of 880 tokens, the pads on the last row): K1 at its limits and the one-row
   call at 3072 beside it, K13 equal bit for bit to the plain chain with and
   without a bias, each with its table launch counted and timed against its
   bound (printed, not summed into the kernels line);
3. the paths of PATHS through the CLIs, random weights drawn on the card
   from a seed (init_params_on_device) and random text states. At full 1.3B
   width and depth, 3 UniPC steps each: W8A8 (get_calib_data
   --collect_minmax, 1 step, then quant_generate --hardware under
   wan_w8a8_speed.yaml), mixed W4A8 (wan_w4a8_mixed.yaml), Atom W4A4
   (wan_w4a4.yaml), W8A8 with int8 attention (wan_w8a8_attn.yaml,
   --hardware), simulated W8A8 (wan_w8a8_speed.yaml without --hardware) and
   W4A8 at every linear with a static ffn.2 scale (wan_w4a8_14b.yaml,
   --hardware, the same calibration) and W8A8 with a temporal window of one
   latent frame (w8a8_win1: wan_w8a8_speed.yaml --hardware --attn_window 1,
   the same calibration: self-attention runs K4's band mode) and ViDiT-Q
   (viditq: quant_configs/config.yaml, the same calibration through cli.ptq,
   whose npz artifact quant_generate --quant_params --hardware deploys) and
   GPTQ (w4a8_gptq: wan_w4a8_gptq.yaml after its own calibration,
   get_calib_data --collect_hessian GPTQ_REGEX (self-attention, cross q and
   o, ffn.0) --calib_rounds 3, one step a round: the Hessian sites and bytes printed
   and counted; then cli.ptq, with each GPTQ solve timed by layer shape, and
   quant_generate --quant_params --hardware) and SVDQuant (svdquant:
   wan_svdquant.yaml, the shared calibration, through cli.ptq and
   --quant_params --hardware: masks, rank-32 bf16 branches, K9); two
   checks of the CFG schedules: w8a8 with --cfg_mode sequential (its first
   step against w8a8's batched one: rel-L2 <= 1e-3, equal bits printed) and
   w8a8 over 8 steps under a static step cache (--reuse_interval 2
   --cfg_cache_interval 2 --cache_warmup 2 --cache_tail 2: the actions of
   StepCachePolicy.plan). Then T2V-14B at full width (dim 5120, 40 heads;
   DEPTH_14B = 10 of its 40 blocks, as for I2V-14B) after its own 1-step
   calibration at 480p, each with --strip_fp (the CLI logs the memory held
   before and after): wan_w4a8_14b and wan_w8a8_14b at 832x480x81, 3 steps
   (the YAML's adaptive cache plans all-full steps); wan_w4a8_14b at 480p over
   8 steps, where the YAML's adaptive policy decides (its trace printed, its
   actions equal to simulate_adaptive_actions replayed on the trace's own
   drifts, the time of each step by action); wan_w4a8_14b at 1280x720x81
   (seq 75776) with --cfg_mode sequential, 2 steps; and w4w8_plan_14b:
   quant_generate --auto_bits_gib PLAN_GIB (2.375 GiB at 10 blocks, which plans
   what 9.5 GiB plans at 40: the two plans' W8 classes held equal) with
   wan_w4a8_14b.yaml's act section, 3 steps at 480p: K8 on the six W4
   classes, ffn.0 in its GELU + quant mode feeding ffn.2's K2, K2 on the four
   W8 classes. Then Wan2.2 TI2V-5B (ti2v_w8a8: all 30 blocks at dim 3072,
   1280x704x121, --strip_fp) in image-to-video mode after its own
   calibration in that mode: per-frame timesteps, K1 and K13 reading the
   table (their *_rows counters, ROW_COUNTERS, checked a block, zero on
   every Wan2.1 path), the time MLP on two rows a forward
   (time_embedding_rows), latent frame 0 equal to the seeded conditioning
   latent. Per path: step times, peak
   memory, finite latents of the task's shape, and kernel launch counts, reset
   just before each path and read just after, equal to the per-block counts of
   PATHS x the layers x the forwards its step actions took (a full step one
   batched forward, two under sequential CFG; a cond step one; a reuse step
   none), which shows no plain version ran (the GELU + quant mode of K2 and of
   K8 has a counter of its own: the paths with a static ffn.2 scale launch it
   once a block, so no plain GELU + quant chain runs behind a GEMM);
4. fidelity and profile: one step's noise prediction of each 1.3B path vs bf16
   FP on the same weights, with CFG 5 and conditional alone (W8A8: PSNR
   >= 30 dB with CFG; 4-bit paths and int8 attention: cosine >= 0.9
   conditional, >= 0.5 with CFG; simulated W8A8 vs the W8A8 kernel path:
   >= 30 dB conditional; w8a8_win1 against bf16 with the same window: PSNR
   >= 30 dB with CFG, its distance to dense bf16 printed; viditq from the
   phase-3 artifact: PSNR >= 30 dB with CFG, and sim vs int8 mode from the
   same artifact >= 30 dB conditional, with the PTQ timed on the card;
   w4a8_gptq and svdquant from their artifacts at the 4-bit gates and sim vs
   int8 >= 30 dB conditional, each printed beside its RTN twin, w4a8_static
   and w4a4; and GPTQ's layer gate: at every Hessian site tr(dW^T H dW) of
   the artifact's codes below RTN's on the same grid at >= 95% of them);
   fp_linear on the card against the CPU's f32 product; one CFG forward of
   each under torch.profiler (wall time, device time by kernel, idle share);
   a small config under each YAML, with a cross_attn section, under a
   smooth_quant dict (masks at every block linear: K1 and K7 with
   channel_scale), and in sim mode with a blockwise attn section and reorder
   tables, on the card against the same on the CPU; and the calibration sweep of get_calib_data with --attn_map_pool
   (pooled attention maps) on the small config, on the card against the CPU;
   and one more CFG forward of w8a8_attn at t=999 with models/dit.py's
   attention_int8 swapped for the plain versions on the card (K10a's and
   K10's), printed against the kernel forward and each against w8a8 and
   bf16: whether w8a8_attn's distance to w8a8 is int8 attention's rounding
   or K10's own error (gated only on a finite prediction). Then T2V-14B at
   480p: w8a8_14b and w4a8_14b against bf16 with the 1.3B gates (W8A8 PSNR
   >= 30 dB with CFG, W4A8 cosine >= 0.9 conditional and >= 0.5 with CFG),
   w4w8_plan_14b at the 4-bit gates (its PSNR printed beside w4a8_14b's and
   w8a8_14b's), the memory of the weights and of each quant state, each
   forward and bf16's under torch.profiler, and one sequential-CFG step of
   w4a8_14b and of bf16 at 720p.
5. whole generate (T2V-1.3B): a checkpoint dir, umT5-XXL, fp_generate from
   --random_init and --ckpt_dir, cli.generate W8A8 to the decoded video, the
   W8A8 video scored against fp_generate's by cli.evaluate --clip_metrics
   --flow_score on the card (PSNR, FPFVD on the random feature net, the
   full ViT-H CLIP metrics, the flow score; each part's seconds and the
   peak; evaluate(fp, fp) ~ 0; the feature net, CLIP and the flow on the
   card against the CPU), the VAE and umT5 on the card against the CPU,
   bf16 decodes at 480p and 720p;
6. image to video: I2V-14B at full width (dim 5120, clip_dim 1280; DEPTH_14B
   = 10 of its 40 blocks) from a seeded [3, 480, 832] image at 832*480x81
   (58 x 104 latents, seq 31668: no token is padded). Every kernel the path runs at its
   shapes and at seq 32760 (K1, K3, K7, K2, K8, K4 self over all keys and
   cross against 512 text and 257 CLIP tokens), printed beside its bound and
   the library call, not summed into the kernels line; a checkpoint dir with
   the full-width random VAE and CLIP's ViT-H/14 visual tower (bf16); cli.ptq
   --random_init under wan_w4a8_mixed.yaml (RTN, --targets int8); cli.generate
   --random_init --ckpt_dir --quant_params --hardware --sample_solver dpm++
   --vae_dtype bfloat16, 3 steps, to a finite [1, 3, 81, 464, 832] video in
   [-1, 1] (CLIP, the encode, each step and the decode timed; the launches of
   each step exactly the per-block table x the blocks); with the bf16
   weights and the int8 state resident: CLIP and the f32 VAE encode on the card against the
   CPU (rel-L2 <= 1e-4), the encode's time and peak in bf16 and f32, and one
   CFG forward at t=999 of the quantized and the bf16 I2V model with the same
   conditioning under the 4-bit gate and torch.profiler; then at T2V-1.3B
   from phase 3's calibration, WanT2V.quant_ctx_schedule (W8A8 on step 1,
   mixed W4A8 on steps 2-3: each step's launches exact) and
   WanT2V.capture_attn_maps from the deployed W8A8 model (17 frames, pool
   256: mass, shapes, select_temporal_windows, against a calib-mode capture);
7. training: K4's residual mode (the output and each row's log-sum-exp), K12
   (dq) and K11 (dk, dv) against their plain versions (_sdpa_lse_reference,
   attention_bwd_reference) at self-attention [1, 12, 32768, 128] with 32760
   valid keys (pad k/v planted), cross-attention against 512 keys and self
   with 40 heads (printed, not summed): the output at K4's limits, the LSE abs
   <= 1e-3, each gradient rel-L2 <= 1e-2, dk = dv = 0 past the valid keys,
   two calls of K12 and K11 equal bit for bit, each beside its bound and
   scaled_dot_product_attention's forward or backward (on k/v[:valid]); K12
   and K11 are timed through flash_attention_bwd (the plain reduction of di
   into the row table included, and timed alone beside them), and the whole
   backward (dq, dk, dv) against scaled_dot_product_attention's; QLoRA at
   T2V-1.3B full depth, 832x480x81 (seq 32760, B = 1) over
   wan_w4a8_mixed.yaml's int8 base (the FP copies stripped, rank-16
   adapters, remat, lr 1e-4, guidance 3, one batch): a warm-up and 3 steps
   with their loss, gradient norm, seconds, peak and launches (exactly
   QLORA_STEP x 30 each; the warm-up's loss, norm and gradients kept for
   8 (g)), finite, the last loss below the first, and one
   more forward and backward split by the host clock; the adapters'
   gradients on the first 2 blocks against the plain-attention route
   (rel-L2 <= 1e-2);
   save_lora_checkpoint, then quant_generate --lora <dir> --hardware (1 step
   at 81 frames, launches exactly QLORA_DEPLOY x 30) and its recorded DiT
   forward against dit_forward(training=True) of the same adapted model (PSNR
   >= 35 dB); then one more QLoRA step under torch.profiler, its device time
   by kernel group (K4's residual mode, K12, K11, the plain K4 of the
   teacher, cuBLAS, the rest: elementwise glue and copies) with each group's
   share; make_distill_step and make_lora_distill_step at full depth,
   832x480x9, 2 steps each (finite). Their launches count into the kernels
   line;
8. multi-GPU on one card (one card cannot run two NCCL ranks, so no run on
   more than one card is made here): (a) K4's partial mode (one ring hop,
   counter attention_partial) against ring.partial_attention_plain at K4's
   limits on shards of [2, 12, 32768, 128] (32760 valid, n = 4), dense and
   band r = 1 (1560 tokens a frame), offsets off a tile and a frame, a shard
   of pad q rows, rows the band misses (0 and -inf), a shard without a valid
   key refused; a hop timed beside its bound and
   aten._scaled_dot_product_flash_attention (output and LSE, on k/v[:valid]);
   (b) the ring's hop schedule over virtual ranks in one process through the
   functions ring_attention calls, at 1.3B 480p (n = 2, 4, 8) and T2V-14B
   720p ([1, 40, 75776, 128], 75600 valid, n = 8), dense and r = 1: each
   folded output against one K4 launch over the whole sequence at K4's
   limits, the hops run against the predicate's count, the hop time against
   the launch; (c) one W8A8 CFG forward at 1.3B full width through
   dit_forward(plan=) on a one-rank NCCL group from init_distributed against
   the forward without a plan (equal bits, else rel-L2 <= 1e-3 with the
   reason), its launches W8A8's per-block counts x 30; (d) printed: K4 on
   one rank's 5 heads of Ulysses 8 at 14B 720p against the 40-head launch;
   (e) K12 and K11's accumulate mode (counters attention_bwd_dq_acc,
   attention_bwd_dkv_acc: one hop of the ring's backward, f32 added into
   caller-given buffers from a row table of the folded LSE) against
   attention_bwd_reference(rows=) at q [1, 12, 8192, 128] against an 8192-key
   shard and the last shard (8184 valid) of the 1.3B 480p self shape (n = 4):
   rel-L2 <= 1e-2 each, nothing added past the valid keys, dq's f32 sum over 4
   hops against the plain sum; each hop timed beside the bf16-out launch on
   the same shard, its bound and the library's flash backward fed the fold;
   (f) the ring's backward over virtual ranks (flash_bwd_rows once a rank,
   one K12 and one K11 accumulate launch a visited hop, the dk / dv
   accumulators in the ring's order) at 1.3B 480p (n = 4, 8; B = 1) and one
   rank's 5 heads of T2V-14B 720p (n = 8): dq, dk, dv against one
   flash_attention_bwd launch, rel-L2 <= 1e-2, the launches the visited hops,
   the host-clock total beside the launch; (g) on a one-rank NCCL group at
   1.3B full width and depth: a 1-step calibration sweep (minmax, the 210
   GPTQ_REGEX Hessians) through the plan against the planless sweep, and one
   QLoRA step (phase 7's base, adapters and batch) through the plan against
   phase 7's warm-up step (the planless step): equal bits (else the QLoRA
   gradients rel-L2 <= 1e-3 with the reason), the planned step's seconds,
   peak and launches (QLORA_STEP x 30);
9. the streamed quantized base (quant/stream.py) and QLoRA at T2V-14B: (i)
   at full width and 2 blocks, the streamed W4A8 base's state equal bit for
   bit to prepare_quant_state on the same generators' draws, one int8 forward
   of each within rel-L2 1e-3; (ii) the streamed base at all 40 blocks: its
   seconds, int bytes (the byte model's 6.56 GiB), the memory held after and
   the peak during the build (gate: the int bytes + 4 GiB); (iii) K4's
   residual mode, K12 and K11 at [1, 40, 4680, 128] self and against 512 text
   tokens, held as in phase 7 (printed, not summed), the row table's pad rows
   (+inf, 0); (iv) 1 warm-up + 2 QLoRA steps on that base at all 40 blocks,
   832x480x9 (seq 4680), rank 16 on self q/k/v/o and ffn, remat, lr 1e-4,
   guidance 3: finite, the last loss below the warm-up's (the loss before
   any update), the launches exactly QLORA_STEP x 40, and one more step split
   by the host clock; (v) 1 warm-up + 1 QLoRA step at 832x480x81 (seq 32760)
   on 2 blocks of that base (the same adapters and batch), in a child
   process whose environment has PYTORCH_CUDA_ALLOC_CONF removed (the
   default allocator): finite, the launches QLORA_STEP x 2, the peak and
   its projection to 40 blocks, the peak + 38 x (one block's int bytes, its
   adapters' tensor, gradient, Adam moments and EMA, and one saved bf16 block
   input), gated at <= 60 GiB.

The third-to-last line is the kernels' JSON record, then the card's name
and power limit, and the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "_smoke_out"
TASK, SIZE, FRAMES, STEPS = "t2v-1.3B", "832*480", 81, 3
YAML = "quant_configs/wan_w8a8_speed.yaml"
# path -> (quant YAML, kernel launches per block), read from models/dit.py:
# W8A8: K1 for q/k/v, cross q and ffn.0; K2 for q/k/v, cross q, ffn.2, and in
#   its GELU + quant mode (a counter of its own) for ffn.0: the static ffn.2
#   scale makes the plain GELU + quant chain the GEMM's epilogue.
# mixed W4A8 (cross-attention FP): K1 for q/k/v and ffn.0; K2 for q/k/v/o;
#   K7 for the o input and the ffn.2 GELU; K8 for ffn.0/2.
# W4A4 (unfused: 4-bit activations): K9 at self q/k/v/o, cross q/o, ffn.0/2.
# Every path: K3 for q and k rope and the cross-q split; K4 self + cross;
#   K13 for the block's three residual updates (calibration and the QLoRA
#   steps too: under autograd its backward is the plain chain's).
# W4A8 static (wan_w4a8_14b.yaml: 4-bit weights at every quantized linear,
#   cross k/v FP, ffn.2 static): K1 for q/k/v, cross q and ffn.0; K7 for the
#   self and cross o inputs; K8 for self q/k/v/o, cross q/o and ffn.2, and in
#   its GELU + quant mode (a counter of its own) for ffn.0.
# W8A8 + attn section: self-attention runs K3 for q and k with unscaled
#   tables (K10 applies the softmax scale), then K10a + K10; K3 also splits
#   the cross q, and K4 runs cross-attention only.
# sim (no --hardware): every linear is fake-quant + a bf16 GEMM; no int kernel.
# W8A8 with --attn_window 1: w8a8's launches, self-attention in K4's band mode
#   (a counter of its own), cross-attention in its dense mode.
# ViDiT-Q (quant_configs/config.yaml, the source's shipped config: SmoothQuant
#   mask + Hadamard rotation, W8A8 on self-attention q/k/v, the rest bf16):
#   rotated q/k/v are not fusable, so each takes plain LN + modulate, x * mask
#   @ rotation (an f32 library product), K7 on the f32 rows and K2; K3 and K4
#   as in bf16.
# GPTQ (wan_w4a8_gptq.yaml: wan_w4a8_14b.yaml with Hessian-aware rounding): the
#   state is a drop-in, so W4A8_STATIC's launches.
# SVDQuant (wan_svdquant.yaml: SmoothQuant masks at every linear, W4A4 on the
#   residual of a rank-32 bf16 branch): K9 at the 8 sites on x * mask, as w4a4;
#   the branch's two products are cuBLAS beside it.
ATTN_YAML = "quant_configs/wan_w8a8_attn.yaml"
VIDITQ_YAML = "quant_configs/config.yaml"
W4A8_14B_YAML = "quant_configs/wan_w4a8_14b.yaml"
GPTQ_YAML = "quant_configs/wan_w4a8_gptq.yaml"
SVD_YAML = "quant_configs/wan_svdquant.yaml"
# the Hessian sites of wan_w4a8_gptq.yaml's own calibration recipe (7 a block)
GPTQ_REGEX = r"self_attn|cross_attn\.(q|o)|ffn\.0"
W4A4 = {"rms_rope_heads": 3, "gate_residual": 3, "attention": 2, "w4a4_linear": 8}
W8A8 = {"ln_modulate_quant": 3, "w8a8_linear": 5, "w8a8_linear_gelu_quant": 1,
        "rms_rope_heads": 3, "gate_residual": 3, "attention": 2}
W4A8_STATIC = {"ln_modulate_quant": 3, "w4a8_linear": 7, "w4a8_linear_gelu_quant": 1,
               "quant_sum": 2, "rms_rope_heads": 3, "gate_residual": 3, "attention": 2}
# W8A8 at 14B (wan_w8a8_14b.yaml: 8-bit weights at every block linear but
#   cross k/v, ffn.2 static): K1 for q/k/v, cross q and ffn.0; K7 for the
#   self and cross o inputs; K2 for self q/k/v/o, cross q/o and ffn.2, and in
#   its GELU + quant mode for ffn.0.
# W4/W8 under a capacity plan (w4w8_plan_14b, --auto_bits_gib; the act section
#   of wan_w4a8_14b.yaml: ffn.2 static): K1 for q/k/v, cross q and ffn.0; K7 for
#   the self and cross o inputs and for the text context of cross k and v each;
#   K8 for self q/k and cross q/k/v, and in its GELU + quant mode for ffn.0,
#   which hands ffn.2's K2 its int8 input; K2 for self v/o, cross o and ffn.2.
W4W8_PLAN = {"ln_modulate_quant": 3, "w4a8_linear": 5, "w4a8_linear_gelu_quant": 1,
             "w8a8_linear": 4, "quant_sum": 4, "rms_rope_heads": 3, "gate_residual": 3,
             "attention": 2}
PATHS = {
    "w8a8": (YAML, W8A8),
    "w4a8_mixed": ("quant_configs/wan_w4a8_mixed.yaml",
                   {"ln_modulate_quant": 2, "w8a8_linear": 4, "rms_rope_heads": 3,
                    "gate_residual": 3, "attention": 2, "quant_sum": 2, "w4a8_linear": 2}),
    "w4a4": ("quant_configs/wan_w4a4.yaml", W4A4),
    "w8a8_attn": (ATTN_YAML, {"ln_modulate_quant": 3, "w8a8_linear": 5,
                              "w8a8_linear_gelu_quant": 1, "rms_rope_heads": 3,
                              "gate_residual": 3, "attention": 1, "quantize_qkv_int8": 1,
                              "attention_int8": 1}),
    "w8a8_sim": (YAML, {"rms_rope_heads": 3, "gate_residual": 3, "attention": 2}),
    "w4a8_static": (W4A8_14B_YAML, W4A8_STATIC),
    "w8a8_win1": (YAML, {"ln_modulate_quant": 3, "w8a8_linear": 5, "w8a8_linear_gelu_quant": 1,
                         "rms_rope_heads": 3, "gate_residual": 3, "attention": 1,
                         "attention_band": 1}),
    "viditq": (VIDITQ_YAML, {"quant_sum": 3, "w8a8_linear": 3, "rms_rope_heads": 3,
                             "gate_residual": 3, "attention": 2}),
    "w4a8_gptq": (GPTQ_YAML, W4A8_STATIC),
    "svdquant": (SVD_YAML, W4A4),
    # two checks of the CFG schedules at 1.3B: w8a8 with sequential CFG (its
    # first step held against w8a8's batched one) and w8a8 under a static
    # step cache (counts from StepCachePolicy.plan)
    "w8a8_seq": (YAML, W8A8),
    "w8a8_static_cache": (YAML, W8A8),
    # T2V-14B at full width (dim 5120, 40 heads), DEPTH_14B blocks, --strip_fp
    "w4a8_14b": (W4A8_14B_YAML, W4A8_STATIC),
    "w8a8_14b": ("quant_configs/wan_w8a8_14b.yaml",
                 {"ln_modulate_quant": 3, "w8a8_linear": 7, "w8a8_linear_gelu_quant": 1,
                  "quant_sum": 2, "rms_rope_heads": 3, "gate_residual": 3, "attention": 2}),
    "w4a8_14b_cache": (W4A8_14B_YAML, W4A8_STATIC),
    "w4a8_14b_720p": (W4A8_14B_YAML, W4A8_STATIC),
    "w4w8_plan_14b": (W4A8_14B_YAML, W4W8_PLAN),
    # Wan2.2 TI2V-5B image-to-video (dim 3072, all 30 blocks, 1280x704x121:
    # 31 latent frames of 880 tokens), W8A8: w8a8's launches, K1's q/k/v and
    # ffn.0 and K13's self and ffn updates reading the per-frame table (their
    # _rows counters; cross q's K1 and the cross update read one row)
    "ti2v_w8a8": (YAML, {**W8A8, "ln_modulate_quant_rows": 2, "gate_residual_rows": 2}),
}
# the counters of launches that read a per-frame table (a launch of their
# kernel too), checked a block as the launches are
ROW_COUNTERS = ("ln_modulate_quant_rows", "gate_residual_rows")
TASK_14B = "t2v-14B"
TASK_TI2V = "ti2v-5B"
# T2V-14B and I2V-14B run at full width with 10 of their 40 blocks, so the
# whole script stays inside its time limit (with 20 blocks a whole run read
# up to 1140.6 s of its 1200); the 1.3B model keeps its 30
DEPTH_14B = 10
# w4w8_plan_14b: quant_generate --auto_bits_gib. The byte model is linear in
# the depth, so this budget plans at DEPTH_14B blocks what 9.5 GiB plans at 40:
# W8 on ffn.2, self o, cross o and self v, W4 on the other six classes (cross
# k/v included)
PLAN_GIB = 9.5 * DEPTH_14B / 40
# how a path's run differs from the 1.3B default (TASK, SIZE, STEPS, no flags).
# The 14B YAML's cache: section (the adaptive policy, warmup 2, tail 2) plans
# all-full steps for 3 or fewer steps; over 8 the policy decides.
RUNS = {
    "w8a8_seq": {"flags": ("--cfg_mode", "sequential")},
    "w8a8_static_cache": {"steps": 8, "flags": (
        "--cfg_cache_interval", "2", "--reuse_interval", "2", "--cache_warmup", "2",
        "--cache_tail", "2")},
    "w4a8_14b": {"task": TASK_14B, "flags": ("--strip_fp",)},
    "w8a8_14b": {"task": TASK_14B, "flags": ("--strip_fp",)},
    "w4a8_14b_cache": {"task": TASK_14B, "steps": 8, "flags": ("--strip_fp",)},
    "w4a8_14b_720p": {"task": TASK_14B, "size": "1280*720", "steps": 2,
                      "flags": ("--strip_fp", "--cfg_mode", "sequential")},
    "w4w8_plan_14b": {"task": TASK_14B, "flags": ("--auto_bits_gib", repr(PLAN_GIB),
                                                  "--strip_fp")},
    "ti2v_w8a8": {"task": TASK_TI2V, "size": "1280*704", "frames": 121,
                  "flags": ("--strip_fp",)},
}
SIM_PATHS = ("w8a8_sim",)                        # quant_generate without --hardware
WINDOWS = {"w8a8_win1": 1}                       # quant_generate --attn_window
# cli.ptq writes the quant-state artifact, quant_generate --quant_params loads it
PTQ_PATHS = ("viditq", "w4a8_gptq", "svdquant")
# the paths that take no calibration; every other path gets its task's
# (a static ffn.2 scale or SmoothQuant masks), or its own (CALIB_FLAGS):
# w4a8_gptq's YAML recipe, one step a round
NO_CALIB_PATHS = ("w4a8_mixed", "w4a4")
CALIB_FLAGS = {"w4a8_gptq": ("--collect_hessian", GPTQ_REGEX, "--calib_rounds", "3")}
# the paths phase 4 holds against bf16: the ten 1.3B deployments, and 14B
FIDELITY_13B = ("w8a8", "w4a8_mixed", "w4a4", "w8a8_attn", "w8a8_sim", "w4a8_static",
                "w8a8_win1", "viditq", "w4a8_gptq", "svdquant")
# gated at PSNR >= 30 dB with CFG 5; the others at the 4-bit cosines
PSNR_GATED = ("w8a8", "w8a8_sim", "w8a8_win1", "viditq")
# a 1.3B path beside the path it changes the rounding of
RTN_TWIN = {"w4a8_gptq": "w4a8_static", "svdquant": "w4a4"}
FIDELITY_14B = ("w8a8_14b", "w4a8_14b", "w4w8_plan_14b")
SOURCES = {
    "ln_modulate_quant": ("wanq_tpu_torch/csrc/ln_modulate_quant.cu",
                          "wanq_tpu/ops/fused.py:172"),
    "w8a8_linear": ("wanq_tpu_torch/csrc/w8a8_gemm.cu", "wanq_tpu/ops/qgemm.py:124"),
    "rms_rope_heads": ("wanq_tpu_torch/csrc/rms_rope_heads.cu",
                       "wanq_tpu/ops/rmsnorm_rope.py:62"),
    "attention": ("wanq_tpu_torch/csrc/flash_attention.cu",
                  "wanq_tpu/models/attention.py:256"),  # band mode: :132 _temporal_band_mask
    "quant_sum": ("wanq_tpu_torch/csrc/quant_sum.cu", "wanq_tpu/ops/fused.py:126"),
    "w4a8_linear": ("wanq_tpu_torch/csrc/w4a8_gemm.cu", "wanq_tpu/ops/qgemm.py:282"),
    "w4a4_linear": ("wanq_tpu_torch/csrc/w4a4_gemm.cu", "wanq_tpu/ops/qgemm.py:492"),
    "quantize_qkv_int8": ("wanq_tpu_torch/csrc/quantize_qkv_int8.cu",
                          "wanq_tpu/ops/attn_int8.py:52"),
    "attention_int8": ("wanq_tpu_torch/csrc/attention_int8.cu",
                       "wanq_tpu/ops/attn_int8.py:181"),
    # training: the TPU flash attention's forward with residuals and its two
    # backward kernels, in the installed JAX
    "attention_lse": ("wanq_tpu_torch/csrc/flash_attention.cu",
                      "jax/experimental/pallas/ops/tpu/flash_attention.py:758"),
    "attention_bwd_dkv": ("wanq_tpu_torch/csrc/flash_attention_bwd.cu",
                          "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"),
    "attention_bwd_dq": ("wanq_tpu_torch/csrc/flash_attention_bwd.cu",
                         "jax/experimental/pallas/ops/tpu/flash_attention.py:1456"),
    # the ring's backward hop: K12's and K11's accumulate mode (wanq_tpu takes
    # the ring's gradient from autodiff through its fold, XLA)
    "attention_bwd_dq_acc": ("wanq_tpu_torch/csrc/flash_attention_bwd.cu",
                             "jax/experimental/pallas/ops/tpu/flash_attention.py:1456"),
    "attention_bwd_dkv_acc": ("wanq_tpu_torch/csrc/flash_attention_bwd.cu",
                              "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"),
    # the block's gated residual update: no TPU kernel to replace (wanq_tpu's
    # ops/fused.py::gate_residual is an XLA fusion, no pallas_call)
    "gate_residual": ("wanq_tpu_torch/csrc/gate_residual.cu", None),
}
# launch counters of a kernel's further modes -> the kernel they belong to
MODES = {"w8a8_linear_gelu_quant": "w8a8_linear", "w4a8_linear_gelu_quant": "w4a8_linear",
         "attention_band": "attention", "attention_partial": "attention"}
# (K, N, out type) of the int GEMM sites: 1.3B q/k/v, ffn.0, ffn.2; T2V-14B
# the square sites, ffn.0, ffn.2
GEMM_SHAPES = ((1536, 1536, "bfloat16"), (1536, 8960, "bfloat16"), (8960, 1536, "float32"),
               (5120, 5120, "bfloat16"), (5120, 13824, "bfloat16"), (13824, 5120, "float32"))
# NVIDIA H100 SXM data sheet, dense: device memory bytes/s and operations/s
HBM_BPS = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 2, reps: int = 5) -> float:
    """Warm median of CUDA-event timings of fn()."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bf16_ulp_check(torch, got, want):
    """(fraction of elements more than one bf16 ulp of ``want`` apart, max
    abs difference). The norm's f32 sum is taken in another order by the
    kernel and by PyTorch, so the bf16 rounding of the normalized value can
    flip by one unit on a few elements (as K1's int8 codes can)."""
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    diff = (got - want).abs()
    return (diff > ulp).float().mean().item(), diff.max().item()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Wan2.1 checkpoint writers (phase 5 and the tests)
# ---------------------------------------------------------------------------

DIT_INDEX = "diffusion_pytorch_model.safetensors.index.json"


def reference_state_dict(params, cfg):
    """The port's DiT params -> the reference's state dict: its key names,
    linear weights [C_out, C_in] and the 5-D patch embedding; no tensor is
    copied to the host."""
    sd = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        elif node is not None:
            sd[prefix[:-1]] = node

    walk(params, "")
    out = {}
    for path, v in sd.items():
        if path == "patch_embedding.w":
            key, v = "patch_embedding.weight", v.t().reshape(
                cfg.dim, cfg.in_dim, *cfg.patch_size)
        elif path.endswith(".w"):
            key, v = path[:-2] + ".weight", v.t() if v.dim() == 2 else v
        elif path.endswith(".b"):
            key = path[:-2] + ".bias"
        elif path.endswith((".norm_q", ".norm_k")):
            key = path + ".weight"
        else:  # the modulation tables
            key = path
        out[key] = v.contiguous()
    return out


def write_dit_checkpoint(params, cfg, ckpt_dir, shards: int = 2) -> int:
    """Write the DiT params as a Wan2.1 checkpoint dir: ``shards``
    safetensors files with the reference's keys and layouts, and their
    index JSON. One shard at a time passes through the host. Returns the
    bytes written."""
    from safetensors.torch import save_file

    os.makedirs(ckpt_dir, exist_ok=True)
    sd = reference_state_dict(params, cfg)
    keys = list(sd)
    per = -(-len(keys) // shards)
    weight_map, total = {}, 0
    for i in range(shards):
        fname = f"diffusion_pytorch_model-{i + 1:05d}-of-{shards:05d}.safetensors"
        part = {k: sd[k].cpu() for k in keys[i * per:(i + 1) * per]}
        save_file(part, os.path.join(ckpt_dir, fname))
        total += sum(v.numel() * v.element_size() for v in part.values())
        weight_map.update({k: fname for k in part})
    with open(os.path.join(ckpt_dir, DIT_INDEX), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return total


def write_vae_checkpoint(params, path) -> None:
    """Write flat VAE params as the reference's Wan2.1_VAE.pth state dict."""
    import torch

    torch.save({k: v.cpu() for k, v in params.items()}, path)


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions at main-path shapes
# ---------------------------------------------------------------------------


def recorder(results):
    """The ``record`` function of the kernel checks, summing into ``results``."""

    def record(name, err, ms, plain_ms, detail, nbytes, ops, op_type, library_ms=None,
               summed=True):
        """One shape of one kernel. ``nbytes``: inputs read once + outputs
        written once; ``ops``: the function's operations of ``op_type``.
        A kernel checked at several shapes sums its times and bounds into
        the kernels line; a shape with ``summed=False`` is printed only, so
        the line's totals keep the shapes of earlier runs."""
        bytes_ms, ops_ms = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[op_type] * 1e3
        if summed:
            r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                          "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0,
                                          "library_ms": None})
            r["max_abs_err"] = max(r["max_abs_err"], float(err))
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["bytes_ms"] += bytes_ms
            r["ops_ms"] += ops_ms
            r["bound_ms"] += max(bytes_ms, ops_ms)
            if library_ms is not None:
                r["library_ms"] = (r["library_ms"] or 0.0) + library_ms
        lib = "" if library_ms is None else f"  library {library_ms:.3f} ms"
        log(f"  {name} {detail}: max_abs_err {err:.3e}  kernel {ms:.3f} ms  "
            f"plain {plain_ms:.3f} ms{lib}  bound {max(bytes_ms, ops_ms):.3f} ms "
            f"({nbytes / 1e6:.1f} MB -> {bytes_ms:.3f} ms; {ops / 1e12:.3f} T {op_type} ops "
            f"-> {ops_ms:.3f} ms)")

    return record


def attn_err(got, want, what):
    """K4's limits against its plain version: the outputs are small (std ~
    sqrt(e / Sk)), so they scale with them: rel-L2 <= 1e-2 and max abs err
    <= 4 bf16 ulps of max|want|. Returns (max abs err, rel-L2)."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    rel = ((g - w).norm() / w.norm()).item()
    ulp = 2.0 ** (math.floor(math.log2(w.abs().max().item())) - 7)
    check(bool(torch.isfinite(g).all()) and rel <= 1e-2 and err <= 4 * ulp,
          f"K4 {what}: max abs err {err:.3e} (limit {4 * ulp:.3e}), rel-L2 {rel:.3e}")
    return err, rel


def kernel_checks(torch, results):
    from wanq_tpu_torch.models.attention import _flash_cuda, _sdpa_reference
    from wanq_tpu_torch.models.rope import pad_tables, rope_tables_interleaved
    from wanq_tpu_torch.ops.fused import ln_modulate_quant_cuda, ln_modulate_quant_plain
    from wanq_tpu_torch.ops.qgemm import w8a8_linear_cuda, w8a8_linear_plain
    from wanq_tpu_torch.ops.rmsnorm_rope import (
        _k3_cuda, rms_rope_heads_plain, rms_split_heads_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, s, valid, c, n, d = 2, 32768, 32760, 1536, 12, 128
    record = recorder(results)

    # K1 -- LN + modulate + int8 quant, x [2, 32768, C] bf16, C = 1536 and the
    # T2V-14B width 5120
    for cw in (c, 5120):
        x = (torch.randn((b, s, cw), device=dev, generator=g) * 2 + 0.3).bfloat16()
        shift = torch.randn((b, cw), device=dev, generator=g) * 0.5
        scale = torch.randn((b, cw), device=dev, generator=g) * 0.5
        got = ln_modulate_quant_cuda(x, shift, scale)
        want = ln_modulate_quant_plain(x, shift, scale)
        torch.cuda.synchronize()
        diff = (got[0].int() - want[0].int()).abs()
        frac = (diff > 0).float().mean().item()
        check(diff.max().item() <= 1 and frac <= 1e-3,
              f"K1 C={cw} codes differ: max {diff.max()}, {frac}")
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
        err = (got[0].float() * got[1][..., None] - want[0].float() * want[1][..., None])
        record("ln_modulate_quant", err.abs().max().item(),
               cuda_ms(lambda: ln_modulate_quant_cuda(x, shift, scale)),
               cuda_ms(lambda: ln_modulate_quant_plain(x, shift, scale), reps=3),
               f"[2,32768,{cw}] bf16 (codes differing: {frac:.2e})",
               b * s * cw * 3 + b * s * 8 + 2 * b * cw * 4, 10 * b * s * cw, "f32",
               summed=cw == c)
        del x, got, want, diff, err

    # K2 -- W8A8 GEMM at M = 65536 for the three (K, N) of the 1.3B paths and
    # the three of T2V-14B, each in the out type its site has: exact, also at
    # ragged M (1.3B: both out types, M - 8 and M + 3; 14B: the site's, M + 3).
    # Then its GELU + quant mode at ffn.0's shape against the plain chain.
    m = b * s
    for k, nn, out_name in GEMM_SHAPES:
        out_dtype, wide = getattr(torch, out_name), 5120 in (k, nn)  # wide: a 14B site
        ragged = (m + 3,) if wide else (m - 8, m + 3)
        a = torch.randint(-128, 128, (max(ragged), k), device=dev, generator=g, dtype=torch.int8)
        w = torch.randint(-128, 128, (nn, k), device=dev, generator=g, dtype=torch.int8)
        s_a = torch.rand((max(ragged),), device=dev, generator=g) * 0.02 + 1e-3
        s_w = torch.rand((nn,), device=dev, generator=g) * 0.02 / k ** 0.5 + 1e-5
        sum_a = s_a * a.float().sum(-1)
        zp = torch.randint(-20, 20, (nn,), device=dev, generator=g).float()
        bias = torch.randn((nn,), device=dev, generator=g)
        for mm in (m, *ragged):
            for dt in ((out_dtype,) if wide else (torch.bfloat16, torch.float32)):
                args = (a[:mm], w, s_a[:mm], s_w, sum_a[:mm], zp, bias, dt)
                got, want = w8a8_linear_cuda(*args), w8a8_linear_plain(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                check(torch.equal(got, want), f"K2 M={mm} ({k},{nn}) {dt}: max abs err {err}")
                del got, want
        args = (a[:m], w, s_a[:m], s_w, sum_a[:m], zp, bias, out_dtype)
        ms = cuda_ms(lambda: w8a8_linear_cuda(*args))
        tops = 2 * m * k * nn / ms / 1e9
        wt = w.t()
        t_mm = cuda_ms(lambda: torch._int_mm(a[:m], wt))
        record("w8a8_linear", err, ms, cuda_ms(lambda: w8a8_linear_plain(*args),
                                               warmup=0 if wide else 2, reps=1 if wide else 3),
               f"M=65536 K={k} N={nn} {str(out_dtype)[6:]} out, exact "
               f"{'at M=65539 too' if wide else 'in both out types also at M=65528 and 65539'} "
               f"({tops:.0f} TOP/s; note: torch._int_mm, the bare int8 product "
               f"of the same operands with an int32 output, {t_mm:.3f} ms)",
               m * k + nn * k + m * nn * (2 if out_dtype == torch.bfloat16 else 4) + 8 * m
               + 12 * nn, 2 * m * k * nn, "int8", summed=not wide)
        if nn in (8960, 13824):
            gelu_quant_check(torch, record, "w8a8_linear", (a, w, s_a, s_w, sum_a, zp, bias), m,
                             ragged, ms)
        del a, w, wt, args
        torch.cuda.empty_cache()

    # K3 -- RMSNorm + RoPE + heads-major, [2, 32768, C] -> [2, C / 128, 32768, 128]
    # at the 1.3B width and the 14B width (40 heads), each with rope (K4's
    # q-scaled tables) and as the cross-q split; the tables are built outside
    # the timed calls
    ca, sb = rope_tables_interleaved((21, 30, 52), d)
    ca, sb = pad_tables(torch.from_numpy(ca.copy()).to(dev), torch.from_numpy(sb.copy()).to(dev),
                        valid, s)
    qs = 1.0 / d ** 0.5
    caq, sbq = ca * qs, sb * qs
    for cw in (c, 5120):
        nh = cw // d
        x = torch.randn((b, s, cw), device=dev, generator=g).bfloat16()
        wn = torch.rand((cw,), device=dev, generator=g) + 0.5
        cases = (("rope, q-scaled tables", lambda: _k3_cuda(x, wn, caq, sbq, nh, 1e-6, torch.bfloat16),
                  lambda: rms_rope_heads_plain(x, wn, caq, sbq, nh)),
                 ("split only (cross q)",
                  lambda: _k3_cuda(x, wn, None, None, nh, 1e-6, torch.bfloat16),
                  lambda: rms_split_heads_plain(x, wn, nh)))
        for detail, kern, plain in cases:
            rope = detail.startswith("rope")
            got, want = kern().float(), plain().float()
            frac, err = bf16_ulp_check(torch, got, want)
            check(frac <= 1e-4 and err <= 1e-2 * want.abs().max().item(),
                  f"K3 C={cw} {detail}: {frac:.2e} of elements beyond one bf16 ulp, "
                  f"max abs err {err}")
            del got, want
            ms = cuda_ms(kern, reps=9)
            nbytes = b * s * cw * 4 + cw * 4 + (2 * s * d * 4 if rope else 0)
            record("rms_rope_heads", err, ms, cuda_ms(plain, reps=3),
                   f"[2,32768,{cw}]->[2,{nh},32768,128] {detail} (beyond 1 ulp: {frac:.2e}; "
                   f"{nbytes / ms / 1e6:.0f} GB/s)", nbytes, 8 * b * s * cw, "f32",
                   summed=cw == c or rope)
        copy_note(torch, x)
        del x
    del ca, sb, caq, sbq
    torch.cuda.empty_cache()

    # K4 -- attention: cross (Sk = 512) and self (32768, valid 32760), at
    # attn_err's limits. Dropping one 128-key tile of the self call moves
    # rel-L2 by ~6e-2.
    q = torch.randn((b, n, s, d), device=dev, generator=g).bfloat16()
    ctx_k = torch.randn((b, 512, n, d), device=dev, generator=g).bfloat16()
    ctx_v = torch.randn((b, 512, n, d), device=dev, generator=g).bfloat16()
    kern = lambda: _flash_cuda(q, ctx_k.transpose(1, 2), ctx_v.transpose(1, 2), qs, 512)
    plain = lambda: _sdpa_reference(q.transpose(1, 2), ctx_k, ctx_v, qs, None, q_chunk=8192)
    err, rel = attn_err(kern(), plain(), "cross")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kh, vh = ctx_k.transpose(1, 2), ctx_v.transpose(1, 2)
    record("attention", err, cuda_ms(kern), cuda_ms(plain, reps=3),
           f"cross q [2,12,32768,128] heads-major, k/v [2,512,12,128] seq-major "
           f"(rel-L2 {rel:.2e}; library = scaled_dot_product_attention)",
           2 * (2 * b * n * s * d + 2 * b * n * 512 * d), 4 * b * n * s * 512 * d, "bf16",
           library_ms=cuda_ms(lambda: sdpa(q, kh, vh, scale=qs)))
    del ctx_k, ctx_v, kh, vh

    # self: the 8 pad rows of k/v are planted (k = 0, v = 100), so a missed
    # kv_valid mask would add ~1.5e-2 (~60 ulps) to every output
    k = torch.randn((b, n, s, d), device=dev, generator=g).bfloat16()
    v_flat = torch.randn((b, s, n * d), device=dev, generator=g).bfloat16()
    k[:, :, valid:] = 0.0
    v_flat[:, valid:] = 100.0
    vh = v_flat.view(b, s, n, d).transpose(1, 2)   # strided, no head-split pass
    qsc = (q.float() * qs).bfloat16()
    kern = lambda: _flash_cuda(qsc, k, vh, 1.0, valid)
    plain = lambda: _sdpa_reference(qsc.transpose(1, 2), k.transpose(1, 2),
                                    vh.transpose(1, 2), 1.0, valid, q_chunk=1024)
    got, want = kern(), plain()
    err, rel = attn_err(got, want, "self")
    pad_err, pad_rel = attn_err(got[:, valid:], want[:, valid:], "self pad q rows")
    del got, want
    ms = cuda_ms(kern, warmup=1, reps=3)
    flops = 4 * b * n * s * valid * d
    kv, vv = k[:, :, :valid], vh[:, :, :valid]  # the library call takes the valid prefix
    t4_self = ms
    record("attention", err, ms, cuda_ms(plain, warmup=1, reps=3),
           f"self [2,12,32768,128] valid 32760, pad k/v planted (rel-L2 {rel:.2e}; "
           f"pad q rows err {pad_err:.3e}, rel-L2 {pad_rel:.2e}; "
           f"{flops / ms / 1e9:.0f} TFLOP/s; library = scaled_dot_product_attention on "
           f"k/v[:valid])",
           2 * 4 * b * n * s * d, flops, "bf16",
           library_ms=cuda_ms(lambda: sdpa(qsc, kv, vv, scale=1.0), warmup=1, reps=3))
    del kv, vv, kern, plain
    band_checks(torch, record, qsc, k, vh, v_flat, valid, t4_self, attn_err)
    int8_attention_checks(torch, record, q, k, vh, valid, qs, t4_self)
    del q, k, v_flat, vh, qsc
    torch.cuda.empty_cache()
    attention_14b_checks(torch, record, attn_err)
    int4_checks(torch, g, record)
    viditq_checks(torch, g, record)
    gate_residual_checks(torch, g, record)
    table_checks(torch, g, record)


# Wan2.2 TI2V-5B's per-frame modulation at 1280x704x121: 31 latent frames of
# 880 tokens over a sequence padded to 27648, the pads on the last row
TABLE_SHAPE, TABLE_TPR, TABLE_ROWS = (2, 27648, 3072), 880, 31


def table_checks(torch, g, record):
    """K1 and K13 reading a per-frame table (TI2V-5B's [B, 31, 6, C]
    modulation, shift / scale / gate its columns as the block passes them) at
    [2, 27648, 3072], tokens_per_row 880: K1 at its usual limits against the
    plain version, with the one-row call at the same width (K1's two-warp
    form) beside it; K13 equal bit for bit to the plain chain with and without
    the FP o bias. Each counts one table launch (``*_rows``); each is timed,
    a tenth of ten calls back to back as a forward runs them, against the
    bound of its bytes (the table rows read included) at 3.35 TB/s. Printed
    only, so the kernels line keeps the Wan2.1 shapes."""
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.ops.fused import (
        gate_residual_cuda, gate_residual_plain, ln_modulate_quant_cuda, ln_modulate_quant_plain)

    dev = torch.device("cuda")
    b, s, cw = TABLE_SHAPE
    tpr, rows = TABLE_TPR, TABLE_ROWS
    tab = torch.randn((b, rows, 6, cw), device=dev, generator=g) * 0.5
    x = (torch.randn((b, s, cw), device=dev, generator=g) * 2 + 0.3).bfloat16()
    shift, scale = tab[:, :, 0], tab[:, :, 1]
    for what, sh, sc, kw, nrows in (
            (f"table of {rows} rows, tokens_per_row {tpr}", shift, scale,
             {"tokens_per_row": tpr}, rows),
            ("one row a sample", shift[:, 0], scale[:, 0], {}, 1)):
        _lib.reset_launch_counts()
        got = ln_modulate_quant_cuda(x, sh, sc, **kw)
        want = ln_modulate_quant_plain(x, sh, sc, **kw)
        torch.cuda.synchronize()
        counts = {"ln_modulate_quant": 1, **({"ln_modulate_quant_rows": 1} if nrows > 1 else {})}
        check(_lib.launch_counts() == counts, f"K1 {what}: launches {_lib.launch_counts()}")
        diff = (got[0].int() - want[0].int()).abs()
        frac = (diff > 0).float().mean().item()
        check(diff.max().item() <= 1 and frac <= 1e-3,
              f"K1 C={cw} {what}: codes differ: max {diff.max()}, {frac}")
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
        err = (got[0].float() * got[1][..., None] - want[0].float() * want[1][..., None])
        nbytes = b * s * cw * 3 + b * s * 8 + 2 * b * nrows * cw * 4
        ms = cuda_ms(lambda: [ln_modulate_quant_cuda(x, sh, sc, **kw) for _ in range(10)],
                     reps=5) / 10
        record("ln_modulate_quant", err.abs().max().item(), ms,
               cuda_ms(lambda: ln_modulate_quant_plain(x, sh, sc, **kw), reps=3),
               f"[2,27648,{cw}] bf16, {what} (codes differing: {frac:.2e}; "
               f"{nbytes / HBM_BPS * 1e3 / ms:.1%} of the bandwidth bound)",
               nbytes, 10 * b * s * cw, "f32", summed=False)
        del got, want, diff, err
    y = torch.randn((b, s, cw), device=dev, generator=g) * 3
    x[0, 0, :8] = -0.0
    y[0, 0, :8] = -0.0
    gate, bias = tab[:, :, 2], torch.randn((cw,), device=dev, generator=g)
    for bi in (None, bias):
        _lib.reset_launch_counts()
        got = gate_residual_cuda(x, y, gate, bi, tokens_per_row=tpr)
        want = gate_residual_plain(x, y, gate, bi, tokens_per_row=tpr)
        torch.cuda.synchronize()
        check(_lib.launch_counts() == {"gate_residual": 1, "gate_residual_rows": 1},
              f"K13 table launches {_lib.launch_counts()}")
        check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
              f"K13 table C={cw} bias {bi is not None}: {(got != want).sum().item()} elements "
              f"differ from the plain chain")
        del got, want
        nbytes = b * s * cw * 8 + b * rows * cw * 4 + (0 if bi is None else cw * 4)
        ms = cuda_ms(lambda: [gate_residual_cuda(x, y, gate, bi, tokens_per_row=tpr)
                              for _ in range(10)], reps=5) / 10
        record("gate_residual", 0.0, ms,
               cuda_ms(lambda: gate_residual_plain(x, y, gate, bi, tokens_per_row=tpr), reps=3),
               f"[2,27648,{cw}] bf16 x, f32 y, gate table of {rows} rows, tokens_per_row {tpr}"
               f"{', the FP o bias' if bi is not None else ''}: equal bits "
               f"({nbytes / HBM_BPS * 1e3 / ms:.1%} of the bandwidth bound)",
               nbytes, 3 * b * s * cw, "f32", summed=False)
    del x, y, tab
    torch.cuda.empty_cache()


def gate_residual_checks(torch, g, record):
    """K13, the block's residual update, at the whole update of a CFG pair at
    480p x 81 frames: [2, 32768, 1536] (1.3B) and [2, 32768, 5120] (14B), bf16
    x, f32 y, the gate a column of the [2, 6, C] modulation. Each combination
    of gate and bias equal bit for bit to the plain chain (the block's former
    update), with a signed zero planted; then each update the paths run (self:
    the gate, and at 1.3B the FP o's bias; cross: the bias or nothing; ffn: the
    gate) timed against the plain chain and the bound of its 8 bytes an
    element (x read, y read, x written) at 3.35 TB/s. Each time is a tenth of
    ten calls back to back, as a forward runs them: a lone 0.3 ms launch timed
    between events from an idle card reads ~10% slower on an H100. The 1.3B
    self-attention update is summed into the kernels line, the others printed."""
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.ops.fused import gate_residual_cuda, gate_residual_plain

    def ten(fn, *args):
        for _ in range(10):
            fn(*args)

    dev = torch.device("cuda")
    b, s = 2, 32768
    for cw in (1536, 5120):
        x = (torch.randn((b, s, cw), device=dev, generator=g) * 4).bfloat16()
        y = torch.randn((b, s, cw), device=dev, generator=g) * 3
        x[0, 0, :8] = -0.0
        y[0, 0, :8] = -0.0
        gate = torch.randn((b, 6, cw), device=dev, generator=g)[:, 2]
        bias = torch.randn((cw,), device=dev, generator=g)
        for gi, bi in ((None, None), (gate, None), (None, bias), (gate, bias)):
            _lib.reset_launch_counts()
            got = gate_residual_cuda(x, y, gi, bi)
            want = gate_residual_plain(x, y, gi, bi)
            torch.cuda.synchronize()
            check(_lib.launch_counts() == {"gate_residual": 1},
                  f"K13 launches {_lib.launch_counts()}")
            check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                  f"K13 C={cw} gate {gi is not None} bias {bi is not None}: "
                  f"{(got != want).sum().item()} elements differ from the plain chain")
            del got, want
        cases = [("self-attention: gate e2", gate, None), ("ffn: gate e5", gate, None),
                 ("cross-attention: no gate", None, None)]
        if cw == 1536:  # the FP o projections leave their bias to K13
            cases = [("self-attention: gate e2 + the FP o bias", gate, bias),
                     ("ffn: gate e5", gate, None), ("cross-attention: the FP o bias", None, bias)]
        for i, (what, gi, bi) in enumerate(cases):
            ms = cuda_ms(lambda: ten(gate_residual_cuda, x, y, gi, bi), reps=5) / 10
            nbytes = b * s * cw * 8 + (0 if gi is None else b * cw * 4) + (0 if bi is None
                                                                            else cw * 4)
            bound = nbytes / HBM_BPS * 1e3
            record("gate_residual", 0.0, ms,
                   cuda_ms(lambda: ten(gate_residual_plain, x, y, gi, bi), reps=3) / 10,
                   f"[2,32768,{cw}] bf16 x, f32 y, {what}: equal bits ({bound / ms:.1%} of the "
                   f"bandwidth bound; {nbytes / ms / 1e6:.0f} GB/s)",
                   nbytes, 3 * b * s * cw, "f32", summed=cw == 1536 and i == 0)
        copy_note(torch, x, y)
        del x, y
        torch.cuda.empty_cache()


def attention_14b_checks(torch, record, attn_err):
    """K4 at T2V-14B's 40 heads x 128. Dense self-attention at 480p (S
    32768, 32760 valid) and 720p (S 75776, 75600 valid): q heads-major with
    the softmax scale folded in, k heads-major, v the strided view over [2,
    S, 5120] as on the path, the pad rows of k/v planted (k 0, v 100); its
    plain version is one call, timed (seconds at 720p). Cross-attention at
    480p (B 2, batched CFG) and 720p (B 1, sequential CFG): q heads-major,
    the 512 text keys and values seq-major [B, 512, 40, 128] read through
    heads-major views (row stride 5120), as on the path. Each held to K4's
    limits against the plain version and timed beside
    scaled_dot_product_attention (self: on k/v[:valid])."""
    from wanq_tpu_torch.models.attention import _flash_cuda, _sdpa_reference

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(40)
    b, n, d = 2, 40, 128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for bc, s, tag in ((2, 32768, "480p"), (1, 75776, "720p")):
        qs = d ** -0.5
        q = torch.randn((bc, n, s, d), device=dev, generator=g).bfloat16()
        ctx_k = torch.randn((bc, 512, n, d), device=dev, generator=g).bfloat16()
        ctx_v = torch.randn((bc, 512, n, d), device=dev, generator=g).bfloat16()
        kh, vh = ctx_k.transpose(1, 2), ctx_v.transpose(1, 2)
        kern = lambda: _flash_cuda(q, kh, vh, qs, 512)
        plain = lambda: _sdpa_reference(q.transpose(1, 2), ctx_k, ctx_v, qs, None, q_chunk=8192)
        err, rel = attn_err(kern(), plain(), f"cross 40 heads {tag}")
        record("attention", err, cuda_ms(kern), cuda_ms(plain, reps=3),
               f"cross q [{bc},40,{s},128] heads-major, k/v [{bc},512,40,128] seq-major "
               f"(T2V-14B {tag}; rel-L2 {rel:.2e}; library = scaled_dot_product_attention)",
               2 * (2 * bc * n * s * d + 2 * bc * n * 512 * d), 4 * bc * n * s * 512 * d, "bf16",
               library_ms=cuda_ms(lambda: sdpa(q, kh, vh, scale=qs)), summed=False)
        del q, ctx_k, ctx_v, kh, vh, kern, plain
        torch.cuda.empty_cache()
    for s, valid, tag, chunk in ((32768, 32760, "480p", 512), (75776, 75600, "720p", 256)):
        qsc = (torch.randn((b, n, s, d), device=dev, generator=g) * d ** -0.5).bfloat16()
        k = torch.randn((b, n, s, d), device=dev, generator=g).bfloat16()
        v_flat = torch.randn((b, s, n * d), device=dev, generator=g).bfloat16()
        k[:, :, valid:] = 0.0
        v_flat[:, valid:] = 100.0
        vh = v_flat.view(b, s, n, d).transpose(1, 2)
        kern = lambda: _flash_cuda(qsc, k, vh, 1.0, valid)
        got = kern()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = _sdpa_reference(qsc.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 1.0,
                               valid, q_chunk=chunk)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        err, rel = attn_err(got, want, f"self 40 heads {tag}")
        pad_err, pad_rel = attn_err(got[:, valid:], want[:, valid:],
                                    f"self 40 heads {tag} pad rows")
        del got, want
        torch.cuda.empty_cache()
        ms = cuda_ms(kern, warmup=1, reps=3)
        flops = 4 * b * n * s * valid * d
        kv, vv = k[:, :, :valid], vh[:, :, :valid]
        record("attention", err, ms, plain_ms,
               f"self [2,40,{s},128] valid {valid} (T2V-14B {tag}), pad k/v planted (rel-L2 "
               f"{rel:.2e}; pad q rows err {pad_err:.3e}, rel-L2 {pad_rel:.2e}; "
               f"{flops / ms / 1e9:.0f} TFLOP/s; plain: one call; library = "
               f"scaled_dot_product_attention on k/v[:valid])",
               2 * 4 * b * n * s * d, flops, "bf16",
               library_ms=cuda_ms(lambda: sdpa(qsc, kv, vv, scale=1.0), warmup=1, reps=3),
               summed=False)
        del qsc, k, v_flat, vh, kv, vv
        torch.cuda.empty_cache()


def band_pairs(s, tpf, r, valid):
    """Query-key pairs inside the band, per batch and head: a valid row of
    frame f sees the valid columns of frames f - r .. f + r, a pad row the
    whole valid prefix."""
    pairs = (s - valid) * valid
    for f in range(-(-valid // tpf)):
        rows = min((f + 1) * tpf, valid) - f * tpf
        pairs += rows * (min(valid, (f + r + 1) * tpf) - max(0, (f - r) * tpf))
    return pairs


def band_checks(torch, record, qsc, k, vh, v_flat, valid, t4_self, attn_err, tpf=1560):
    """K4's band mode at the w8a8_win1 path's shape ([2, 12, 32768, 128], valid
    32760, 1560 tokens a frame; q heads-major with the scale folded in, k
    heads-major, v the strided view over [2, 32768, 1536]; the pad rows of k/v
    planted as for the dense check). Held to K4's limits against the plain
    version with the band mask at radii 0, 1, 2 and a per-head vector, with the
    v rows of the two kv tiles beside the visited window of one q tile that
    straddles two frames planted (v 100): those rows lie outside every band of
    that tile, so a leaked tile moves its rows by ~100x their size; that tile
    is held on its own, and so is every row whose band holds no planted
    column. Then the times at radii 0, 1, 2, 4, 8 beside the bound (in-band
    pairs x 4 D over the bf16 peak, or the bytes), the visited-tile fraction
    (band_kv_tiles) and scaled_dot_product_attention with the band as a
    boolean [S, S] mask, and a band that covers every frame (r = 20) next to
    the dense launch."""
    from wanq_tpu_torch.models.attention import (
        TemporalWindow, _band_rows, _flash_cuda, _sdpa_reference, band_kv_tiles)
    from wanq_tpu_torch.ops import _lib

    t_band = time.time()
    b, n, s, d = qsc.shape
    dev = qsc.device
    q0 = 10 * tpf // 128 * 128       # a q tile across frames 9 and 10 (15488 at tpf 1560)
    rows = torch.arange(s, device=dev)
    frame = rows // tpf

    for radii in ([0] * n, [1] * n, [2] * n, [0, 0, 1, 1, 1, 2, 2, 2, 4, 4, 8, 20]):
        # per head: the v rows of the kv tiles just beside its window for q
        # tile q0 that lie outside every band of that tile
        v2 = v_flat.clone().view(b, s, n, d)
        planted, windows = {}, {}
        for h, r in enumerate(radii):
            j_lo, j_hi = windows[h] = band_kv_tiles(q0, 128, 128, tpf, r, valid)
            cols = torch.cat([torch.arange((j_lo - 1) * 128, j_lo * 128, device=dev),
                              torch.arange(j_hi * 128, (j_hi + 1) * 128, device=dev)])
            cols = cols[(cols >= 0) & (cols < valid)]
            tile_band = _band_rows(rows[q0:q0 + 128], s, tpf, r, valid)
            planted[h] = cols[~tile_band[:, cols].any(dim=0)]
            v2[:, planted[h], h] = 100.0
        check(sum(c.numel() for c in planted.values()) > 0, f"nothing planted at radii {radii}")
        vh2 = v2.transpose(1, 2)     # heads-major view over [B, S, N*D], as on the path
        win = TemporalWindow(tpf, max(radii), None if len(set(radii)) == 1 else tuple(radii))
        _lib.reset_launch_counts()
        got = _flash_cuda(qsc, k, vh2, 1.0, valid, tokens_per_frame=tpf, radii=radii)
        torch.cuda.synchronize()
        check(_lib.launch_counts() == {"attention_band": 1}, f"band launches {_lib.launch_counts()}")
        want = _sdpa_reference(qsc.transpose(1, 2), k.transpose(1, 2), vh2.transpose(1, 2), 1.0,
                               valid, window=win, q_chunk=1024)
        tag = f"band radii {radii if len(set(radii)) > 1 else radii[0]}"
        err, rel = attn_err(got, want, tag)
        t_err, t_rel = attn_err(got[:, q0:q0 + 128], want[:, q0:q0 + 128], f"{tag}, q tile {q0}")
        for h, cols in planted.items():  # rows whose band holds no planted column
            if cols.numel():
                pf = torch.unique(cols // tpf)
                clear = ((frame[:, None] - pf[None, :]).abs() > radii[h]).all(dim=1)
                clear &= rows < valid
                attn_err(got[:, clear, h], want[:, clear, h], f"{tag}, head {h}, clear rows")
        log(f"  attention {tag}: max_abs_err {err:.3e}, rel-L2 {rel:.2e}; q tile {q0} alone "
            f"{t_err:.3e}, {t_rel:.2e}; v rows planted beside its kv windows "
            f"{sorted(set(windows.values()))}: {sum(c.numel() for c in planted.values())}")
        del v2, vh2, got, want

    n_qt, n_kt = -(-s // 128), -(-valid // 128)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for r in (0, 1, 2, 4, 8):
        radii = [r] * n
        kern = lambda: _flash_cuda(qsc, k, vh, 1.0, valid, tokens_per_frame=tpf, radii=radii)
        ms = cuda_ms(kern, warmup=1, reps=5)
        pairs = band_pairs(s, tpf, r, valid)
        visited = sum(band_kv_tiles(i * 128, 128, 128, tpf, r, valid)[1]
                      - band_kv_tiles(i * 128, 128, 128, tpf, r, valid)[0] for i in range(n_qt))
        ops, nbytes = 4 * b * n * pairs * d, 2 * 4 * b * n * s * d
        bound = max(ops / PEAK_OPS["bf16"], nbytes / HBM_BPS) * 1e3
        mask = torch.empty((s, s), dtype=torch.bool, device=dev)
        for i in range(0, s, 4096):
            mask[i:i + 4096] = _band_rows(rows[i:i + 4096], s, tpf, r, valid)
        try:
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]):
                lib_ms = cuda_ms(lambda: sdpa(qsc, k, vh, attn_mask=mask, scale=1.0),
                                 warmup=1, reps=3)
            lib = f"{lib_ms:.3f} ms"
        except RuntimeError as e:  # the library call only; the port never makes it
            lib_ms, lib = None, f"none runs ({str(e).splitlines()[0][:160]})"
        del mask
        log(f"  attention band r={r}: kernel {ms:.3f} ms ({ms / t4_self:.3f} x dense K4 self), "
            f"in-band pairs {pairs / (s * s):.4f} of dense, visited 128-tiles "
            f"{visited / (n_qt * n_kt):.4f} of dense, bound {bound:.3f} ms "
            f"({ops / 1e12:.3f} T bf16 ops; {ms / bound:.2f}x), "
            f"{ops / ms / 1e9:.0f} TFLOP/s; library (scaled_dot_product_attention, boolean "
            f"band mask, efficient/cudnn backends): {lib}")
        if r == 1:
            check(ms <= 0.30 * t4_self, f"band r=1 {ms:.3f} ms > 0.30 x dense {t4_self:.3f}")
            record("attention", 0.0, ms,
                   cuda_ms(lambda: _sdpa_reference(
                       qsc.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 1.0, valid,
                       window=TemporalWindow(tpf, 1), q_chunk=1024), warmup=0, reps=1),
                   f"band mode r=1 (the w8a8_win1 path), [2,12,32768,128] tpf 1560 valid 32760 "
                   f"(errors above)", nbytes, ops, "bf16", library_ms=lib_ms)

    # a band over every frame pair is the dense function: the same tiles and
    # the same mask on the last one
    dense_kern = lambda: _flash_cuda(qsc, k, vh, 1.0, valid)
    wide_kern = lambda: _flash_cuda(qsc, k, vh, 1.0, valid, tokens_per_frame=tpf, radii=[20] * n)
    dense_out, wide_out = dense_kern(), wide_kern()
    attn_err(wide_out, dense_out, "band r=20 vs the dense launch")
    same = torch.equal(dense_out, wide_out)
    del dense_out, wide_out
    # in rounds of (dense, band, band, dense), each round's ratio from its own
    # four readings: under sustained tensor-core load the card's clock swings
    # by several percent over a few readings, so readings pooled across rounds
    # measure the swing, and a round's ratio cancels a linear drift within it
    for _ in range(10):
        dense_kern()
    ratios, dense_t, wide_t = [], [], []
    for _ in range(12):
        d1 = cuda_ms(dense_kern, warmup=1, reps=3)
        w = cuda_ms(wide_kern, warmup=1, reps=3) + cuda_ms(wide_kern, warmup=0, reps=3)
        d2 = cuda_ms(dense_kern, warmup=0, reps=3)
        ratios.append(w / (d1 + d2))
        dense_t.append((d1 + d2) / 2)
        wide_t.append(w / 2)
    ratio = sorted(ratios)[len(ratios) // 2]
    log(f"  attention band r=20 (every frame pair), 12 rounds of (dense, band, band, dense): "
        f"median round ratio {ratio:.4f} (of {', '.join(f'{x:.3f}' for x in ratios)}); band "
        f"{sorted(wide_t)[6]:.3f} ms, dense {sorted(dense_t)[6]:.3f} ms (median round means); "
        f"equal bits: {same}")
    check(abs(ratio - 1) <= 0.05, f"band r=20 vs dense: median round ratio {ratio:.4f}, more "
          f"than 5% apart")
    log(f"  band checks: {time.time() - t_band:.1f} s")


def gelu_quant_check(torch, record, kernel, operands, m, ragged, bf16_ms):
    """The GELU + quant mode of ``kernel`` (K2 ``w8a8_linear`` or K8
    ``w4a8_linear``) at ffn.0's shape (1536 -> 8960 or, at 14B, 5120 ->
    13824; M = 65536) against its
    plain chain (the plain GEMM with a bf16 output, tanh-GELU in f32,
    static-scale int8 quant, row sums). Limits, stated before the first run:
    codes equal (every step of the epilogue is the plain chain's own
    arithmetic: exact int32 sum, _rn dequant, bf16 rounding, PyTorch's GELU
    expression, a true division, rint); the scaled row sums exactly the sums
    of the kernel's own codes; s2 and sm2 equal to the plain version's. Also
    at ragged M, where rows past M must add nothing to the sums."""
    from wanq_tpu_torch.ops import qgemm

    cuda_fn = getattr(qgemm, f"{kernel}_gelu_quant_cuda")
    plain_fn = getattr(qgemm, f"{kernel}_gelu_quant_plain")
    tag = "K2" if kernel == "w8a8_linear" else "K8"
    a, w, s_a, s_w, sum_a, zp, bias = operands  # max(ragged) rows
    k, n = a.shape[1], w.shape[0]
    scale2 = torch.tensor(0.021, device=a.device)  # ~ absmax / 127 of the GELU output
    for mm in (m, *ragged):
        ops = (a[:mm], w, s_a[:mm], s_w, scale2, sum_a[:mm], zp, bias)
        got = cuda_fn(*ops)
        want = plain_fn(*ops)
        torch.cuda.synchronize()
        ndiff = (got[0] != want[0]).sum().item()
        own = torch.equal(got[2], scale2 * got[0].float().sum(-1))
        check(ndiff == 0 and own and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
              f"{tag} gelu+quant M={mm}: {ndiff} codes differ, row sums of own codes equal: {own}")
        sat = (got[0].abs() >= 127).float().mean().item()
        del got, want
    ops = (a[:m], w, s_a[:m], s_w, scale2, sum_a[:m], zp, bias)
    ms = cuda_ms(lambda: cuda_fn(*ops))
    wide = n > 8960  # a 14B site: one timed call of the plain chain
    record(kernel, 0.0, ms, cuda_ms(lambda: plain_fn(*ops), warmup=0 if wide else 2,
                                    reps=1 if wide else 3),
           f"GELU + quant mode M=65536 K={k} N={n} int8 out + row sums, codes, s2 and sm2 equal "
           f"also at M={', '.join(str(r) for r in ragged)} "
           f"({2 * m * k * n / ms / 1e9:.0f} TOP/s; "
           f"{ms / bf16_ms:.3f} x the bf16-out mode; codes at +-127: {sat:.3f})",
           m * k + w.numel() + m * n + 12 * m + 12 * n + 4, 2 * m * k * n, "int8",
           summed=not wide)


def int8_attention_checks(torch, record, q, k, vh, valid, qs, t4_self):
    """K10a and K10 at the w8a8_attn path's shape, on the bf16 q/k/v of the
    K4 self-attention check (pad k rows zero, pad v rows 100). Limits, stated
    before the first run: K10a scales and codes equal its plain version's
    exactly; K10 against its blocked plain version rel-L2 <= 1e-3 and
    <= 1e-4 of elements further than one prob step (max|want| / 127) apart;
    K10 against K4 on the same bf16 operands rel-L2 < 0.08 and max abs error
    < 0.3 of max|K4| (wanq_tpu's test holds 0.15 at S = 256; at 32760 flat
    keys the function itself reads 0.20, see the comment at the check)."""
    from wanq_tpu_torch.models.attention import _flash_cuda
    from wanq_tpu_torch.ops.attn_int8 import (
        attention_int8, attention_int8_blocked, attention_int8_cuda, v_from_kernel_layout)

    b, n, s, d = q.shape
    k = k.clone()
    k[:, :, valid:] = 3.0   # pad k rows that would win the softmax if unmasked
    views = (q, k, vh)      # [B, H, S, D]; vh strided over [B, S, H*D]
    got = k10a_check(torch, record, views, "q/k/v [2,12,32768,128] bf16 views")
    copy_note(torch, q, k, vh)

    qi, ki, vt, s_q, s_k, s_v = got
    kern = lambda: attention_int8_cuda(qi, ki, vt, s_q, s_k, s_v, qs, valid)
    out = kern().transpose(1, 2)
    torch.cuda.synchronize()
    vi = v_from_kernel_layout(vt)
    plain = lambda: attention_int8_blocked(qi, ki, vi, s_q, s_k, s_v, qs, valid, q_chunk=8192)
    ref = plain()
    err = (out - ref).abs().max().item()
    rel = ((out - ref).norm() / ref.norm()).item()
    far = ((out - ref).abs() > ref.abs().max() / 127).float().mean().item()
    check(bool(torch.isfinite(out).all()) and rel <= 1e-3 and far <= 1e-4,
          f"K10 vs blocked plain: rel-L2 {rel:.3e}, {far:.3e} of elements beyond one step")
    ms = cuda_ms(kern, warmup=1, reps=3)
    ops = 4 * b * n * s * valid * d
    record("attention_int8", err, ms, cuda_ms(plain, warmup=0, reps=1),
           f"[2,12,32768,128] int8 valid 32760, pad k/v planted, all heads (rel-L2 {rel:.2e}; "
           f"beyond one step {far:.1e}; {ops / ms / 1e9:.0f} TOP/s; K10 / K4 self "
           f"{ms / t4_self:.3f})",
           3 * b * n * s * d + (2 * s // 512 + d) * b * n * 4 + 4 * b * n * s * d, ops, "int8")
    del ref, vi, out, qi, ki, vt

    # the wrapper (K10a + K10) against K4 on the same bf16 operands. v's scale
    # is per channel over ALL rows, the pad tail included (as in wanq_tpu), so
    # the 100s planted above would cost v 5 of its 7 bits: here the pad rows of
    # v hold 3.0, inside the range of the valid rows
    v3 = vh.clone()
    v3[:, :, valid:] = 3.0
    y8 = attention_int8(q.transpose(1, 2), k.transpose(1, 2), v3.transpose(1, 2),
                        sm_scale=qs, k_valid_len=valid)
    y4 = _flash_cuda(q, k, v3, qs, valid).float()
    rel_max = ((y8 - y4).abs().max() / y4.abs().max()).item()
    rel_l2 = ((y8 - y4).norm() / y4.norm()).item()
    # At 32760 flat keys (scores ~N(0,1)) a typical prob is ~3/127 of its row's
    # maximum, so its rounding error is large and only averages out over the
    # keys: rel-L2 ~0.05 and a largest error of ~0.2 max|K4| are the function's
    # own (K10 equals its plain version above). The 0.15 that wanq_tpu's test
    # holds at S = 256 is held at S = 700 by tests/test_torch_cuda.py.
    log(f"  attention_int8 (K10a + K10) vs K4 on the same bf16 q/k/v: max abs err / max|K4| "
        f"{rel_max:.4f} (limit 0.3), rel-L2 {rel_l2:.4f} (limit 0.08)")
    check(rel_max < 0.3 and rel_l2 < 0.08,
          f"K10 vs K4: max abs relative error {rel_max}, rel-L2 {rel_l2}")
    del y8, y4, v3, got, s_q, s_k, s_v
    torch.cuda.empty_cache()

    # K10a at the T2V-14B 720p shape (40 heads, 75776 tokens) and the same views
    g14 = torch.Generator(device=q.device).manual_seed(14)
    q14, k14 = (torch.randn((b, 40, 75776, d), device=q.device, generator=g14).bfloat16()
                for _ in range(2))
    v14 = torch.randn((b, 75776, 40 * d), device=q.device, generator=g14).bfloat16()
    v14 = v14.view(b, 75776, 40, d).transpose(1, 2)
    k10a_check(torch, record, (q14, k14, v14), "q/k/v [2,40,75776,128] bf16 views (T2V-14B 720p)")
    copy_note(torch, q14, k14, v14)
    del q14, k14, v14
    torch.cuda.empty_cache()


def copy_note(torch, *xs):
    """A note beside the memory-bound kernels: what a plain copy of the
    tensors xs (PyTorch's clone: every byte read once and written once)
    reaches on this card, the practical rate of device memory for a stream
    that reads and writes alike. The kernels' bounds stay the published
    3.35 TB/s."""
    ms = cuda_ms(lambda: [x.clone() for x in xs], reps=9)
    nbytes = 2 * sum(x.numel() * x.element_size() for x in xs)
    what = " + ".join(f"{list(x.shape)} {str(x.dtype)[6:]}" for x in xs)
    log(f"  note: torch clone of {what} ({nbytes / 1e6:.1f} MB read and written): {ms:.3f} ms, "
        f"{nbytes / ms / 1e6:.0f} GB/s")


def k10a_check(torch, record, views, detail):
    """K10a on bf16 [B, H, S, 128] views against its plain version: scales
    and codes equal, stated before the first run. Its bound reads q, k and v
    once; the kernel reads v twice, and the bytes it moves are printed beside
    the bound's."""
    from wanq_tpu_torch.ops.attn_int8 import (
        quantize_qkv_int8_cuda, quantize_qkv_int8_plain, quantize_qkv_int8_traffic,
        v_kernel_layout)

    b, n, s, d = views[0].shape
    got = quantize_qkv_int8_cuda(*views)
    want = quantize_qkv_int8_plain(*views)
    torch.cuda.synchronize()
    same = all(torch.equal(got[i], want[i]) for i in (0, 1, 3, 4, 5))
    same = same and torch.equal(got[2], v_kernel_layout(want[2]))
    check(same, f"K10a {detail}: scales or codes differ from the plain version")
    del want
    torch.cuda.empty_cache()
    bound, moved = quantize_qkv_int8_traffic(b, n, s, d)
    ms = cuda_ms(lambda: quantize_qkv_int8_cuda(*views), reps=9)
    # ten calls between one pair of events: the wrapper's host time of the
    # later calls hides behind the card's work, as it does in a forward
    ms10 = cuda_ms(lambda: [quantize_qkv_int8_cuda(*views) for _ in range(10)], reps=5) / 10
    record("quantize_qkv_int8", 0.0, ms,
           cuda_ms(lambda: quantize_qkv_int8_plain(*views), warmup=1, reps=3),
           f"{detail} -> int8 + scales (codes and scales equal; moves {moved / 1e6:.1f} MB, "
           f"v read twice, {moved / ms / 1e6:.0f} GB/s; ten calls back to back {ms10:.3f} ms a "
           f"call, {moved / ms10 / 1e6:.0f} GB/s; aim <= 1.7x the bound)",
           bound, 6 * 3 * b * n * s * d, "f32")
    return got


def gelu_table_check(torch):
    """K7 takes the GELU of a bf16 x from a table of 1 + tanh(inner) that each
    block builds with the kernels' gelu_tanh_factor, and from the identities
    f = 1, 2, 0 outside it: all 65536 bf16 inputs (NaNs and infinities too)
    must give the kernels' gelu_tanh bit for bit (a NaN only where it gives
    NaN). PyTorch's own CUDA GELU on the same values is printed beside it."""
    from wanq_tpu_torch.ops.fused import gelu_bf16_table_check

    table, direct = gelu_bf16_table_check()
    torch.cuda.synchronize()
    nan = torch.isnan(direct)
    same_nan = torch.equal(torch.isnan(table), nan)
    differ = (table[~nan].view(torch.int32) != direct[~nan].view(torch.int32)).sum().item()
    x = torch.arange(65536, device=table.device, dtype=torch.int32).to(torch.int16)
    x = x.view(torch.bfloat16).float()
    ref = torch.nn.functional.gelu(x, approximate="tanh")
    fin = torch.isfinite(ref) & ~nan
    vs_torch = (table[fin].view(torch.int32) != ref[fin].view(torch.int32)).sum().item()
    log(f"  quant_sum GELU table, all 65536 bf16 inputs: {differ} differ from gelu_tanh "
        f"(NaN where it gives NaN: {same_nan}, {int(nan.sum())} NaNs); against torch's CUDA "
        f"GELU on the {int(fin.sum())} finite ones: {vs_torch} differ")
    check(same_nan and differ == 0, f"K7 GELU table: {differ} values differ, NaNs agree {same_nan}")


def viditq_checks(torch, g, record):
    """The viditq path's shapes ([2, 32768, 1536], M = 65536 rows):
    K7 on the f32 rotated rows without GELU, without and with a
    channel_scale (a mask-only SmoothQuant site), codes and scales equal to
    the plain version's and sums within rel 1e-6 (stated before the first
    run: without GELU every step is the plain version's own f32 arithmetic);
    K1 with a channel_scale (the masked ffn.0 of a smooth_quant config),
    K1's limits; the f32 rotation product x @ Q by torch.mm with TF32 off
    (a library product on the path, as in the JAX package, timed against its
    bound and held to an f64 product); one whole viditq site (x * mask @ Q,
    K7, K2) through qlinear; and rotate_weight_fwht, PTQ's f64 weight
    rotation, at 1536 x 1536 and 8960 x 1536, equal to the CPU's."""
    from wanq_tpu_torch.ops.fused import (
        ln_modulate_quant_cuda, ln_modulate_quant_plain, quant_sum_cuda, quant_sum_plain)
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.hadamard import rotate_weight_fwht, rotation_for_dim
    from wanq_tpu_torch.quant.ptq import prepare_quant_state
    from wanq_tpu_torch.quant.qlinear import QuantCtx, qlinear

    dev = torch.device("cuda")
    b, s, c = 2, 32768, 1536
    rows = b * s
    cs = torch.rand((c,), device=dev, generator=g) + 0.5
    x = torch.randn((b, s, c), device=dev, generator=g) * 2 + 0.2
    for scale in (None, cs):
        got, want = quant_sum_cuda(x, channel_scale=scale), quant_sum_plain(x, channel_scale=scale)
        torch.cuda.synchronize()
        s_rel = ((got[2] - want[2]).abs() / want[2].abs().clamp_min(1e-30)).max().item()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and s_rel <= 1e-6,
              f"K7 f32 channel_scale={scale is not None}: codes or scales differ, sum rel {s_rel}")
        del got, want
        ms = cuda_ms(lambda: quant_sum_cuda(x, channel_scale=scale), reps=9)
        nbytes = x.numel() * 5 + rows * 8 + (0 if scale is None else 4 * c)
        record("quant_sum", 0.0, ms,
               cuda_ms(lambda: quant_sum_plain(x, channel_scale=scale), reps=3),
               f"[2,32768,1536] f32 gelu=False channel_scale={scale is not None} (the viditq "
               f"site's rotated rows; codes and scales equal; {nbytes / ms / 1e6:.0f} GB/s; "
               f"not summed into the kernels line)",
               nbytes, (7 if scale is not None else 6) * x.numel(), "f32", summed=False)

    # K1 with a channel_scale, x [2, 32768, 1536] bf16 (smooth_quant ffn.0)
    xb = (torch.randn((b, s, c), device=dev, generator=g) * 2 + 0.3).bfloat16()
    shift = torch.randn((b, c), device=dev, generator=g) * 0.5
    smod = torch.randn((b, c), device=dev, generator=g) * 0.5
    got = ln_modulate_quant_cuda(xb, shift, smod, channel_scale=cs)
    want = ln_modulate_quant_plain(xb, shift, smod, channel_scale=cs)
    torch.cuda.synchronize()
    diff = (got[0].int() - want[0].int()).abs()
    frac = (diff > 0).float().mean().item()
    check(diff.max().item() <= 1 and frac <= 1e-3,
          f"K1 channel_scale codes differ: max {diff.max()}, {frac}")
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    err = (got[0].float() * got[1][..., None] - want[0].float() * want[1][..., None]).abs().max()
    del got, want, diff
    record("ln_modulate_quant", err.item(),
           cuda_ms(lambda: ln_modulate_quant_cuda(xb, shift, smod, channel_scale=cs)),
           cuda_ms(lambda: ln_modulate_quant_plain(xb, shift, smod, channel_scale=cs), reps=3),
           f"[2,32768,1536] bf16 with channel_scale (codes differing: {frac:.2e}; not summed "
           f"into the kernels line)",
           b * s * c * 3 + b * s * 8 + 2 * b * c * 4 + 4 * c, 11 * b * s * c, "f32",
           summed=False)

    # the rotation product, f32 [65536, 1536] x [1536, 1536]
    rot = rotation_for_dim(c, seed=0, device=dev)
    x2 = x.reshape(rows, c)
    y = torch.mm(x2, rot)
    ref = (x2[:4096].double() @ rot.double()).float()
    rel = ((y[:4096] - ref).norm() / ref.norm()).item()
    check(rel <= 1e-6, f"rotation product rel-L2 {rel} against f64 (TF32 on?)")
    ms = cuda_ms(lambda: torch.mm(x2, rot))
    ops, nbytes = 2 * rows * c * c, 2 * rows * c * 4 + c * c * 4
    bound = max(ops / PEAK_OPS["f32"], nbytes / HBM_BPS) * 1e3
    log(f"  rotation product x @ Q (torch.mm, f32, TF32 off) [65536,1536] x [1536,1536]: "
        f"{ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s), bound {bound:.3f} ms ({ops / 1e12:.3f} T f32 "
        f"ops over 67 TFLOP/s; {nbytes / 1e6:.1f} MB) -> {ms / bound:.2f}x; rel-L2 vs f64 "
        f"{rel:.2e}; a library product on the viditq path (3 a block), no kernel of the port")
    del y, ref

    # one viditq site through qlinear: bf16 x -> x * mask @ Q -> K7 -> K2 (f32 out)
    w = torch.randn((c, c), device=dev, generator=g) * 0.03
    qcfg = QuantConfig.from_dict({"weight": {"n_bits": 8, "sym": False},
                                  "act": {"n_bits": 8, "sym": True},
                                  "viditq": {"alpha": 0.5665, "layer_name_regex": ""}})
    calib = {"lin": xb.float().abs().reshape(rows, c).amax(0).cpu().numpy()[None]}
    pol, st, rots = prepare_quant_state({"lin": {"w": w}}, ["lin"], qcfg, calib=calib,
                                        targets="int8")
    ctx = QuantCtx(mode="int8", policies=pol, state=st, rotations=rots)
    ms_site = cuda_ms(lambda: qlinear(ctx, "lin", {"w": w}, xb))
    log(f"  one viditq site (qlinear: x * mask @ Q, K7 on the f32 rows, K2 1536 -> 1536 f32 "
        f"out) [2,32768,1536] bf16: {ms_site:.3f} ms; the rotation product {ms:.3f} ms of it")
    del x, x2, xb, w, st, ctx
    torch.cuda.empty_cache()

    # PTQ's f64 weight rotation on the card against the CPU
    for k_in, n_out in ((1536, 1536), (8960, 1536)):
        wr = torch.randn((k_in, n_out), device=dev, generator=g)
        got = rotate_weight_fwht(wr, 17)
        same = torch.equal(got.cpu(), rotate_weight_fwht(wr.cpu(), 17))
        check(same, f"rotate_weight_fwht [{k_in},{n_out}] card != CPU")
        ms = cuda_ms(lambda: rotate_weight_fwht(wr, 17))
        log(f"  rotate_weight_fwht [{k_in},{n_out}] f64 on the card: {ms:.3f} ms, equal to the "
            f"CPU's in f32")
        del wr, got
    torch.cuda.empty_cache()


def int4_checks(torch, g, record):
    """K7, K8 (all three modes) and K9 against their plain versions at the
    4-bit paths' shapes (M = 65536 token rows), plus ragged-M tails for K8
    and K9."""
    from wanq_tpu_torch.ops.fused import quant_sum_cuda, quant_sum_plain
    from wanq_tpu_torch.ops.qgemm import (
        w4a4_linear_cuda, w4a4_linear_plain, w4a8_linear_cuda, w4a8_linear_plain)

    dev = torch.device("cuda")
    m = 2 * 32768

    # K7 -- the ffn.2 input [2, 32768, 8960] with GELU, the o input
    # [2, 32768, 1536] without, the 14B ffn.2 input [2, 32768, 13824] with
    # GELU and the 14B o input [2, 32768, 5120] without, bf16. Codes equal
    # except <= 0.1% one-unit flips (the kernels' GELU
    # and torch's may differ by ulps); scale rel <= 1e-6; sum rel <= 1e-6 on rows
    # whose codes agree.
    gelu_table_check(torch)
    for c, gelu in ((8960, True), (1536, False), (13824, True), (5120, False)):
        x = (torch.randn((2, 32768, c), device=dev, generator=g) * 2 + 0.2).bfloat16()
        got, want = quant_sum_cuda(x, gelu), quant_sum_plain(x, gelu)
        torch.cuda.synchronize()
        diff = (got[0].int() - want[0].int()).abs()
        frac = (diff > 0).float().mean().item()
        check(diff.max().item() <= 1 and frac <= 1e-3,
              f"K7 C={c} gelu={gelu}: codes differ by {diff.max().item()} on {frac:.2e}")
        s_rel = ((got[1] - want[1]).abs() / want[1]).max().item()
        same = diff.amax(dim=-1) == 0
        sum_bad = ((got[2] - want[2]).abs() > 1e-6 * want[2].abs())[same].sum().item()
        check(s_rel <= 1e-6 and sum_bad == 0,
              f"K7 C={c}: scale rel {s_rel:.2e}, {sum_bad} sums off by > 1e-6 rel")
        err = (got[0].float() * got[1][..., None] - want[0].float() * want[1][..., None])
        err = err.abs().max().item()
        del got, want, diff
        ms = cuda_ms(lambda: quant_sum_cuda(x, gelu), reps=9)
        gbs = x.numel() * 3 / ms / 1e6
        record("quant_sum", err, ms, cuda_ms(lambda: quant_sum_plain(x, gelu), reps=3),
               f"[2,32768,{c}] bf16 gelu={gelu} (codes differing: {frac:.2e}, scale rel "
               f"{s_rel:.1e}; {gbs:.0f} GB/s)",
               x.numel() * 3 + 2 * 32768 * 8, (20 if gelu else 6) * x.numel(), "f32",
               summed=c != 5120)
        if c == 8960:
            copy_note(torch, x)
        del x
        torch.cuda.empty_cache()

    def operands(k, n, int4_a):
        mm = m + 3
        lo, hi = (-8, 8) if int4_a else (-128, 128)
        a = torch.randint(lo, hi, (mm, k), device=dev, generator=g, dtype=torch.int8)
        wp = torch.randint(-128, 128, (n, k // 2), device=dev, generator=g, dtype=torch.int8)
        return a, wp

    # K8 -- the three (K, N) of the W4A8 paths, each in the out type its site
    # has (q/k/v and ffn.0 bf16, ffn.2 f32), asymmetric weights with bias:
    # exact in both out types, also at ragged M. Then its GELU + quant mode at
    # ffn.0's shape against the plain chain.
    from wanq_tpu_torch.quant.quantizers import unpack_int4

    for k, n, out_name in GEMM_SHAPES:
        out_dtype, wide = getattr(torch, out_name), 5120 in (k, n)  # wide: a 14B site
        ragged = (m + 3,) if wide else (m - 8, m + 3)
        a, wp = operands(k, n, False)
        s_a = torch.rand((a.shape[0],), device=dev, generator=g) * 0.02 + 1e-3
        sum_a = s_a * a.float().sum(-1)
        s_w = torch.rand((n,), device=dev, generator=g) * 0.3 / k ** 0.5 + 1e-4
        zp = torch.randint(0, 16, (n,), device=dev, generator=g).float()
        bias = torch.randn((n,), device=dev, generator=g)
        for mm in (m, *ragged):
            for dt in ((out_dtype,) if wide else (torch.bfloat16, torch.float32)):
                args = (a[:mm], wp, s_a[:mm], s_w, sum_a[:mm], zp, bias, dt)
                got, want = w4a8_linear_cuda(*args), w4a8_linear_plain(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                check(torch.equal(got, want), f"K8 M={mm} ({k},{n}) {dt}: max abs err {err}")
                del got, want
        args = (a[:m], wp, s_a[:m], s_w, sum_a[:m], zp, bias, out_dtype)
        ms = cuda_ms(lambda: w4a8_linear_cuda(*args))
        wt = unpack_int4(wp).t()
        t_mm = cuda_ms(lambda: torch._int_mm(a[:m], wt))
        record("w4a8_linear", err, ms, cuda_ms(lambda: w4a8_linear_plain(*args),
                                               warmup=0 if wide else 2, reps=1 if wide else 3),
               f"M=65536 K={k} N={n} {out_name} out, exact "
               f"{'at M=65539 too' if wide else 'in both out types also at M=65528 and 65539'} "
               f"({2 * m * k * n / ms / 1e9:.0f} TOP/s; note: torch._int_mm, the "
               f"bare int8 product on the unpacked weight with an int32 output, {t_mm:.3f} ms)",
               m * k + n * k // 2 + m * n * (2 if out_dtype == torch.bfloat16 else 4)
               + 8 * m + 12 * n, 2 * m * k * n, "int8", summed=not wide)
        if n in (8960, 13824):
            gelu_quant_check(torch, record, "w4a8_linear", (a, wp, s_a, s_w, sum_a, zp, bias), m,
                             ragged, ms)
        del a, wp, wt, args
        torch.cuda.empty_cache()

    # K9 -- the W4A4 sites: (1536 -> 1536) x6, (1536 -> 8960), (8960 -> 1536),
    # f32 out with bias: exact
    for k, n in ((1536, 1536), (1536, 8960), (8960, 1536)):
        a, wp = operands(k, n, True)
        s_a = torch.rand((a.shape[0], k // 128), device=dev, generator=g) * 0.02 + 1e-3
        s_w = torch.rand((k // 128, n), device=dev, generator=g) * 0.02 + 1e-3
        bias = torch.randn((n,), device=dev, generator=g)
        for mm in ((m, m - 8, m + 3) if k == n else (m,)):
            args = (a[:mm], wp, s_a[:mm], s_w, bias)
            got, want = w4a4_linear_cuda(*args), w4a4_linear_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(torch.equal(got, want), f"K9 M={mm} ({k},{n}): max abs err {err}")
            del got, want
        args = (a[:m], wp, s_a[:m], s_w, bias)
        ms = cuda_ms(lambda: w4a4_linear_cuda(*args))
        record("w4a4_linear", err, ms, cuda_ms(lambda: w4a4_linear_plain(*args), reps=3),
               f"M=65536 K={k} N={n} f32 out"
               f"{', exact also at M=65528 and 65539' if k == n else ''} "
               f"({2 * m * k * n / ms / 1e9:.0f} TOP/s)",
               m * k + n * k // 2 + 4 * m * n + 4 * (m + n) * (k // 128) + 4 * n,
               2 * m * k * n, "int8")
        del a, wp, args
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 3-4
# ---------------------------------------------------------------------------


def cli_args(yaml, extra, task=TASK, size=SIZE, frames=FRAMES):
    return ["--task", task, "--size", size, "--frame_num", str(frames), "--random_init",
            "--quant_config", yaml, "--device", "cuda", *extra]


def calibrate(torch, task=TASK, yaml=YAML, extra=(), tag=None, size=SIZE, frames=FRAMES):
    """get_calib_data --collect_minmax, 1 batched step at 480p: the static
    ffn.2 scale of the task's paths (at 14B it serves 720p too: the scale is
    per tensor) comes from it. ``extra`` flags (a path's own recipe,
    CALIB_FLAGS) write ``calib_data_<tag>.npz``; with --collect_hessian the
    number of Hessians and their bytes are printed and the count checked
    against the regex's sites."""
    import re

    import numpy as np

    from wanq_tpu_torch.cli import get_calib_data
    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.models.dit import linear_layer_names
    from wanq_tpu_torch.ops import _lib

    calib_path = str(OUT / f"calib_data_{tag or task}.npz")
    t0 = time.time()
    _lib.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    get_calib_data.generate(get_calib_data.parse_args(cli_args(yaml, [
        "--collect_minmax", "--sample_steps", "1", "--calib_save_path", calib_path,
        *extra], task, size, frames)))
    torch.cuda.synchronize()
    log(f"  get_calib_data {task} {' '.join(extra)} (1 step a round, incl. random init on the "
        f"card): {time.time() - t0:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{_lib.launch_counts()} (calibration runs FP; K13 adds the residual updates)")
    if "--collect_hessian" in extra:
        regex = extra[extra.index("--collect_hessian") + 1]
        want = [n for n in linear_layer_names(WAN_CONFIGS[task]) if re.search(regex, n)]
        with np.load(calib_path) as d:
            shapes = {k: d[k].shape for k in d.files if k.endswith(".hess")}
        nbytes = sum(4 * a * b for a, b in shapes.values())
        log(f"  {len(shapes)} Hessian sites ({len(want)} match {regex!r}), [C_in, C_in] f32: "
            f"{nbytes / 1e9:.3f} GB, summed on the card and saved in the npz "
            f"({os.path.getsize(calib_path) / 1e9:.3f} GB with the absmax and min/max stacks)")
        check(sorted(shapes) == sorted(f"{n}.hess" for n in want),
              f"Hessian sites {len(shapes)} != the regex's {len(want)}")
    return calib_path


def step_actions(label, args, lat_file, steps):
    """The actions of each denoise step of a path's run, checked against the
    policy its arguments and quant config give (cache_policy_from_args, as
    quant_generate builds it; a capacity plan has no cache: section): all
    'full' without a step cache; a static
    schedule equal to StepCachePolicy.plan; an adaptive one equal to
    simulate_adaptive_actions replayed on the run's own drifts (the trace
    saved beside the latents)."""
    from wanq_tpu_torch.cli.common import cache_policy_from_args
    from wanq_tpu_torch.cli.quant_generate import quant_config_from_args
    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.pipelines.text2video import (
        AdaptiveCachePolicy, simulate_adaptive_actions)

    pol = cache_policy_from_args(args, quant_config_from_args(args, WAN_CONFIGS[args.task]))
    stats = json.loads(str(lat_file["cache_stats"])) if "cache_stats" in lat_file else None
    if pol is None:
        acts = ["full"] * steps
    elif not isinstance(pol, AdaptiveCachePolicy):
        acts = pol.plan(steps)
    else:
        trace = json.loads(str(lat_file["cache_trace"]))
        drifts, acts = [0.0] * steps, ["full"] * steps
        for e in trace:
            drifts[e["step"]], acts[e["step"]] = e["d"], e["act"]
        replay = simulate_adaptive_actions(pol, drifts)
        if trace:
            log(f"  [{label}] adaptive trace ({pol}): " + "; ".join(
                f"step {e['step']} d {e['d']:.4f} acc {e['acc']:.4f} {e['act']}"
                + (f" o {e['o']:.4f}" if "o" in e else "") for e in trace))
            log(f"  [{label}] simulate_adaptive_actions on the trace's drifts: {replay}")
        check(replay == acts, f"{label}: the loop's actions {acts} != the replay {replay}")
    if pol is not None:
        check(stats == {a: acts.count(a) for a in ("full", "cond", "reuse")},
              f"{label}: cache_stats {stats} != the actions {acts}")
    return acts


def run_path(torch, label, launches, calib_path=None):
    """quant_generate (--hardware unless the path is simulated) under the
    path's YAML, task, size, steps and flags (RUNS); the launch counts are
    reset just before and read just after, and must equal the per-block
    counts x the layers x the forwards the step actions took (a full step one
    batched forward or, under sequential CFG, two; a cond step one B-sized
    forward, the same launches; a reuse step none). Returns the mean step
    time and the latents after the first step (on the host)."""
    import numpy as np

    from wanq_tpu_torch.cli import ptq, quant_generate
    from wanq_tpu_torch.configs import SIZE_CONFIGS, WAN_CONFIGS
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.pipelines.text2video import compute_target_shape

    yaml, per_block = PATHS[label]
    run = RUNS.get(label, {})
    task, size, steps = run.get("task", TASK), run.get("size", SIZE), run.get("steps", STEPS)
    frames = run.get("frames", FRAMES)
    flags = list(run.get("flags", ()))
    cfg = WAN_CONFIGS[task]
    lat_path = str(OUT / f"latents_{label}.npz")
    marks, first = [], []
    if "--auto_bits_gib" in flags:
        plan_check(cfg, float(flags[flags.index("--auto_bits_gib") + 1]))

    def on_step(i, t, latents):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if i == 0:
            first.append(latents.cpu())

    extra = ["--calib_data", calib_path] if calib_path else []
    if label in PTQ_PATHS:
        # the ptq stage writes the artifact that quant_generate deploys
        art = str(OUT / f"quant_params_{label}.npz")
        _lib.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with timed_gptq(torch) as solves:
            ptq.generate(ptq.parse_args(cli_args(yaml, extra + ["--save_path", art], task, size,
                                                 frames)))
        torch.cuda.synchronize()
        log(f"  [{label}] cli.ptq {yaml} (incl. random init and the npz write): "
            f"{time.time() - t0:.1f} s, {os.path.getsize(art) / 2**20:.1f} MiB; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"{_lib.launch_counts()}")
        if solves:
            log(f"  [{label}] GPTQ solves on the card: {sum(map(len, solves.values()))} sites, "
                f"{sum(map(sum, solves.values())):.2f} s in all; by [C_in, C_out]: " + "; ".join(
                    f"{k}x{n}: {len(ts)} x {sum(ts) / len(ts):.3f} s" for (k, n), ts in
                    sorted(solves.items())))
        check(not _lib.launch_counts(), f"{label}: PTQ launched {_lib.launch_counts()}")
        extra = ["--quant_params", art]
    hw = [] if label in SIM_PATHS else ["--hardware"]
    if label in WINDOWS:
        hw += ["--attn_window", str(WINDOWS[label])]
    hw += flags
    args = quant_generate.parse_args(cli_args(yaml, extra + [
        *hw, "--sample_steps", str(steps), "--save_file", lat_path], task, size, frames))
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    t0 = time.time()
    quant_generate.generate(args, on_step=on_step)
    counts = _lib.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # steps 2..steps, each from one step's end to the next's (synchronized)
    step_s = [marks[i + 1] - marks[i] for i in range(len(marks) - 1)]
    check(len(step_s) == steps - 1, f"expected {steps - 1} step intervals, got {len(step_s)}")
    lat_file = np.load(lat_path)
    acts = step_actions(label, args, lat_file, steps)
    full_s = [x for x, a in zip(step_s, acts[1:]) if a == "full"]
    mean = sum(full_s) / len(full_s)
    log(f"  [{label}] {yaml} {task} {size}x{frames}: quant_generate "
        f"{' '.join(hw + extra[:1] * (label in PTQ_PATHS)) or '(simulated)'} "
        f"({steps} steps, incl. random init + PTQ or the artifact's load): "
        f"{time.time() - t0:.1f} s; denoise step s (steps 2-{steps}): "
        f"{', '.join(f'{x:.3f} ({a})' for x, a in zip(step_s, acts[1:]))}; mean of the full "
        f"steps {mean:.3f} s")
    log(f"  [{label}] peak torch.cuda.max_memory_allocated: {peak / 2**30:.2f} GiB")
    log(f"  [{label}] launches: {counts}")
    sequential = "sequential" in flags
    forwards = sum({"full": 2 if sequential else 1, "cond": 1, "reuse": 0}[a] for a in acts)
    log(f"  [{label}] actions {acts}: {forwards} forwards of {cfg.num_layers} blocks")
    for name in (*SOURCES, *MODES, *ROW_COUNTERS):
        want = per_block.get(name, 0) * cfg.num_layers * forwards
        check(counts.get(name, 0) == want,
              f"{label}: {name} {counts.get(name, 0)} launches, want {want}")
    # a per-frame forward runs the time MLP on its two distinct timesteps
    # (frame 0's 0 and the step's t), none of one timestep a sample
    want = 2 * forwards if cfg.model_type == "ti2v" else 0
    check(counts.get("time_embedding_rows", 0) == want,
          f"{label}: time_embedding_rows {counts.get('time_embedding_rows', 0)}, want {want}")
    for name, cnt in counts.items():  # a mode's launches are its kernel's
        if name in ROW_COUNTERS or name == "time_embedding_rows":
            continue
        name = MODES.get(name, name)
        launches[name] = launches.get(name, 0) + cnt

    lat = lat_file["latents"]
    shape = (1, *compute_target_shape(cfg, SIZE_CONFIGS[size], frames))
    check(lat.shape == shape, f"{label}: latents shape {lat.shape}, want {shape}")
    check(bool(np.isfinite(lat).all()), f"{label}: non-finite latents")
    if cfg.model_type == "ti2v":  # image-to-video: frame 0 held to the seeded latent
        from wanq_tpu_torch.cli.common import conditioning

        z = conditioning(cfg, SIZE_CONFIGS[size], args.base_seed)["cond_latent"].numpy()
        check(np.array_equal(lat[0, :, :1], z), f"{label}: latent frame 0 not held")
        log(f"  [{label}] image-to-video: latent frame 0 equal to the conditioning latent")
    log(f"  [{label}] latents {lat.shape} finite, std {lat.std():.4f}")
    return mean, first[0]


def plan_check(cfg, gib):
    """The capacity plan of ``gib`` at the run's depth (``quant_generate
    --auto_bits_gib``) upgrades the classes that 9.5 GiB upgrades at all 40
    blocks of T2V-14B; both printed."""
    from wanq_tpu_torch.quant.planner import plan_capacity_bits

    plan = plan_capacity_bits(cfg, int(gib * 2**30))
    full = plan_capacity_bits(dataclasses.replace(cfg, num_layers=40), int(9.5 * 2**30))
    log(f"  {cfg.num_layers} blocks, {gib} GiB: {plan.report()}")
    log(f"  40 blocks, 9.5 GiB: {full.report()}")
    check(plan.upgraded == full.upgraded,
          f"the plan at {cfg.num_layers} blocks {plan.upgraded} != at 40 {full.upgraded}")


@contextlib.contextmanager
def timed_gptq(torch):
    """Wraps quant.ptq's gptq_quantize inside the block: each solve's seconds
    (synchronized host clock) by weight shape [C_in, C_out]."""
    from wanq_tpu_torch.quant import ptq as ptq_mod

    real, solves = ptq_mod.gptq_quantize, {}

    def timed(w, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(w, *a, **k)
        torch.cuda.synchronize()
        solves.setdefault(tuple(w.shape), []).append(time.perf_counter() - t0)
        return out

    ptq_mod.gptq_quantize = timed
    try:
        yield solves
    finally:
        ptq_mod.gptq_quantize = real


def cfg_mode_check(torch, first):
    """w8a8's first denoise step with sequential CFG (two B-sized forwards)
    against the batched one (one [2B] forward), from the same weights, noise
    and calibration: rel-L2 <= 1e-3 (a B-sized and a 2B-sized cuBLAS GEMM at
    the FP sites may sum in another order; the int kernels treat rows alike);
    whether the bits are equal is printed."""
    a, b = first["w8a8"].double(), first["w8a8_seq"].double()
    rel = ((a - b).norm() / a.norm()).item()
    log(f"  w8a8 first step, sequential vs batched CFG: rel-L2 {rel:.3e}; equal bits: "
        f"{torch.equal(first['w8a8'], first['w8a8_seq'])}")
    check(rel <= 1e-3, f"sequential CFG {rel:.3e} rel-L2 from batched")


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


def psnr_cos(want, got):
    """PSNR over want's range and cosine of two float64 arrays."""
    import numpy as np

    rng = float(want.max() - want.min()) or 1.0
    psnr = 10 * np.log10(rng ** 2 / float(np.mean((want - got) ** 2)))
    return psnr, float((want * got).sum() / np.linalg.norm(want) / np.linalg.norm(got))


KERNEL_NAMES = {"ln_mod_quant_kernel": "K1", "w8a8_gemm_kernel": "K2",
                "rms_rope_heads_kernel": "K3", "flash_fwd_kernel": "K4",
                "quant_sum_kernel": "K7", "w4a8_gemm_kernel": "K8", "w4a4_gemm_kernel": "K9",
                "attn_int8_kernel": "K10", "qkv_absmax_quant_kernel": "K10a",
                "v_quant_kernel": "K10a", "flash_bwd_dkv_kernel": "K11",
                "flash_bwd_dq_kernel": "K12", "gate_residual_kernel": "K13"}


def device_ops(events):
    """The device work among a ``torch.profiler`` trace's events: its CUDA
    events less the user annotations, which the program's spans
    (``wanq_tpu_torch/utils/trace.py``) put on the device's timeline around
    the kernels launched inside them."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_steps(torch, steps, ref="bf16"):
    """One CFG forward of each step function: its wall time unprofiled
    (host clock around a synchronized call, after a warm call) and the peak
    memory it allocates beyond what is held before it, then its device time
    by kernel under torch.profiler. The idle share is 1 - the
    union of device-activity intervals / the profiled call's wall time.
    The whole table goes to _smoke_out/profile_<label>.txt; each wall time
    is printed against that of ``ref``."""
    from torch.profiler import ProfilerActivity, profile

    walls, peaks = {}, {}
    for label, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[label] = (time.perf_counter() - t0) * 1e3
        # what the forward allocates beyond the weights and states held
        peaks[label] = (torch.cuda.max_memory_allocated() - held) / 2**30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        spans, by_name = [], {}
        for e in device_ops(prof.events()):
            t_us = e.time_range.end - e.time_range.start
            spans.append((e.time_range.start, e.time_range.end))
            tot = by_name.setdefault(e.name, [0.0, 0])
            tot[0] += t_us / 1e3
            tot[1] += 1
        if not spans:
            log(f"  profile {label}: wall {walls[label]:.1f} ms; the profiler saw no "
                "device activity, so device time and idle share are not measured")
            continue
        busy, end = 0.0, -math.inf
        for a, z in sorted(spans):
            if z > end:
                busy += z - max(a, end)
                end = z
        dev_ms = sum(t for t, _ in by_name.values())
        rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        with open(OUT / f"profile_{label}.txt", "w") as f:
            for name, (t, cnt) in rows:
                f.write(f"{t:10.3f} ms  n={cnt:5d}  {name}\n")
        log(f"  profile {label} (one CFG forward, t=999): wall {walls[label]:.1f} ms "
            f"unprofiled; device time {dev_ms:.1f} ms; idle share "
            f"{max(0.0, 1 - busy / 1e3 / prof_wall):.4f}; the forward's own peak "
            f"allocation {peaks[label]:.2f} GiB")
        ours = {}
        for name, (t, cnt) in rows:
            for sub, tag in KERNEL_NAMES.items():
                if sub in name:
                    if tag in ("K2", "K8") and ", 2>" in name:  # *_gemm_kernel<BN, mode 2>
                        tag += " gelu+quant"
                    sum_t, sum_n = ours.get(tag, (0.0, 0))
                    ours[tag] = (sum_t + t, sum_n + cnt)
        log("    hand kernels: " + ", ".join(
            f"{k} {t:.1f} ms ({100 * t / dev_ms:.1f}%, n={c})" for k, (t, c) in sorted(ours.items())))
        for name, (t, cnt) in rows[:8]:
            log(f"    {t:9.2f} ms {100 * t / dev_ms:5.1f}%  n={cnt:4d}  {name[:90]}")
    for label in walls:
        if label != ref:
            log(f"  {label} / {ref} forward wall time: {walls[label] / walls[ref]:.3f}")


def fidelity(torch, calib_path, gptq_calib_path):
    import numpy as np

    from wanq_tpu_torch.cli.common import load_contexts, load_params
    from wanq_tpu_torch.configs import WAN_CONFIGS, tiny_config
    from wanq_tpu_torch.models.dit import dit_forward, init_params, linear_layer_names
    from wanq_tpu_torch.pipelines.text2video import (
        WanT2V, compute_seq_len, compute_target_shape)
    from wanq_tpu_torch.models.params import attn_perms_from_numpy
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.attn import AttnQuantCfg
    from wanq_tpu_torch.quant.ptq import load_quant_state, prepare_quant_state, rebuild_rotations
    from wanq_tpu_torch.quant.qlinear import QuantCtx, fp_linear

    cfg = WAN_CONFIGS[TASK]
    args = argparse.Namespace(base_seed=42, device="cuda", context_file=None)
    params = load_params(args, cfg)
    context, context_null = (torch.from_numpy(a).cuda() for a in load_contexts(args, cfg))
    calib = dict(np.load(calib_path))
    names = linear_layer_names(cfg)
    ctxs = {}  # every path's quant state on the same weights
    sim_of = {}  # a PTQ path's sim-mode ctx on the same artifact
    for label in FIDELITY_13B:
        qcfg = QuantConfig.from_yaml(PATHS[label][0])
        mode = "sim" if label in SIM_PATHS else "int8"
        if label in PTQ_PATHS:
            # the artifact phase 3 deployed (written by cli.ptq from the same
            # seed-42 weights and calibration); the PTQ itself timed here
            # where it takes the shared calibration (phase 3 times GPTQ's)
            if label not in CALIB_FLAGS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prepare_quant_state(params, names, qcfg, calib=calib)
                torch.cuda.synchronize()
                n_q = sum(qcfg.resolve(n).is_quantized for n in names)
                log(f"  [{label}] prepare_quant_state on the card ({n_q} layers, targets both): "
                    f"{time.perf_counter() - t0:.3f} s")
            state, seed = load_quant_state(str(OUT / f"quant_params_{label}.npz"), device="cuda")
            policies = qcfg.resolve_all(names)
            rotations = rebuild_rotations(state, policies, seed)
            sim_of[label] = QuantCtx(mode="sim", policies=policies, state=state,
                                     rotations=rotations)
        else:
            policies, state, rotations = prepare_quant_state(params, names, qcfg, calib=calib,
                                                             targets=mode)
        ctxs[label] = QuantCtx(mode=mode, policies=policies, state=state, rotations=rotations,
                               attn=qcfg.attn_cfg, cross_attn=qcfg.cross_attn_cfg,
                               attn_window=WINDOWS.get(label))
    shape = compute_target_shape(cfg, (832, 480), FRAMES)
    seq_len = compute_seq_len(cfg, shape)
    g = torch.Generator(device="cuda").manual_seed(1)
    lat = torch.randn((1, *shape), generator=g, device="cuda")
    pipe = WanT2V(cfg, params, device="cuda")

    def step(ctx, guide=5.0):
        return pipe._step(lat, 999.0, context, context_null, guide, ctx, seq_len)

    # CFG 5 scales the (cond - uncond) difference, and with it the
    # quantization error of both halves, by 5; guide 1 is the conditional
    # prediction alone. The 4-bit gates: cosine >= 0.9 without CFG, and
    # >= 0.5 with it (an unrelated output scores ~0; RTN W4A4's CFG cosine
    # is far below its conditional one, see PERF.md Findings).
    failures = []
    # bf16, dense and with each windowed path's window (K4's band mode on both)
    fp_ctxs = {None: None, **{w: QuantCtx(mode="fp", attn_window=w) for w in WINDOWS.values()}}
    with torch.no_grad():
        fps = {w: {guide: step(c, guide).cpu().numpy().astype(np.float64) for guide in (5.0, 1.0)}
               for w, c in fp_ctxs.items()}
    preds = {}  # (label, guide) -> noise prediction, of w8a8 and w8a8_attn
    scores = {}  # label -> (PSNR, cosine) with CFG 5 and conditional
    for label, ctx in ctxs.items():
        res = {}
        for guide, fp64 in fps[WINDOWS.get(label)].items():
            with torch.no_grad():
                q64 = step(ctx, guide).cpu().numpy().astype(np.float64)
            if not np.isfinite(q64).all():
                failures.append(f"non-finite {label} noise prediction")
            res[guide] = psnr_cos(fp64, q64)
            if label in ("w8a8", "w8a8_attn", *PTQ_PATHS):
                preds[label, guide] = q64
            if guide == 1.0 and label in ("w8a8_attn", *SIM_PATHS):
                # against the W8A8 kernel path on the same linears: what the
                # int8 attention alone changes, and sim, which quantizes alike
                # (the same scales and codes through bf16 GEMMs of the
                # dequantized operands)
                psnr_hw, cos_hw = psnr_cos(preds["w8a8", 1.0], q64)
                log(f"  {label} vs the w8a8 kernel path, conditional: PSNR {psnr_hw:.2f} dB, "
                    f"cosine {cos_hw:.6f}")
                if label in SIM_PATHS and psnr_hw < 30.0:
                    failures.append(f"{label} vs w8a8 kernel path {psnr_hw:.2f} dB < 30 dB")
        (psnr, cos), (psnr1, cos1) = scores[label] = res[5.0], res[1.0]
        ref = (f"bf16 FP with --attn_window {WINDOWS[label]}" if label in WINDOWS
               else "bf16 FP")
        log(f"  {label} vs {ref} noise prediction (t=999): CFG 5.0 PSNR {psnr:.2f} dB, "
            f"cosine {cos:.6f}; conditional (guide 1) PSNR {psnr1:.2f} dB, cosine {cos1:.6f}")
        if label in WINDOWS:
            # not gated: on random weights a band changes the function a great deal
            with torch.no_grad():
                q64 = step(ctx, 5.0).cpu().numpy().astype(np.float64)
            d_psnr, d_cos = psnr_cos(fps[None][5.0], q64)
            w_psnr, w_cos = psnr_cos(fps[None][5.0], fps[WINDOWS[label]][5.0])
            log(f"  {label} vs dense bf16 FP, CFG 5.0: PSNR {d_psnr:.2f} dB, cosine {d_cos:.6f} "
                f"(bf16 with the window vs dense bf16: {w_psnr:.2f} dB, cosine {w_cos:.6f})")
        if label in sim_of:
            # sim and int8 mode from the same artifact quantize alike
            with torch.no_grad():
                q64 = step(sim_of[label], 1.0).cpu().numpy().astype(np.float64)
            psnr_s, cos_s = psnr_cos(preds[label, 1.0], q64)
            log(f"  {label} sim vs int8 mode from the same artifact, conditional: PSNR "
                f"{psnr_s:.2f} dB, cosine {cos_s:.6f}")
            if psnr_s < 30.0:
                failures.append(f"{label} sim vs int8 {psnr_s:.2f} dB < 30 dB")
        if label in PSNR_GATED and psnr < 30.0:
            failures.append(f"{label} PSNR {psnr:.2f} dB < 30 dB")
        if label not in PSNR_GATED and (cos1 < 0.9 or cos < 0.5):
            failures.append(f"{label} cosine {cos1:.4f} (guide 1) < 0.9 or {cos:.4f} (CFG) < 0.5")
    for label, twin in RTN_TWIN.items():
        # not gated: on Gaussian weights neither method has outliers to recover
        log(f"  {label} beside its RTN twin {twin}, vs bf16 FP: " + "; ".join(
            f"{tag} PSNR {scores[lb][i][0]:.2f} dB, cosine {scores[lb][i][1]:.6f}"
            for lb in (label, twin) for i, tag in ((0, f"{lb} CFG 5.0"), (1, "conditional"))))
    failures += gptq_layer_gate(torch, np, params, ctxs["w4a8_gptq"], gptq_calib_path)

    failures += int8_attention_plain_route(torch, np, step, ctxs["w8a8_attn"], preds,
                                           {g: fps[None][g] for g in (5.0, 1.0)})

    # the FP linears keep the f32 accumulator on the card, as on the CPU
    po = params["blocks"][0]["self_attn"]["o"]
    xo = torch.randn((1, 4096, cfg.dim), generator=g, device="cuda")
    got = fp_linear(po, xo).cpu()
    want = fp_linear({kk: vv.cpu() for kk, vv in po.items()}, xo.cpu())
    rel = float((got - want).norm() / want.norm())
    log(f"  fp_linear (self_attn.o, [1,4096,1536] bf16 operands, f32 out) card vs CPU: "
        f"rel-L2 {rel:.3e}")
    if not (got.dtype == torch.float32 and rel <= 1e-5):
        failures.append(f"fp_linear card vs CPU rel-L2 {rel}")

    with torch.no_grad():
        profile_steps(torch, {**{label: (lambda c=ctx: step(c)) for label, ctx in ctxs.items()},
                              "bf16": lambda: step(None)})
        for label in WINDOWS:
            t1 = time.perf_counter()
            step(fp_ctxs[WINDOWS[label]])
            torch.cuda.synchronize()
            t1 = time.perf_counter() - t1
            step(None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(None)
            torch.cuda.synchronize()
            t0 = time.perf_counter() - t0
            log(f"  bf16 with --attn_window {WINDOWS[label]} / dense bf16 forward wall time: "
                f"{t1 / t0:.3f} ({t1 * 1e3:.1f} / {t0 * 1e3:.1f} ms, warm)")
    del params, ctxs, sim_of, pipe
    torch.cuda.empty_cache()

    # a small config (head dim 128) under each YAML, through the kernels vs
    # through the plain versions on the CPU
    small = tiny_config(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32,
                        text_dim=64, freq_dim=64, param_dtype="bfloat16",
                        residual_dtype="bfloat16")
    rs = np.random.default_rng(5)
    x = torch.from_numpy(rs.standard_normal((2, 16, 3, 8, 10)).astype(np.float32))
    t = torch.tensor([999.0, 500.0])
    c = torch.from_numpy(rs.standard_normal((2, 32, 64)).astype(np.float32))
    p_cpu = init_params(small, 3, device="cpu")
    p_cpu["head"]["head"]["w"] = torch.from_numpy(
        rs.standard_normal((256, 64)).astype(np.float32) * 0.02).bfloat16()
    cc = QuantCtx(mode="calib", collect_minmax=True, hessian_regex=GPTQ_REGEX)
    dit_forward(p_cpu, small, x, t, c, 64, ctx=cc)
    small_calib = {kk: vv.float().numpy()[None] for kk, vv in cc.collect.items()}
    # beside the paths: a cross_attn section in int8 mode (the simulated
    # quantizers on cross-attention) and sim mode with a blockwise attn
    # section, int8-quantized deltas and per-layer reorder tables
    section = {"qk": {"n_bits": 8, "sym": True}, "v": {"n_bits": 8, "sym": True},
               "attn_map": {"n_bits": 8, "sym": True, "group": "row"}}
    block = AttnQuantCfg.from_dict({**section, "attn_map": {
        "n_bits": 8, "sym": True, "group": "block", "block_size": 16, "int8_scale": True}})
    perms = {f"blocks.{i}.self_attn": np.stack([rs.permutation(64) for _ in range(2)])
             for i in range(2)}
    cases = {label: (QuantConfig.from_yaml(PATHS[label][0]),
                     "sim" if label in SIM_PATHS else "int8", {})
             for label in (*FIDELITY_13B, "w8a8_14b")}
    cases["w8a8 + cross_attn section"] = (QuantConfig.from_yaml(YAML), "int8", {
        "cross_attn": AttnQuantCfg.from_dict(section)})
    cases["w8a8 sim + blockwise attn, perms"] = (QuantConfig.from_yaml(YAML), "sim",
                                                 {"attn": block, "perms": perms})
    # SmoothQuant masks at every block linear: K1 and K7 take them as channel_scale
    cases["smooth_quant W8A8 dict"] = (QuantConfig.from_dict({
        "weight": {"n_bits": 8, "sym": False}, "act": {"n_bits": 8, "sym": True},
        "smooth_quant": {"alpha": 0.5665, "layer_name_regex": ""},
        "remain_fp_regex": r"text_embedding|time_embedding|time_projection|head\.head"}),
        "int8", {})
    for label, (qcfg, mode, extra) in cases.items():
        outs = {}
        for dev in ("cpu", "cuda"):
            p = _to_device(p_cpu, dev)
            if dev == "cuda" and qcfg.weight_lowrank:
                # the SVD sketch is drawn on the weight's device, so the card's
                # factors are not the CPU's: the card runs the CPU's state (the
                # split itself is held card vs CPU from one sketch by the card
                # tests)
                st, rot = _to_device(st, dev), {d: m.to(dev) for d, m in rot.items()}
            else:
                pol, st, rot = prepare_quant_state(p, linear_layer_names(small), qcfg,
                                                   calib=small_calib, targets=mode)
            ctx = QuantCtx(mode=mode, policies=pol, state=st, rotations=rot,
                           attn=extra.get("attn", qcfg.attn_cfg),
                           cross_attn=extra.get("cross_attn", qcfg.cross_attn_cfg),
                           attn_perms=attn_perms_from_numpy(extra.get("perms", {}), dev),
                           attn_window=WINDOWS.get(label))
            with torch.no_grad():
                outs[dev] = dit_forward(p, small, x.to(dev), t.to(dev), c.to(dev), 64,
                                        ctx=ctx).cpu()
        a, bq = outs["cpu"].double(), outs["cuda"].double()
        rel = float((a - bq).norm() / a.norm())
        win = f", --attn_window {WINDOWS[label]}" if label in WINDOWS else ""
        log(f"  small config (dim 256, 2 heads, 2 layers, seq 64 > 60 tokens) {label}, "
            f"{mode} mode{win} on the card vs on the CPU: rel-L2 {rel:.3e}")
        if rel > 2e-2:
            failures.append(f"small-config {label} rel-L2 {rel} > 2e-2")
    failures += calib_maps_check(torch, small, p_cpu)
    check(not failures, "; ".join(failures))


def gptq_layer_gate(torch, np, params, ctx, calib_path):
    """At every Hessian site of the w4a8_gptq artifact: GPTQ's objective
    tr(dW^T H dW), dW = W - W_q in the GEMM's input space (the YAML's base
    method: the raw input), of the artifact's int4 codes against RTN's on
    the same grid, in f64 on the card. GPTQ must be lower at >= 95% of the
    sites; the ratios' median and range are printed."""
    from wanq_tpu_torch.quant.ptq import params_get
    from wanq_tpu_torch.quant.quantizers import unpack_int4, weight_fake_quant

    ratios = {}
    t0 = time.perf_counter()
    with np.load(calib_path) as d:
        for key in d.files:
            if not key.endswith(".hess"):
                continue
            name = key[:-len(".hess")]
            h = torch.from_numpy(d[key]).cuda().double()
            w = params_get(params, name)["w"].float()
            st = ctx.state[name]
            w_gptq = ((unpack_int4(st["w_int4"]).double() + st["zp_w_int"].double()[:, None])
                      * st["scale_w"].double()[:, None]).t()
            w_rtn = weight_fake_quant(w, ctx.policies[name].weight).double()
            obj = [float(((h @ dw) * dw).sum()) for dw in (w.double() - w_gptq,
                                                           w.double() - w_rtn)]
            ratios[name] = obj[0] / obj[1]
    r = np.array(list(ratios.values()))
    below = float((r < 1.0).mean())
    log(f"  w4a8_gptq layer gate ({len(r)} Hessian sites, {time.perf_counter() - t0:.1f} s): "
        f"tr(dW^T H dW) GPTQ / RTN median {np.median(r):.4f} (min {r.min():.4f}, max "
        f"{r.max():.4f}); GPTQ lower at {100 * below:.1f}% of the sites; by suffix: " + "; ".join(
            f"{sfx} {np.median([v for k, v in ratios.items() if k.endswith(sfx)]):.4f}"
            for sfx in ("self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o",
                        "cross_attn.q", "cross_attn.o", "ffn.0")))
    return [] if below >= 0.95 and len(r) else [
        f"GPTQ below RTN at {100 * below:.1f}% of {len(r)} Hessian sites < 95%"]


def fidelity_14b(torch, calib_path):
    """T2V-14B at 480p from phase 3's seed (the same weights and text
    states) and its calibration: one CFG forward at t=999 of bf16 and of
    each path of FIDELITY_14B (the plan's config as quant_generate
    --auto_bits_gib builds it), the path's noise prediction against bf16's
    with CFG 5 and conditional (the gates of the 1.3B paths: W8A8 PSNR >= 30
    dB with CFG; W4A8 and the W4/W8 plan cosine >= 0.9 conditional and >= 0.5
    with CFG; the plan's PSNR printed beside W4A8's and W8A8's), the
    device memory of the weights and of each quant state, then each forward
    under torch.profiler (wall time against bf16's, the forward's own peak
    allocation, kernels by device time); then one sequential-CFG step of
    w4a8_14b and of bf16 at 720p (seq 75776), timed on the host clock."""
    import numpy as np

    from wanq_tpu_torch.cli import quant_generate
    from wanq_tpu_torch.cli.common import load_contexts, load_params
    from wanq_tpu_torch.cli.quant_generate import quant_config_from_args
    from wanq_tpu_torch.configs import SIZE_CONFIGS, WAN_CONFIGS
    from wanq_tpu_torch.models.dit import linear_layer_names
    from wanq_tpu_torch.pipelines.text2video import (
        WanT2V, compute_seq_len, compute_target_shape)
    from wanq_tpu_torch.quant.ptq import prepare_quant_state
    from wanq_tpu_torch.quant.qlinear import QuantCtx

    cfg = WAN_CONFIGS[TASK_14B]
    args = argparse.Namespace(base_seed=42, device="cuda", context_file=None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = load_params(args, cfg)
    torch.cuda.synchronize()
    log(f"  {TASK_14B} random init on the card: {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    context, context_null = (torch.from_numpy(a).cuda() for a in load_contexts(args, cfg))
    calib = dict(np.load(calib_path))
    names = linear_layer_names(cfg)
    shape = compute_target_shape(cfg, SIZE_CONFIGS[SIZE], FRAMES)
    seq_len = compute_seq_len(cfg, shape)
    g = torch.Generator(device="cuda").manual_seed(1)
    lat = torch.randn((1, *shape), generator=g, device="cuda")
    pipe = WanT2V(cfg, params, device="cuda")

    def step(ctx):
        return pipe._step(lat, 999.0, context, context_null, 5.0, ctx, seq_len)

    def predictions(ctx):
        """CFG 5 and the conditional prediction of one batched forward."""
        with torch.no_grad():
            cond, uncond = pipe._split(lat, 999.0, context, context_null, ctx, seq_len)
            return {5.0: (uncond + 5.0 * (cond - uncond)).cpu().numpy().astype(np.float64),
                    1.0: cond.cpu().numpy().astype(np.float64)}

    fp = predictions(None)
    ctxs, failures, psnrs = {}, [], {}
    for label in FIDELITY_14B:
        # as quant_generate builds it from the path's YAML and flags (a plan)
        qcfg = quant_config_from_args(quant_generate.parse_args(cli_args(
            PATHS[label][0], RUNS[label]["flags"], TASK_14B)), cfg)
        held = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pol, st, rot = prepare_quant_state(params, names, qcfg, calib=calib, targets="int8")
        torch.cuda.synchronize()
        n_q = sum(p.is_quantized for p in pol.values())
        log(f"  [{label}] prepare_quant_state on the card ({n_q} layers): "
            f"{time.perf_counter() - t0:.2f} s; the state "
            f"{(torch.cuda.memory_allocated() - held) / 2**30:.2f} GiB")
        ctxs[label] = QuantCtx(mode="int8", policies=pol, state=st, rotations=rot)
        q = predictions(ctxs[label])
        if not all(np.isfinite(v).all() for v in q.values()):
            failures.append(f"non-finite {label} noise prediction")
        (psnr, cos), (psnr1, cos1) = psnr_cos(fp[5.0], q[5.0]), psnr_cos(fp[1.0], q[1.0])
        log(f"  {label} vs bf16 FP noise prediction ({TASK_14B} {SIZE}x{FRAMES}, t=999): CFG 5.0 "
            f"PSNR {psnr:.2f} dB, cosine {cos:.6f}; conditional PSNR {psnr1:.2f} dB, cosine "
            f"{cos1:.6f}")
        psnrs[label] = psnr
        if label.startswith("w8a8") and psnr < 30.0:
            failures.append(f"{label} PSNR {psnr:.2f} dB < 30 dB")
        if not label.startswith("w8a8") and (cos1 < 0.9 or cos < 0.5):
            failures.append(f"{label} cosine {cos1:.4f} (conditional) < 0.9 or {cos:.4f} (CFG) "
                            f"< 0.5")
    log(f"  w4w8_plan_14b (W8 on {PLAN_GIB} GiB's planned classes) PSNR with CFG 5 "
        f"{psnrs['w4w8_plan_14b']:.2f} dB beside w4a8_14b's {psnrs['w4a8_14b']:.2f} dB and "
        f"w8a8_14b's {psnrs['w8a8_14b']:.2f} dB (printed, not gated)")
    log(f"  held for the profile: {torch.cuda.memory_allocated() / 2**30:.2f} GiB (bf16 weights "
        f"and the {len(ctxs)} quant states)")
    with torch.no_grad():
        profile_steps(torch, {**{label: (lambda c=ctx: step(c)) for label, ctx in ctxs.items()},
                              "bf16_14b": lambda: step(None)}, ref="bf16_14b")
    # 720p (seq 75776), sequential CFG: one step's forwards of w4a8_14b and bf16
    del ctxs["w8a8_14b"], ctxs["w4w8_plan_14b"]
    torch.cuda.empty_cache()
    shape = compute_target_shape(cfg, SIZE_CONFIGS["1280*720"], FRAMES)
    seq_len = compute_seq_len(cfg, shape)
    lat = torch.randn((1, *shape), generator=g, device="cuda")
    walls = {}
    for label, ctx in (("w4a8_14b", ctxs["w4a8_14b"]), ("bf16", None)):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            pred = pipe._step(lat, 999.0, context, context_null, 5.0, ctx, seq_len,
                              sequential=True)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        if not bool(torch.isfinite(pred).all()):
            failures.append(f"non-finite {label} 720p noise prediction")
        log(f"  {label} {TASK_14B} 1280*720x81 (seq {seq_len}), one sequential-CFG step's two "
            f"forwards: {walls[label]:.3f} s; peak beyond the {held / 2**30:.2f} GiB held "
            f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB")
        del pred
    log(f"  w4a8_14b / bf16 at 720p, sequential CFG: {walls['w4a8_14b'] / walls['bf16']:.3f}")
    del params, ctxs, pipe
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))


# ---------------------------------------------------------------------------
# phase 5: whole generate
# ---------------------------------------------------------------------------

CKPT = OUT / f"ckpt_{TASK}"
T5_VALID = (37, 113)  # the valid lengths of the seeded prompt and negative prompt


def _timed(torch, owner, name, store):
    """Wrap ``owner.name`` (a method or a module's function) to append each
    call's seconds (synchronized) to ``store``; returns the original."""
    orig = getattr(owner, name)

    def run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        store.append(time.perf_counter() - t0)
        return out

    setattr(owner, name, run)
    return orig


def _rel(torch, want, got) -> float:
    want, got = want.double().cpu(), got.double().cpu()
    return float((want - got).norm() / want.norm())


def _psnr_video(np, want, got) -> float:
    """PSNR over the video range [-1, 1]."""
    err = np.mean((np.asarray(want, np.float64) - np.asarray(got, np.float64)) ** 2)
    return float(10 * np.log10(4.0 / err)) if err > 0 else float("inf")


def t5_phase(torch, np):
    """umT5-XXL drawn on the card, two seeded [1, 512] id rows (a prompt and
    a negative prompt with ragged valid lengths) encoded into the context
    file; then its first 2 layers on the card against the CPU (bf16, the
    prompt row; rel-L2 <= 4e-3: 1.6e-3 in the first card run, where both sides
    multiply bf16 operands in f32 and round the attention's P·V product and
    the FFN's gated product to bf16 at the same sites). Returns (context
    file, first encode s)."""
    import dataclasses

    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.models import t5 as t5m

    cfg, wan = t5m.UMT5_XXL, WAN_CONFIGS[TASK]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = t5m.init_t5_params_on_device(cfg, seed=0)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n = sum(v.numel() for v in _leaves(params))
    enc = t5m.T5EncoderModel(wan.text_len, cfg=cfg, params=params, device="cuda")
    g = np.random.default_rng(7)
    ids = g.integers(0, cfg.vocab_size, (2, wan.text_len))
    mask = (np.arange(wan.text_len)[None] < np.asarray(T5_VALID)[:, None]).astype(np.int64)
    enc_s = []
    for _ in range(2):  # the first pass, then a warm one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = [enc.encode_ids(ids[i:i + 1], mask[i:i + 1]) for i in range(2)]
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
    log(f"  umT5-XXL ({n / 1e9:.2f} B params, {n * 2 / 2**30:.2f} GiB bf16) drawn on the card: "
        f"{draw_s:.2f} s; encode_ids of 2 x [1, {wan.text_len}] (valid {T5_VALID}): "
        f"{enc_s[0]:.3f} s, warm {enc_s[1]:.3f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for st, valid in zip(states, T5_VALID):
        check(tuple(st.shape) == (1, wan.text_len, cfg.dim), f"T5 states {tuple(st.shape)}")
        check(bool(torch.isfinite(st).all()), "non-finite T5 states")
        check(float(st[0, valid:].abs().max()) == 0.0 and float(st[0, :valid].abs().max()) > 0,
              "T5 states not zero exactly past the valid length")
    ctx_file = str(OUT / "context_t5.npz")
    np.savez(ctx_file, context=states[0].cpu().numpy(), context_null=states[1].cpu().numpy())
    # the first 2 layers at full width, on the card and on the CPU
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p2 = {"token_embedding": params["token_embedding"], "blocks": params["blocks"][:2],
          "norm": params["norm"]}
    ids1, mask1 = torch.from_numpy(ids[:1]), torch.from_numpy(mask[:1])
    with torch.no_grad():
        card = t5m.encoder_forward(p2, cfg2, ids1.cuda(), mask1.cuda())
        t0 = time.perf_counter()
        host = t5m.encoder_forward(_to_device(p2, "cpu"), cfg2, ids1, mask1)
    rel = _rel(torch, host, card)
    log(f"  umT5-XXL, 2 of 24 layers, bf16, 512 ids (valid {T5_VALID[0]}): card vs CPU rel-L2 "
        f"{rel:.3e} (the CPU's {time.perf_counter() - t0:.1f} s)")
    check(rel <= 4e-3, f"T5 card vs CPU rel-L2 {rel:.3e} > 4e-3")
    del enc, params, p2, states, card
    torch.cuda.empty_cache()
    return ctx_file, enc_s[0]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def vae_checks(torch, np, vae_params):
    """The full-width VAE on the card against the CPU on a [1, 16, 2, 30,
    52] latent (5 frames at 240x416): f32 rel-L2 <= 1e-4, bf16 PSNR >= 35
    dB against the CPU's f32; the 720p latent's single frame (90x160 =
    14400 tokens) through attention_block, row-blockwise against one-shot on
    the card, rel-L2 <= 1e-5."""
    from wanq_tpu_torch.models import vae as vaem

    g = torch.Generator().manual_seed(5)
    z = torch.randn((1, 16, 2, 30, 52), generator=g)
    t0 = time.perf_counter()
    host = vaem.WanVAE(params=vae_params, device="cpu").decode(z)
    host_s = time.perf_counter() - t0
    card = vaem.WanVAE(params=vae_params, device="cuda").decode(z.cuda())
    card16 = vaem.WanVAE(params=vae_params, device="cuda",
                         compute_dtype=torch.bfloat16).decode(z.cuda())
    rel, psnr = _rel(torch, host, card), _psnr_video(np, host.numpy(), card16.cpu().numpy())
    log(f"  VAE decode {tuple(z.shape)} -> {tuple(host.shape)} (the CPU's {host_s:.1f} s): f32 "
        f"card vs CPU rel-L2 {rel:.3e}; bf16 card vs f32 CPU PSNR {psnr:.2f} dB")
    check(rel <= 1e-4, f"VAE f32 card vs CPU rel-L2 {rel:.3e} > 1e-4")
    check(psnr >= 35.0, f"VAE bf16 card vs f32 CPU PSNR {psnr:.2f} dB < 35")
    p = {k: v.cuda() for k, v in vae_params.items() if k.startswith("decoder.middle.1.")}
    x = torch.randn((1, 384, 1, 90, 160), generator=g).cuda()
    blocked = vaem.attention_block(p, "decoder.middle.1", x)
    limit = vaem._ATTN_BLOCKWISE_MIN_HW
    vaem._ATTN_BLOCKWISE_MIN_HW = 1 << 30
    try:
        one_shot = vaem.attention_block(p, "decoder.middle.1", x)
    finally:
        vaem._ATTN_BLOCKWISE_MIN_HW = limit
    rel = _rel(torch, one_shot, blocked)
    log(f"  VAE attention_block at 90x160 (14400 tokens, 384 channels): blockwise "
        f"({vaem._ATTN_Q_BLOCK}-row blocks) vs one-shot on the card rel-L2 {rel:.3e}")
    check(rel <= 1e-5, f"blockwise vs one-shot attention rel-L2 {rel:.3e} > 1e-5")


def whole_generate(torch, calib_path, launches):
    """Phase 5: a Wan2.1 checkpoint dir from the seed-42 weights, umT5-XXL
    on the card, fp_generate from --random_init and from --ckpt_dir (equal
    latent bits), the W8A8 main path through cli.generate down to the
    decoded video, the VAE and T5 on the card against the CPU, and the 720p
    bf16 decode of phase 3's w4a8_14b_720p latents."""
    import numpy as np

    from wanq_tpu_torch.cli import fp_generate, generate, ptq
    from wanq_tpu_torch.cli.common import load_params
    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.models import params as params_mod
    from wanq_tpu_torch.models import vae as vaem
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.pipelines.text2video import WanT2V

    cfg = WAN_CONFIGS[TASK]
    t0 = time.perf_counter()
    params = load_params(argparse.Namespace(base_seed=42, device="cuda", random_init=True), cfg)
    shutil.rmtree(CKPT, ignore_errors=True)
    nbytes = write_dit_checkpoint(params, cfg, str(CKPT))
    del params
    torch.cuda.empty_cache()
    vae_params = vaem.init_vae_params(vaem.WAN_VAE_CFG, seed=0, device="cpu")
    write_vae_checkpoint(vae_params, str(CKPT / cfg.vae_checkpoint))
    log(f"  {CKPT.name}: the seed-42 {TASK} DiT as 2 safetensors shards + index "
        f"({nbytes / 2**30:.2f} GiB), {cfg.vae_checkpoint} "
        f"({os.path.getsize(CKPT / cfg.vae_checkpoint) / 2**30:.2f} GiB): "
        f"{time.perf_counter() - t0:.1f} s")

    ctx_file, t5_enc_s = t5_phase(torch, np)

    denoise_s, decode_s, load_s = [], [], []
    timed = [(owner, name, _timed(torch, owner, name, store)) for owner, name, store in (
        (WanT2V, "generate", denoise_s), (vaem.WanVAE, "decode", decode_s),
        (params_mod, "load_wan_checkpoint", load_s))]
    try:
        common = ["--task", TASK, "--size", SIZE, "--frame_num", str(FRAMES), "--sample_steps",
                  str(STEPS), "--context_file", ctx_file, "--device", "cuda"]
        lat = {}
        for label, flags in (("random_init", ["--random_init"]),
                             ("ckpt_dir", ["--ckpt_dir", str(CKPT)])):
            out = np.load(fp_generate.generate(fp_generate.parse_args(
                common + flags + ["--save_file", str(OUT / f"fp_{label}.npz")])))
            lat[label] = out["latents"]
            if label == "ckpt_dir":
                fp_video = out["video"]
        log(f"  fp_generate {STEPS} steps, --random_init vs --ckpt_dir: denoise "
            f"{denoise_s[0]:.2f} / {denoise_s[1]:.2f} s; load_wan_checkpoint {load_s[0]:.2f} s; "
            f"f32 VAE decode {decode_s[0]:.2f} s; latents equal bits: "
            f"{np.array_equal(lat['random_init'], lat['ckpt_dir'])}")
        check(np.array_equal(lat["random_init"], lat["ckpt_dir"]),
              "fp_generate latents differ between --random_init and --ckpt_dir")

        art = str(OUT / "quant_params_w8a8.npz")
        ptq.generate(ptq.parse_args(["--task", TASK, "--size", SIZE, "--frame_num", str(FRAMES),
                                     "--random_init", "--quant_config", YAML, "--calib_data",
                                     calib_path, "--save_path", art, "--device", "cuda"]))
        save = str(OUT / "generate_w8a8.npz")
        args = generate.parse_args(common + [
            "--random_init", "--ckpt_dir", str(CKPT), "--quant_config", YAML,
            "--quant_params", art, "--hardware", "--vae_dtype", "float32", "--save_file", save])
        del denoise_s[:], decode_s[:]
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        generate.generate(args)
        counts = _lib.launch_counts()
        total_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        for owner, name, orig in timed:
            setattr(owner, name, orig)
    log(f"  [generate w8a8] cli.generate --random_init --ckpt_dir --quant_params --hardware "
        f"({STEPS} steps, f32 VAE): {total_s:.1f} s; T5 encode {t5_enc_s:.3f} s (the context "
        f"file's, above), denoise {denoise_s[0]:.2f} s, VAE decode {decode_s[0]:.2f} s; peak "
        f"{peak / 2**30:.2f} GiB; launches {counts}")
    per_block = PATHS["w8a8"][1]
    for name in (*SOURCES, *MODES):
        want = per_block.get(name, 0) * cfg.num_layers * STEPS
        check(counts.get(name, 0) == want,
              f"generate w8a8: {name} {counts.get(name, 0)} launches, want {want}")
    for name, cnt in counts.items():
        name = MODES.get(name, name)
        launches[name] = launches.get(name, 0) + cnt
    out = np.load(save)
    video = out["video"]
    check(video.shape == (1, 3, FRAMES, 480, 832), f"video shape {video.shape}")
    check(bool(np.isfinite(video).all()), "non-finite video")
    check(float(np.abs(video).max()) <= 1.0 and float(video.std()) > 0,
          "video outside [-1, 1] or constant")
    files = sorted(f for f in os.listdir(OUT) if f.startswith("generate_w8a8."))
    log(f"  video {video.shape} finite in [{video.min():.3f}, {video.max():.3f}], std "
        f"{video.std():.4f}; files written: {files} (a video file needs imageio)")
    vae32 = vaem.WanVAE(params=vae_params, device="cuda")
    again = vae32.decode(torch.from_numpy(out["latents"]).cuda()).cpu().numpy()
    check(np.array_equal(again, video), "decoding the saved latents again gives other bits")
    log(f"  decoding the saved latents again: equal bits; PSNR against fp_generate "
        f"--ckpt_dir's video (a reading: random VAE weights): "
        f"{_psnr_video(np, fp_video, video):.2f} dB")
    del vae32
    torch.cuda.empty_cache()

    score_videos(torch, np, fp_video, video, str(OUT / "fp_ckpt_dir.npz"), save)

    vae_checks(torch, np, vae_params)

    vae16 = vaem.WanVAE(params=vae_params, device="cuda", compute_dtype=torch.bfloat16)
    lat720 = np.load(OUT / "latents_w4a8_14b_720p.npz")["latents"]
    for label, z in (("720p w4a8_14b_720p", lat720), ("480p generate w8a8", out["latents"])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = vae16.decode(torch.from_numpy(z).cuda())
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(bool(torch.isfinite(v).all()), f"non-finite bf16 decode of {label}")
        note = ""
        if label.startswith("480p"):
            note = (f"; f32 {decode_s[0]:.2f} s; bf16 vs f32 PSNR "
                    f"{_psnr_video(np, video, v.cpu().numpy()):.2f} dB")
        log(f"  bf16 VAE decode of the {label} latents {z.shape} -> {tuple(v.shape)}: "
            f"{sec:.2f} s, peak {peak / 2**30:.2f} GiB{note}")
        del v


def _evaluate(argv):
    """cli.evaluate's main with its JSON line caught: (report, the line)."""
    import io

    from wanq_tpu_torch.cli import evaluate

    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rep = evaluate.main(argv)
    return rep, buf.getvalue().strip().splitlines()[-1]


def score_videos(torch, np, fp_video, video, fp_npz, gen_npz):
    """Phase 5's evaluation: W8A8's decoded [1, 3, 81, 480, 832] video
    against fp_generate's through cli.evaluate --clip_metrics --flow_score
    --device cuda (the full ViT-H CLIP tower drawn on the card, seed 0), each
    part timed on the host clock around synchronized calls, with its peak;
    gates: every value finite; evaluate(fp, fp) reads fvd_random_feat <= 1e-6
    x evaluate(fp, w8a8)'s and cosine 1 (to 1e-12); the feature net's [1, 256]
    output on the card against the CPU's, rel-L2 <= 1e-4 (TF32 off inside the
    net, XLA's padding); clip_frame_features on the first 4 frames of each
    video on the card against the CPU, <= 1e-5 abs; flow_score on the card
    against the CPU, <= 1e-4 relative. Then evaluate on the two npz files of
    fp_generate and generate as they are: as in wanq_tpu it scores their
    'latents' (printed, labelled so)."""
    from wanq_tpu_torch.models import clip as clipm
    from wanq_tpu_torch.utils import clip_metrics, flow, fvd

    t_all = time.perf_counter()
    paths, vids = {}, {}
    for label, v in (("fp", fp_video), ("w8a8", video)):
        vids[label] = np.ascontiguousarray(v.transpose(0, 2, 3, 4, 1))  # [N, T, H, W, 3]
        paths[label] = str(OUT / f"videos_{label}.npz")
        np.savez(paths[label], videos=vids[label])
    write_s = time.perf_counter() - t_all
    parts = {"feature net": [], "CLIP": [], "flow": []}
    timed = [(owner, name, _timed(torch, owner, name, parts[key])) for owner, name, key in (
        (fvd.I3DLikeFeatures, "__call__", "feature net"),
        (clip_metrics, "clip_frame_features", "CLIP"), (flow, "flow_score", "flow"))]
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep, line = _evaluate(["--fp", paths["fp"], "--quant", paths["w8a8"], "--clip_metrics",
                               "--flow_score", "--device", "cuda"])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        for owner, name, orig in timed:
            setattr(owner, name, orig)
    frames = video.shape[0] * video.shape[2]
    log(f"  [evaluate w8a8 vs fp video] cli.evaluate --clip_metrics --flow_score --device cuda "
        f"on videos {vids['fp'].shape}: {line}")
    log(f"  evaluate: {eval_s:.2f} s in all (npz load and elementwise metrics included); "
        f"feature net {sum(parts['feature net']):.3f} s for 2 videos ({parts['feature net']}; "
        f"f32, TF32 off inside the net), CLIP {sum(parts['CLIP']):.2f} s for {2 * frames} "
        f"frames (ViT-H/14, 32 blocks, drawn on the card; "
        f"{2 * frames / sum(parts['CLIP']):.1f} frames/s), flow {sum(parts['flow']):.3f} s "
        f"({parts['flow']}); peak {peak / 2**30:.2f} GiB; writing the two videos npz "
        f"{write_s:.1f} s")
    log(f"  two PSNR definitions: evaluate's psnr_db {rep['psnr_db']:.3f} dB (range = the FP "
        f"video's max - min, {float(fp_video.max() - fp_video.min()):.4f}), _psnr_video "
        f"{_psnr_video(np, fp_video, video):.3f} dB (range 2, [-1, 1])")
    check(all(math.isfinite(v) for v in rep.values()), f"non-finite evaluate values: {rep}")
    for key in ("psnr_db", "rel_err", "cosine", "fvd_random_feat", "clip_temp_fp",
                "clip_temp_quant", "flicker_fp", "flicker_quant", "clip_frame_cosine_fp_vs_quant",
                "flow_score_fp", "flow_score_quant"):
        check(key in rep, f"evaluate report lacks {key}")

    same, _ = _evaluate(["--fp", paths["fp"], "--quant", paths["fp"], "--device", "cuda"])
    log(f"  evaluate(fp, fp): fvd_random_feat {same['fvd_random_feat']:.3e} (fp vs w8a8 "
        f"{rep['fvd_random_feat']:.6e}), cosine 1 - {1 - same['cosine']:.1e}, psnr_db "
        f"{same['psnr_db']}")
    check(abs(same["fvd_random_feat"]) <= 1e-6 * rep["fvd_random_feat"],
          f"evaluate(fp, fp) fvd_random_feat {same['fvd_random_feat']:.3e} > 1e-6 x "
          f"{rep['fvd_random_feat']:.3e}")
    check(abs(same["cosine"] - 1.0) <= 1e-12, f"evaluate(fp, fp) cosine {same['cosine']!r}")

    t0 = time.perf_counter()
    card = fvd.I3DLikeFeatures(device="cuda")(vids["fp"])
    host = fvd.I3DLikeFeatures(device="cpu")(vids["fp"])
    rel = float(np.linalg.norm(card - host) / np.linalg.norm(host))
    log(f"  feature net on the fp video, card vs CPU: rel-L2 {rel:.3e} ({card.shape}; "
        f"{time.perf_counter() - t0:.1f} s with the CPU's)")
    check(rel <= 1e-4, f"feature net card vs CPU rel-L2 {rel:.3e} > 1e-4")

    t0 = time.perf_counter()
    cfg = clipm.CLIP_XLM_ROBERTA_VIT_H_14
    params = clipm.init_clip_params_on_device(cfg, seed=0, device="cuda")
    vis = {k: v for k, v in params.items() if k.startswith("visual.")}
    del params
    first4 = np.concatenate([vids["fp"][:, :4], vids["w8a8"][:, :4]])
    card = clip_metrics.clip_frame_features(vis, cfg, first4, device="cuda")
    host = clip_metrics.clip_frame_features({k: v.cpu() for k, v in vis.items()}, cfg, first4,
                                            device="cpu")
    err = float(np.abs(card - host).max())
    log(f"  clip_frame_features on the first 4 frames of each video, card vs CPU: max abs "
        f"{err:.3e} ({time.perf_counter() - t0:.1f} s with the CPU's)")
    check(err <= 1e-5, f"clip_frame_features card vs CPU {err:.3e} > 1e-5")
    del vis
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    for label, key in (("fp", "flow_score_fp"), ("w8a8", "flow_score_quant")):
        card_f = flow.flow_score(vids[label], device="cuda")
        host_f = flow.flow_score(vids[label], device="cpu")
        log(f"  flow_score {label}: card {card_f!r} (evaluate's {rep[key]!r}), CPU {host_f!r}")
        check(abs(card_f - host_f) <= 1e-4 * abs(host_f),
              f"flow_score {label} card {card_f} vs CPU {host_f}")
        check(card_f == rep[key], f"flow_score {label} differs from evaluate's {rep[key]}")
    log(f"  flow card vs CPU: {time.perf_counter() - t0:.1f} s")

    _, line = _evaluate(["--fp", fp_npz, "--quant", gen_npz, "--device", "cuda"])
    log(f"  evaluate on the fp_generate and generate npz files as they are (scores their "
        f"'latents', not 'video', as wanq_tpu does): {line}")
    log(f"  phase 5 evaluation: {time.perf_counter() - t_all:.1f} s")


def int8_attention_plain_route(torch, np, step, ctx, preds, fps):
    """Is the ~58 dB between w8a8_attn and w8a8 the rounding that int8
    attention does by definition, or K10's own error? One more CFG forward
    of w8a8_attn at t=999 in which models/dit.py's attention_int8 runs the
    plain versions on the card (quantize_qkv_int8_plain, then
    attention_int8_blocked with q_chunk 8192: the function's 512-block grid
    step by step), printed against the kernel forward and each against w8a8
    and bf16, with CFG 5 and conditional. Limit, stated before the first
    run: the plain route's prediction is finite; the distances are printed,
    not gated. The launch counts of the kernel run were read in phase 3."""
    import wanq_tpu_torch.models.dit as dit
    from wanq_tpu_torch.ops.attn_int8 import (
        BLK, attention_int8_blocked, quantize_qkv_int8_plain)

    def plain_route(q, k, v, sm_scale=None, k_valid_len=None, blk=BLK):
        s = q.shape[1]
        scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
        quantized = quantize_qkv_int8_plain(q.transpose(1, 2), k.transpose(1, 2),
                                            v.transpose(1, 2), blk)
        out = attention_int8_blocked(*quantized, scale, k_valid_len=k_valid_len or s,
                                     q_chunk=8192)
        return out[:, :, :s].transpose(1, 2).contiguous()

    kernel_route, dit.attention_int8 = dit.attention_int8, plain_route
    try:
        with torch.no_grad():
            plain = {g: step(ctx, g).cpu().numpy().astype(np.float64) for g in (5.0, 1.0)}
    finally:
        dit.attention_int8 = kernel_route
    failures = []
    for g, name in ((5.0, "CFG 5.0"), (1.0, "conditional")):
        if not np.isfinite(plain[g]).all():
            failures.append(f"w8a8_attn through the plain versions: non-finite {name} prediction")
            continue
        pk, _ = psnr_cos(plain[g], preds["w8a8_attn", g])
        kw, _ = psnr_cos(preds["w8a8", g], preds["w8a8_attn", g])
        pw, _ = psnr_cos(preds["w8a8", g], plain[g])
        kf, _ = psnr_cos(fps[g], preds["w8a8_attn", g])
        pf, _ = psnr_cos(fps[g], plain[g])
        log(f"  w8a8_attn {name} (t=999): kernels (K10a + K10) vs plain versions PSNR {pk:.2f} "
            f"dB; vs w8a8: kernels {kw:.2f} dB, plain versions {pw:.2f} dB; vs bf16: kernels "
            f"{kf:.2f} dB, plain versions {pf:.2f} dB")
    return failures


def calib_maps_check(torch, small, p_cpu):
    """get_calib_data --attn_map_pool 8 --attn_map_reduce mean at the small
    config (head dim 128, 4 latent frames of 20 tokens, seq 80): the sweep it
    runs (WanT2V.collect_calibration, 1 step, a calib ctx with the pooled-map
    capture) on the card against the same on the CPU. The maps' q/k come from
    bf16 forwards that differ in f32 sum order, so a bf16 rounding can flip:
    the pooled maps must agree within 1e-2 absolute (their cells are ~1/80 to
    1) and rel-L2 2e-2, each row keep 1/pool of its mass, and the capture
    must see every layer."""
    import numpy as np

    from wanq_tpu_torch.pipelines.text2video import WanT2V
    from wanq_tpu_torch.quant.qlinear import QuantCtx

    rs = np.random.default_rng(11)
    ctx_np = rs.standard_normal((1, 32, 64)).astype(np.float32)
    null_np = rs.standard_normal((1, 32, 64)).astype(np.float32)
    stats = {}
    for dev in ("cpu", "cuda"):
        pipe = WanT2V(small, _to_device(p_cpu, dev), device=dev, quant_ctx=QuantCtx(
            mode="calib", attn_map_pool=8, attn_map_reduce="mean", attn_window=1))
        g = torch.Generator().manual_seed(2)
        noise = torch.randn((1, 16, 4, 8, 10), generator=g)
        with torch.no_grad():
            stats[dev] = pipe.collect_calibration(
                torch.from_numpy(ctx_np), torch.from_numpy(null_np), sampling_steps=1,
                size=(80, 64), frame_num=13, noise=noise)
    failures = []
    keys = [k for k in stats["cpu"] if k.endswith(".attn_map")]
    if sorted(keys) != [f"blocks.{i}.self_attn.attn_map" for i in range(small.num_layers)]:
        failures.append(f"attn-map capture saw {keys}")
    worst = 0.0
    for key in keys:
        a, c = stats["cpu"][key], stats["cuda"][key]
        rel = float(np.linalg.norm(a - c) / np.linalg.norm(a))
        mass = np.abs(c.sum(-1) - 1 / 8).max()
        worst = max(worst, float(np.abs(a - c).max()))
        if a.shape != (1, 2, 10, 10) or rel > 2e-2 or worst > 1e-2 or mass > 1e-4:
            failures.append(f"{key}: shape {a.shape}, rel-L2 {rel}, max abs {worst}, mass {mass}")
    log(f"  get_calib_data sweep with --attn_map_pool 8 (mean), small config, card vs CPU: "
        f"{len(keys)} maps {stats['cpu'][keys[0]].shape if keys else None}, max abs diff "
        f"{worst:.2e}")
    return failures


# ---------------------------------------------------------------------------
# phase 6: image to video
# ---------------------------------------------------------------------------

TASK_I2V = "i2v-14B"
I2V_YAML = "quant_configs/wan_w4a8_mixed.yaml"
I2V_STEPS = 3
# I2V-14B under wan_w4a8_mixed.yaml (cross-attention FP), per block: K1 for
# q/k/v and ffn.0; K2 for q/k/v/o; K7 for the o input and the ffn.2 GELU; K8
# for ffn.0/2; K3 for q and k rope and the cross-q split; K4 three times:
# self-attention, then the one cross q against the text and against the 257
# CLIP tokens
I2V_PER_BLOCK = {"ln_modulate_quant": 2, "w8a8_linear": 4, "quant_sum": 2, "w4a8_linear": 2,
                 "rms_rope_heads": 3, "gate_residual": 3, "attention": 3}
CKPT_I2V = OUT / f"ckpt_{TASK_I2V}"
CLIP_TOKENS = 257
# the quant_ctx_schedule check at 1.3B: the two paths whose ctxs it switches
SCHEDULE = ("w8a8", "w4a8_mixed")
# the capture check at 1.3B: 17 frames (5 latent frames of 1560 tokens, seq
# 8192 with 7800 valid), pool 256 -> [12, 32, 32] maps
CAPTURE_FRAMES, CAPTURE_POOL = 17, 256


def i2v_image(torch):
    """The seeded [3, 480, 832] image in [-1, 1] the I2V path starts from."""
    return torch.rand((3, 480, 832), generator=torch.Generator().manual_seed(42)) * 2 - 1


def i2v_kernel_checks(torch, record, grid_path):
    """Every kernel the I2V path runs, at its shapes, against its plain
    version at the limits of phase 2, printed, not summed into the kernels
    line: the path's latent grid ``grid_path`` (I2V pads no token: every
    sequence kernel ends on a partial tile, and K4's kv_valid is S) and the
    grid of S = 32760 (60 x 104 latents, which the 480p area cannot give: see
    the log), B =
    2 (batched CFG), dim 5120, ffn 13824, 40 heads x 128. K1 and K3 (rope and
    the cross-q split) on [2, S, 5120]; K7 on the o input [2S, 5120] and the
    ffn.2 GELU input [2S, 13824]; K2 (5120 -> 5120, bf16 and f32 out: q/k/v
    and o) and K8 (5120 -> 13824 bf16, 13824 -> 5120 f32) at M = 2S, exact;
    K4 self-attention over all S keys (the last kv tile partial), and cross
    from the same q against the 512 text tokens and the 257 CLIP tokens
    (three kv tiles, the last with one valid key), each beside
    scaled_dot_product_attention."""
    from wanq_tpu_torch.models.attention import _flash_cuda, _sdpa_reference
    from wanq_tpu_torch.models.rope import pad_tables, rope_tables_interleaved
    from wanq_tpu_torch.ops.fused import (
        ln_modulate_quant_cuda, ln_modulate_quant_plain, quant_sum_cuda, quant_sum_plain)
    from wanq_tpu_torch.ops.qgemm import (
        w4a8_linear_cuda, w4a8_linear_plain, w8a8_linear_cuda, w8a8_linear_plain)
    from wanq_tpu_torch.ops.rmsnorm_rope import (
        _k3_cuda, rms_rope_heads_plain, rms_split_heads_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, c, f, n, d = 2, 5120, 13824, 40, 128
    qs = d ** -0.5
    for grid in (grid_path, (21, 30, 52)):
        s = grid[0] * grid[1] * grid[2]
        m = b * s
        tag = f"I2V-14B S {s} = {s // 128}*128 + {s % 128}"
        # K1
        x = (torch.randn((b, s, c), device=dev, generator=g) * 2 + 0.3).bfloat16()
        shift = torch.randn((b, c), device=dev, generator=g) * 0.5
        scale = torch.randn((b, c), device=dev, generator=g) * 0.5
        got = ln_modulate_quant_cuda(x, shift, scale)
        want = ln_modulate_quant_plain(x, shift, scale)
        diff = (got[0].int() - want[0].int()).abs()
        frac = (diff > 0).float().mean().item()
        check(diff.max().item() <= 1 and frac <= 1e-3, f"K1 {tag}: codes differ {frac}")
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
        err = (got[0].float() * got[1][..., None] - want[0].float() * want[1][..., None])
        record("ln_modulate_quant", err.abs().max().item(),
               cuda_ms(lambda: ln_modulate_quant_cuda(x, shift, scale)),
               cuda_ms(lambda: ln_modulate_quant_plain(x, shift, scale), reps=3),
               f"[2,{s},5120] bf16 ({tag}; codes differing: {frac:.2e})",
               b * s * c * 3 + b * s * 8 + 2 * b * c * 4, 10 * b * s * c, "f32", summed=False)
        del got, want, diff, err
        # K3: rope (q-scaled tables, identity past nothing: S is all valid) and split
        ca, sb = rope_tables_interleaved(grid, d)
        ca, sb = pad_tables(torch.from_numpy(ca.copy()).to(dev),
                            torch.from_numpy(sb.copy()).to(dev), s, s)
        caq, sbq = ca * qs, sb * qs
        wn = torch.rand((c,), device=dev, generator=g) + 0.5
        for detail, kern, plain in (
                ("rope", lambda: _k3_cuda(x, wn, caq, sbq, n, 1e-6, torch.bfloat16),
                 lambda: rms_rope_heads_plain(x, wn, caq, sbq, n)),
                ("split only (cross q)", lambda: _k3_cuda(x, wn, None, None, n, 1e-6,
                                                          torch.bfloat16),
                 lambda: rms_split_heads_plain(x, wn, n))):
            frac, err = bf16_ulp_check(torch, kern().float(), plain().float())
            check(frac <= 1e-4, f"K3 {tag} {detail}: {frac:.2e} beyond one ulp")
            nbytes = b * s * c * 4 + c * 4 + (2 * s * d * 4 if detail == "rope" else 0)
            record("rms_rope_heads", err, cuda_ms(kern, reps=5), cuda_ms(plain, reps=3),
                   f"[2,{s},5120]->[2,40,{s},128] {detail} ({tag}; beyond 1 ulp: {frac:.2e})",
                   nbytes, 8 * b * s * c, "f32", summed=False)
        del x, ca, sb, caq, sbq
        # K7: the o input without GELU, the ffn.2 input with it
        for cw, gelu in ((c, False), (f, True)):
            xr = (torch.randn((m, cw), device=dev, generator=g) * 2 + 0.2).bfloat16()
            got, want = quant_sum_cuda(xr, gelu), quant_sum_plain(xr, gelu)
            diff = (got[0].int() - want[0].int()).abs()
            frac = (diff > 0).float().mean().item()
            s_rel = ((got[1] - want[1]).abs() / want[1]).max().item()
            check(diff.max().item() <= 1 and frac <= 1e-3 and s_rel <= 1e-6,
                  f"K7 {tag} C={cw}: codes {frac:.2e}, scale rel {s_rel:.2e}")
            err = (got[0].float() * got[1][..., None] - want[0].float() * want[1][..., None])
            record("quant_sum", err.abs().max().item(), cuda_ms(lambda: quant_sum_cuda(xr, gelu)),
                   cuda_ms(lambda: quant_sum_plain(xr, gelu), reps=3),
                   f"[{m},{cw}] bf16 gelu={gelu} ({tag}; codes differing: {frac:.2e})",
                   xr.numel() * 3 + m * 8, (20 if gelu else 6) * xr.numel(), "f32", summed=False)
            del xr, got, want, diff, err
        torch.cuda.empty_cache()
        # K2 and K8 at M = 2S
        for name, k, nn, outs in (("w8a8_linear", c, c, ("bfloat16", "float32")),
                                  ("w4a8_linear", c, f, ("bfloat16",)),
                                  ("w4a8_linear", f, c, ("float32",))):
            a = torch.randint(-128, 128, (m, k), device=dev, generator=g, dtype=torch.int8)
            w = torch.randint(-128, 128, (nn, k // 2 if name == "w4a8_linear" else k),
                              device=dev, generator=g, dtype=torch.int8)
            s_a = torch.rand((m,), device=dev, generator=g) * 0.02 + 1e-3
            s_w = torch.rand((nn,), device=dev, generator=g) * 0.1 / k ** 0.5 + 1e-5
            sum_a = s_a * a.float().sum(-1)
            zp = torch.randint(0, 16, (nn,), device=dev, generator=g).float()
            bias = torch.randn((nn,), device=dev, generator=g)
            kern_fn, plain_fn = ((w8a8_linear_cuda, w8a8_linear_plain) if name == "w8a8_linear"
                                 else (w4a8_linear_cuda, w4a8_linear_plain))
            for out in outs:
                args = (a, w, s_a, s_w, sum_a, zp, bias, getattr(torch, out))
                got, want = kern_fn(*args), plain_fn(*args)
                err = (got.float() - want.float()).abs().max().item()
                check(torch.equal(got, want), f"{name} {tag} ({k},{nn}) {out}: max err {err}")
                del got, want
                ms = cuda_ms(lambda: kern_fn(*args))
                record(name, err, ms, cuda_ms(lambda: plain_fn(*args), warmup=0, reps=1),
                       f"M={m} K={k} N={nn} {out} out, exact ({tag}; "
                       f"{2 * m * k * nn / ms / 1e9:.0f} TOP/s)",
                       m * k + w.numel() + m * nn * (2 if out == "bfloat16" else 4) + 8 * m
                       + 12 * nn, 2 * m * k * nn, "int8", summed=False)
            del a, w
            torch.cuda.empty_cache()
        # K4 self over all S keys (q heads-major with the scale folded in, k
        # heads-major, v the strided view over [2, S, 5120]); the plain
        # version is one timed call
        q = (torch.randn((b, n, s, d), device=dev, generator=g) * qs).bfloat16()
        k = torch.randn((b, n, s, d), device=dev, generator=g).bfloat16()
        vh = torch.randn((b, s, n * d), device=dev, generator=g).bfloat16().view(
            b, s, n, d).transpose(1, 2)
        kern = lambda: _flash_cuda(q, k, vh, 1.0, s)
        got = kern()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = _sdpa_reference(q.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 1.0,
                               None, q_chunk=512)
        end.record()
        end.synchronize()
        err, rel = attn_err(got, want, f"self {tag}")
        tail_err, tail_rel = attn_err(got[:, -(s % 128 or 128):], want[:, -(s % 128 or 128):],
                                      f"self {tag} last q tile")
        del got, want
        torch.cuda.empty_cache()
        ms, flops = cuda_ms(kern, warmup=1, reps=3), 4 * b * n * s * s * d
        record("attention", err, ms, start.elapsed_time(end),
               f"self [2,40,{s},128], every key valid ({tag}; rel-L2 {rel:.2e}; the last, "
               f"partial q tile err {tail_err:.3e}, rel-L2 {tail_rel:.2e}; "
               f"{flops / ms / 1e9:.0f} TFLOP/s; plain: one call; library = "
               f"scaled_dot_product_attention)", 2 * 4 * b * n * s * d, flops, "bf16",
               library_ms=cuda_ms(lambda: sdpa(q, k, vh, scale=1.0), warmup=1, reps=3),
               summed=False)
        del k, vh
        q = (q.float() / qs).bfloat16()  # cross-attention takes its scale in K4
        for sk, what in ((512, "text"),
                         (CLIP_TOKENS, "image: 3 kv tiles, 1 valid key in the last")):
            ck = torch.randn((b, sk, n, d), device=dev, generator=g).bfloat16()
            cv = torch.randn((b, sk, n, d), device=dev, generator=g).bfloat16()
            kh, vh = ck.transpose(1, 2), cv.transpose(1, 2)
            kern = lambda: _flash_cuda(q, kh, vh, qs, sk)
            plain = lambda: _sdpa_reference(q.transpose(1, 2), ck, cv, qs, None, q_chunk=8192)
            err, rel = attn_err(kern(), plain(), f"cross Sk {sk} {tag}")
            record("attention", err, cuda_ms(kern), cuda_ms(plain, reps=3),
                   f"cross q [2,40,{s},128] heads-major, k/v [2,{sk},40,128] seq-major ({what}; "
                   f"{tag}; rel-L2 {rel:.2e}; library = scaled_dot_product_attention)",
                   2 * (2 * b * n * s * d + 2 * b * n * sk * d), 4 * b * n * s * sk * d, "bf16",
                   library_ms=cuda_ms(lambda: sdpa(q, kh, vh, scale=qs)), summed=False)
            del ck, cv, kh, vh
        del q
        torch.cuda.empty_cache()


def write_i2v_checkpoint(torch, np, cfg):
    """The I2V checkpoint dir without the DiT (--random_init draws it): the
    full-width random VAE, seed 0, and CLIP's visual tower at ViT-H/14's
    width drawn on the card from seed 42, in bf16 (the loader reads any
    float dtype into f32; the visual keys are all CLIPModel.visual reads, so
    the 250002-token text tower is left out); and the seeded random text
    states of the run (no umT5 files exist). Returns the context file."""
    from wanq_tpu_torch.models import clip as clipm
    from wanq_tpu_torch.models import vae as vaem

    t0 = time.perf_counter()
    CKPT_I2V.mkdir(parents=True, exist_ok=True)
    write_vae_checkpoint(vaem.init_vae_params(vaem.WAN_VAE_CFG, seed=0, device="cpu"),
                         str(CKPT_I2V / cfg.vae_checkpoint))
    params = clipm.init_clip_params_on_device(clipm.CLIP_XLM_ROBERTA_VIT_H_14, seed=42,
                                              device="cuda")
    visual = {k: v.bfloat16().cpu() for k, v in params.items() if k.startswith("visual.")}
    n_all = sum(v.numel() for v in params.values())
    del params
    torch.cuda.empty_cache()
    torch.save(visual, CKPT_I2V / cfg.clip_checkpoint)
    rng = np.random.default_rng(42)
    ctx_file = str(OUT / "i2v_context.npz")
    np.savez(ctx_file, **{k: rng.normal(size=(1, cfg.text_len, cfg.text_dim)).astype(np.float32)
                          for k in ("context", "context_null")})
    n_visual = sum(v.numel() for v in visual.values())
    log(f"  {CKPT_I2V.name}: {cfg.vae_checkpoint} "
        f"({os.path.getsize(CKPT_I2V / cfg.vae_checkpoint) / 2**30:.2f} GiB), "
        f"{cfg.clip_checkpoint}: the visual tower, {n_visual / 1e6:.0f} M of the model's "
        f"{n_all / 1e6:.0f} M params, bf16 "
        f"({os.path.getsize(CKPT_I2V / cfg.clip_checkpoint) / 2**30:.2f} GiB): "
        f"{time.perf_counter() - t0:.1f} s")
    return ctx_file


def i2v_generate(torch, np, cfg, img, ctx_file, launches):
    """cli.ptq --task i2v-14B --random_init (RTN under wan_w4a8_mixed.yaml,
    the int8 targets), then cli.generate from --random_init --ckpt_dir (the
    dir's VAE and CLIP) with the artifact, --hardware, DPM++, 3 steps and
    the bf16 VAE, on the seeded image. Times CLIP, the VAE encode and decode
    and each step; the launches of every step equal I2V_PER_BLOCK x the
    blocks; the video is finite, in [-1, 1] and not constant. Returns the
    artifact."""
    from wanq_tpu_torch.cli import generate, ptq
    from wanq_tpu_torch.models import clip as clipm
    from wanq_tpu_torch.models import vae as vaem
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.pipelines.image2video import i2v_latent_size

    common = ["--task", TASK_I2V, "--size", SIZE, "--frame_num", str(FRAMES), "--random_init",
              "--quant_config", I2V_YAML, "--device", "cuda"]
    art = str(OUT / "quant_params_i2v.npz")
    _lib.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ptq.generate(ptq.parse_args(common + ["--targets", "int8", "--save_path", art]))
    torch.cuda.synchronize()
    log(f"  cli.ptq {TASK_I2V} {I2V_YAML} --targets int8 (incl. random init and the npz write): "
        f"{time.perf_counter() - t0:.1f} s, {os.path.getsize(art) / 2**30:.2f} GiB; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(not _lib.launch_counts(), f"i2v PTQ launched {_lib.launch_counts()}")

    save = str(OUT / "generate_i2v.npz")
    args = generate.parse_args(common + [
        "--ckpt_dir", str(CKPT_I2V), "--context_file", ctx_file, "--quant_params", art,
        "--hardware", "--sample_solver", "dpm++", "--sample_steps", str(I2V_STEPS),
        "--vae_dtype", "bfloat16", "--save_file", save])
    clip_s, enc_s, dec_s, load_s = [], [], [], []
    timed = [(owner, name, _timed(torch, owner, name, store)) for owner, name, store in (
        (clipm.CLIPModel, "visual", clip_s), (vaem.WanVAE, "encode", enc_s),
        (vaem.WanVAE, "decode", dec_s), (generate, "_maybe_quant_ctx", load_s))]
    marks, per_step = [], []

    def on_step(i, t, latents):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        per_step.append(_lib.launch_counts())
        _lib.reset_launch_counts()

    try:
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        generate.generate(args, on_step=on_step, image=img)
        total_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(not _lib.launch_counts(), f"launches after the last step: {_lib.launch_counts()}")
    finally:
        for owner, name, orig in timed:
            setattr(owner, name, orig)
    steps_s = [marks[i + 1] - marks[i] for i in range(len(marks) - 1)]
    want = {k: v * cfg.num_layers for k, v in I2V_PER_BLOCK.items()}
    log(f"  [generate i2v] cli.generate --random_init --ckpt_dir --quant_params --hardware "
        f"--sample_solver dpm++ ({I2V_STEPS} steps, bf16 VAE): {total_s:.1f} s; quant state "
        f"load {load_s[0]:.2f} s; CLIP {clip_s[0]:.3f} s; VAE encode {enc_s[0]:.2f} s; denoise "
        f"step s (steps 2-{I2V_STEPS}) {', '.join(f'{x:.3f}' for x in steps_s)}; VAE decode "
        f"{dec_s[0]:.2f} s; peak {peak / 2**30:.2f} GiB")
    log(f"  [generate i2v] launches per step: {per_step} (want {want} each)")
    check(len(per_step) == I2V_STEPS, f"{len(per_step)} steps ran, want {I2V_STEPS}")
    for i, counts in enumerate(per_step):
        check(counts == want, f"i2v step {i + 1}: launches {counts}, want {want}")
        for name, cnt in counts.items():
            launches[name] = launches.get(name, 0) + cnt
    lat_h, lat_w = i2v_latent_size(cfg, (480, 832), 832 * 480)
    video = np.load(save)["video"]
    shape = (1, 3, FRAMES, lat_h * 8, lat_w * 8)
    check(video.shape == shape, f"i2v video shape {video.shape}, want {shape}")
    check(bool(np.isfinite(video).all()), "non-finite i2v video")
    check(float(np.abs(video).max()) <= 1.0 and float(video.std()) > 0,
          "i2v video outside [-1, 1] or constant")
    log(f"  [generate i2v] video {video.shape} finite in [{video.min():.3f}, {video.max():.3f}], "
        f"std {video.std():.4f}")
    return art


def i2v_fidelity(torch, np, cfg, img, art, ctx_file):
    """With I2V-14B's bf16 weights (the CLI's seed-42 draw) and the
    artifact's int8 state resident: CLIP on the card against the CPU (f32,
    rel-L2 <= 1e-4); the VAE encode of the path's video in bf16 and f32
    (time, the peak beyond what is held, bf16 vs f32), the f32 encode of a
    5-frame 120 x 208 crop against the CPU's (rel-L2 <= 1e-4); then one CFG
    forward at t=999 of the quantized and of the bf16 model with the same
    clip_fea and y (the bf16 encode's), under profile_steps: the 4-bit gate
    (cosine >= 0.9 conditional, >= 0.5 with CFG 5), PSNR, the wall ratio and
    the kernels by device time."""
    from wanq_tpu_torch.cli import generate
    from wanq_tpu_torch.cli.common import load_params
    from wanq_tpu_torch.cli.quant_generate import quantize_or_load
    from wanq_tpu_torch.models import clip as clipm
    from wanq_tpu_torch.models import vae as vaem
    from wanq_tpu_torch.models.clip import resize_cubic
    from wanq_tpu_torch.pipelines.image2video import WanI2V, first_frame_mask, i2v_latent_size
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.qlinear import QuantCtx

    args = generate.parse_args(["--task", TASK_I2V, "--random_init", "--quant_params", art,
                                "--device", "cuda"])
    params = load_params(args, cfg)
    pol, st, rot = quantize_or_load(args, params, cfg, QuantConfig.from_yaml(I2V_YAML), "int8")
    ctx = QuantCtx(mode="int8", policies=pol, state=st, rotations=rot)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    log(f"  {TASK_I2V} bf16 weights and the int8 state resident: {held / 2**30:.2f} GiB")

    clip_pth = str(CKPT_I2V / cfg.clip_checkpoint)
    clip = clipm.CLIPModel(checkpoint_path=clip_pth, device="cuda")
    frame = img[None, :, None]
    clip_fea = clip.visual(frame.cuda())
    t0 = time.perf_counter()
    host = clipm.CLIPModel(checkpoint_path=clip_pth, device="cpu").visual(frame)
    rel = _rel(torch, host, clip_fea)
    log(f"  CLIP visual {tuple(frame.shape)} -> {tuple(clip_fea.shape)}, f32: card vs CPU rel-L2 "
        f"{rel:.3e} (the CPU's {time.perf_counter() - t0:.1f} s with the load)")
    check(rel <= 1e-4, f"CLIP card vs CPU rel-L2 {rel:.3e} > 1e-4")
    del clip, host

    lat_h, lat_w = i2v_latent_size(cfg, (480, 832), 832 * 480)
    h, w, lat_f = lat_h * 8, lat_w * 8, (FRAMES - 1) // 4 + 1
    vid = torch.cat([resize_cubic(img[None].cuda(), (h, w))[:, :, None],
                     torch.zeros((1, 3, FRAMES - 1, h, w), device="cuda")], dim=2)
    vae_pth = str(CKPT_I2V / cfg.vae_checkpoint)
    z = {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        vae = vaem.WanVAE(vae_pth=vae_pth, compute_dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        z[label] = vae.encode(vid)
        torch.cuda.synchronize()
        log(f"  VAE encode {label} {tuple(vid.shape)} -> {tuple(z[label].shape)} with the 14B "
            f"state resident: {time.perf_counter() - t0:.2f} s, peak beyond the "
            f"{base / 2**30:.2f} GiB held {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f}"
            f" GiB")
        del vae
        torch.cuda.empty_cache()
    log(f"  VAE encode bf16 vs f32 (the path's latents): rel-L2 "
        f"{_rel(torch, z['f32'], z['bf16'].float()):.3e}")
    crop = vid[:, :, :5, :120, :208].contiguous()
    vae_params = vaem.load_vae_checkpoint(vae_pth, device="cpu")
    card = vaem.WanVAE(params=vae_params, device="cuda").encode(crop)
    t0 = time.perf_counter()
    host = vaem.WanVAE(params=vae_params, device="cpu").encode(crop.cpu())
    rel = _rel(torch, host, card)
    log(f"  VAE encode {tuple(crop.shape)} f32: card vs CPU rel-L2 {rel:.3e} (the CPU's "
        f"{time.perf_counter() - t0:.1f} s)")
    check(rel <= 1e-4, f"VAE encode f32 card vs CPU rel-L2 {rel:.3e} > 1e-4")
    y = torch.cat([first_frame_mask(FRAMES, lat_h, lat_w, 4, device="cuda"),
                   z["bf16"][0].float()], dim=0)
    del vid, crop, card, host, z, vae_params
    torch.cuda.empty_cache()

    with np.load(ctx_file) as data:
        context, context_null = (torch.from_numpy(data[k]).cuda()
                                 for k in ("context", "context_null"))
    extra = {"y": y[None], "clip_fea": clip_fea}
    seq_len = lat_f * lat_h * lat_w // 4
    lat = torch.randn((1, 16, lat_f, lat_h, lat_w), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    pipe = WanI2V(cfg, params, device="cuda")
    preds = {}

    def step(label, c):
        with torch.no_grad():
            preds[label] = pipe._split(lat, 999.0, context, context_null, c, seq_len,
                                       extra=extra)

    profile_steps(torch, {"i2v_w4a8_mixed": lambda: step("quant", ctx),
                          "bf16_i2v": lambda: step("bf16", None)}, ref="bf16_i2v")
    got = {}
    for label, (c, u) in preds.items():
        got[label] = {5.0: (u + 5.0 * (c - u)).cpu().numpy().astype(np.float64),
                      1.0: c.cpu().numpy().astype(np.float64)}
    (psnr, cos), (psnr1, cos1) = (psnr_cos(got["bf16"][gs], got["quant"][gs]) for gs in (5.0, 1.0))
    log(f"  i2v_w4a8_mixed vs bf16 FP noise prediction ({TASK_I2V} {SIZE}x{FRAMES}, seq "
        f"{seq_len}, t=999): CFG 5.0 PSNR {psnr:.2f} dB, cosine {cos:.6f}; conditional PSNR "
        f"{psnr1:.2f} dB, cosine {cos1:.6f}")
    check(all(np.isfinite(v).all() for g in got.values() for v in g.values()),
          "non-finite i2v noise prediction")
    check(cos1 >= 0.9 and cos >= 0.5,
          f"i2v_w4a8_mixed cosine {cos1:.4f} (conditional) < 0.9 or {cos:.4f} (CFG) < 0.5")
    del params, ctx, pipe, preds, extra
    torch.cuda.empty_cache()


def schedule_and_capture(torch, np, calib_path, launches):
    """Two checks at T2V-1.3B from phase 3's calibration (no new one):
    ``quant_ctx_schedule`` over 3 UniPC steps at 832x480x81 with W8A8 for t
    at or above the midpoint of the first two timesteps and mixed W4A8
    below: step 1 launches W8A8's kernels, steps 2-3 mixed W4A8's (per
    block x 30, exact); ``capture_attn_maps`` from the deployed W8A8 model
    at 17 frames (seq 8192, 7800 valid), pool 256: 30 maps [12, 32, 32],
    every row of mass 1/pool (within 1e-3), the radii of
    select_temporal_windows, and the maps against a calib-mode capture of
    the same forward: the FP model's deployed capture equal bit for bit, the
    W8A8 one within rel-L2 5e-2 (its quantization error), stated before the
    first run."""
    from wanq_tpu_torch.cli.common import load_contexts, load_params
    from wanq_tpu_torch.configs import SIZE_CONFIGS, WAN_CONFIGS
    from wanq_tpu_torch.models.dit import dit_forward, linear_layer_names
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.pipelines.text2video import (
        WanT2V, compute_seq_len, compute_target_shape)
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.attn import select_temporal_windows
    from wanq_tpu_torch.quant.ptq import prepare_quant_state
    from wanq_tpu_torch.quant.qlinear import QuantCtx

    cfg = WAN_CONFIGS[TASK]
    args = argparse.Namespace(base_seed=42, device="cuda", random_init=True, ckpt_dir=None,
                              context_file=None)
    params = load_params(args, cfg)
    context, context_null = (torch.from_numpy(a).cuda() for a in load_contexts(args, cfg))
    calib = dict(np.load(calib_path))
    ctxs = {}
    for label in SCHEDULE:
        pol, st, rot = prepare_quant_state(params, linear_layer_names(cfg),
                                           QuantConfig.from_yaml(PATHS[label][0]),
                                           calib=calib, targets="int8")
        ctxs[label] = QuantCtx(mode="int8", policies=pol, state=st, rotations=rot)
    pipe = WanT2V(cfg, params, device="cuda")
    ts = pipe._make_scheduler("unipc", STEPS, 5.0).timesteps
    t1 = (float(ts[0]) + float(ts[1])) / 2
    pipe = WanT2V(cfg, params, device="cuda",
                  quant_ctx_schedule=[(t1, ctxs[SCHEDULE[0]]), (0.0, ctxs[SCHEDULE[1]])])
    per_step, marks = [], []

    def on_step(i, t, latents):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        per_step.append(_lib.launch_counts())
        _lib.reset_launch_counts()

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    marks.append(time.perf_counter())
    pipe.generate(context, context_null, size=SIZE_CONFIGS[SIZE], frame_num=FRAMES,
                  sampling_steps=STEPS, seed=42, on_step=on_step)
    log(f"  quant_ctx_schedule [(t >= {t1:.1f}: {SCHEDULE[0]}), (0: {SCHEDULE[1]})] over the "
        f"timesteps {[int(t) for t in ts]}: step s "
        f"{', '.join(f'{marks[i + 1] - marks[i]:.3f}' for i in range(STEPS))}; launches per step "
        f"{per_step}")
    for i, counts in enumerate(per_step):
        label = SCHEDULE[0] if float(ts[i]) >= t1 else SCHEDULE[1]
        want = {k: v * cfg.num_layers for k, v in PATHS[label][1].items()}
        check(counts == want, f"schedule step {i + 1} ({label}): launches {counts}, want {want}")
        for name, cnt in counts.items():
            name = MODES.get(name, name)
            launches[name] = launches.get(name, 0) + cnt
    check([float(t) >= t1 for t in ts] == [True] + [False] * (STEPS - 1),
          f"the schedule's threshold {t1} does not split the timesteps {list(ts)} after step 1")

    shape = compute_target_shape(cfg, SIZE_CONFIGS[SIZE], CAPTURE_FRAMES)
    seq_len = compute_seq_len(cfg, shape)
    valid = shape[1] * shape[2] * shape[3] // 4
    tpf = shape[2] * shape[3] // 4
    lat = torch.randn((1, *shape), generator=torch.Generator(device="cuda").manual_seed(3),
                      device="cuda")
    kw = dict(size=SIZE_CONFIGS[SIZE], frame_num=CAPTURE_FRAMES, pool=CAPTURE_POOL,
              reduce="mean", latents=lat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps = WanT2V(cfg, params, quant_ctx=ctxs["w8a8"], device="cuda").capture_attn_maps(
        context, **kw)
    cap_s = time.perf_counter() - t0
    fp_maps = WanT2V(cfg, params, device="cuda").capture_attn_maps(context, **kw)
    cctx = QuantCtx(mode="calib", attn_map_pool=CAPTURE_POOL, attn_map_reduce="mean")
    with torch.no_grad():
        dit_forward(params, cfg, lat, torch.full((1,), 500.0, device="cuda"), context, seq_len,
                    ctx=cctx)
    calib_maps = {k[: -len(".attn_map")]: v.float().cpu().numpy()
                  for k, v in cctx.collect.items() if k.endswith(".attn_map")}
    sp = seq_len // CAPTURE_POOL
    check(sorted(maps) == sorted(calib_maps) == sorted(f"blocks.{i}.self_attn"
                                                       for i in range(cfg.num_layers)),
          f"captured {sorted(maps)[:3]}...")
    mass = max(float(np.abs(m.sum(-1) * CAPTURE_POOL - 1).max()) for m in maps.values())
    rels = [float(np.linalg.norm(maps[k] - calib_maps[k]) / np.linalg.norm(calib_maps[k]))
            for k in maps]
    fp_equal = all(np.array_equal(fp_maps[k], calib_maps[k]) for k in maps)
    radii = select_temporal_windows(maps, tokens_per_frame=tpf, pool=CAPTURE_POOL,
                                    threshold=0.9, valid_len=valid)
    log(f"  capture_attn_maps from the deployed w8a8 model ({TASK} {SIZE}x{CAPTURE_FRAMES}, seq "
        f"{seq_len} with {valid} valid, pool {CAPTURE_POOL}): {len(maps)} maps "
        f"{maps['blocks.0.self_attn'].shape} in {cap_s:.2f} s; row mass x pool off 1 by at most "
        f"{mass:.2e}; against the calib-mode capture of the same forward: w8a8 rel-L2 max "
        f"{max(rels):.3e}, the FP model's deployed capture equal bits: {fp_equal}; "
        f"select_temporal_windows (0.9 of the mass): radii "
        f"{sorted({int(r) for v in radii.values() for r in v})}")
    check(all(m.shape == (cfg.num_heads, sp, sp) for m in maps.values()),
          f"capture shape {maps['blocks.0.self_attn'].shape}")
    check(mass <= 1e-3, f"captured rows' mass off 1/pool by {mass:.2e} x pool")
    check(fp_equal, "the FP model's deployed capture differs from the calib-mode capture")
    check(max(rels) <= 5e-2, f"w8a8 capture vs calib-mode capture rel-L2 {max(rels):.3e} > 5e-2")
    check(all(r.shape == (cfg.num_heads,) for r in radii.values()), "select_temporal_windows")
    del params, ctxs, pipe
    torch.cuda.empty_cache()


def image_to_video(torch, results, launches, calib_path):
    """Phase 6: the I2V-14B path at 832*480x81 (kernels at its shapes, the
    checkpoint dir, cli.ptq, cli.generate to the video, CLIP and the VAE
    encoder on the card, fidelity against bf16), then the 1.3B schedule and
    capture checks."""
    import numpy as np

    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.pipelines.image2video import i2v_latent_size

    cfg = WAN_CONFIGS[TASK_I2V]
    img = i2v_image(torch)
    lat_h, lat_w = i2v_latent_size(cfg, tuple(img.shape[1:]), 832 * 480)
    lat_f = (FRAMES - 1) // 4 + 1
    s_path = lat_f * lat_h * lat_w // 4
    log(f"  the [3, 480, 832] image at {SIZE}: latents {lat_f} x {lat_h} x {lat_w} (the area's "
        f"sqrt(832 * 480 * 480 / 832) is 479.99999999999994 in float64, so 58 rows, not 60, as "
        f"in wanq_tpu), video {lat_h * 8} x {lat_w * 8}, seq {s_path} = {s_path // 128} * 128 + "
        f"{s_path % 128} (i2v rounds to no multiple of 512)")
    t0 = time.perf_counter()
    i2v_kernel_checks(torch, recorder(results), (lat_f, lat_h // 2, lat_w // 2))
    torch.cuda.empty_cache()
    log(f"  phase 6 kernels: {time.perf_counter() - t0:.1f} s")
    ctx_file = write_i2v_checkpoint(torch, np, cfg)
    art = i2v_generate(torch, np, cfg, img, ctx_file, launches)
    torch.cuda.empty_cache()
    i2v_fidelity(torch, np, cfg, img, art, ctx_file)
    schedule_and_capture(torch, np, calib_path, launches)


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------


def once_ms(fn):
    """(fn(), its time in ms by CUDA events): one call, for plain versions
    too slow to repeat."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


# the training shapes of phase 7: (label, heads, Sq, Sk, valid keys, the plain
# version's q chunk, summed into the kernels line)
TRAIN_SHAPES = (("self", 12, 32768, 32768, 32760, 1024, True),
                ("cross", 12, 32768, 512, 512, 8192, True),
                ("self 40 heads", 40, 32768, 32768, 32760, 256, False))


def training_kernel_checks(torch, record, shapes=TRAIN_SHAPES):
    """K4's residual mode (the output and each row's LSE), K12 (dq) and K11
    (dk, dv) against their plain versions (_sdpa_lse_reference,
    attention_bwd_reference on the kernel's own o and LSE) at the training
    shapes: self-attention [1, 12, 32768, 128] with 32760 valid keys (the pad
    rows of k/v planted), cross-attention against 512 keys, and self with 40
    heads (T2V-14B, printed with summed=False); ``shapes`` others. Limits:
    the output at K4's, the LSE abs <= 1e-3, each gradient rel-L2 <= 1e-2,
    dk = dv = 0 past the valid keys, a second call of K12 and K11 equal to
    the first bit for bit, and the row table's pad rows (+inf, 0). K12 and
    K11 are timed through flash_attention_bwd, each with the plain reduction
    that fills the row table (flash_bwd_rows: di = sum(o do), lse log2e)
    inside its time; that reduction alone and the whole backward
    (dq, dk and dv in one call, the row table once) are printed beside.
    Beside the kernels: scaled_dot_product_attention's forward and its
    backward (one autograd.grad for dq, dk and dv, on the valid keys)."""
    from wanq_tpu_torch.models.attention import (
        _flash_cuda, _sdpa_lse_reference, attention_bwd_reference, flash_attention_bwd,
        flash_bwd_rows)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, d, qs = 1, 128, 1.0 / math.sqrt(128)
    for label, n, sq, sk, valid, chunk, summed in shapes:
        shape = f"{label} q [1,{sq},{n},128], k/v [1,{sk},{n},128] valid {valid}"
        # [B, S, N, D] views of the projections' [B, S, N*D] rows, as the model
        # hands them over
        q = torch.randn((b, sq, n * d), device=dev, generator=g).bfloat16().view(b, sq, n, d)
        k = torch.randn((b, sk, n * d), device=dev, generator=g).bfloat16().view(b, sk, n, d)
        v = torch.randn((b, sk, n * d), device=dev, generator=g).bfloat16().view(b, sk, n, d)
        k[:, valid:] = 0.0
        v[:, valid:] = 100.0
        do = torch.randn((b, sq, n, d), device=dev, generator=g).bfloat16()

        fwd = lambda: _flash_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), qs,
                                  valid, lse=True)
        out, lse = fwd()
        (want_o, want_lse), plain_ms = once_ms(
            lambda: _sdpa_lse_reference(q, k, v, qs, valid, q_chunk=chunk))
        err, rel = attn_err(out, want_o, f"residual mode {label}")
        lse_err = (lse - want_lse).abs().max().item()
        check(lse.shape == (b, n, sq) and lse_err <= 1e-3,
              f"residual mode {label}: LSE abs err {lse_err:.3e} (limit 1e-3)")
        del want_o, want_lse
        ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k[:, :valid], v[:, :valid]))
        lib_fwd = cuda_ms(lambda: sdpa(ql, kl, vl, scale=qs), warmup=1, reps=3)
        qkv_bytes = 2 * b * n * d * (2 * sq + 2 * sk)
        flops = 2 * b * n * sq * valid * d  # one S-sized product
        ms = cuda_ms(fwd, warmup=1, reps=3)
        record("attention_lse", max(err, lse_err), ms, plain_ms,
               f"{shape} (out rel-L2 {rel:.2e}, LSE abs err {lse_err:.2e}; "
               f"{2 * flops / ms / 1e9:.0f} TFLOP/s; library = scaled_dot_product_attention "
               f"forward on k/v[:valid])", qkv_bytes + 4 * b * n * sq, 2 * flops, "bf16",
               library_ms=lib_fwd, summed=summed)

        got = flash_attention_bwd(q, k, v, out, lse, do, qs, valid)
        again = flash_attention_bwd(q, k, v, out, lse, do, qs, valid)
        check(all(torch.equal(a, z) for a, z in zip(got, again)),
              f"K11/K12 {label}: two calls differ")
        del again
        want, plain_ms = once_ms(lambda: attention_bwd_reference(q, k, v, out, lse, do, qs, valid,
                                                                 q_chunk=chunk))
        check(all(bool(torch.isfinite(a).all()) for a in got), f"K11/K12 {label}: not finite")
        # on the card: at 40 heads a host copy of each gradient in f64 is 1.3 GB
        rels = [((a.float() - w.float()).norm() / w.float().norm()).item()
                for a, w in zip(got, want)]
        errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
        check(max(rels) <= 1e-2, f"K11/K12 {label}: rel-L2 dq, dk, dv {rels} (limit 1e-2)")
        check(not got[1][:, valid:].any() and not got[2][:, valid:].any(),
              f"K11 {label}: dk/dv not zero past the valid keys")
        del got, want
        o_l = sdpa(ql, kl, vl, scale=qs)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(o_l, (ql, kl, vl), do.transpose(1, 2),
                                                      retain_graph=True), warmup=1, reps=3)
        del o_l
        in_bytes = qkv_bytes + 2 * 2 * b * n * sq * d + 4 * b * n * sq  # + dO, o, lse
        note = (f"; flash_attention_bwd, the row table included; the plain and the library "
                f"time are the whole backward (dq, dk, dv: attention_bwd_reference; "
                f"scaled_dot_product_attention's backward on k/v[:valid])")
        rows = flash_bwd_rows(lse, out, do)
        pad = rows[..., sq:]
        check(bool((pad[:, :, 0] == math.inf).all()) and not pad[:, :, 1].any(),
              f"row table {label}: its {pad.shape[-1]} pad rows are not (+inf, 0)")
        rows_ms = cuda_ms(lambda: flash_bwd_rows(lse, out, do), warmup=1, reps=3)
        whole_ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, qs, valid),
                           warmup=1, reps=3)
        log(f"  backward {label}: flash_attention_bwd whole (dq, dk, dv) {whole_ms:.3f} ms = "
            f"{whole_ms / lib_bwd:.3f}x scaled_dot_product_attention's backward "
            f"({lib_bwd:.3f} ms); its row table alone (di = sum(o do), lse log2e; "
            f"flash_bwd_rows) {rows_ms:.3f} ms")
        ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, qs, valid, dkv=False),
                     warmup=1, reps=3)
        record("attention_bwd_dq", errs[0], ms, plain_ms,
               f"{shape} (dq rel-L2 {rels[0]:.2e}; {3 * flops / ms / 1e9:.0f} TFLOP/s{note})",
               in_bytes + 2 * b * n * sq * d, 3 * flops, "bf16", library_ms=lib_bwd,
               summed=summed)
        ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, qs, valid, dq=False),
                     warmup=1, reps=3)
        record("attention_bwd_dkv", max(errs[1:]), ms, plain_ms,
               f"{shape} (dk rel-L2 {rels[1]:.2e}, dv {rels[2]:.2e}; "
               f"{4 * flops / ms / 1e9:.0f} TFLOP/s{note})",
               in_bytes + 2 * 2 * b * n * sk * d, 4 * flops, "bf16", library_ms=lib_bwd,
               summed=summed)
        del q, k, v, do, out, lse, ql, kl, vl, rows, pad
        torch.cuda.empty_cache()


QLORA_YAML = "quant_configs/wan_w4a8_mixed.yaml"
# the launches of one QLoRA step a block (remat): the student's forward and its
# recompute in the backward run K4's residual mode at self- and cross-attention;
# the backward runs K12 at both and K11 at self-attention only (the cross k/v
# come from the frozen FP cross-attention, so they need no gradient); the
# teacher's two no-grad forwards run the plain K4 launch at both; K13 runs the
# three residual updates in each of those four forwards
QLORA_STEP = {"attention_lse": 4, "attention_bwd_dq": 2, "attention_bwd_dkv": 1,
              "attention": 4, "gate_residual": 12}
# the deployed adapted model (quant_generate --lora --hardware, one batched
# forward a block): each adapted site (self q/k/v/o, ffn.0/2) leaves the fused
# producers for qlinear's int route, K7 then K2 (W8) or K8 (W4); the ffn.2
# input's GELU is PyTorch's; K3 and K4 as in bf16; cross-attention is FP
QLORA_DEPLOY = {"quant_sum": 6, "w8a8_linear": 4, "w4a8_linear": 2, "rms_rope_heads": 3,
                "gate_residual": 3, "attention": 2}
QLORA_SEQ = 32760  # 21 x 30 x 52 latent tokens of 832x480x81, unpadded


def qlora_base(torch, cfg):
    """quant_generate --random_init's seed-42 weights, wan_w4a8_mixed.yaml's
    int8 state (W8 self-attention, W4 ffn, dynamic activations) with the FP
    copies of the quantized weights stripped, and rank-16 adapters on the
    default targets (init_lora_from_cfg)."""
    from wanq_tpu_torch.cli.common import load_params
    from wanq_tpu_torch.models.dit import linear_layer_names
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state, strip_quantized_weights
    from wanq_tpu_torch.quant.qlinear import QuantCtx
    from wanq_tpu_torch.training.lora import init_lora_from_cfg

    params = load_params(argparse.Namespace(base_seed=42, device="cuda", random_init=True,
                                            ckpt_dir=None), cfg)
    pol, state, rot = prepare_quant_state(params, linear_layer_names(cfg),
                                          QuantConfig.from_yaml(QLORA_YAML), targets="int8")
    params = strip_quantized_weights(params, pol)
    return (params, QuantCtx(mode="int8", policies=pol, state=state, rotations=rot),
            init_lora_from_cfg(cfg, rank=16, seed=3, device="cuda"))


def distill_batch(torch, cfg, frames, seed=11):
    """One training batch at 832x480: x0 and noise [1, 16, F, 60, 104], t =
    500, two text states, drawn on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lat = (1, cfg.in_dim, (frames - 1) // 4 + 1, 60, 104)
    text = (1, cfg.text_len, cfg.text_dim)
    return (torch.randn(lat, device="cuda", generator=g),
            torch.randn(lat, device="cuda", generator=g),
            torch.tensor([500.0], device="cuda"),
            torch.randn(text, device="cuda", generator=g),
            torch.randn(text, device="cuda", generator=g))


def qlora_steps(torch, cfg, params, qctx, lora, batch, launches, steps=3, seq=QLORA_SEQ,
                since_warmup=False):
    """1 warm-up + ``steps`` QLoRA steps (lr 1e-4, remat, the same batch,
    guidance 3): loss, gnorm, seconds and peak memory of each, the launches
    of every step equal to QLORA_STEP x the layers, finite losses, the last
    of the timed steps below the first of them (``since_warmup``: below the
    warm-up's, the loss of the adapters before any update). Then one more
    forward and backward, split by the host clock: the teacher's two
    forwards, the student's forward, its backward (the blocks' recompute
    included), and the peak of that split. Returns the train
    state, the optimizer, the config, one more step (a callable) for
    qlora_step_profile and the warm-up step's loss, gradient norm and adapter
    gradients (phase 8 (g) holds the planned step against them)."""
    import dataclasses

    from wanq_tpu_torch.models.dit import dit_forward
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.training import (
        DistillConfig, init_train_state, make_qlora_distill_step)
    from wanq_tpu_torch.training.lora import merge_lora_into_quant_state

    dcfg = DistillConfig(learning_rate=1e-4, seq_len=seq, remat=True)
    state, tx = init_train_state(lora, dcfg)
    step = make_qlora_distill_step(cfg, dcfg, tx)
    want = {k: v * cfg.num_layers for k, v in QLORA_STEP.items()}
    losses, warm = [], None
    for i in range(steps + 1):
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, loss, gnorm = step(state.params, state.ema_params, tx, params, qctx, *batch,
                                    3.0)
        loss, gnorm = float(loss), float(gnorm)
        secs = time.perf_counter() - t0
        counts = _lib.launch_counts()
        log(f"  QLoRA step {i}{' (warm-up)' if i == 0 else ''}: loss {loss:.6f}  gnorm "
            f"{gnorm:.4e}  {secs:.3f} s  peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB  launches {counts}")
        check(math.isfinite(loss) and math.isfinite(gnorm), f"QLoRA step {i}: not finite")
        check(counts == want, f"QLoRA step {i}: launches {counts}, want {want}")
        if i:
            losses.append(loss)
            for name, cnt in counts.items():
                launches[name] = launches.get(name, 0) + cnt
        else:
            warm = dict(loss=loss, gnorm=gnorm, grads=[t.grad.clone() for t in _adapter_leaves(
                state.params)])
    first = warm["loss"] if since_warmup else losses[0]
    check(losses[-1] < first, f"QLoRA: the loss {losses[-1]} of the last step is not below "
          f"{first} ({'the warm-up' if since_warmup else 'the first timed step'})")

    # the step's loss, piece by piece (training/distill.py's make_qlora_distill_step)
    x0, noise, t, c, cn = batch
    sigma = (t / dcfg.num_train_timesteps)[:, None, None, None, None]
    xt = (1.0 - sigma) * x0 + sigma * noise
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    mark()
    with torch.no_grad():
        tc, tu = (dit_forward(params, cfg, xt, t, ctx_, seq, ctx=qctx, training=True)
                  for ctx_ in (c, cn))
        v_teacher = tu + 3.0 * (tc - tu)
    mark()
    student = dataclasses.replace(qctx, state=merge_lora_into_quant_state(qctx.state,
                                                                          state.params))
    v = dit_forward(params, cfg, xt, t, c, seq, ctx=student, training=True, remat=True)
    loss = torch.mean(torch.square(v - v_teacher))
    mark()
    loss.backward()
    mark()
    tx.zero_grad(set_to_none=True)
    split = {"teacher forwards (2, no grad)": marks[1] - marks[0],
             "student forward (remat)": marks[2] - marks[1],
             "backward (the blocks' recompute included)": marks[3] - marks[2]}
    log("  QLoRA step split (host clock, synchronized): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
        + f"; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return state, tx, dcfg, lambda: step(state.params, state.ema_params, tx, params, qctx,
                                         *batch, 3.0), warm


def _adapter_leaves(lora):
    """The adapters' tensors (a and b of each layer), in the tree's order."""
    return [t for ab in lora.values() if isinstance(ab, dict) for t in ab.values()]


def qlora_step_profile(torch, run, want):
    """One more QLoRA step under torch.profiler (its launches = ``want``),
    run after every check that reads the adapters, since it updates them:
    the wall time of the profiled step, the device time, the idle share (1 -
    the union of device-activity intervals / the wall time) and the device
    ms, share and count of each kernel group: K4's residual mode, K12, K11,
    the plain K4 of the teacher's two no-grad forwards, cuBLAS (gemm / nvjet
    / cutlass kernels), and the rest (elementwise glue, reductions, copies,
    the optimizer). Both K4 modes are one kernel (flash_fwd_kernel) on one
    stream: the i-th of its launches in device order is the i-th K4 launch
    the wrapper made, whose counter (attention or attention_lse) the step
    logs. The whole table goes to _smoke_out/profile_qlora_step.txt."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from wanq_tpu_torch.ops import _lib

    k4_modes, launch = [], _lib.launch

    def logged(counter, *args):
        launch(counter, *args)
        if counter in ("attention", "attention_lse"):
            k4_modes.append(counter)

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    _lib.launch = logged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        _lib.launch = launch
    counts = _lib.launch_counts()
    check(counts == want, f"QLoRA profiled step: launches {counts}, want {want}")
    kern = sorted(device_ops(prof.events()), key=lambda e: e.time_range.start)
    if not kern:
        log(f"  QLoRA step profile: wall {wall:.1f} ms; the profiler saw no device activity, "
            "so the kernel split is not measured")
        return
    n_fwd = sum("flash_fwd_kernel" in e.name for e in kern)
    if n_fwd != len(k4_modes):
        log(f"  QLoRA step profile: {n_fwd} flash_fwd_kernel on the device, {len(k4_modes)} K4 "
            "launches logged, so K4's two modes are not told apart")
    seen_fwd = 0
    groups, by_name = {}, {}
    busy, end = 0.0, -math.inf
    for e in kern:
        a, z = e.time_range.start, e.time_range.end
        if z > end:
            busy += z - max(a, end)
            end = z
        t = (z - a) / 1e3
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += t
        tot[1] += 1
        if "flash_fwd_kernel" in e.name:
            g = ("K4, both modes" if n_fwd != len(k4_modes) else
                 "K4 plain (teacher)" if k4_modes[seen_fwd] == "attention" else
                 "K4 residual mode")
            seen_fwd += 1
        elif "flash_bwd_dq_kernel" in e.name:
            g = "K12 (dq)"
        elif "flash_bwd_dkv_kernel" in e.name:
            g = "K11 (dk, dv)"
        elif any(sub in e.name for sub in KERNEL_NAMES):
            g = "other hand kernels"
        elif re.search(r"gemm|gemv|nvjet|cutlass|xmma|cublas|splitk", e.name, re.I):
            g = "cuBLAS"
        else:
            g = "elementwise glue, reductions, copies"
        tot = groups.setdefault(g, [0.0, 0])
        tot[0] += t
        tot[1] += 1
    dev_ms = sum(t for t, _ in by_name.values())
    with open(OUT / "profile_qlora_step.txt", "w") as f:
        for name, (t, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
            f.write(f"{t:10.3f} ms  n={cnt:6d}  {name}\n")
    log(f"  QLoRA step profile (torch.profiler, one step): wall {wall:.1f} ms, device time "
        f"{dev_ms:.1f} ms, idle share {1 - busy / 1e3 / wall:.4f}; "
        f"{sum(c for _, c in by_name.values())} kernels")
    for g, (t, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"    {g}: {t:.1f} ms ({100 * t / dev_ms:.1f}%, n={cnt})")
    for name, (t, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"    {t:9.2f} ms {100 * t / dev_ms:5.1f}%  n={cnt:5d}  {name[:90]}")


def qlora_grad_check(torch, cfg, params, qctx, lora, batch, dcfg):
    """(c) The adapters' gradients of the distillation loss on the first 2
    blocks, full width and sequence: the kernel route (K4's residual mode,
    K12, K11) against the plain-attention route (attention(force_reference=
    True): the chunked plain forward with its LSE and attention_bwd_reference),
    rel-L2 <= 1e-2 over all adapters; and the same loss and gradients with
    the residual updates on the plain chain instead of K13: equal bit for
    bit."""
    import dataclasses
    import functools

    import wanq_tpu_torch.models.dit as dit
    from wanq_tpu_torch.models.attention import attention
    from wanq_tpu_torch.ops.fused import gate_residual_plain
    from wanq_tpu_torch.training import make_qlora_distill_step

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params2 = {**params, "blocks": params["blocks"][:2]}
    lora2 = {k: v for k, v in lora.items() if not k.startswith("blocks.")
             or k.startswith(("blocks.0.", "blocks.1."))}
    leaves = [t for k, ab in lora2.items() if k != "__scale__" for t in ab.values()]
    loss_fn = make_qlora_distill_step(cfg2, dcfg, None).loss_fn

    def grads(with_loss=False):
        for t in leaves:
            t.grad = None
        loss = loss_fn(lora2, params2, qctx, *batch, 3.0)
        loss.backward()
        return ([loss.detach()] if with_loss else []) + [t.grad.clone() for t in leaves]

    t0 = time.perf_counter()
    kern = grads(with_loss=True)
    t_kern = time.perf_counter() - t0
    k13 = dit.gate_residual
    dit.gate_residual = gate_residual_plain
    try:
        chain = grads(with_loss=True)
    finally:
        dit.gate_residual = k13
    same = all(torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
               for a, b in zip(kern, chain))
    log(f"  QLoRA loss and gradients, 2 blocks at seq {QLORA_SEQ}: K13 against the plain "
        f"chain at the residual updates: {'equal bits' if same else 'DIFFERENT'} "
        f"(loss {float(kern[0]):.9e})")
    check(same, "QLoRA: K13's loss or gradients differ from the plain chain's")
    kern = kern[1:]
    dit.attention = functools.partial(attention, force_reference=True)
    try:
        t0 = time.perf_counter()
        plain = grads()
        t_plain = time.perf_counter() - t0
    finally:
        dit.attention = attention
    for t in leaves:
        t.grad = None
    num = sum(float((a.float() - b.float()).square().sum()) for a, b in zip(kern, plain))
    den = sum(float(b.float().square().sum()) for b in plain)
    rel = math.sqrt(num / den)
    worst = max(_rel(torch, b, a) for a, b in zip(kern, plain) if float(b.norm()) > 0)
    log(f"  QLoRA gradients, 2 blocks at seq {QLORA_SEQ}: kernel route vs plain attention "
        f"rel-L2 {rel:.3e} over {len(leaves)} adapter tensors (worst tensor {worst:.3e}); "
        f"forward + backward {t_kern:.2f} s (kernels) / {t_plain:.2f} s (plain)")
    check(math.isfinite(rel) and rel <= 1e-2, f"QLoRA gradients: rel-L2 {rel:.3e} > 1e-2")


def qlora_deploy(torch, cfg, params, qctx, state, tx, launches):
    """(e) save_lora_checkpoint, then quant_generate --lora <dir> --hardware
    (wan_w4a8_mixed.yaml, --random_init seed 42, 1 step at 81 frames): its
    launches exactly QLORA_DEPLOY x the layers (one batched forward), finite
    latents, and its DiT forward (recorded) against dit_forward(training=
    True) of the same adapted model on the same inputs: PSNR >= 35 dB."""
    import dataclasses

    import numpy as np

    import wanq_tpu_torch.pipelines.text2video as t2v
    from wanq_tpu_torch.cli import quant_generate
    from wanq_tpu_torch.models.dit import dit_forward
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.training.lora import (
        merge_lora_into_quant_state, resume_lora_checkpoint, save_lora_checkpoint)

    ckpt = save_lora_checkpoint(str(OUT / "qlora"), 4, state.params, opt_state=tx)
    lora, opt, step, _ = resume_lora_checkpoint(ckpt)
    check(step == 4 and opt is not None and sorted(lora) == sorted(state.params),
          "save / resume_lora_checkpoint")
    recorded = []
    orig = t2v.dit_forward

    def record(*a, **kw):
        out = orig(*a, **kw)
        recorded.append((a, kw, out))
        return out

    lat_path = str(OUT / "latents_qlora_deploy.npz")
    args = quant_generate.parse_args(cli_args(QLORA_YAML, [
        "--hardware", "--sample_steps", "1", "--base_seed", "42", "--lora", ckpt,
        "--save_file", lat_path]))
    t2v.dit_forward = record
    try:
        _lib.reset_launch_counts()
        t0 = time.time()
        quant_generate.generate(args)
        counts = _lib.launch_counts()
    finally:
        t2v.dit_forward = orig
    want = {k: v * cfg.num_layers for k, v in QLORA_DEPLOY.items()}
    log(f"  quant_generate --lora {os.path.relpath(ckpt, ROOT)} --hardware ({QLORA_YAML}, "
        f"1 step, incl. random init and PTQ): {time.time() - t0:.1f} s; launches {counts}")
    check(counts == want, f"deploy: launches {counts}, want {want}")
    for name, cnt in counts.items():
        launches[name] = launches.get(name, 0) + cnt
    lat = np.load(lat_path)["latents"]
    check(bool(np.isfinite(lat).all()), "deploy: non-finite latents")
    check(len(recorded) == 1, f"deploy: {len(recorded)} forwards recorded, want 1 (batched)")
    (p_cli, _, x, t, context, seq_len), kw, got = recorded[0]
    ctx = dataclasses.replace(qctx, state=merge_lora_into_quant_state(qctx.state, lora))
    with torch.no_grad():
        ref = dit_forward(params, cfg, x, t, context, seq_len, ctx=ctx, training=True)
    psnr, cos = psnr_cos(ref.double().cpu().numpy(), got.double().cpu().numpy())
    log(f"  deployed forward (K7, K2, K8, K3, K4) vs the trainable route of the same "
        f"adapted model, batched CFG pair at t={float(t[0]):.0f}: PSNR {psnr:.2f} dB, "
        f"cosine {cos:.6f}")
    check(psnr >= 35.0, f"deploy: PSNR {psnr:.2f} dB < 35")


def other_builders(torch, cfg):
    """(f) make_distill_step (every parameter, the seed-42 weights as the
    teacher) and make_lora_distill_step (FP LoRA, rank 16) at full depth,
    832x480x9 (seq 4680), 2 steps each: finite losses, seconds, peak."""
    import argparse as _argparse

    from wanq_tpu_torch.cli.common import load_params
    from wanq_tpu_torch.models.dit import linear_layer_names
    from wanq_tpu_torch.training import (
        DistillConfig, distill_step, init_train_state, make_distill_step,
        make_lora_distill_step)
    from wanq_tpu_torch.training.lora import init_lora

    params = load_params(_argparse.Namespace(base_seed=42, device="cuda", random_init=True,
                                             ckpt_dir=None), cfg)
    x0, noise, t, c, cn = distill_batch(torch, cfg, 9, seed=12)
    batch = {"x0": x0, "noise": noise, "t": t, "context": c, "null_context": cn}
    dcfg = DistillConfig(learning_rate=1e-5, seq_len=3 * 30 * 52, remat=True)
    for label, trained, make in (
            ("make_distill_step (every parameter)", params, make_distill_step),
            ("make_lora_distill_step (FP LoRA, rank 16)",
             init_lora(params, linear_layer_names(cfg), rank=16, seed=3),
             make_lora_distill_step)):
        state, tx = init_train_state(trained, dcfg)
        step = make(cfg, dcfg, tx)
        for i in range(2):
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, info = distill_step(state, step, params, batch, dcfg)
            secs = time.perf_counter() - t0
            log(f"  {label} step {i}: loss {info['loss']:.6f} gnorm {info['grad_norm']:.4e} "
                f"guidance {info['guidance']:.0f}  {secs:.3f} s  peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            check(math.isfinite(info["loss"]) and math.isfinite(info["grad_norm"]),
                  f"{label}: not finite")
        del state, tx, step
        torch.cuda.empty_cache()


def training(torch, results, launches):
    """Phase 7: the kernels of the training path against their plain
    versions, QLoRA at T2V-1.3B full depth, its gradients against the plain
    route, the deployment of its adapters, and the other two step builders.
    Returns the warm-up QLoRA step's loss, gradient norm and gradients."""
    from wanq_tpu_torch.configs import WAN_CONFIGS

    t0 = time.time()
    training_kernel_checks(torch, recorder(results))
    log(f"  phase 7 kernels: {time.time() - t0:.1f} s")
    cfg = WAN_CONFIGS[TASK]
    t0 = time.time()
    params, qctx, lora = qlora_base(torch, cfg)
    log(f"  QLoRA base ({QLORA_YAML}, FP copies stripped) and rank-16 adapters: "
        f"{time.time() - t0:.1f} s, held {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    batch = distill_batch(torch, cfg, FRAMES)
    state, tx, dcfg, one_step, warm = qlora_steps(torch, cfg, params, qctx, lora, batch,
                                                  launches)
    qlora_grad_check(torch, cfg, params, qctx, state.params, batch, dcfg)
    qlora_deploy(torch, cfg, params, qctx, state, tx, launches)
    torch.cuda.empty_cache()
    qlora_step_profile(torch, one_step, {k: v * cfg.num_layers for k, v in QLORA_STEP.items()})
    del params, qctx, lora, state, tx, batch, one_step
    torch.cuda.empty_cache()
    other_builders(torch, cfg)
    return warm


# ---------------------------------------------------------------------------
# phase 8: multi-GPU on one card
# ---------------------------------------------------------------------------

# the ring shapes: (tag, B, heads, S, valid, tokens a frame, the ring sizes)
RING_SHAPES = (("1.3B 480p", 2, 12, 32768, 32760, 1560, (2, 4, 8)),
               ("T2V-14B 720p", 1, 40, 75776, 75600, 3600, (8,)))


def _ring_operands(torch, g, b, n, s, valid):
    """q (softmax scale folded in), k, v heads-major [B, N, S, 128] bf16, the
    pad rows of k/v planted (k 0, v 100)."""
    dev = torch.device("cuda")
    q = (torch.randn((b, n, s, 128), device=dev, generator=g) * 128 ** -0.5).bfloat16()
    k = torch.randn((b, n, s, 128), device=dev, generator=g).bfloat16()
    v = torch.randn((b, n, s, 128), device=dev, generator=g).bfloat16()
    k[:, :, valid:] = 0.0
    v[:, :, valid:] = 100.0
    return q, k, v


def partial_checks(torch, record, attn_err):
    """(a) K4's partial mode, one ring hop, against ring.partial_attention_plain
    (ring._partial_attn's fold) on the card at K4's limits: shards of
    [2, 12, 32768, 128] with 32760 valid at n = 4, dense and band r = 1 (1560
    tokens a frame); offsets off a tile and a frame, a shard of pad q rows,
    rows the band misses (0 and -inf exactly), and a shard without a valid key
    (refused by the wrapper; the ring's predicate skips it). A hop's time
    beside its bound and the library call that returns the same output and
    LSE, torch.ops.aten._scaled_dot_product_flash_attention on k/v[:valid]."""
    from wanq_tpu_torch.models.attention import TemporalWindow, flash_partial
    from wanq_tpu_torch.parallel.ring import hop_visits, partial_attention_plain

    g = torch.Generator(device="cuda").manual_seed(80)
    b, n, s, valid, tpf = 2, 12, 32768, 32760, 1560
    q, k, v = _ring_operands(torch, g, b, n, s, valid)
    s_loc = s // 4
    # (what, q rows, kv rows, window)
    cases = [("dense hop 1 -> 2", (8192, 16384), (16384, 24576), None),
             ("dense hop 3 -> 3 (pad rows, 8184 valid keys)", (24576, 32768), (24576, 32768),
              None),
             ("band r=1 hop 1 -> 2 (rows in band of the shard's first frames)", (8192, 16384),
              (16384, 24576), 1),
             ("band r=1 hop 0 -> 3 (band misses: every row empty)", (0, 8192), (24576, 32768), 1),
             ("band r=1 offsets off a tile and a frame", (5000, 9096), (9001, 17193), 1),
             ("band r=1 pad q rows only", (32760, 32768), (8192, 16384), 1)]
    for what, (q0, q1), (k0, k1), r in cases:
        win = None if r is None else TemporalWindow(tpf, r)
        qs, ks, vs = q[:, :, q0:q1], k[:, :, k0:k1], v[:, :, k0:k1]
        o, lse = flash_partial(qs, ks, vs, 1.0, q0, k0, valid, window=win)
        o_w, lse_w = partial_attention_plain(qs.transpose(1, 2), ks.transpose(1, 2),
                                             vs.transpose(1, 2), 1.0, q0, k0, valid, win,
                                             q_chunk=1024)
        torch.cuda.synchronize()
        empty = torch.isneginf(lse_w)
        check(torch.equal(torch.isneginf(lse), empty) and not bool(torch.isnan(lse).any()),
              f"K4 partial {what}: empty rows differ")
        check(bool((o.float().transpose(1, 2)[empty] == 0).all()),
              f"K4 partial {what}: an empty row is not 0")
        err = rel = lse_err = 0.0
        if bool((~empty).any()):
            seen = ~empty
            err, rel = attn_err(o.transpose(1, 2)[seen], o_w.transpose(1, 2)[seen],
                                f"partial {what}")
            lse_err = (lse[seen] - lse_w[seen]).abs().max().item()
            check(lse_err <= 1e-3, f"K4 partial {what}: lse err {lse_err}")
        log(f"  K4 partial {what}: q [{q0}, {q1}) kv [{k0}, {k1}): max abs err {err:.3e}, "
            f"rel-L2 {rel:.2e}, lse max err {lse_err:.2e}, empty rows "
            f"{empty.float().mean().item():.3f}")
    check(not hop_visits(0, 256, 32768, 256, valid) and not hop_visits(0, s_loc, 32760, 8, valid),
          "the predicate visits a shard without a valid key")
    try:
        flash_partial(q[:, :, :256], k[:, :, 32760:], v[:, :, 32760:], 1.0, 0, 32760, valid)
        check(False, "K4 partial accepted a shard without a valid key")
    except ValueError:
        pass
    # a hop's time: dense hop 1 -> 2 and band r = 1 hop 1 -> 2, beside the bound
    # and the library: the flash forward with LSE on the same q and k/v[:valid]
    # (dense), the memory-efficient forward with LSE and the band as an
    # additive bias (band)
    qs, ks, vs = q[:, :, s_loc:2 * s_loc], k[:, :, 2 * s_loc:3 * s_loc], v[:, :, 2 * s_loc:3 * s_loc]
    for r in (None, 1):
        win = None if r is None else TemporalWindow(tpf, r)
        kern = lambda: flash_partial(qs, ks, vs, 1.0, s_loc, 2 * s_loc, valid, window=win)
        plain = lambda: partial_attention_plain(qs.transpose(1, 2), ks.transpose(1, 2),
                                                vs.transpose(1, 2), 1.0, s_loc, 2 * s_loc,
                                                valid, win, q_chunk=1024)
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain, warmup=1, reps=1)
        pairs, q_rows, kv_rows = _hop_extent(s_loc, 2 * s_loc, s_loc, valid, tpf, r)
        library_ms, lib = _hop_library_ms(torch, qs, ks, vs, s_loc, 2 * s_loc, valid, tpf, r)
        o, _ = kern()
        err, rel = attn_err(o, plain()[0].bfloat16(), f"partial timed r={r}")
        # bytes: the q rows that see a key of the shard and the keys some row
        # sees, read once; o (bf16) and the LSE (f32) written in full
        record("attention", err, ms, plain_ms,
               f"partial hop {'dense' if r is None else 'band r=1'} q [2,12,8192,128] rows "
               f"8192.. against k/v rows 16384.. (n = 4 of [2,12,32768,128], valid 32760; "
               f"rel-L2 {rel:.2e}; {pairs / s_loc / s_loc:.3f} of the pairs; {q_rows} q rows "
               f"and {kv_rows} k/v rows needed; library = {lib})",
               2 * b * n * 128 * (q_rows + 2 * kv_rows) + 2 * b * n * s_loc * 128
               + 4 * b * n * s_loc, 4 * b * n * pairs * 128, "bf16", library_ms=library_ms,
               summed=False)
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()


def _hop_library_ms(torch, qs, ks, vs, q0, k0, valid, tpf, r):
    """(ms, what) of the library call that returns a hop's output and LSE:
    aten._scaled_dot_product_flash_attention on k/v[:valid] for a dense hop
    (this shard is all valid), aten._scaled_dot_product_efficient_attention
    with compute_log_sumexp and the band of global positions as an additive
    bf16 bias (-inf outside; broadcast over B and heads, else materialized)
    for a band hop. (None, the reason) where no such call runs; the port
    never makes it."""
    if r is None:
        return (cuda_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            qs, ks, vs, scale=1.0)), "aten._scaled_dot_product_flash_attention, output and LSE")
    from wanq_tpu_torch.models.attention import _band_rows

    sq, sk = qs.shape[2], ks.shape[2]
    rows = torch.arange(q0, q0 + sq, device=qs.device)
    seen = _band_rows(rows, k0 + sk, tpf, r, valid)[:, k0:]  # [Sq, Sk]: global columns k0..
    bias = torch.zeros((sq, sk), dtype=qs.dtype, device=qs.device)
    bias.masked_fill_(~seen, float("-inf"))
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    what = ("aten._scaled_dot_product_efficient_attention, output and LSE, the band as an "
            "additive bias")
    full = bias.expand(qs.shape[0], qs.shape[1], sq, sk)
    for b_in, how in ((full, "broadcast"), (None, "materialized")):
        try:
            b_in = full.contiguous() if b_in is None else b_in
            return cuda_ms(lambda: eff(qs, ks, vs, b_in, True, scale=1.0), warmup=1,
                           reps=3), f"{what} ({how})"
        except RuntimeError as e:
            reason = str(e).splitlines()[0][:160]
    return None, f"none runs ({reason})"


def _hop_extent(q0, k0, n, valid, tpf, r):
    """(pairs, q rows, k/v rows) of a hop, rows q0..q0+n against keys
    k0..k0+n, in the band of radius r (None: dense): the (query, key) pairs
    it computes, the q rows that see a key of the shard and the keys that
    some row sees (a pad row sees every valid key)."""
    kv_end = min(k0 + n, valid)
    pad_rows = max(0, q0 + n - max(q0, valid))
    spans = [(pad_rows, k0, kv_end)]  # (rows, their first key, their key end)
    if r is None:
        spans.append((n - pad_rows, k0, kv_end))
    else:
        for row_f in range(q0 // tpf, (q0 + n - 1) // tpf + 1):
            rows = min((row_f + 1) * tpf, q0 + n, valid) - max(row_f * tpf, q0)
            spans.append((rows, max(k0, (row_f - r) * tpf), min(kv_end, (row_f + r + 1) * tpf)))
    pairs = q_rows = 0
    lo_all, hi_all = kv_end, k0
    for rows, lo, hi in spans:
        if rows > 0 and hi > lo:
            pairs, q_rows = pairs + rows * (hi - lo), q_rows + rows
            lo_all, hi_all = min(lo_all, lo), max(hi_all, hi)
    return pairs, q_rows, hi_all - lo_all if pairs else 0


def ring_schedule_checks(torch, attn_err):
    """(b) The ring's hop schedule over virtual ranks in one process, through
    the functions ring_attention calls (hop_visits, partial_attention: one K4
    partial launch a hop, fold_partial), at 1.3B 480p (n = 2, 4, 8) and T2V-14B
    720p (n = 8), dense and r = 1: every rank's folded output against one K4
    launch over the whole sequence at K4's limits. Prints the hops run
    against the predicate's count and the total hop time against the single
    launch."""
    from wanq_tpu_torch.models.attention import TemporalWindow, _flash_cuda
    from wanq_tpu_torch.parallel import ring

    g = torch.Generator(device="cuda").manual_seed(81)
    for tag, b, n_heads, s, valid, tpf, sizes in RING_SHAPES:
        q, k, v = _ring_operands(torch, g, b, n_heads, s, valid)
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        for r in (None, 1):
            win = None if r is None else TemporalWindow(tpf, r)
            band = None if r is None else (tpf, r)
            kw = {} if r is None else {"tokens_per_frame": tpf, "radii": (r,) * n_heads}
            whole = lambda: _flash_cuda(q, k, v, 1.0, valid, **kw)
            want = whole()
            one_ms = cuda_ms(whole, warmup=1, reps=3)
            for n in sizes:
                s_loc = s // n
                predicted = sum(ring.hop_visits(i * s_loc, s_loc, j * s_loc, s_loc, valid, band)
                                for i in range(n) for j in range(n))

                def schedule():
                    outs, hops = [], 0
                    for idx in range(n):
                        acc = None
                        for i in range(n):
                            src = (idx - i) % n
                            if ring.hop_visits(idx * s_loc, s_loc, src * s_loc, s_loc, valid,
                                               band):
                                hops += 1
                                sl = slice(src * s_loc, (src + 1) * s_loc)
                                acc = ring.fold_partial(acc, *ring.partial_attention(
                                    qs[:, idx * s_loc:(idx + 1) * s_loc], ks[:, sl], vs[:, sl],
                                    1.0, idx * s_loc, src * s_loc, valid, win))
                        outs.append(acc[0].to(torch.bfloat16))
                    return outs, hops

                outs, hops = schedule()
                got = torch.cat(outs, dim=1)
                err, rel = attn_err(got, want, f"ring {tag} n={n} r={r}")
                del outs, got
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                schedule()
                torch.cuda.synchronize()
                ring_ms = (time.perf_counter() - t0) * 1e3
                check(hops == predicted, f"ring {tag} n={n}: {hops} hops, predicate {predicted}")
                log(f"  ring {tag} n={n} {'dense' if r is None else f'band r={r}'}: {hops} of "
                    f"{n * n} hops run (predicate {predicted}), folded output against one K4 "
                    f"launch: max abs err {err:.3e}, rel-L2 {rel:.2e}; all hops of all ranks "
                    f"with the folds {ring_ms:.2f} ms (host clock) against the launch "
                    f"{one_ms:.2f} ms; per rank {ring_ms / n:.2f} ms")
            del want
        del q, k, v, qs, ks, vs
        torch.cuda.empty_cache()


def planned_forward_check(torch, calib_path, launches):
    """(c) One W8A8 CFG forward at 1.3B full width through dit_forward(plan=)
    on a one-rank NCCL group made by init_distributed: the storage cut and
    packed (fsdp 1: every split leaf still gathers through NCCL), the
    Ulysses all-to-alls and the token and batch gathers over one-rank groups,
    against the forward without a plan (equal bits expected). Its launches
    are W8A8's per-block counts x 30 blocks."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from wanq_tpu_torch.cli.common import load_params
    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.models.dit import dit_forward, linear_layer_names
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.parallel import ShardingPlan, init_distributed, make_mesh, shard_params
    from wanq_tpu_torch.pipelines.text2video import compute_seq_len, compute_target_shape
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state, shard_quant_state
    from wanq_tpu_torch.quant.qlinear import QuantCtx

    cfg = WAN_CONFIGS[TASK]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    world = init_distributed("cuda", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    check(world == 1 and dist.get_backend() == "nccl", f"init_distributed: {world}, "
          f"{dist.get_backend()}")
    try:
        args = argparse.Namespace(base_seed=42, device="cuda", ckpt_dir=None, random_init=True)
        params = load_params(args, cfg)
        policies, state, rotations = prepare_quant_state(
            params, linear_layer_names(cfg), QuantConfig.from_yaml(YAML),
            calib=dict(np.load(calib_path)), targets="int8")
        ctx = QuantCtx(mode="int8", policies=policies, state=state, rotations=rotations)
        plan = ShardingPlan(make_mesh())
        shape = compute_target_shape(cfg, (832, 480), FRAMES)
        seq_len = compute_seq_len(cfg, shape, plan.sp_size)
        g = torch.Generator(device="cuda").manual_seed(82)
        x = torch.randn((2, *shape), generator=g, device="cuda")
        t = torch.full((2,), 999.0, device="cuda")
        c = torch.randn((2, cfg.text_len, cfg.text_dim), generator=g, device="cuda")
        with torch.no_grad():
            want = dit_forward(params, cfg, x, t, c, seq_len, ctx=ctx)
            t0 = time.perf_counter()
            sp_params = shard_params(params, plan)
            sp_ctx = QuantCtx(mode="int8", policies=policies,
                              state=shard_quant_state(state, plan), rotations=rotations)
            torch.cuda.synchronize()
            shard_s = time.perf_counter() - t0
            _lib.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = dit_forward(sp_params, cfg, x, t, c, seq_len, ctx=sp_ctx, plan=plan)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts = _lib.launch_counts()
            # warm: the first call also made each group's NCCL communicator
            times = {}
            for label in ("plan", "base", "base", "plan"):
                t0 = time.perf_counter()
                if label == "plan":
                    dit_forward(sp_params, cfg, x, t, c, seq_len, ctx=sp_ctx, plan=plan)
                else:
                    dit_forward(params, cfg, x, t, c, seq_len, ctx=ctx)
                torch.cuda.synchronize()
                times.setdefault(label, []).append(time.perf_counter() - t0)
            plan_s, base_s = (sum(times[k]) / 2 for k in ("plan", "base"))
        for name in (*SOURCES, *MODES):
            want_n = PATHS["w8a8"][1].get(name, 0) * cfg.num_layers
            check(counts.get(name, 0) == want_n,
                  f"planned forward: {name} {counts.get(name, 0)} launches, want {want_n}")
        for name, cnt in counts.items():
            launches[MODES.get(name, name)] = launches.get(MODES.get(name, name), 0) + cnt
        equal = torch.equal(got, want)
        rel = ((got - want).norm() / want.norm()).item()
        check(equal or rel <= 1e-3, f"planned forward rel-L2 {rel:.2e} from the planless one")
        log(f"  W8A8 CFG forward at {TASK} full width (seq {seq_len}) through dit_forward(plan=) "
            f"on a one-rank NCCL group: {'equal bits' if equal else f'rel-L2 {rel:.2e}'} to the "
            f"forward without a plan{'' if equal else ' (not equal bits: an ulp of a reduction order)'}"
            f"; warm {plan_s * 1e3:.1f} ms against {base_s * 1e3:.1f} ms without the plan "
            f"(rounds plan, base, base, plan; the one-rank collectives copy the weights, the "
            f"state, q/k/v and the tokens), the first call {first_s * 1e3:.1f} ms (it makes the "
            f"groups' NCCL communicators); storage cut and packed in {shard_s:.2f} s; launches "
            f"{counts}")
    finally:
        dist.destroy_process_group()


def ulysses_14b_note(torch):
    """(d) Printed only: the per-rank K4 launch of Ulysses 8 at T2V-14B 720p (5
    of its 40 heads over the whole sequence) against the 40-head launch."""
    from wanq_tpu_torch.models.attention import _flash_cuda

    g = torch.Generator(device="cuda").manual_seed(83)
    q, k, v = _ring_operands(torch, g, 1, 40, 75776, 75600)
    ms40 = cuda_ms(lambda: _flash_cuda(q, k, v, 1.0, 75600), warmup=1, reps=3)
    q5, k5, v5 = (t[:, :5].contiguous() for t in (q, k, v))
    ms5 = cuda_ms(lambda: _flash_cuda(q5, k5, v5, 1.0, 75600), warmup=1, reps=3)
    log(f"  Ulysses 8 at T2V-14B 720p: K4 on one rank's 5 heads [1,5,75776,128] {ms5:.2f} ms, "
        f"the 40-head launch {ms40:.2f} ms ({ms40 / ms5:.2f}x; 8 would be linear)")
    del q, k, v, q5, k5, v5
    torch.cuda.empty_cache()


def _rel_dev(want, got) -> float:
    """rel-L2 of two tensors on their device, in f32."""
    w = want.float()
    return ((got.float() - w).norm() / w.norm()).item()


def hop_mode_checks(torch, record):
    """(e) K12 and K11's accumulate mode, one hop of the ring's backward, against
    attention_bwd_reference(rows=) (f32) at the 1.3B 480p self shape split n =
    4 ways: q [1, 12, 8192, 128] (rank 1's rows) against the 8192-key shard 2
    and the last shard (8184 valid keys, its pad k/v planted), dense, the row
    table from rank 1's 4-hop fold (K4's partial mode) of 32760 valid keys.
    Gates: each hop's dq, dk, dv rel-L2 <= 1e-2 (K12's and K11's limits), dk =
    dv = 0 added past the valid keys, and dq summed in f32 over all 4 hops
    against the plain versions' f32 sum at the same limit. Each hop launch is
    timed beside the bf16-out launch on the same shard (flash_attention_bwd,
    its row table included) and its bound (1/16 of the self launch's work),
    with the library's flash backward fed the same folded output and LSE."""
    from wanq_tpu_torch.models.attention import (
        attention_bwd_reference, flash_attention_bwd, flash_attention_bwd_acc, flash_bwd_rows)
    from wanq_tpu_torch.parallel import ring

    g = torch.Generator(device="cuda").manual_seed(84)
    b, n_heads, s, valid, n, idx = 1, 12, 32768, 32760, 4, 1
    q, k, v = _ring_operands(torch, g, b, n_heads, s, valid)
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    s_loc = s // n
    rsl = slice(idx * s_loc, (idx + 1) * s_loc)
    acc = None
    for src in range(n):
        sl = slice(src * s_loc, (src + 1) * s_loc)
        acc = ring.fold_partial(acc, *ring.partial_attention(
            qs[:, rsl], ks[:, sl], vs[:, sl], 1.0, idx * s_loc, src * s_loc, valid))
    o, lse = acc[0].to(torch.bfloat16), acc[1].contiguous()
    do = torch.randn((b, s_loc, n_heads, 128), device="cuda", generator=g).bfloat16()
    rows = flash_bwd_rows(lse, o, do)
    qr = qs[:, rsl]
    f32 = lambda rows_: torch.zeros((b, rows_, n_heads, 128), device="cuda")
    dq_sum, want_sum = f32(s_loc), f32(s_loc)
    for src in range(n):
        sl = slice(src * s_loc, (src + 1) * s_loc)
        kv_valid = min(s_loc, valid - src * s_loc)
        dq, dk, dv = f32(s_loc), f32(s_loc), f32(s_loc)
        flash_attention_bwd_acc(qr, ks[:, sl], vs[:, sl], do, rows, 1.0, kv_valid, dq, dk, dv)
        flash_attention_bwd_acc(qr, ks[:, sl], vs[:, sl], do, rows, 1.0, kv_valid, dq_sum)
        (want, plain_ms) = once_ms(lambda: attention_bwd_reference(
            qr, ks[:, sl], vs[:, sl], None, None, do, 1.0, kv_valid, q_chunk=1024, rows=rows))
        want_sum += want[0]
        rels = [_rel_dev(w, a) for a, w in zip((dq, dk, dv), want)]
        errs = [(a - w).abs().max().item() for a, w in zip((dq, dk, dv), want)]
        check(max(rels) <= 1e-2, f"hop mode shard {src}: rel-L2 dq, dk, dv {rels} (limit 1e-2)")
        check(not dk[:, kv_valid:].any() and not dv[:, kv_valid:].any(),
              f"hop mode shard {src}: dk / dv added past the valid keys")
        if src < 2:
            continue
        # the timed shards: shard 2 (8192 valid keys) and the last (8184)
        ms_dq = cuda_ms(lambda: flash_attention_bwd_acc(qr, ks[:, sl], vs[:, sl], do, rows, 1.0,
                                                        kv_valid, dq))
        ms_dkv = cuda_ms(lambda: flash_attention_bwd_acc(qr, ks[:, sl], vs[:, sl], do, rows, 1.0,
                                                         kv_valid, None, dk, dv))
        bf_dq = cuda_ms(lambda: flash_attention_bwd(qr, ks[:, sl], vs[:, sl], o, lse, do, 1.0,
                                                    kv_valid, dkv=False))
        bf_dkv = cuda_ms(lambda: flash_attention_bwd(qr, ks[:, sl], vs[:, sl], o, lse, do, 1.0,
                                                     kv_valid, dq=False))
        lib_ms, lib = _hop_bwd_library_ms(torch, qr, ks[:, sl], vs[:, sl], o, lse, do, kv_valid,
                                          want)
        pairs = 2 * b * n_heads * s_loc * kv_valid * 128  # one S-sized product
        ins = 2 * b * n_heads * 128 * 2 * (s_loc + kv_valid) + 8 * b * n_heads * s_loc
        shape = (f"hop q [1,12,8192,128] (rank 1 of n = 4) against shard {src}'s {kv_valid} "
                 f"valid keys, the row table of the 4-hop fold (valid 32760)")
        for name, ms, bf, err, rel, out_rows, products, what in (
                ("attention_bwd_dq_acc", ms_dq, bf_dq, errs[0], rels[0], s_loc, 3, "dq"),
                ("attention_bwd_dkv_acc", ms_dkv, bf_dkv, max(errs[1:]), max(rels[1:]),
                 2 * kv_valid, 4, "dk, dv")):
            record(name, err, ms, plain_ms,
                   f"{shape} ({what} rel-L2 {rel:.2e}; the bf16-out launch on this shard "
                   f"{bf:.3f} ms = {ms / bf:.3f}x, its row table included; "
                   f"{products * pairs / ms / 1e9:.0f} TFLOP/s; the plain time is the hop's "
                   f"whole plain backward; library = {lib})",
                   ins + 8 * b * n_heads * 128 * out_rows, products * pairs, "bf16",
                   library_ms=lib_ms)
    rel = _rel_dev(want_sum, dq_sum)
    check(rel <= 1e-2, f"hop mode: dq summed over 4 hops rel-L2 {rel:.3e} from the plain sum")
    log(f"  hop mode: dq summed in f32 over the 4 hops (K12's accumulate mode, launch order) "
        f"against the plain versions' f32 sum: rel-L2 {rel:.2e}")
    del q, k, v, qs, ks, vs, o, lse, do, rows, dq_sum, want_sum
    torch.cuda.empty_cache()


def _hop_bwd_library_ms(torch, q, k, v, o, lse, do, kv_valid, want):
    """(ms, what) of the library's flash backward on one hop: aten's
    _scaled_dot_product_flash_attention_backward on k/v[:kv_valid], fed the
    folded output and LSE (so its di and P are the global ones), after the
    forward that gives it its other arguments; (None, the reason) where it
    does not run or does not compute the hop's gradient (rel-L2 > 1e-2 from the
    plain version). The port never calls it."""
    aten = torch.ops.aten
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k[:, :kv_valid], v[:, :kv_valid]))
    try:
        fwd = aten._scaled_dot_product_flash_attention(qh, kh, vh, scale=1.0)
        lse_lib = fwd[1].clone()
        lse_lib[..., :lse.shape[-1]] = lse
        args = (do.transpose(1, 2), qh, kh, vh, o.transpose(1, 2), lse_lib, *fwd[2:6], 0.0,
                False, fwd[6], fwd[7])
        got = aten._scaled_dot_product_flash_attention_backward(*args, scale=1.0)
        rel = _rel_dev(want[0], got[0].transpose(1, 2).float())
        if not rel <= 1e-2:
            return None, f"none: the flash backward fed the fold reads {rel:.2e} from the hop's dq"
        return (cuda_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
            *args, scale=1.0)), "aten._scaled_dot_product_flash_attention_backward on "
                f"k/v[:valid], fed the folded output and LSE (dq rel-L2 {rel:.2e})")
    except RuntimeError as e:
        return None, f"none runs ({str(e).splitlines()[0][:160]})"


def ring_backward_checks(torch, launches):
    """(f) The ring's backward over virtual ranks in one process, through the
    functions _RingAttention's backward calls (flash_bwd_rows once a rank from
    its fold, hop_backward: one K12 and one K11 accumulate launch a visited
    hop, the dk / dv accumulators travelling with their shards in the ring's
    order), at T2V-1.3B 480p (n = 4 and 8; B = 1, as training runs) and one
    rank's 5 heads of T2V-14B 720p (n = 8): dq, dk and dv against one
    flash_attention_bwd launch over the whole sequence (its own K4 residual
    output and LSE), rel-L2 <= 1e-2; the launches are the visited hops; the
    host-clock total beside the single launch. Its launches count into the
    kernels line."""
    from wanq_tpu_torch.models.attention import _flash_cuda, flash_attention_bwd, flash_bwd_rows
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.parallel import ring

    g = torch.Generator(device="cuda").manual_seed(85)
    for tag, n_heads, s, valid, sizes in (("1.3B 480p", 12, 32768, 32760, (4, 8)),
                                          ("T2V-14B 720p, 5 heads", 5, 75776, 75600, (8,))):
        q, k, v = _ring_operands(torch, g, 1, n_heads, s, valid)
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        do = torch.randn((1, s, n_heads, 128), device="cuda", generator=g).bfloat16()
        out, lse = _flash_cuda(q, k, v, 1.0, valid, lse=True)
        whole = lambda: flash_attention_bwd(qs, ks, vs, out, lse, do, 1.0, valid)
        want = whole()
        one_ms = cuda_ms(whole, warmup=1, reps=3)
        for n in sizes:
            s_loc = s // n
            rank = [slice(i * s_loc, (i + 1) * s_loc) for i in range(n)]
            folds = []
            for idx in range(n):
                acc = None
                for src in range(n):
                    if ring.hop_visits(idx * s_loc, s_loc, src * s_loc, s_loc, valid):
                        acc = ring.fold_partial(acc, *ring.partial_attention(
                            qs[:, rank[idx]], ks[:, rank[src]], vs[:, rank[src]], 1.0,
                            idx * s_loc, src * s_loc, valid))
                folds.append((acc[0].to(torch.bfloat16), acc[1].contiguous()))

            def backward():
                rows = [flash_bwd_rows(lse_r, o_r, do[:, rank[i]])
                        for i, (o_r, lse_r) in enumerate(folds)]
                dq = torch.zeros((1, s, n_heads, 128), device="cuda")
                dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
                hops = 0
                for i in range(n):  # hop i: rank idx holds shard idx - i
                    for idx in range(n):
                        src = (idx - i) % n
                        kv_valid = min(s_loc, valid - src * s_loc)
                        if kv_valid < 1:
                            continue
                        hops += 1
                        ring.hop_backward(qs[:, rank[idx]], ks[:, rank[src]], vs[:, rank[src]],
                                          do[:, rank[idx]], rows[idx], 1.0, kv_valid,
                                          dq[:, rank[idx]], dk[:, rank[src]], dv[:, rank[src]])
                return (dq, dk, dv), hops

            _lib.reset_launch_counts()
            got, hops = backward()
            counts = _lib.launch_counts()
            check(counts == {"attention_bwd_dq_acc": hops, "attention_bwd_dkv_acc": hops},
                  f"ring backward {tag} n={n}: launches {counts}, {hops} hops")
            for name, cnt in counts.items():
                launches[name] = launches.get(name, 0) + cnt
            rels = [_rel_dev(w.float(), a) for a, w in zip(got, want)]
            check(max(rels) <= 1e-2, f"ring backward {tag} n={n}: rel-L2 dq, dk, dv {rels}")
            del got
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            backward()
            torch.cuda.synchronize()
            ring_ms = (time.perf_counter() - t0) * 1e3
            log(f"  ring backward {tag} n={n}: {hops} of {n * n} hops run (one K12 and one K11 "
                f"accumulate launch each), dq, dk, dv against one flash_attention_bwd launch "
                f"rel-L2 {', '.join(f'{r:.2e}' for r in rels)}; all ranks' hops with their row "
                f"tables {ring_ms:.2f} ms (host clock) against the launch {one_ms:.2f} ms "
                f"({ring_ms / one_ms:.3f}x); per rank {ring_ms / n:.2f} ms")
        del q, k, v, qs, ks, vs, do, out, lse, want
        torch.cuda.empty_cache()


def planned_training_check(torch, launches, warm):
    """(g) Calibration and QLoRA through the plan on a one-rank NCCL group at
    T2V-1.3B full width and depth (832x480x81): a 1-step calibration sweep
    (collect_calibration, minmax and GPTQ_REGEX's 210 Hessians) of the seed-42
    weights stored by shard_params, against the planless sweep: equal bits
    (the statistics' all-reduces over one rank); one QLoRA step (phase 7's
    base, adapters and batch; make_qlora_distill_step(plan=), remat) against
    phase 7's warm-up step (``warm``: the planless step from the same
    adapters): the loss, the gradient norm and every adapter's gradient equal
    bits, else rel-L2 <= 1e-3 with the reason printed; the planned step's
    seconds, peak and launches (QLORA_STEP x 30)."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from wanq_tpu_torch.cli.common import load_params
    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.parallel import ShardingPlan, init_distributed, make_mesh, shard_params
    from wanq_tpu_torch.pipelines.text2video import WanT2V
    from wanq_tpu_torch.quant.ptq import shard_quant_state
    from wanq_tpu_torch.quant.qlinear import QuantCtx
    from wanq_tpu_torch.training import DistillConfig, init_train_state, make_qlora_distill_step

    cfg = WAN_CONFIGS[TASK]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    init_distributed("cuda", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        plan = ShardingPlan(make_mesh())
        params = load_params(argparse.Namespace(base_seed=42, device="cuda", ckpt_dir=None,
                                                random_init=True), cfg)
        g = torch.Generator(device="cuda").manual_seed(86)
        c, cn = (torch.randn((1, cfg.text_len, cfg.text_dim), device="cuda", generator=g)
                 for _ in range(2))
        stats, secs = {}, {}
        for label, pl in (("planless", None), ("plan", plan)):
            pipe = WanT2V(cfg, params if pl is None else shard_params(params, pl),
                          quant_ctx=QuantCtx(mode="calib", collect_minmax=True,
                                             hessian_regex=GPTQ_REGEX),
                          device="cuda", shardings=pl)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats[label] = pipe.collect_calibration(c, cn, sampling_steps=1, size=(832, 480),
                                                    frame_num=FRAMES, seed=42)
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t0
            del pipe
        a, z = stats["planless"], stats["plan"]
        n_hess = sum(k.endswith(".hess") for k in a)
        check(sorted(a) == sorted(z) and n_hess == 7 * cfg.num_layers,
              f"planned calibration: {len(z)} entries, {n_hess} Hessians")
        unequal = [k for k in a if not (torch.equal(a[k], z[k]) if torch.is_tensor(a[k])
                                        else np.array_equal(a[k], z[k]))]
        check(not unequal, f"planned calibration: {len(unequal)} entries differ, e.g. "
              f"{unequal[:3]}")
        log(f"  calibration, 1 step at {TASK} 832x480x81 on a one-rank NCCL group: {len(a)} "
            f"entries ({n_hess} f64 Hessians, the absmax and min/max stacks) equal bits to the "
            f"planless sweep; {secs['plan']:.2f} s against {secs['planless']:.2f} s (the first "
            f"planned call makes the groups' NCCL communicators)")
        del stats, a, z, params
        torch.cuda.empty_cache()

        params, qctx, lora = qlora_base(torch, cfg)
        batch = distill_batch(torch, cfg, FRAMES)
        dcfg = DistillConfig(learning_rate=1e-4, seq_len=QLORA_SEQ, remat=True)
        state, tx = init_train_state(lora, dcfg)
        step = make_qlora_distill_step(cfg, dcfg, tx, plan=plan)
        p = shard_params(params, plan)
        qc = dataclasses.replace(qctx, state=shard_quant_state(qctx.state, plan))
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, loss, gnorm = step(state.params, state.ema_params, tx, p, qc, *batch, 3.0)
        z = dict(loss=float(loss), gnorm=float(gnorm), s=time.perf_counter() - t0,
                 peak=torch.cuda.max_memory_allocated() / 2**30, counts=_lib.launch_counts(),
                 grads=[t.grad.clone() for t in _adapter_leaves(state.params)])
        a = warm
        want = {k: v * cfg.num_layers for k, v in QLORA_STEP.items()}
        check(z["counts"] == want, f"planned QLoRA step: launches {z['counts']}, want {want}")
        for name, cnt in z["counts"].items():
            launches[name] = launches.get(name, 0) + cnt
        equal = (a["loss"] == z["loss"] and a["gnorm"] == z["gnorm"]
                 and all(torch.equal(x, y) for x, y in zip(a["grads"], z["grads"])))
        num = sum(float((x.float() - y.float()).square().sum()) for x, y in zip(a["grads"],
                                                                               z["grads"]))
        rel = math.sqrt(num / sum(float(x.float().square().sum()) for x in a["grads"]))
        check(len(a["grads"]) == len(z["grads"]) and math.isfinite(z["loss"])
              and (equal or rel <= 1e-3),
              f"planned QLoRA step: gradients rel-L2 {rel:.2e} from phase 7's warm-up step")
        log(f"  QLoRA step at {TASK} 832x480x81 through make_qlora_distill_step(plan=) on a "
            f"one-rank NCCL group: loss {z['loss']:.6f}, gnorm {z['gnorm']:.4e}; "
            + ("loss, gradient norm and the " + str(len(z["grads"])) + " adapter gradients "
               "equal bits to phase 7's warm-up step (the planless step from the same base, "
               "adapters and batch)" if equal else
               f"rel-L2 {rel:.2e} from phase 7's warm-up step (loss {a['loss']:.6f}, gnorm "
               f"{a['gnorm']:.4e}; not equal bits: an ulp of a reduction order)")
            + f"; planned {z['s']:.3f} s, peak {z['peak']:.2f} GiB; launches a step "
            f"{z['counts']}")
        del params, qctx, lora, batch, state, tx, step, p, qc, a, z
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def multi_gpu(torch, results, launches, calib_path, warm):
    """Phase 8: what one card can show of multi-GPU serving (a run on more
    than one card is not made here). ``warm``: phase 7's warm-up QLoRA step,
    which (g)'s planned step is held against."""
    t0 = time.time()
    partial_checks(torch, recorder(results), attn_err)
    log(f"  phase 8 (a): {time.time() - t0:.1f} s")
    t0 = time.time()
    ring_schedule_checks(torch, attn_err)
    log(f"  phase 8 (b): {time.time() - t0:.1f} s")
    t0 = time.time()
    planned_forward_check(torch, calib_path, launches)
    log(f"  phase 8 (c): {time.time() - t0:.1f} s")
    ulysses_14b_note(torch)
    t0 = time.time()
    hop_mode_checks(torch, recorder(results))
    log(f"  phase 8 (e): {time.time() - t0:.1f} s")
    t0 = time.time()
    ring_backward_checks(torch, launches)
    log(f"  phase 8 (f): {time.time() - t0:.1f} s")
    t0 = time.time()
    planned_training_check(torch, launches, warm)
    log(f"  phase 8 (g): {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 9: the streamed quantized base and QLoRA at T2V-14B full depth
# ---------------------------------------------------------------------------

# tools/qlora_smoke.py's 14B base: 4-bit weights at every block linear (cross
# k/v too: their FP copies would hold 4.2 GiB), dynamic 8-bit activations
QLORA_14B = {"remain_fp_regex": r"text_embedding|time_embedding|time_projection|head\.head",
             "weight": {"n_bits": 4, "sym": False}, "act": {"n_bits": 8, "sym": True}}
QLORA_14B_FRAMES = 9
QLORA_14B_SEQ = 4680  # 3 x 30 x 52 latent tokens of 832x480x9: 36 tiles of 128 + 72 rows
# the training kernels at the 14B 9-frame shapes (printed, not summed)
TRAIN_SHAPES_14B = (("14B self", 40, QLORA_14B_SEQ, QLORA_14B_SEQ, QLORA_14B_SEQ, 1024, False),
                    ("14B cross", 40, QLORA_14B_SEQ, 512, 512, QLORA_14B_SEQ, False))


def stream_parity(torch, cfg, qcfg):
    """(i) The streamed base at full width and ``cfg.num_layers`` blocks
    against prepare_quant_state on the same generators' draws (the prelude,
    the head's redraw, each block's seed): every state leaf equal bit for
    bit, and one int8 forward of each at 832x480x9 within rel-L2 1e-3 (the
    streamed base runs with stripped FP placeholders; equal bits printed)."""
    from wanq_tpu_torch.models import dit
    from wanq_tpu_torch.quant.ptq import prepare_quant_state
    from wanq_tpu_torch.quant.qlinear import QuantCtx
    from wanq_tpu_torch.quant.stream import (
        BLOCK_SEED, PRELUDE_SEED, build_streamed_quant_base, head_draw)

    params_s, qctx_s, qbytes = build_streamed_quant_base(cfg, qcfg)
    params = dit.make_nonblock_generator(cfg)(PRELUDE_SEED)
    w = params["head"]["head"]["w"]
    params["head"]["head"]["w"] = head_draw(w.shape, w.dtype, "cuda")
    gen = dit.make_block_generator(cfg)
    params["blocks"] = [gen(BLOCK_SEED + i) for i in range(cfg.num_layers)]
    pol, state, rot = prepare_quant_state(params, dit.linear_layer_names(cfg), qcfg,
                                          targets="int8")
    check(sorted(state) == sorted(qctx_s.state), "streamed base: other layers than the "
          "conventional build's")
    unequal = [f"{n}|{k}" for n, st in state.items() for k, v in st.items()
               if not torch.equal(v, qctx_s.state[n][k])]
    check(not unequal, f"streamed base: {len(unequal)} state leaves differ, e.g. {unequal[:3]}")
    x0, _, t, c, _ = distill_batch(torch, cfg, QLORA_14B_FRAMES, seed=21)
    with torch.no_grad():
        out_s = dit.dit_forward(params_s, cfg, x0, t, c, QLORA_14B_SEQ, ctx=qctx_s)
        out_c = dit.dit_forward(params, cfg, x0, t, c, QLORA_14B_SEQ,
                                ctx=QuantCtx(mode="int8", policies=pol, state=state,
                                             rotations=rot))
    rel = _rel(torch, out_c, out_s)
    log(f"  (i) streamed base, {cfg.num_layers} blocks at full width: {len(state)} layers' "
        f"state ({qbytes / 2**20:.1f} MiB) equal bits to prepare_quant_state on the same draws; "
        f"one int8 forward at 832x480x{QLORA_14B_FRAMES} against the conventional build's: "
        f"rel-L2 {rel:.3e}, equal bits {torch.equal(out_s, out_c)}")
    check(bool(torch.isfinite(out_s).all()) and rel <= 1e-3,
          f"streamed forward rel-L2 {rel:.3e} from the conventional build")


def streamed_14b(torch, results, launches):
    """Phase 9: (i) the streamed base against the conventional build at 2
    blocks; (ii) the streamed W4A8 base of T2V-14B at all 40 blocks: seconds,
    int bytes against class_weight_bytes, memory held after, the peak
    allocated during the build (gate: the int bytes + 4 GiB); (iii) K4's
    residual mode, K12 and K11 at the 14B 9-frame shapes; (iv) 1 warm-up + 2
    QLoRA steps on that base (rank 16, seed 3, remat, lr 1e-4, guidance 3,
    x0 and noise [1, 16, 3, 60, 104], seq 4680) with launches QLORA_STEP x 40,
    the last loss below the warm-up's (the two timed steps need not fall
    between themselves: on the card the second reads above the first at lr
    1e-4, both far below the warm-up's), and the split of one more."""
    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.planner import class_weight_bytes
    from wanq_tpu_torch.quant.stream import build_streamed_quant_base
    from wanq_tpu_torch.training.lora import DEFAULT_TARGETS, init_lora_from_cfg

    full = dataclasses.replace(WAN_CONFIGS[TASK_14B], num_layers=40)
    qcfg = QuantConfig.from_dict(QLORA_14B)
    t0 = time.time()
    stream_parity(torch, dataclasses.replace(full, num_layers=2), qcfg)
    torch.cuda.empty_cache()
    log(f"  phase 9 (i): {time.time() - t0:.1f} s")

    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, qctx, qbytes = build_streamed_quant_base(full, qcfg, log=log)
    secs = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - held0
    peak = torch.cuda.max_memory_allocated() - held0
    model = sum(class_weight_bytes(full, 4).values())
    log(f"  (ii) streamed W4A8 base, T2V-14B all 40 blocks ({len(qctx.state)} layers): "
        f"{secs:.2f} s; int bytes {qbytes / 2**30:.3f} GiB (class_weight_bytes: "
        f"{model / 2**30:.3f} GiB, which leaves out delta_w and zp_w, 8 B a channel); held after "
        f"{held / 2**30:.3f} GiB; peak during the build {peak / 2**30:.3f} GiB (gate: the int "
        f"bytes + 4 GiB)")
    check(abs(qbytes - model) <= 0.01 * model, f"streamed base: {qbytes} int bytes, the byte "
          f"model {model}")
    check(peak <= qbytes + 4 * 2**30, f"streamed build peak {peak / 2**30:.3f} GiB over the "
          f"int bytes + 4 GiB")

    t0 = time.time()
    training_kernel_checks(torch, recorder(results), TRAIN_SHAPES_14B)
    log(f"  phase 9 (iii): {time.time() - t0:.1f} s")

    t0 = time.time()
    lora = init_lora_from_cfg(full, rank=16, seed=3, targets=DEFAULT_TARGETS, device="cuda")
    batch = distill_batch(torch, full, QLORA_14B_FRAMES)
    log(f"  (iv) QLoRA at {TASK_14B}, all 40 blocks, 832x480x{QLORA_14B_FRAMES} (seq "
        f"{QLORA_14B_SEQ}), rank 16 on {DEFAULT_TARGETS}: base and adapters held "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (card: {nvidia_smi()})")
    qlora_steps(torch, full, params, qctx, lora, batch, launches, steps=2, seq=QLORA_14B_SEQ,
                since_warmup=True)
    del params, qctx, lora, batch
    torch.cuda.empty_cache()
    log(f"  phase 9 (iv): {time.time() - t0:.1f} s")

    t0 = time.time()
    env = {k: v for k, v in os.environ.items() if k != "PYTORCH_CUDA_ALLOC_CONF"}
    r = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                        "sys.exit(chip_smoke.qlora_81_frames(2))"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    for line in r.stdout.splitlines():
        log(line)
    check(r.returncode == 0, f"phase 9 (v) failed (exit {r.returncode}): {r.stderr[-3000:]}")
    log(f"  phase 9 (v): {time.time() - t0:.1f} s")


QLORA_81_GATE_GIB = 60.0


def qlora_81_frames(blocks: int) -> int:
    """Phase 9 (v), in its own process (the caller removes
    PYTORCH_CUDA_ALLOC_CONF from its environment): 1 warm-up + 1 QLoRA step
    at 832x480x81 on ``blocks`` blocks of the streamed T2V-14B W4A8 base, as
    phase 9 (iv) takes them; prints the peak and its projection to 40
    blocks. 0 when finite, the launches QLORA_STEP x blocks, the projection
    <= QLORA_81_GATE_GIB."""
    import torch

    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.stream import build_streamed_quant_base
    from wanq_tpu_torch.training import (
        DistillConfig, init_train_state, make_qlora_distill_step)
    from wanq_tpu_torch.training.lora import DEFAULT_TARGETS, init_lora_from_cfg

    torch.backends.cuda.matmul.allow_tf32 = False
    _lib.lib()
    cfg = dataclasses.replace(WAN_CONFIGS[TASK_14B], num_layers=blocks)
    params, qctx, qbytes = build_streamed_quant_base(cfg, QuantConfig.from_dict(QLORA_14B))
    lora = init_lora_from_cfg(cfg, rank=16, seed=3, targets=DEFAULT_TARGETS, device="cuda")
    batch = distill_batch(torch, cfg, 81)
    dcfg = DistillConfig(learning_rate=1e-4, seq_len=QLORA_SEQ, remat=True)
    state, tx = init_train_state(lora, dcfg)
    step = make_qlora_distill_step(cfg, dcfg, tx)
    want = {k: v * blocks for k, v in QLORA_STEP.items()}
    adapters = sum(t.numel() * t.element_size() for t in _adapter_leaves(state.params))
    per_block = (qbytes + 5 * adapters) / blocks + QLORA_SEQ * cfg.dim * 2
    ok = True
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        _, _, _, loss, gnorm = step(state.params, state.ema_params, tx, params, qctx, *batch,
                                    3.0)
        loss, gnorm = float(loss), float(gnorm)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = _lib.launch_counts()
        proj = peak + (40 - blocks) * per_block
        print(f"  (v) QLoRA at {TASK_14B} 832x480x81 (seq {QLORA_SEQ}), {blocks} blocks, "
              f"PYTORCH_CUDA_ALLOC_CONF {os.environ.get('PYTORCH_CUDA_ALLOC_CONF', 'unset')}, "
              f"step {i}{' (warm-up)' if i == 0 else ''}: loss {loss:.8f}  gnorm {gnorm:.8e}  "
              f"{secs:.3f} s  peak {peak / 2**30:.3f} GiB; projected to 40 blocks "
              f"{proj / 2**30:.3f} GiB (+ 38 x {per_block / 2**30:.4f}: a block's int state "
              f"{qbytes / blocks / 2**30:.4f}, its adapters x5 {5 * adapters / blocks / 2**30:.4f}"
              f", a saved bf16 input {QLORA_SEQ * cfg.dim * 2 / 2**30:.4f}; gate "
              f"{QLORA_81_GATE_GIB} GiB); launches {counts}", flush=True)
        ok &= math.isfinite(loss) and math.isfinite(gnorm) and counts == want
        ok &= proj <= QLORA_81_GATE_GIB * 2**30
    print(f"  (v) card: {nvidia_smi()}", flush=True)
    return 0 if ok else 1


# kernels whose build must show no spill: the wgmma kernels (a spill there
# means ptxas gave up on the setmaxnreg budgets), K1, K3 and K7, which hold a
# row in registers, K10a's two, which hold half a tile (q/k) or a
# channel-by-row block (v) in registers, and K13, which holds two vectors of
# x and y in flight
NO_SPILL = ("flash_fwd_kernel", "attn_int8_kernel", "w8a8_gemm_kernel", "w4a8_gemm_kernel",
            "w4a4_gemm_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
            "ln_mod_quant_kernel", "rms_rope_heads_kernel", "quant_sum_kernel",
            "qkv_absmax_quant_kernel", "v_quant_kernel", "gate_residual_kernel")


def ptxas_records(log_text: str):
    """(mangled name, spill stores, spill loads, registers) of every kernel
    in the build log (ptxas -v: 'Compiling entry function <name>', then its
    properties)."""
    import re

    return [(name, int(st), int(ld), int(regs)) for name, st, ld, regs in re.findall(
        r"Compiling entry function '([^']+)'.*?(\d+) bytes spill stores, "
        r"(\d+) bytes spill loads.*?Used (\d+) registers", log_text, re.S)]


def hopper_evidence(_lib, nvcc: str) -> None:
    """Prints the registers and spill bytes of every kernel of the library
    (ptxas, from the build log) and fails on a spill in any kernel of
    NO_SPILL; a spill elsewhere is printed, not hidden. Then shows that the
    attention kernels and the int GEMMs K2, K8 and K9 are built from Hopper's
    own instructions: counts HGMMA (bf16 wgmma: K4, K11, K12), IGMMA (int8
    wgmma: K10, K2, K8, K9) and UTMALDG / UTMASTG (TMA loads / stores) in the
    library's SASS, and reads any note that ptxas serialised their wgmma
    instructions. K4 (dense and band mode), K2, K8, K9, K11 and K12 (bf16 out and
    the accumulate mode) are templates: every instantiation is held to the same.
    Fails if such a kernel has no wgmma or no TMA load, or was serialised, or
    if any kernel still holds an mma.sync product (IMMA int, HMMA bf16)."""
    import re

    log_text = str(_lib.last_build.get("log", ""))
    records = ptxas_records(log_text)
    check(len(records) >= len(KERNEL_NAMES), f"only {len(records)} ptxas records in the build log")
    for name, spill_st, spill_ld, regs in records:
        short = next((k for k in KERNEL_NAMES if k in name), name)
        inst = re.search(rf"{short}(I\w+?E)EvNS", name)  # template arguments, mangled
        must = any(k in name for k in NO_SPILL)
        log(f"  ptxas {KERNEL_NAMES.get(short, '?')} {short}{' ' + inst.group(1) if inst else ''}: "
            f"{regs} registers, spill stores {spill_st} B, loads {spill_ld} B"
            + ("" if must or not (spill_st or spill_ld) else "  (known spill, listed in ROADMAP.md)"))
        check(not must or (spill_st == 0 and spill_ld == 0),
              f"{short}: spills {spill_st}/{spill_ld} B")

    res = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                          str(_lib.last_build["path"])], capture_output=True, text=True)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr.strip()[:200]}")
    functions = re.split(r"\n\s*Function : ", res.stdout)[1:]
    # kernel -> (its wgmma instruction, how many instantiations the library has)
    kernels = {"flash_fwd_kernel": ("HGMMA", 2), "attn_int8_kernel": ("IGMMA", 1),
               "w8a8_gemm_kernel": ("IGMMA", 6), "w4a8_gemm_kernel": ("IGMMA", 6),
               "w4a4_gemm_kernel": ("IGMMA", 2), "flash_bwd_dq_kernel": ("HGMMA", 2),
               "flash_bwd_dkv_kernel": ("HGMMA", 2)}
    for kernel, (mma, n_inst) in kernels.items():
        sass = [f for f in functions if kernel in f.split("\n", 1)[0]]
        check(len(sass) == n_inst, f"{kernel}: {len(sass)} functions of that name in the SASS")
        check(sum(kernel in name for name, *_ in records) == n_inst,
              f"{kernel}: ptxas records in the build log != {n_inst}")
        serialised = [ln for ln in log_text.splitlines() if "serialized" in ln and kernel in ln]
        for fn in sass:
            mangled = fn.split("\n", 1)[0].strip()
            counts = {op: len(re.findall(rf"\b{op}\b", fn))
                      for op in ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG")}
            inst = re.search(rf"{kernel}(I\w+?E)EvNS", mangled)
            log(f"  SASS {kernel}{' ' + inst.group(1) if inst else ''}: "
                + ", ".join(f"{op} {n}" for op, n in counts.items())
                + f"; wgmma serialised by ptxas: {'yes' if serialised else 'no'}")
            check(counts[mma] > 0 and counts["UTMALDG"] > 0,
                  f"{kernel}: {mma} {counts[mma]}, UTMALDG {counts['UTMALDG']} in the SASS")
            check(not serialised, f"{kernel}: serialised wgmma: {serialised[:1]}")
    for op, what in (("IMMA", "int"), ("HMMA", "bf16")):
        check(not re.search(rf"\b{op}\b", res.stdout),
              f"an mma.sync {what} product ({op}) is left in the library")
    log("  SASS of the library: no IMMA, no HMMA (no mma.sync product left)")
    # K3, K7 and K10a stream rows or tiles into shared memory by TMA (bulk
    # copies UBLKCP, tensor-map loads UTMALDG): their instantiations' static
    # instruction and copy counts, and the SASS itself for reading. K10a's
    # kernels must have their tensor-map loads.
    streams = ("rms_rope_heads_kernel", "quant_sum_kernel", "qkv_absmax_quant_kernel",
               "v_quant_kernel")
    with open(OUT / "sass_k3_k7_k10a.txt", "w") as f:
        for fn in functions:
            mangled = fn.split("\n", 1)[0].strip()
            short = next((k for k in streams if k in mangled), None)
            if short is None:
                continue
            f.write("Function : " + fn)
            inst = re.search(rf"{short}(I\w+?E)EvNS", mangled)
            n_inst = len(re.findall(r"/\*[0-9a-f]{4,}\*/", fn))
            copies = {op: len(re.findall(rf"\b{op}\b", fn)) for op in ("UBLKCP", "UTMALDG")}
            log(f"  SASS {short}{' ' + inst.group(1) if inst else ''}: {n_inst} instructions, "
                + ", ".join(f"{op} {n}" for op, n in copies.items()))
            if KERNEL_NAMES[short] == "K10a":
                check(copies["UTMALDG"] > 0, f"{short}: no TMA tensor-map load in the SASS")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from wanq_tpu_torch.ops import _lib
    except ImportError as e:
        print(f"chip_smoke: the wanq_tpu_torch package is missing beside this script "
              f"({e})", file=sys.stderr)
        return 1
    missing = [y for y, _ in PATHS.values() if not (ROOT / y).exists()]
    if missing:
        print(f"chip_smoke: {', '.join(missing)} missing", file=sys.stderr)
        return 1
    os.chdir(ROOT)
    OUT.mkdir(exist_ok=True)
    from wanq_tpu_torch.configs import WAN_CONFIGS
    for task in (TASK_14B, TASK_I2V):  # read by the CLIs at each call
        WAN_CONFIGS[task] = dataclasses.replace(WAN_CONFIGS[task], num_layers=DEPTH_14B)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.time()

    smi = nvidia_smi()
    log(f"[0] environment\n  nvidia-smi name, power.limit: {smi}")
    nvcc = _lib._nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout
    log(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    log(f"  nvcc: {ver.strip().splitlines()[-1] if ver.strip() else '?'} ({nvcc})")
    try:
        import yaml  # noqa: F401
        log("  yaml importable: True")
    except ImportError:
        log("  yaml importable: False (wanq_tpu_torch.quant needs PyYAML)")
    log("  torch.backends.cuda.matmul.allow_tf32 = False, cudnn.allow_tf32 = False")

    log("[1] build")
    shutil.rmtree(_lib.BUILD_DIR, ignore_errors=True)
    t0 = time.time()
    _lib.lib()
    log(f"  nvcc sm_90a build: {time.time() - t0:.1f} s -> {_lib.last_build['path']}")
    hopper_evidence(_lib, nvcc)

    log(f"  phases 0-1: {time.time() - t_all:.1f} s")
    results, launches = {}, {}
    log("[2] kernels vs plain versions at the paths' shapes (warm median, CUDA events)")
    t0 = time.time()
    kernel_checks(torch, results)
    torch.cuda.empty_cache()
    log(f"  phase 2: {time.time() - t0:.1f} s")

    log(f"[3] the {len(PATHS)} paths through the CLIs (1.3B {SIZE}x{FRAMES}, seq 32768; "
        f"{TASK_14B} at 480p and 720p)")
    t0 = time.time()
    calib = {TASK: calibrate(torch)}
    step_s, first = {}, {}
    for label in PATHS:
        task = RUNS.get(label, {}).get("task", TASK)
        if task not in calib:
            log(f"  phase 3 {TASK} paths: {time.time() - t0:.1f} s")
            run = RUNS.get(label, {})
            calib[task] = calibrate(torch, task, PATHS[label][0], size=run.get("size", SIZE),
                                    frames=run.get("frames", FRAMES))
        if label in CALIB_FLAGS:
            calib[label] = calibrate(torch, task, PATHS[label][0], CALIB_FLAGS[label], label)
        step_s[label], first[label] = run_path(
            torch, label, launches, None if label in NO_CALIB_PATHS else calib.get(label,
                                                                                 calib[task]))
        torch.cuda.empty_cache()
    cfg_mode_check(torch, first)
    for label in FIDELITY_13B[1:]:
        log(f"  step time {label} / w8a8: {step_s[label] / step_s['w8a8']:.3f}")
    for label, twin in RTN_TWIN.items():
        log(f"  step time {label} / {twin}: {step_s[label] / step_s[twin]:.3f} "
            f"({step_s[label]:.3f} / {step_s[twin]:.3f} s)")
    log(f"  step time w4a8_14b / w8a8_14b: {step_s['w4a8_14b'] / step_s['w8a8_14b']:.3f}")
    log(f"  step time w4w8_plan_14b {step_s['w4w8_plan_14b']:.3f} s against w4a8_14b "
        f"{step_s['w4a8_14b']:.3f} and w8a8_14b {step_s['w8a8_14b']:.3f} s")
    log(f"  phase 3: {time.time() - t0:.1f} s")

    log("[4] fidelity and profile")
    t0 = time.time()
    fidelity(torch, calib[TASK], calib["w4a8_gptq"])
    log(f"  phase 4 {TASK}: {time.time() - t0:.1f} s")
    fidelity_14b(torch, calib[TASK_14B])
    log(f"  phase 4: {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()

    log(f"[5] whole generate ({TASK} {SIZE}x{FRAMES}: checkpoint dir, umT5-XXL, VAE)")
    t0 = time.time()
    whole_generate(torch, calib[TASK], launches)
    log(f"  phase 5: {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()

    log(f"[6] image to video ({TASK_I2V} {SIZE}x{FRAMES}: CLIP, the VAE encoder, DPM++), the "
        f"{TASK} timestep schedule and the map capture")
    t0 = time.time()
    image_to_video(torch, results, launches, calib[TASK])
    log(f"  phase 6: {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()

    log(f"[7] training: K4's residual mode, K12 and K11; QLoRA at {TASK} {SIZE}x{FRAMES}, "
        f"its deployment, the other step builders")
    t0 = time.time()
    warm = training(torch, results, launches)
    log(f"  phase 7: {time.time() - t0:.1f} s")

    log(f"[8] multi-GPU on one card: K4's partial mode (a ring hop), the ring's hop schedule "
        f"over virtual ranks, dit_forward(plan=) on a one-rank NCCL group, K12 / K11's "
        f"accumulate mode (the ring's backward hop) and the ring's backward over virtual ranks, "
        f"calibration and QLoRA on a one-rank NCCL group; no multi-card run "
        f"(card: {nvidia_smi()})")
    t0 = time.time()
    multi_gpu(torch, results, launches, calib[TASK], warm)
    log(f"  phase 8: {time.time() - t0:.1f} s")

    log(f"[9] the streamed quantized base and QLoRA at {TASK_14B}, all 40 blocks, "
        f"832x480x{QLORA_14B_FRAMES} (card: {nvidia_smi()})")
    t0 = time.time()
    streamed_14b(torch, results, launches)
    log(f"  phase 9: {time.time() - t0:.1f} s")
    log(f"total {time.time() - t_all:.1f} s")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": int(launches.get(name, 0)),
         "max_abs_err": results[name]["max_abs_err"], "ms": results[name]["ms"],
         "plain_ms": results[name]["plain_ms"], "bound_ms": results[name]["bound_ms"],
         "bound_by": ("bytes" if results[name]["bytes_ms"] >= results[name]["ops_ms"]
                      else "operations"),
         "library_ms": results[name]["library_ms"]}
        for name in SOURCES
    ]}
    print(json.dumps(record), flush=True)
    print(f"nvidia-smi name, power.limit: {nvidia_smi()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
