#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (wanq_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its numbers on its own lines; any failure exits
non-zero:

0. environment: card name and power limit (nvidia-smi), torch / CUDA / nvcc
   versions, whether PyYAML imports;
1. build: nvcc compiles wanq_tpu_torch/csrc/*.cu for sm_90a into
   wanq_tpu_torch/_build/;
2. each kernel against its plain PyTorch version on the card at the main
   path's shapes (T2V-1.3B, 832x480x81, batched CFG: B=2, seq 32768 with
   32760 valid tokens), with the warm median of CUDA-event timings of both;
3. the main path through the CLIs: get_calib_data --collect_minmax (1 step)
   then quant_generate --hardware (3 UniPC steps) at full 1.3B width and
   depth, random weights from a seed; per-step time, peak memory, finite
   latents, and per-step kernel launch counts equal to the 30-block total
   (per block K1 x3, K2 x6, K3 x3, K4 x2), which shows no plain version ran;
4. fidelity and profile: one CFG step's noise prediction, W8A8 vs bf16 FP
   on the same weights (PSNR >= 30 dB); fp_linear on the card against the
   CPU's f32 product; one CFG forward of each under torch.profiler (wall
   time, device time by kernel, idle share); and a small config through
   the kernels against the same config through the plain versions on the
   CPU.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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
PER_BLOCK = {"ln_modulate_quant": 3, "w8a8_linear": 6, "rms_rope_heads": 3, "attention": 2}
SOURCES = {
    "ln_modulate_quant": ("wanq_tpu_torch/csrc/ln_modulate_quant.cu",
                          "wanq_tpu/ops/fused.py:172"),
    "w8a8_linear": ("wanq_tpu_torch/csrc/w8a8_gemm.cu", "wanq_tpu/ops/qgemm.py:124"),
    "rms_rope_heads": ("wanq_tpu_torch/csrc/rms_rope_heads.cu",
                       "wanq_tpu/ops/rmsnorm_rope.py:62"),
    "attention": ("wanq_tpu_torch/csrc/flash_attention.cu",
                  "wanq_tpu/models/attention.py:256"),
}


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
# phase 2: kernels vs plain versions at main-path shapes
# ---------------------------------------------------------------------------


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

    def record(name, err, ms, plain_ms, detail):
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        log(f"  {name} {detail}: max_abs_err {err:.3e}  kernel {ms:.3f} ms  "
            f"plain {plain_ms:.3f} ms")

    # K1 -- LN + modulate + int8 quant, x [2, 32768, 1536] bf16
    x = (torch.randn((b, s, c), device=dev, generator=g) * 2 + 0.3).bfloat16()
    shift = torch.randn((b, c), device=dev, generator=g) * 0.5
    scale = torch.randn((b, c), device=dev, generator=g) * 0.5
    got = ln_modulate_quant_cuda(x, shift, scale)
    want = ln_modulate_quant_plain(x, shift, scale)
    torch.cuda.synchronize()
    diff = (got[0].int() - want[0].int()).abs()
    frac = (diff > 0).float().mean().item()
    check(diff.max().item() <= 1 and frac <= 1e-3, f"K1 codes differ: max {diff.max()}, {frac}")
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    err = (got[0].float() * got[1][..., None] - want[0].float() * want[1][..., None]).abs().max()
    record("ln_modulate_quant", err.item(),
           cuda_ms(lambda: ln_modulate_quant_cuda(x, shift, scale)),
           cuda_ms(lambda: ln_modulate_quant_plain(x, shift, scale), reps=3),
           f"[2,32768,1536] bf16 (codes differing: {frac:.2e})")
    del x, got, want, diff

    # K2 -- W8A8 GEMM at M = 65536 for the three (K, N) of the path
    m = b * s
    for k, nn, out_dtype in ((1536, 1536, torch.bfloat16), (1536, 8960, torch.bfloat16),
                             (8960, 1536, torch.float32)):
        a = torch.randint(-128, 128, (m, k), device=dev, generator=g, dtype=torch.int8)
        w = torch.randint(-128, 128, (nn, k), device=dev, generator=g, dtype=torch.int8)
        s_a = torch.rand((m,), device=dev, generator=g) * 0.02 + 1e-3
        s_w = torch.rand((nn,), device=dev, generator=g) * 0.02 + 1e-3
        sum_a = s_a * a.float().sum(-1)
        zp = torch.randint(-20, 20, (nn,), device=dev, generator=g).float()
        bias = torch.randn((nn,), device=dev, generator=g)
        args = (a, w, s_a, s_w, sum_a, zp, bias, out_dtype)
        got = w8a8_linear_cuda(*args)
        want = w8a8_linear_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-6 * want.float().abs().max().item()
        check(err <= tol, f"K2 ({k},{nn}) max abs err {err} > {tol}")
        ms = cuda_ms(lambda: w8a8_linear_cuda(*args))
        tops = 2 * m * k * nn / ms / 1e9
        record("w8a8_linear", err, ms, cuda_ms(lambda: w8a8_linear_plain(*args), reps=3),
               f"M=65536 K={k} N={nn} {str(out_dtype)[6:]} out ({tops:.0f} TOP/s)")
        del a, w, got, want, args

    # K3 -- RMSNorm + RoPE + heads-major, [2, 32768, 1536] -> [2, 12, 32768, 128]
    ca, sb = rope_tables_interleaved((21, 30, 52), d)
    ca, sb = pad_tables(torch.from_numpy(ca.copy()).to(dev), torch.from_numpy(sb.copy()).to(dev),
                        valid, s)
    qs = 1.0 / d ** 0.5
    x = torch.randn((b, s, c), device=dev, generator=g).bfloat16()
    wn = torch.rand((c,), device=dev, generator=g) + 0.5
    for detail, kern, plain in (
        ("rope, q-scaled tables", lambda: _k3_cuda(x, wn, ca * qs, sb * qs, n, 1e-6, torch.bfloat16),
         lambda: rms_rope_heads_plain(x, wn, ca * qs, sb * qs, n)),
        ("split only (cross q)", lambda: _k3_cuda(x, wn, None, None, n, 1e-6, torch.bfloat16),
         lambda: rms_split_heads_plain(x, wn, n)),
    ):
        got, want = kern().float(), plain().float()
        frac, err = bf16_ulp_check(torch, got, want)
        check(frac <= 1e-4 and err <= 1e-2 * want.abs().max().item(),
              f"K3 {detail}: {frac:.2e} of elements beyond one bf16 ulp, max abs err {err}")
        record("rms_rope_heads", err, cuda_ms(kern), cuda_ms(plain, reps=3),
               f"[2,32768,1536]->[2,12,32768,128] {detail} (beyond 1 ulp: {frac:.2e})")
        del got, want

    # K4 -- attention: cross (Sk = 512) and self (32768, valid 32760). The
    # outputs are small (std ~ sqrt(e / Sk)), so the limits scale with them:
    # rel-L2 <= 1e-2 and max abs err <= 4 bf16 ulps of max|want|. Dropping
    # one 64-key tile of the self call moves rel-L2 by ~4e-2.
    def attn_err(got, want, what):
        g, w = got.float(), want.float()
        err = (g - w).abs().max().item()
        rel = ((g - w).norm() / w.norm()).item()
        ulp = 2.0 ** (math.floor(math.log2(w.abs().max().item())) - 7)
        check(bool(torch.isfinite(g).all()) and rel <= 1e-2 and err <= 4 * ulp,
              f"K4 {what}: max abs err {err:.3e} (limit {4 * ulp:.3e}), rel-L2 {rel:.3e}")
        return err, rel

    q = torch.randn((b, n, s, d), device=dev, generator=g).bfloat16()
    ctx_k = torch.randn((b, 512, n, d), device=dev, generator=g).bfloat16()
    ctx_v = torch.randn((b, 512, n, d), device=dev, generator=g).bfloat16()
    kern = lambda: _flash_cuda(q, ctx_k.transpose(1, 2), ctx_v.transpose(1, 2), qs, 512)
    plain = lambda: _sdpa_reference(q.transpose(1, 2), ctx_k, ctx_v, qs, None, q_chunk=8192)
    err, rel = attn_err(kern(), plain(), "cross")
    record("attention", err, cuda_ms(kern), cuda_ms(plain, reps=3),
           f"cross q [2,12,32768,128] heads-major, k/v [2,512,12,128] seq-major "
           f"(rel-L2 {rel:.2e})")
    del ctx_k, ctx_v

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
    record("attention", err, ms, cuda_ms(plain, warmup=1, reps=3),
           f"self [2,12,32768,128] valid 32760, pad k/v planted (rel-L2 {rel:.2e}; "
           f"pad q rows err {pad_err:.3e}, rel-L2 {pad_rel:.2e}; "
           f"{flops / ms / 1e9:.0f} TFLOP/s)")


# ---------------------------------------------------------------------------
# phases 3-4
# ---------------------------------------------------------------------------


def cli_args(extra):
    return ["--task", TASK, "--size", SIZE, "--frame_num", str(FRAMES), "--random_init",
            "--quant_config", YAML, "--device", "cuda", *extra]


def main_path(torch, launches):
    from wanq_tpu_torch.cli import get_calib_data, quant_generate
    from wanq_tpu_torch.ops import _lib

    calib_path = str(OUT / "calib_data.npz")
    lat_path = str(OUT / "latents.npz")
    t0 = time.time()
    _lib.reset_launch_counts()
    get_calib_data.generate(get_calib_data.parse_args(cli_args(
        ["--collect_minmax", "--sample_steps", "1", "--calib_save_path", calib_path])))
    torch.cuda.synchronize()
    log(f"  get_calib_data (1 step, incl. random init): {time.time() - t0:.1f} s; "
        f"launches {_lib.launch_counts()}")

    marks = []

    def on_step(i, t, latents):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    t0 = time.time()
    quant_generate.generate(quant_generate.parse_args(cli_args(
        ["--calib_data", calib_path, "--hardware", "--sample_steps", str(STEPS),
         "--save_file", lat_path])), on_step=on_step)
    counts = _lib.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # steps 2..STEPS, each from one step's end to the next's (synchronized)
    step_s = [marks[i + 1] - marks[i] for i in range(len(marks) - 1)]
    check(len(step_s) == STEPS - 1, f"expected {STEPS - 1} step intervals, got {len(step_s)}")
    log(f"  quant_generate --hardware ({STEPS} steps, incl. random init + PTQ): "
        f"{time.time() - t0:.1f} s; denoise step s (steps 2-{STEPS}): "
        f"{', '.join(f'{x:.3f}' for x in step_s)}; mean {sum(step_s) / len(step_s):.3f} s")
    log(f"  peak torch.cuda.max_memory_allocated: {peak / 2**30:.2f} GiB")
    log(f"  launches: {counts}")
    for name, per_block in PER_BLOCK.items():
        want = per_block * 30 * STEPS
        check(counts.get(name, 0) == want, f"{name}: {counts.get(name, 0)} launches, want {want}")
    launches.update(counts)

    import numpy as np

    lat = np.load(lat_path)["latents"]
    check(lat.shape == (1, 16, 21, 60, 104), f"latents shape {lat.shape}")
    check(bool(np.isfinite(lat).all()), "non-finite latents")
    log(f"  latents {lat.shape} finite, std {lat.std():.4f}")
    return calib_path


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


KERNEL_NAMES = {"ln_mod_quant_kernel": "K1", "w8a8_gemm_kernel": "K2",
                "rms_rope_heads_kernel": "K3", "flash_fwd_kernel": "K4"}


def profile_steps(torch, steps):
    """One CFG forward of each step function: its wall time unprofiled
    (host clock around a synchronized call, after a warm call), then its
    device time by kernel under torch.profiler. The idle share is 1 - the
    union of device-activity intervals / the profiled call's wall time.
    The whole table goes to _smoke_out/profile_<label>.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = {}
    for label, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[label] = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        spans, by_name = [], {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
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
            f"{max(0.0, 1 - busy / 1e3 / prof_wall):.4f}")
        ours = {}
        for name, (t, cnt) in rows:
            for sub, tag in KERNEL_NAMES.items():
                if sub in name:
                    sum_t, sum_n = ours.get(tag, (0.0, 0))
                    ours[tag] = (sum_t + t, sum_n + cnt)
        log("    hand kernels: " + ", ".join(
            f"{k} {t:.1f} ms ({100 * t / dev_ms:.1f}%, n={c})" for k, (t, c) in sorted(ours.items())))
        for name, (t, cnt) in rows[:8]:
            log(f"    {t:9.2f} ms {100 * t / dev_ms:5.1f}%  n={cnt:4d}  {name[:90]}")
    if len(walls) == 2:
        log(f"  W8A8 / bf16 forward wall time: {walls['w8a8'] / walls['bf16']:.3f}")


def fidelity(torch, calib_path):
    import numpy as np

    from wanq_tpu_torch.cli.common import load_contexts, load_params
    from wanq_tpu_torch.configs import WAN_CONFIGS, tiny_config
    from wanq_tpu_torch.models.dit import dit_forward, init_params, linear_layer_names
    from wanq_tpu_torch.pipelines.text2video import (
        WanT2V, compute_seq_len, compute_target_shape)
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state
    from wanq_tpu_torch.quant.qlinear import QuantCtx, fp_linear

    cfg = WAN_CONFIGS[TASK]
    args = argparse.Namespace(base_seed=42, device="cuda", context_file=None)
    params = load_params(args, cfg)
    context, context_null = (torch.from_numpy(a).cuda() for a in load_contexts(args, cfg))
    qcfg = QuantConfig.from_yaml(YAML)
    policies, state, _ = prepare_quant_state(params, linear_layer_names(cfg), qcfg,
                                             calib=dict(np.load(calib_path)))
    ctx = QuantCtx(mode="int8", policies=policies, state=state)
    shape = compute_target_shape(cfg, (832, 480), FRAMES)
    seq_len = compute_seq_len(cfg, shape)
    g = torch.Generator(device="cuda").manual_seed(1)
    lat = torch.randn((1, *shape), generator=g, device="cuda")
    pipe = WanT2V(cfg, params, device="cuda")
    with torch.no_grad():
        fp = pipe._step(lat, 999.0, context, context_null, 5.0, None, seq_len).cpu().numpy()
        q8 = pipe._step(lat, 999.0, context, context_null, 5.0, ctx, seq_len).cpu().numpy()
    fp64, q64 = fp.astype(np.float64), q8.astype(np.float64)
    rng = float(fp64.max() - fp64.min()) or 1.0
    psnr = 10 * np.log10(rng ** 2 / float(np.mean((fp64 - q64) ** 2)))
    cos = float((fp64 * q64).sum() / np.linalg.norm(fp64) / np.linalg.norm(q64))
    log(f"  W8A8 vs bf16 FP noise prediction (t=999, CFG 5.0): PSNR {psnr:.2f} dB, "
        f"cosine {cos:.6f}")
    check(bool(np.isfinite(q8).all()), "non-finite W8A8 noise prediction")
    check(psnr >= 30.0, f"PSNR {psnr:.2f} dB < 30 dB")

    # the FP linears keep the f32 accumulator on the card, as on the CPU
    po = params["blocks"][0]["self_attn"]["o"]
    xo = torch.randn((1, 4096, cfg.dim), generator=g, device="cuda")
    got = fp_linear(po, xo).cpu()
    want = fp_linear({kk: vv.cpu() for kk, vv in po.items()}, xo.cpu())
    rel = float((got - want).norm() / want.norm())
    log(f"  fp_linear (self_attn.o, [1,4096,1536] bf16 operands, f32 out) card vs CPU: "
        f"rel-L2 {rel:.3e}")
    check(got.dtype == torch.float32 and rel <= 1e-5, f"fp_linear card vs CPU rel-L2 {rel}")

    with torch.no_grad():
        profile_steps(torch, {
            "w8a8": lambda: pipe._step(lat, 999.0, context, context_null, 5.0, ctx, seq_len),
            "bf16": lambda: pipe._step(lat, 999.0, context, context_null, 5.0, None, seq_len),
        })
    del params, state, ctx, pipe

    # a small config through the kernels vs the plain versions on the CPU
    small = tiny_config(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32,
                        text_dim=64, freq_dim=64, param_dtype="bfloat16",
                        residual_dtype="bfloat16")
    rs = np.random.default_rng(5)
    x = torch.from_numpy(rs.standard_normal((2, 16, 3, 8, 10)).astype(np.float32))
    t = torch.tensor([999.0, 500.0])
    c = torch.from_numpy(rs.standard_normal((2, 32, 64)).astype(np.float32))
    p_cpu = init_params(small, 3)
    p_cpu["head"]["head"]["w"] = torch.from_numpy(
        rs.standard_normal((256, 64)).astype(np.float32) * 0.02).bfloat16()
    cc = QuantCtx(mode="calib", collect_minmax=True)
    dit_forward(p_cpu, small, x, t, c, 64, ctx=cc)
    calib = {kk: vv.float().numpy()[None] for kk, vv in cc.collect.items()}
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _to_device(p_cpu, dev)
        pol, st, _ = prepare_quant_state(p, linear_layer_names(small),
                                         QuantConfig.from_yaml(YAML), calib=calib)
        with torch.no_grad():
            outs[dev] = dit_forward(p, small, x.to(dev), t.to(dev), c.to(dev), 64,
                                    ctx=QuantCtx(mode="int8", policies=pol, state=st)).cpu()
    a, bq = outs["cpu"].double(), outs["cuda"].double()
    rel = float((a - bq).norm() / a.norm())
    log(f"  small config (dim 256, 2 heads, 2 layers, seq 64 > 60 tokens) int8, kernels "
        f"vs plain on CPU: rel-L2 {rel:.3e}")
    check(rel <= 2e-2, f"small-config rel-L2 {rel} > 2e-2")
    return psnr


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
    if not (ROOT / YAML).exists():
        print(f"chip_smoke: {YAML} is missing", file=sys.stderr)
        return 1
    os.chdir(ROOT)
    OUT.mkdir(exist_ok=True)
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
    for line in str(_lib.last_build.get("log", "")).splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    log("[2] kernels vs plain versions at main-path shapes (warm median, CUDA events)")
    results = {}
    kernel_checks(torch, results)
    torch.cuda.empty_cache()

    log(f"[3] main path: get_calib_data -> quant_generate --hardware, {TASK} "
        f"{SIZE}x{FRAMES} (seq 32768)")
    launches = {}
    calib_path = main_path(torch, launches)
    torch.cuda.empty_cache()

    log("[4] fidelity")
    fidelity(torch, calib_path)
    log(f"total {time.time() - t_all:.1f} s")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": int(launches.get(name, 0)),
         "max_abs_err": results[name]["max_abs_err"], "ms": results[name]["ms"],
         "plain_ms": results[name]["plain_ms"]}
        for name in PER_BLOCK
    ]}
    print(json.dumps(record), flush=True)
    print(f"nvidia-smi name, power.limit: {nvidia_smi()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
