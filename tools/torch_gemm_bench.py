#!/usr/bin/env python3
"""Times the port's wgmma int GEMMs and the K1 producer alone on one NVIDIA card.

    python3 tools/torch_gemm_bench.py [--reps 7] [--m 65536] [--only k1|k2|k8|k9]

K2 (``csrc/w8a8_gemm.cu``) and K8 (``csrc/w4a8_gemm.cu``), each with a bf16 or
f32 output and in its GELU + static quant mode, and K9 (``csrc/w4a4_gemm.cu``)
at the three (K, N) of
T2V-1.3B's linears with M = 65536 token rows (832x480x81, batched CFG),
beside ``torch._int_mm``, the bare int8 product of the same operands, and
beside each kernel's bound (the int8 operations over 1979 TOP/s); for K8 the
library product runs on the unpacked weight. K1 (``csrc/ln_modulate_quant.cu``,
the int8 producer in front of these GEMMs) is timed at [2, 32768, 1536] and
[2, 32768, 5120] bf16 beside its bound (bytes over 3.35 TB/s). Prints the
card's name and power limit, what ptxas reported for the kernels
(registers, spills, any "serialized" note), and warm medians of CUDA-event
times. Before timing, each kernel is held against its plain version on a
ragged M of a few thousand rows (bit for bit; the GELU + quant mode: codes,
row sums, s2 and sm2), so that a broken kernel is not timed; the full-size
checks are ``chip_smoke.py``'s and ``tests/test_torch_cuda.py``'s.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = ((1536, 1536), (1536, 8960), (8960, 1536))  # (K, N)
PEAK_INT8 = 1979e12


def cuda_ms(torch, fn, reps):
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return sorted(times)[len(times) // 2]


def ptxas_report(log: str) -> None:
    for kernel in ("w8a8_gemm_kernel", "w4a8_gemm_kernel", "w4a4_gemm_kernel",
                   "ln_mod_quant_kernel"):
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and kernel in line:
                print("  ptxas:", " | ".join(x.strip().replace("ptxas info    : ", "")
                                              for x in lines[i:i + 4]), flush=True)
        for line in lines:
            if "serialized" in line and kernel in line:
                print(f"  ptxas SERIALIZED: {line.strip()}", flush=True)


def int8_gemm_operands(torch, g, tag, m, k, n):
    """Operands of K2 (int8 weight [N, K]) or K8 (packed int4 weight [N, K/2],
    scales 16 times larger so that h keeps its size); asymmetric, with bias."""
    dev = torch.device("cuda")
    a = torch.randint(-128, 128, (m, k), device=dev, generator=g, dtype=torch.int8)
    w = torch.randint(-128, 128, (n, k if tag == "K2" else k // 2), device=dev, generator=g,
                      dtype=torch.int8)
    s_a = torch.rand((m,), device=dev, generator=g) * 0.02 + 1e-3
    s_w = torch.rand((n,), device=dev, generator=g) * 2e-2 / k ** 0.5 + 1e-5
    sum_a = s_a * a.float().sum(-1)
    zp = torch.randint(-20, 20, (n,), device=dev, generator=g).float()
    bias = torch.randn((n,), device=dev, generator=g)
    return a, w, (s_w if tag == "K2" else s_w * 16), s_a, sum_a, zp, bias


def bench_int8_gemm(torch, g, m, reps, tag) -> bool:
    """K2 (tag "K2") or K8 ("K8"): every mode against its plain version at a
    small ragged M, then timed at M = m beside torch._int_mm (for K8 on the
    unpacked weight)."""
    from wanq_tpu_torch.ops import qgemm
    from wanq_tpu_torch.quant.quantizers import unpack_int4

    name = "w8a8_linear" if tag == "K2" else "w4a8_linear"
    linear, plain = getattr(qgemm, f"{name}_cuda"), getattr(qgemm, f"{name}_plain")
    mode = getattr(qgemm, f"{name}_gelu_quant_cuda")
    mode_plain = getattr(qgemm, f"{name}_gelu_quant_plain")
    ok = True
    scale2 = torch.tensor(0.03, device="cuda")
    for k, n in (*SHAPES, (128, 128), (384, 640)):
        a, w, s_w, s_a, sum_a, zp, bias = int8_gemm_operands(torch, g, tag, 3000 + 37, k, n)
        for dt in (torch.bfloat16, torch.float32):
            got = linear(a, w, s_a, s_w, sum_a, zp, bias, dt)
            want = plain(a, w, s_a, s_w, sum_a, zp, bias, dt)
            if not torch.equal(got, want):
                ok = False
                err = (got.float() - want.float()).abs().max().item()
                print(f"  {tag} ({k},{n}) {dt}: DIFFERS, max abs {err}", flush=True)
        got = mode(a, w, s_a, s_w, scale2, sum_a, zp, bias)
        want = mode_plain(a, w, s_a, s_w, scale2, sum_a, zp, bias)
        diff = (got[0].int() - want[0].int()).abs()
        sums_own = torch.equal(got[2], scale2 * got[0].float().sum(-1))
        if diff.max().item() > 0 or not sums_own or not torch.equal(got[1], want[1]):
            ok = False
            print(f"  {tag} gelu+quant ({k},{n}): codes differ on "
                  f"{(diff > 0).float().mean().item():.2e} (max {diff.max().item()}), "
                  f"sums of own codes equal: {sums_own}", flush=True)
    print(f"{tag} vs plain at M=3037 (bf16, f32, gelu+quant): {'exact' if ok else 'DIFFERS'}",
          flush=True)

    for k, n in SHAPES:
        a, w, s_w, s_a, sum_a, zp, bias = int8_gemm_operands(torch, g, tag, m, k, n)
        wt = (w if tag == "K2" else unpack_int4(w)).t()
        ops = 2 * m * k * n
        print(f"{tag} M={m} K={k} N={n}: bound {ops / PEAK_INT8 * 1e3:.3f} ms; torch._int_mm"
              f"{'' if tag == 'K2' else ' on the unpacked weight'} "
              f"{cuda_ms(torch, lambda: torch._int_mm(a, wt), reps):.3f} ms", flush=True)
        row = []
        for label, fn in (
            ("bf16", lambda: linear(a, w, s_a, s_w, sum_a, zp, bias, torch.bfloat16)),
            ("f32", lambda: linear(a, w, s_a, s_w, sum_a, zp, bias, torch.float32)),
            ("gelu+quant", lambda: mode(a, w, s_a, s_w, scale2, sum_a, zp, bias)),
        ):
            t = cuda_ms(torch, fn, reps)
            row.append(f"{label} {t:.3f} ms ({ops / t / 1e9:.0f} TOP/s)")
        print("  " + "; ".join(row), flush=True)
        del a, w, wt
        torch.cuda.empty_cache()
    return ok


def bench_k1(torch, g, m, reps) -> bool:
    from wanq_tpu_torch.ops.fused import ln_modulate_quant_cuda, ln_modulate_quant_plain

    dev = torch.device("cuda")
    ok = True
    for c in (1536, 5120):
        b, n = 2, m // 2
        x = (torch.randn((b, n, c), device=dev, generator=g) * 2 + 0.3).bfloat16()
        shift = torch.randn((b, c), device=dev, generator=g) * 0.5
        scale = torch.randn((b, c), device=dev, generator=g) * 0.5
        got = ln_modulate_quant_cuda(x[:, :3001], shift, scale)
        want = ln_modulate_quant_plain(x[:, :3001], shift, scale)
        diff = (got[0].int() - want[0].int()).abs()
        frac = (diff > 0).float().mean().item()
        s_rel = ((got[1] - want[1]).abs() / want[1]).max().item()
        good = diff.max().item() <= 1 and frac <= 1e-3 and s_rel <= 1e-5
        ok = ok and good
        t = cuda_ms(torch, lambda: ln_modulate_quant_cuda(x, shift, scale), reps)
        nbytes = b * n * c * 3 + b * n * 8 + 2 * b * c * 4
        print(f"K1 [2,{n},{c}] bf16: {t:.3f} ms ({nbytes / t / 1e6:.0f} GB/s); bound "
              f"{nbytes / 3.35e12 * 1e3:.3f} ms -> {t / (nbytes / 3.35e12 * 1e3):.2f}x; vs plain "
              f"at N=3001: codes differing {frac:.2e}, scale rel {s_rel:.1e} "
              f"({'ok' if good else 'OUT OF TOLERANCE'})", flush=True)
        del x
        torch.cuda.empty_cache()
    return ok


def bench_k9(torch, g, m, reps) -> bool:
    from wanq_tpu_torch.ops.qgemm import w4a4_linear_cuda, w4a4_linear_plain

    dev = torch.device("cuda")

    def operands(mm, k, n):
        a = torch.randint(-8, 8, (mm, k), device=dev, generator=g, dtype=torch.int8)
        wp = torch.randint(-128, 128, (n, k // 2), device=dev, generator=g, dtype=torch.int8)
        s_a = torch.rand((mm, k // 128), device=dev, generator=g) * 0.02 + 1e-3
        s_w = torch.rand((k // 128, n), device=dev, generator=g) * 0.02 + 1e-3
        return a, wp, s_a, s_w, torch.randn((n,), device=dev, generator=g)

    ok = True
    for k, n in (*SHAPES, (128, 128), (384, 256)):
        args = operands(3000 + 37, k, n)
        for dt in (torch.float32, torch.bfloat16):
            got = w4a4_linear_cuda(*args, out_dtype=dt)
            want = w4a4_linear_plain(*args, out_dtype=dt)
            if not torch.equal(got, want):
                ok = False
                err = (got.float() - want.float()).abs().max().item()
                print(f"  K9 ({k},{n}) {dt}: DIFFERS, max abs {err}", flush=True)
    print(f"K9 vs plain at M=3037 (f32 and bf16 out): {'exact' if ok else 'DIFFERS'}", flush=True)
    for k, n in SHAPES:
        args = operands(m, k, n)
        ops = 2 * m * k * n
        t = cuda_ms(torch, lambda: w4a4_linear_cuda(*args), reps)
        print(f"K9 M={m} K={k} N={n} f32 out: {t:.3f} ms ({ops / t / 1e9:.0f} TOP/s); "
              f"bound {ops / PEAK_INT8 * 1e3:.3f} ms -> {t / (ops / PEAK_INT8 * 1e3):.2f}x",
              flush=True)
        del args
        torch.cuda.empty_cache()
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--m", type=int, default=65536)
    ap.add_argument("--only", choices=("k1", "k2", "k8", "k9"), default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_gemm_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from wanq_tpu_torch.ops import _lib

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi name, power.limit: {smi}", flush=True)
    _lib.lib()
    print(f"build: {_lib.last_build.get('seconds', 0.0):.1f} s", flush=True)
    ptxas_report(str(_lib.last_build.get("log", "")))
    g = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    benches = (("k1", bench_k1), ("k2", lambda *a: bench_int8_gemm(*a, "K2")),
               ("k8", lambda *a: bench_int8_gemm(*a, "K8")), ("k9", bench_k9))
    for name, bench in benches:
        if args.only in (None, name):
            ok = bench(torch, g, args.m, args.reps) and ok
    torch.cuda.synchronize()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
