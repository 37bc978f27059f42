#!/usr/bin/env python3
"""Times the port's attention kernels on one NVIDIA card.

    python3 tools/torch_attn_bench.py [--reps 5] [--only k10a|bwd] [--tree DIR]

K4 (bf16 flash attention, ``csrc/flash_attention.cu``) on the self-attention
shape of T2V-1.3B at 832x480x81 with batched CFG ([2, 12, 32768, 128], 32760
valid keys) and on the cross-attention shape (512 keys), beside
``torch.nn.functional.scaled_dot_product_attention`` on the same operands;
K10a + K10 (int8 attention, ``csrc/quantize_qkv_int8.cu`` and
``csrc/attention_int8.cu``) on the self-attention shape. ``--only k10a``
times K10a alone at that shape and at T2V-14B 720p ([2, 40, 75776, 128]):
code for code against its plain version, each of its two launches' device
time (torch.profiler), the bytes it moves beside its bound's, and a plain
copy of the same q, k and v bytes. ``--only bwd`` times the backward,
K12 (dq) and K11 (dk, dv, ``csrc/flash_attention_bwd.cu``), at the training
shapes: self-attention [1, 12, 32768, 128] with 32760 valid keys,
cross-attention against 512 keys, and self-attention with 40 heads (T2V-14B);
each against ``attention_bwd_reference`` (rel-L2), two calls for equal bits,
and beside its bound and the whole backward of
``scaled_dot_product_attention`` on the valid keys; each is timed through
``flash_attention_bwd``, the plain reduction of di included, as
``chip_smoke.py`` times them. ``--tree DIR`` imports
``wanq_tpu_torch`` from another checkout (a parent commit unpacked with ``git
archive``), so two versions are compared within one call. Prints the card's
name and power limit, warm medians of CUDA-event times, and the rates they
mean. Correctness is held by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``; this script only checks the outputs against
each other loosely so that a broken kernel is not timed.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def cuda_ms(torch, fn, reps):
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", choices=["k10a", "bwd"])
    ap.add_argument("--tree", default=str(ROOT), help="the checkout to import the port from")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_attn_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from wanq_tpu_torch.models.attention import _flash_cuda
    from wanq_tpu_torch.ops.attn_int8 import attention_int8_cuda, quantize_qkv_int8_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi name, power.limit: {smi}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    if args.only == "k10a":
        return k10a_bench(torch, g, args.reps)
    if args.only == "bwd":
        return bwd_bench(torch, g, args.reps)
    b, n, s, d, valid = 2, 12, 32768, 128, 32760
    qs = 1.0 / d ** 0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = torch.randn((b, n, s, d), device=dev, generator=g).bfloat16()
    k = torch.randn((b, n, s, d), device=dev, generator=g).bfloat16()
    vh = torch.randn((b, s, n * d), device=dev, generator=g).bfloat16().view(b, s, n, d)
    vh = vh.transpose(1, 2)
    ck = torch.randn((b, 512, n, d), device=dev, generator=g).bfloat16().transpose(1, 2)
    cv = torch.randn((b, 512, n, d), device=dev, generator=g).bfloat16().transpose(1, 2)

    y4 = _flash_cuda(q, k, vh, qs, valid).transpose(1, 2).float()
    ref = sdpa(q, k[:, :, :valid], vh[:, :, :valid], scale=qs).float()
    rel = ((y4 - ref).norm() / ref.norm()).item()
    print(f"K4 self vs scaled_dot_product_attention: rel-L2 {rel:.3e}", flush=True)
    if not rel < 2e-2:
        return 1
    flops = 4 * b * n * s * valid * d
    t = cuda_ms(torch, lambda: _flash_cuda(q, k, vh, qs, valid), args.reps)
    t_lib = cuda_ms(torch, lambda: sdpa(q, k[:, :, :valid], vh[:, :, :valid], scale=qs), args.reps)
    print(f"K4 self [2,12,32768,128] valid 32760: {t:.3f} ms ({flops / t / 1e9:.0f} TFLOP/s); "
          f"scaled_dot_product_attention {t_lib:.3f} ms", flush=True)
    t4 = t
    t = cuda_ms(torch, lambda: _flash_cuda(q, ck, cv, qs, 512), args.reps)
    t_lib = cuda_ms(torch, lambda: sdpa(q, ck, cv, scale=qs), args.reps)
    print(f"K4 cross, 512 keys: {t:.3f} ms; scaled_dot_product_attention {t_lib:.3f} ms",
          flush=True)

    quant = quantize_qkv_int8_cuda(q, k, vh)
    y8 = attention_int8_cuda(*quant, qs, valid).transpose(1, 2)
    rel = ((y8 - y4).norm() / y4.norm()).item()
    print(f"K10a + K10 vs K4: rel-L2 {rel:.3e}", flush=True)
    if not rel < 0.1:
        return 1
    t10a = cuda_ms(torch, lambda: quantize_qkv_int8_cuda(q, k, vh), args.reps)
    t10 = cuda_ms(torch, lambda: attention_int8_cuda(*quant, qs, valid), args.reps)
    print(f"K10 [2,12,32768,128] int8 valid 32760: {t10:.3f} ms ({flops / t10 / 1e9:.0f} TOP/s); "
          f"K10a {t10a:.3f} ms; (K10a + K10) / K4 self {(t10 + t10a) / t4:.3f}", flush=True)
    return 0


def k10a_bench(torch, g, reps):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wanq_tpu_torch.ops.attn_int8 import (
        quantize_qkv_int8_cuda, quantize_qkv_int8_plain, quantize_qkv_int8_traffic,
        v_kernel_layout)

    dev = g.device
    for b, n, s in ((2, 12, 32768), (2, 40, 75776)):
        q = torch.randn((b, n, s, 128), device=dev, generator=g).bfloat16()
        k = torch.randn((b, n, s, 128), device=dev, generator=g).bfloat16()
        v_flat = torch.randn((b, s, n * 128), device=dev, generator=g).bfloat16()
        vh = v_flat.view(b, s, n, 128).transpose(1, 2)
        got = quantize_qkv_int8_cuda(q, k, vh)
        want = quantize_qkv_int8_plain(q, k, vh)
        same = all(torch.equal(got[i], want[i]) for i in (0, 1, 3, 4, 5)) and torch.equal(
            got[2], v_kernel_layout(want[2]))
        del got, want
        torch.cuda.empty_cache()
        t = cuda_ms(torch, lambda: quantize_qkv_int8_cuda(q, k, vh), reps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                quantize_qkv_int8_cuda(q, k, vh)
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            name = re.search(r"\w+_kernel", e.name)
            if e.device_type == DeviceType.CUDA and name:
                per[name[0]] = (per.get(name[0], 0.0)
                                + (e.time_range.end - e.time_range.start) / 1e3 / reps)
        t_copy = cuda_ms(torch, lambda: (q.clone(), k.clone(), v_flat.clone()), reps)
        bound, moved = quantize_qkv_int8_traffic(b, n, s)
        copy_bytes = 4 * 3 * q.numel()
        print(f"K10a [{b},{n},{s},128]: equal to the plain version: {same}; {t:.3f} ms "
              f"({', '.join(f'{k_} {v_:.3f}' for k_, v_ in per.items())}); bound "
              f"{bound / 3.35e9:.3f} ms ({bound / 1e6:.1f} MB), moves {moved / 1e6:.1f} MB "
              f"({moved / t / 1e6:.0f} GB/s); clone of q, k, v ({copy_bytes / 1e6:.1f} MB "
              f"read and written) {t_copy:.3f} ms ({copy_bytes / t_copy / 1e6:.0f} GB/s)",
              flush=True)
        if not same:
            return 1
        del q, k, v_flat, vh
        torch.cuda.empty_cache()
    return 0


def bwd_bench(torch, g, reps):
    """K12 and K11 at the training shapes; see the module docstring. The
    bounds: three (K12) and four (K11) S-sized products of 2 Sq kv_valid D
    flops a head at 989 TFLOP/s (bf16)."""
    import math

    from wanq_tpu_torch.models.attention import (
        _flash_cuda, attention_bwd_reference, flash_attention_bwd)

    dev = g.device
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, d, qs = 1, 128, 1.0 / math.sqrt(128)
    failed = False
    for label, n, sq, sk, valid, chunk in (("self", 12, 32768, 32768, 32760, 1024),
                                           ("cross", 12, 32768, 512, 512, 8192),
                                           ("self 40 heads", 40, 32768, 32768, 32760, 256)):
        q = torch.randn((b, sq, n * d), device=dev, generator=g).bfloat16().view(b, sq, n, d)
        k = torch.randn((b, sk, n * d), device=dev, generator=g).bfloat16().view(b, sk, n, d)
        v = torch.randn((b, sk, n * d), device=dev, generator=g).bfloat16().view(b, sk, n, d)
        k[:, valid:] = 0.0
        v[:, valid:] = 100.0
        do = torch.randn((b, sq, n, d), device=dev, generator=g).bfloat16()
        out, lse = _flash_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), qs,
                               valid, lse=True)
        got = flash_attention_bwd(q, k, v, out, lse, do, qs, valid)
        again = flash_attention_bwd(q, k, v, out, lse, do, qs, valid)
        same = all(torch.equal(a, z) for a, z in zip(got, again))
        del again
        want = attention_bwd_reference(q, k, v, out, lse, do, qs, valid, q_chunk=chunk)
        rels = [((a.float() - w.float()).norm() / w.float().norm()).item()
                for a, w in zip(got, want)]
        zeros = not got[1][:, valid:].any() and not got[2][:, valid:].any()
        del got, want
        torch.cuda.empty_cache()
        ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k[:, :valid], v[:, :valid]))
        o_l = sdpa(ql, kl, vl, scale=qs)
        t_lib = cuda_ms(torch, lambda: torch.autograd.grad(o_l, (ql, kl, vl), do.transpose(1, 2),
                                                           retain_graph=True), reps)
        del o_l, ql, kl, vl
        t_dq = cuda_ms(torch, lambda: flash_attention_bwd(q, k, v, out, lse, do, qs, valid,
                                                          dkv=False), reps)
        t_dkv = cuda_ms(torch, lambda: flash_attention_bwd(q, k, v, out, lse, do, qs, valid,
                                                           dq=False), reps)
        flops = 2 * b * n * sq * valid * d  # one S-sized product
        bound = flops / 989e9  # ms
        print(f"backward {label} q [1,{sq},{n},128] k/v [1,{sk},{n},128] valid {valid}: "
              f"rel-L2 dq, dk, dv {', '.join(f'{r:.2e}' for r in rels)}; equal bits of two "
              f"calls {same}; dk = dv = 0 past valid {zeros}; K12 {t_dq:.3f} ms "
              f"({3 * flops / t_dq / 1e9:.0f} TFLOP/s, {t_dq / (3 * bound):.2f}x its bound "
              f"{3 * bound:.3f}); K11 {t_dkv:.3f} ms ({4 * flops / t_dkv / 1e9:.0f} TFLOP/s, "
              f"{t_dkv / (4 * bound):.2f}x its bound {4 * bound:.3f}); K12 + K11 "
              f"{t_dq + t_dkv:.3f} ms; scaled_dot_product_attention's backward {t_lib:.3f} ms "
              f"-> {(t_dq + t_dkv) / t_lib:.2f}x", flush=True)
        failed |= not (max(rels) <= 1e-2 and same and zeros)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
