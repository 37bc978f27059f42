#!/usr/bin/env python3
"""The port's Wan VAE decode on one NVIDIA card: how cuDNN's choice of
convolution algorithm moves the time and the peak memory.

    python3 tools/torch_vae_bench.py [--latent 1,16,21,60,104]
    python3 tools/torch_vae_bench.py --count [--latent ...]   # FLOPs only, any host

Each case runs in a fresh process (PyTorch caches a convolution plan per
shape for the life of the process), decodes the same seeded latents with
the full-width VAE (random weights from init_vae_params, seed 0) and prints
the seconds (host clock after a synchronize) and the peak memory above what
was held before the call:

- heuristics (torch.backends.cudnn.benchmark False, the default), float32:
  the first decode with the card's memory free, then with 40 GiB held by a
  dummy tensor, then free again;
- benchmark mode (cudnn.benchmark True), float32 and bfloat16: the first
  decode (which times every candidate algorithm) and a second one;
- heuristics, bfloat16: first and second decode.

TF32 stays off, as in the port. The bits of each decode are compared with
the case's first decode. ``--count`` prints the decode's floating-point
operations (torch.utils.flop_counter on meta tensors: the convolutions and
the attention products) and its compute bounds at the H100's dense f32 and
bf16 peaks; it needs no card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "heuristics_f32": ("float32", False, ("free", "40 GiB held", "free")),
    "benchmark_f32": ("float32", True, ("first", "second")),
    "heuristics_bf16": ("bfloat16", False, ("first", "second")),
    "benchmark_bf16": ("bfloat16", True, ("first", "second")),
}


def run_case(name: str, latent) -> None:
    import torch

    sys.path.insert(0, ROOT)
    from wanq_tpu_torch.models import vae as vaem

    dtype, benchmark, calls = CASES[name]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = benchmark
    vae = vaem.WanVAE(params=vaem.init_vae_params(vaem.WAN_VAE_CFG, seed=0, device="cpu"),
                      device="cuda", compute_dtype=getattr(torch, dtype))
    z = torch.randn(latent, generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    first = None
    for label in calls:
        hold = torch.empty(40 << 30, dtype=torch.uint8, device="cuda") if "held" in label else None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        video = vae.decode(z)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        same = "-" if first is None else str(torch.equal(video, first))
        first = video if first is None else first
        print(f"{name} ({dtype}, cudnn.benchmark {benchmark}) {label}: {sec:.2f} s, peak "
              f"{peak:.2f} GiB above {base / 2**30:.2f} GiB held; bits equal to the first "
              f"decode: {same}", flush=True)
        del hold, video


PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM data sheet, dense


def count_flops(latent) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    sys.path.insert(0, ROOT)
    from wanq_tpu_torch.models import vae as vaem

    params = {k: v.to("meta") for k, v in
              vaem.init_vae_params(vaem.WAN_VAE_CFG, seed=0, device="cpu").items()}
    vae = vaem.WanVAE(params=params, device="meta")
    with FlopCounterMode(display=False) as fc:
        vae.decode(torch.empty(latent, device="meta"))
    return float(fc.get_total_flops())


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--latent", default="1,16,21,60,104",
                   help="latent shape B,C,T,H,W (default: 832x480x81)")
    p.add_argument("--case", choices=list(CASES), default=None,
                   help="run one case in this process (the default runs each in its own)")
    p.add_argument("--count", action="store_true", help="print the FLOP count and exit")
    args = p.parse_args()
    latent = tuple(int(x) for x in args.latent.split(","))
    if args.count:
        flops = count_flops(latent)
        print(f"VAE decode of {latent}: {flops / 1e12:.2f} TFLOP; bound "
              + ", ".join(f"{dt} {flops / peak:.3f} s" for dt, peak in PEAK_FLOPS.items()))
        return 0
    if args.case:
        run_case(args.case, latent)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_vae_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"nvidia-smi name, power.limit: {smi.strip()}; latent {latent}", flush=True)
    for name in CASES:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--case", name,
                              "--latent", args.latent], timeout=900)
        if res.returncode != 0:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
