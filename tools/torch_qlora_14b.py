"""QLoRA steps at T2V-14B, all 40 blocks, on the streamed W4A8 base
(quant/stream.py), at a frame count of the caller's choosing; chip_smoke.py
phase 9 runs the same steps at 9 frames (seq 4680).

    python3 tools/torch_qlora_14b.py [--frames 81] [--steps 1]

Runs on one NVIDIA card. Prints the card's name and power limit, the
allocator setting (PYTORCH_CUDA_ALLOC_CONF), the build, and for each step the
loss, gradient norm, seconds, peak and launches, then one more step split by
the host clock (chip_smoke.qlora_steps: a warm-up and ``--steps`` timed
steps, rank 16 on self q/k/v/o and ffn, remat, lr 1e-4, guidance 3). Out of
memory, it prints the allocator's message (the bytes allocated and reserved
at the failure) and the peak, and exits 1.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("torch_qlora_14b")
    p.add_argument("--frames", type=int, default=81, help="video frames (4k + 1)")
    p.add_argument("--steps", type=int, default=1, help="timed steps after the warm-up")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_qlora_14b: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.quant import QuantConfig, build_streamed_quant_base
    from wanq_tpu_torch.training.lora import init_lora_from_cfg

    torch.backends.cuda.matmul.allow_tf32 = False
    _lib.lib()
    cs.OUT.mkdir(exist_ok=True)
    cs.log(f"card: {cs.nvidia_smi()}; PYTORCH_CUDA_ALLOC_CONF="
           f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF', '(unset)')}")
    cfg = WAN_CONFIGS["t2v-14B"]
    params, qctx, _ = build_streamed_quant_base(cfg, QuantConfig.from_dict(cs.QLORA_14B),
                                                log=cs.log)
    lora = init_lora_from_cfg(cfg, rank=16, seed=3, device="cuda")
    batch = cs.distill_batch(torch, cfg, args.frames)
    _, _, f, h, w = batch[0].shape
    seq = f * (h // cfg.patch_size[1]) * (w // cfg.patch_size[2])
    cs.log(f"QLoRA at t2v-14B, {cfg.num_layers} blocks, 832x480x{args.frames} (seq {seq})")
    try:
        cs.qlora_steps(torch, cfg, params, qctx, lora, batch, {}, steps=args.steps, seq=seq,
                       since_warmup=True)
    except torch.OutOfMemoryError as e:
        # the allocator's message gives the bytes allocated and reserved at the failure
        cs.log(f"out of memory: {str(e).split(' If reserved')[0]} Peak allocated "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB.")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
