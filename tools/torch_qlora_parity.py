"""The QLoRA steps of chip_smoke.py phase 7 (T2V-1.3B, 832x480x81, 1 warm-up
+ 3 steps) and phase 9 (iv) (T2V-14B at 40 blocks, 832x480x9, 1 warm-up + 2
steps) from a given checkout, with every loss and gradient norm in full, so
that two trees can be held against each other in one call.

    python3 tools/torch_qlora_parity.py [--root DIR]

``--root``: the checkout whose ``chip_smoke.py`` and ``wanq_tpu_torch`` run
(default: this one). Runs on one NVIDIA card; builds that checkout's kernels.
Prints chip_smoke's log of the steps and then one JSON line: the card, the
root, and for each model the steps' [loss, gradient norm, seconds, peak GiB,
launches] (the split step that qlora_steps runs after them is not in it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser("torch_qlora_parity")
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_qlora_parity: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import dataclasses

    import chip_smoke as cs
    import wanq_tpu_torch.training as training
    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.stream import build_streamed_quant_base
    from wanq_tpu_torch.training.lora import DEFAULT_TARGETS, init_lora_from_cfg

    assert cs.__file__.startswith(root), cs.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    _lib.lib()
    cs.OUT.mkdir(exist_ok=True)
    rows = []
    make = training.make_qlora_distill_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(*aa, **kk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*aa, **kk)
            loss, gnorm = float(out[3]), float(out[4])
            rows.append([loss, gnorm, time.perf_counter() - t0,
                         torch.cuda.max_memory_allocated() / 2**30, _lib.launch_counts()])
            return out
        return run

    training.make_qlora_distill_step = recording
    result = {"root": root, "card": cs.nvidia_smi()}
    cfg = WAN_CONFIGS[cs.TASK]
    params, qctx, lora = cs.qlora_base(torch, cfg)
    cs.qlora_steps(torch, cfg, params, qctx, lora, cs.distill_batch(torch, cfg, cs.FRAMES), {})
    result[cs.TASK], rows = rows[:4], []
    del params, qctx, lora
    torch.cuda.empty_cache()
    full = dataclasses.replace(WAN_CONFIGS[cs.TASK_14B], num_layers=40)
    params, qctx, _ = build_streamed_quant_base(full, QuantConfig.from_dict(cs.QLORA_14B))
    lora = init_lora_from_cfg(full, rank=16, seed=3, targets=DEFAULT_TARGETS, device="cuda")
    cs.qlora_steps(torch, full, params, qctx, lora, cs.distill_batch(torch, full,
                                                                   cs.QLORA_14B_FRAMES),
                   {}, steps=2, seq=cs.QLORA_14B_SEQ, since_warmup=True)
    result[cs.TASK_14B] = rows[:3]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
