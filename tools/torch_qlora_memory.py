"""What holds the peak of a T2V-14B QLoRA step: the step of
chip_smoke.qlora_steps (the streamed W4A8 base of chip_smoke.QLORA_14B, rank-16
adapters, seed 3, remat, lr 1e-4, guidance 3) at a cut depth.

    python3 tools/torch_qlora_memory.py [--frames 81 9]

Runs on one NVIDIA card. For each frame count, in a fresh process (no cache of
the allocator carries over), it prints the card's name and power limit, the
allocator setting and:

- the peak allocated of one step at BLOCKS (2) blocks under remat, and the
  projection to 40 blocks: the peak + 38 x (one block's int state
  and adapters with their gradient, Adam moments and EMA, and one saved block
  input);
- the account of that peak: the student's forward of one block without remat
  under ``torch.autograd.graph.saved_tensors_hooks``, every tensor it saves
  for the backward (each storage once, the base, the adapters and the batch
  left out), grouped by the line of the port whose op saved it (its two innermost
  frames), and how far that block's backward rises above them (its
  transients). Under remat a block's backward holds its recompute's saved
  tensors and these transients, so the two make the peak beside what the
  step keeps (the base, the saved block inputs, the teacher's output).

The TOP (30) largest groups also go to ``_smoke_out/qlora_memory_<frames>f.json``.
(The allocator's own history, ``torch.cuda.memory._record_memory_history``
with Python stacks, fails inside the checkpoint's recompute on the card with
"error return without exception set", and ``torch.profiler``'s memory events
miss the allocations of autograd's device thread.)
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.sep + "wanq_tpu_torch" + os.sep
GIB = 2**30
BLOCKS, TOP = 2, 30


def _site(stack) -> str:
    """The two innermost frames of the port in a traceback.StackSummary."""
    port = [f for f in stack if PORT in f.filename][-2:]
    if not port:
        return "outside the port"
    inner = port[-1]
    where = f"{inner.filename.split(PORT)[-1]}:{inner.lineno} `{(inner.line or '').strip()}`"
    if len(port) == 2:
        where += f" < {port[0].filename.split(PORT)[-1]}:{port[0].lineno}"
    return where


def _ptrs(tree, out=None) -> set:
    """The storages of every tensor in a nested dict / list / tuple."""
    import torch

    out = set() if out is None else out
    if torch.is_tensor(tree):
        out.add(tree.untyped_storage().data_ptr())
    elif isinstance(tree, dict):
        for v in tree.values():
            _ptrs(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _ptrs(v, out)
    return out


def saved_account(fn, exclude: set):
    """Run ``fn`` (a forward under autograd) recording each tensor it saves
    for the backward: (its result, {storage: (bytes, site, dtype, shape)}),
    storages in ``exclude`` left out."""
    import torch

    seen = {}

    def pack(t):
        key = t.untyped_storage().data_ptr()
        if key not in exclude and key not in seen:
            seen[key] = (t.untyped_storage().nbytes(), _site(traceback.extract_stack()[:-1]),
                         str(t.dtype).replace("torch.", ""), tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, seen


def group(seen, top: int):
    """[(site, dtype, bytes, count, {shape: n})], largest first, and the bytes
    past ``top``."""
    g = collections.defaultdict(lambda: [0, 0, collections.Counter()])
    for nbytes, site, dtype, shape in seen.values():
        e = g[(site, dtype)]
        e[0] += nbytes
        e[1] += 1
        e[2][str(list(shape))] += 1
    rows = sorted(((s, d, v[0], v[1], dict(v[2].most_common(3))) for (s, d), v in g.items()),
                  key=lambda r: -r[2])
    return rows[:top], sum(r[2] for r in rows[top:])


def run(frames: int) -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.ops import _lib
    from wanq_tpu_torch.quant import QuantConfig, build_streamed_quant_base
    from wanq_tpu_torch.training import (
        DistillConfig, init_train_state, make_qlora_distill_step)
    from wanq_tpu_torch.training.lora import init_lora_from_cfg

    torch.backends.cuda.matmul.allow_tf32 = False
    _lib.lib()
    cs.OUT.mkdir(exist_ok=True)
    blocks = BLOCKS
    cfg = dataclasses.replace(WAN_CONFIGS["t2v-14B"], num_layers=blocks)
    params, qctx, qbytes = build_streamed_quant_base(cfg, QuantConfig.from_dict(cs.QLORA_14B))
    lora = init_lora_from_cfg(cfg, rank=16, seed=3, device="cuda")
    batch = cs.distill_batch(torch, cfg, frames)
    _, _, f, h, w = batch[0].shape
    seq = f * (h // cfg.patch_size[1]) * (w // cfg.patch_size[2])
    dcfg = DistillConfig(learning_rate=1e-4, seq_len=seq, remat=True)
    state, tx = init_train_state(lora, dcfg)
    step = make_qlora_distill_step(cfg, dcfg, tx)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, _, _, loss, gnorm = step(state.params, state.ema_params, tx, params, qctx, *batch, 3.0)
    loss, gnorm = float(loss), float(gnorm)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    adapters = sum(t.numel() * t.element_size() for ab in lora.values()
                   if isinstance(ab, dict) for t in ab.values())
    per_block = (qbytes + 5 * adapters) / blocks + seq * cfg.dim * 2
    projected = peak + (40 - blocks) * per_block
    print(f"card: {cs.nvidia_smi()}; PYTORCH_CUDA_ALLOC_CONF="
          f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF', '(unset)')}")
    print(f"T2V-14B QLoRA warm-up step, {blocks} blocks, remat, 832x480x{frames} (seq {seq}): "
          f"loss {loss:.8f} gnorm {gnorm:.8e}; held before {held / GIB:.3f} GiB (int state "
          f"{qbytes / GIB:.3f}); peak allocated {peak / GIB:.3f} GiB; a block's int state, "
          f"adapters x5 and saved input {per_block / GIB:.4f} GiB; projected to 40 blocks "
          f"{projected / GIB:.3f} GiB")

    # the account: one block's student forward without remat, then its backward
    one = make_qlora_distill_step(dataclasses.replace(cfg, num_layers=1),
                                  dataclasses.replace(dcfg, remat=False), tx)
    exclude = _ptrs([params, qctx.state, state.params, batch])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    loss1, seen = saved_account(
        lambda: one.loss_fn(state.params, params, qctx, *batch, 3.0), exclude)
    torch.cuda.synchronize()
    after_fwd = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss1.backward()
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated()
    tx.zero_grad(set_to_none=True)
    saved = sum(v[0] for v in seen.values())
    rows, rest = group(seen, TOP)
    print(f"  one block (and the prelude / head), no remat: saved for the backward "
          f"{saved / GIB:.3f} GiB in {len(seen)} storages; held after the forward "
          f"{(after_fwd - before) / GIB:.3f} GiB above before it; the backward's peak "
          f"{(bwd_peak - after_fwd) / GIB:.3f} GiB above the end of the forward")
    for site, dtype, nbytes, count, shapes in rows:
        print(f"  {nbytes / GIB:8.3f} GiB  x{count:<3d} {dtype:8s} {site}  "
              + ", ".join(f"{s} x{n}" for s, n in shapes.items()))
    print(f"  {rest / GIB:8.3f} GiB  the rest")
    with open(cs.OUT / f"qlora_memory_{frames}f.json", "w") as fh:
        json.dump({"card": cs.nvidia_smi(), "frames": frames, "blocks": blocks, "seq": seq,
                   "loss": loss, "gnorm": gnorm, "held_before": held, "int_bytes": qbytes,
                   "peak_allocated": peak, "per_block": per_block, "projected_40": projected,
                   "saved": saved, "held_after_forward": after_fwd - before,
                   "backward_rise": bwd_peak - after_fwd, "rest": rest,
                   "groups": [dict(site=s, dtype=d, bytes=b, count=n, shapes=z)
                              for s, d, b, n, z in rows]}, fh, indent=1)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser("torch_qlora_memory")
    p.add_argument("--frames", type=int, nargs="+", default=[81, 9])
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_qlora_memory: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.one:
        return run(args.frames[0])
    rc = 0
    for frames in args.frames:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", "--frames",
                              str(frames)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
