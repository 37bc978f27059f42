"""Each device second of a traced denoise window credited to the program
span that launched it, on the chip at a cell's own size:

    python3 bench_h100/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell as ``run.py --trace 1`` does (the same set-up, window, check
and last line), with ``harness.reduce_trace`` also returning ``spans`` and
each span's largest kernels (:func:`reduce_trace_with_spans`), then prints
one more JSON line: each span's exclusive device milliseconds per step,
``(outside)``'s, the sum beside the window's kernel milliseconds, and each
span's five largest kernels. The benchmark's own runs never run this:
``reduce_trace`` does not call :func:`span_seconds` yet, so no per-layer
metric reads the spans. When it does, :func:`reduce_trace_with_spans` and
the patch in :func:`main` go, and the harness keeps one trace path.

The program's spans (``wanq_tpu_torch/utils/trace.py``) are
``record_function`` ranges; with CUDA activity each also appears on the
device's timeline as a user annotation around the kernels launched inside
it. A kernel goes to the innermost annotation that holds its interval (the
shortest; between equal ones, the later in :data:`SPAN_NAMES`), or to
``(outside)`` when none does: the benchmark's own record copies in the step
callback. So a span's seconds are exclusive of its children's, and the
spans and ``(outside)`` add up to the window's device seconds that
``reduce_trace`` puts in ``kernels``, clipped to the window the same way."""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterator, List, Optional, Tuple

from harness import reduce_trace

# the program's span names, outermost first: a frozen copy of
# wanq_tpu_torch/utils/trace.py's SPAN_NAMES (the benchmark imports nothing
# of the program to read a trace)
SPAN_NAMES = ("pipe.step", "dit.forward", "dit.block", "dit.self_attn", "dit.cross_attn",
              "dit.ffn")
OUTSIDE = "(outside)"


def credited(events, window_name: str, w0: float, w1: float) -> Iterator[Tuple[str, str, float]]:
    """(span or ``(outside)``, kernel name, device seconds inside [w0, w1])
    for each device op of a ``torch.profiler`` trace that ``reduce_trace``
    counts as device work."""
    from torch.autograd import DeviceType

    marks, ops = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        a, z = e.time_range.start, e.time_range.end
        if e.name == window_name or getattr(e, "is_user_annotation", False):
            if e.name in SPAN_NAMES:
                marks.append((a, z, e.name))
            continue
        if min(z, w1) > max(a, w0):
            ops.append((a, z, e.name))
    marks.sort()
    depth = {name: i for i, name in enumerate(SPAN_NAMES)}
    live: List[Tuple[float, float, str]] = []
    i = 0
    for a, z, name in sorted(ops):
        while i < len(marks) and marks[i][0] <= a:
            live.append(marks[i])
            i += 1
        live = [m for m in live if m[1] >= a]  # ops come in start order
        holding = [m for m in live if m[1] >= z]
        span = (min(holding, key=lambda m: (m[1] - m[0], -depth[m[2]]))[2] if holding
                else OUTSIDE)
        yield span, name, (min(z, w1) - max(a, w0)) / 1e6


def span_seconds(events, window_name: str, w0: float, w1: float,
                 by_kernel: Optional[Dict[str, Dict[str, float]]] = None) -> Dict[str, List]:
    """{span name or ``(outside)``: [exclusive device seconds, device ops]}
    over the window [w0, w1] (the trace's microseconds). When ``by_kernel``
    is a dict, each span's device seconds by kernel name go into it in the
    same pass."""
    out = {name: [0.0, 0] for name in SPAN_NAMES + (OUTSIDE,)}
    for span, name, s in credited(events, window_name, w0, w1):
        out[span][0] += s
        out[span][1] += 1
        if by_kernel is not None:
            ops = by_kernel.setdefault(span, {})
            ops[name] = ops.get(name, 0.0) + s
    return out


def reduce_trace_with_spans(prof, window_name: str, top: int = 0) -> Dict:
    """``harness.reduce_trace``'s readings, unchanged, and ``spans``; with
    ``top``, also each span's ``top`` largest device ops under ``top``
    ([[name, seconds], ...])."""
    from torch.autograd import DeviceType

    out = reduce_trace(prof, window_name)  # raises without the window
    events = prof.events()
    win = next(e for e in events if e.name == window_name and e.device_type == DeviceType.CPU)
    by_kernel: Optional[Dict[str, Dict[str, float]]] = {} if top else None
    out["spans"] = span_seconds(events, window_name, win.time_range.start, win.time_range.end,
                                by_kernel)
    if top:
        out["top"] = {span: sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:top]
                      for span, ops in by_kernel.items()}
    return out


def summary(reading: Dict, steps: int) -> Dict:
    """The per-step figures of a reading with ``spans``."""
    kernel_s = sum(s for s, _ in reading["kernels"].values())
    span_s = sum(s for s, _ in reading["spans"].values())
    return {"steps": steps,
            "ms_per_step": {k: 1e3 * s / steps for k, (s, _) in reading["spans"].items()},
            "ops_per_step": {k: n / steps for k, (_, n) in reading["spans"].items()},
            "kernel_ms_per_step": 1e3 * kernel_s / steps,
            "spans_ms_per_step": 1e3 * span_s / steps,
            "sum_rel_gap": abs(span_s - kernel_s) / kernel_s if kernel_s else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("bench_h100 spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import harness
    import run

    readings = []

    def traced(prof, window_name):
        readings.append(reduce_trace_with_spans(prof, window_name, top=5))
        return readings[-1]

    harness.reduce_trace = traced
    try:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"])
    finally:
        harness.reduce_trace = reduce_trace
    if rc != 0 or not readings:
        return rc or 1
    tag = f"{args.workload}.{args.seed}.trace"
    steps = len(json.loads((run.OUT / f"{tag}.steps.json").read_text())["step_s"])
    line = {"workload": args.workload, "seed": args.seed, **summary(readings[0], steps),
            "top": readings[0]["top"]}
    (run.OUT / f"{tag}.spans.json").write_text(json.dumps(line))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
