"""What every job kind shares: logging to standard error, the card's
clock / power sampler beside the window, the reduction of a
``torch.profiler`` trace of the window to device time by kernel, busy time
and idle gaps, the frozen table of the program's hand-kernel names, and the
comparison numbers' arithmetic."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
OUT = HERE / "_out"

# substrings of the program's hand-written kernels' names -> their tags
# (PERF.md §6's K-numbers); every other device op is glue: library GEMMs,
# elementwise ops, reductions, copies
KERNEL_NAMES = {"ln_mod_quant_kernel": "K1", "w8a8_gemm_kernel": "K2",
                "rms_rope_heads_kernel": "K3", "flash_fwd_kernel": "K4",
                "quant_sum_kernel": "K7", "w4a8_gemm_kernel": "K8", "w4a4_gemm_kernel": "K9",
                "attn_int8_kernel": "K10", "qkv_absmax_quant_kernel": "K10a",
                "v_quant_kernel": "K10a", "flash_bwd_dkv_kernel": "K11",
                "flash_bwd_dq_kernel": "K12"}

# modules whose presence after the window means JAX ran in the process
# (compared by whole top-level names: the program's package begins with the
# JAX package's name)
FORBIDDEN = ("jax", "jaxlib", "flax", "wanq_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def kernel_tag(name: str) -> Optional[str]:
    for sub, tag in KERNEL_NAMES.items():
        if sub in name:
            return tag
    return None


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in f64."""
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm().clamp_min(1e-300))


class SmiSampler:
    """``nvidia-smi`` reading the SM clock, power and temperature every
    500 ms into a file under ``_out/`` while it runs."""

    def __init__(self, path: Path):
        self.path, self.proc = path, None

    def __enter__(self):
        try:
            self.file = open(self.path, "w")
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,temperature.gpu",
                 "--format=csv,noheader", "-lms", "500"], stdout=self.file,
                stderr=subprocess.DEVNULL)
        except OSError as err:
            log(f"nvidia-smi sampler not started: {err}")
        return self

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if hasattr(self, "file"):
            self.file.close()
        return False


def device_info(torch) -> Dict:
    """The card's name and count, and its power limit (``nvidia-smi``)."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        info["power_limit"] = res.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        info["power_limit"] = "not read"
    return info


def _union(spans: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, the gaps between covered intervals) of spans."""
    busy, end, gaps = 0.0, -math.inf, []
    for a, z in sorted(spans):
        if z <= end:
            continue
        if end > -math.inf and a > end:
            gaps.append((end, a))
        busy += z - max(a, end)
        end = z
    return busy, gaps


def reduce_trace(prof, window_name: str) -> Dict:
    """The window of a ``torch.profiler`` run (the CPU span named
    ``window_name``): device seconds by kernel name with launch counts, the
    busy seconds (the union of device intervals inside the window), the
    window's seconds, and its ten longest idle gaps, each named by the
    innermost host op that was running when it began."""
    from torch.autograd import DeviceType

    events = prof.events()
    win = [e for e in events if e.name == window_name and e.device_type == DeviceType.CPU]
    if not win:
        raise RuntimeError(f"no {window_name!r} span in the trace")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    spans, by_name, host = [], {}, []
    for e in events:
        a, z = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the host's record_function spans appear on the device's
            # timeline too; they are no device work
            if e.name == window_name or getattr(e, "is_user_annotation", False):
                continue
            a, z = max(a, w0), min(z, w1)
            if z <= a:
                continue
            spans.append((a, z))
            tot = by_name.setdefault(e.name, [0.0, 0])
            tot[0] += (z - a) / 1e6
            tot[1] += 1
        elif e.name != window_name and z > w0 and a < w1:
            host.append((a, z, e.name))
    busy_us, gaps = _union(spans)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, z in gaps:
        inner = [h for h in host if h[0] <= a < h[1]]
        label = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host: no op traced"
        named.append([label, (z - a) / 1e6])
    return {"kernels": by_name, "busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "idle_gaps": named}


def kernel_seconds(kernels: Dict, tags) -> float:
    """Device seconds of the kernels whose tag is in ``tags``."""
    return sum(t for name, (t, _) in kernels.items() if kernel_tag(name) in tags)


def top_ops(kernels: Dict, n: int = 10) -> List:
    return [[name, t] for name, (t, _) in
            sorted(kernels.items(), key=lambda kv: -kv[1][0])[:n]]


def now() -> float:
    return time.perf_counter()


def run_window(job, loop, forwards_per_step: int = 1) -> Dict:
    """The measured window of a job: the peak counter and the program's
    launch counts reset, the ``nvidia-smi`` sampler on, with ``--trace 1`` a
    ``torch.profiler`` over all of it; ``loop(deadline, marks, counts)`` runs
    whole steps, appending each step's end (the host clock, after the card
    is synchronized) to ``marks`` and the launch counts to ``counts``, and
    returns after the first step that ends past ``deadline``. Logs the
    launch check (the window's launches against the cell's per-block counts x
    layers x forwards) and writes each step's seconds and launches to
    ``_out/``. Returns the window's readings."""
    import torch

    from wanq_tpu_torch.ops import _lib

    on_card = job.device != "cpu"
    prof = span = None
    if job.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        span = record_function("bench.window")
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    marks, counts = [], []
    with SmiSampler(OUT / f"{job.tag}.smi.csv"):
        t_open, job.t_open_wall = now(), time.time()
        if span is not None:
            span.__enter__()
        try:
            loop(t_open + job.seconds, marks, counts)
        finally:
            if span is not None:
                span.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    reading = None
    if prof is not None:
        prof.__exit__(None, None, None)
        reading = reduce_trace(prof, "bench.window")
    steps, layers = len(marks), job.cfg["num_layers"]
    launches = _lib.launch_counts()
    want = {k: n * layers * steps * forwards_per_step
            for k, n in job.spec.get("launches_per_block", {}).items()}
    log(f"launch check: window launches {launches}; the cell's per-block counts x {layers} "
        f"layers x {steps * forwards_per_step} forwards: {want}; "
        f"{'equal' if launches == want else 'DIFFERENT'}")
    step_s = [b - a for a, b in zip([t_open] + marks, marks)]
    per_step = [{k: c.get(k, 0) - p.get(k, 0) for k in c}
                for p, c in zip([{}] + counts[:-1], counts)]
    (OUT / f"{job.tag}.steps.json").write_text(json.dumps(
        {"step_s": step_s, "launches_per_step": per_step}))
    log(f"window: {steps} steps in {marks[-1] - t_open:.3f} s; step s "
        f"{[round(x, 4) for x in step_s]}")
    return {"window_s": marks[-1] - t_open, "steps": steps, "peak": peak,
            "peak_setup": peak_setup, "trace": reading}


def run_job(job, kind) -> Dict:
    """A whole run of a job kind's module: set-up, the window, the program's
    state freed, the check. Returns the harness's readings: steps, the
    end-to-end values (``kind.RATE``: the window's seconds a step), what the
    per-layer readers read, the peak, the numbers compared."""
    run = kind.setup(job)
    win = kind.window(job, run)
    values = {"setup_s": job.t_open_wall - job.t_start,
              kind.RATE: win["window_s"] / win["steps"], "peak_gib": win["peak"] / 2**30}
    kept = kind.free(run)
    layer = kind.trace_context(job, win) if win["trace"] is not None else None
    return {"attempted": win["steps"], "failed": 0, "values": values, "layer": layer,
            "memory_peak_bytes": max(win["peak"], win["peak_setup"]),
            "checks": kind.check(job, kept)}
