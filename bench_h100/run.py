"""The benchmark of wanq_tpu_torch on one NVIDIA H100, one cell a run:

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json`` and in
``bench_h100/workloads/<cell>.json``; its configuration in the file that
``BENCHMARK.json`` names, its job kind in ``jobs/<job>.py``, its scheme in
``schemes/<scheme>.yaml`` and each per-layer metric's reader in
``metrics/<metric>.py``. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit. Everything else goes to standard error and ``_out/``.
Without a CUDA card (or with fewer than the cell asks for) it prints no
result and exits with 2; if JAX or the JAX package was imported, with 3."""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]
os.environ.setdefault("USE_FLAX", "0")
# any kernel cache a library keeps goes to a fixed directory in the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, str(HERE / "_out" / "cache" / _sub))

from harness import OUT, device_info, forbidden_modules, log, run_job, top_ops  # noqa: E402


class Job:
    """One run's inputs, as the job kinds read them."""

    def __init__(self, spec, cfg, seed, seconds, trace, t_start, device="cuda"):
        self.spec, self.cfg, self.seed, self.seconds = spec, cfg, seed, seconds
        self.trace, self.t_start, self.device = trace, t_start, device
        self.scheme_path = str(HERE / "schemes" / f"{spec['scheme']}.yaml")
        self.tag = f"{spec['name']}.{seed}.{'trace' if trace else 'e2e'}"


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(name: str):
    """(BENCHMARK.json, the cell's entry, its file, its configuration file)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = find(bench["workloads"], name, "workload")
    spec = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    conf = find(bench["configs"], entry["config"], "config")
    cfg = json.loads((ROOT / conf["file"]).read_text())
    return bench, entry, spec, cfg


def metric_names(metrics, cell: str):
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def layer_metrics(bench, cell: str, layer) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in metric_names(bench["per_layer"], cell):
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(layer)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("bench_h100")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench, entry, spec, cfg = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"needs {entry['chips']} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    OUT.mkdir(exist_ok=True)
    job = Job(spec, cfg, args.seed, args.seconds, bool(args.trace), T_START)
    res = run_job(job, load_module(HERE / "jobs" / f"{spec['job']}.py"))
    found = forbidden_modules()
    if found:
        log(f"JAX in the process after the window: {found}: no result")
        return 3

    limits = spec["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in res["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if args.trace:
        metrics = layer_metrics(bench, args.workload, res["layer"])
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {m["name"]: {"value": res["values"][m["name"]], "unit": units[m["name"]]}
                   for m in metric_names(bench["end_to_end"], args.workload)}
    device = {**device_info(torch), "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if args.trace:
        layer = res["layer"]
        device.update(busy_s=layer["busy_s"], window_s=layer["window_s"])
        line["breakdown"] = {"device_ops": top_ops(layer["kernels"]),
                             "idle_gaps": layer["idle_gaps"]}
    line["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
