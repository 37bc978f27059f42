"""The readings the limits of a cell's comparison are set from, on the chip
at the cell's own size, many seeds in one process:

    python3 bench_h100/control.py --workload <cell> --seeds 1,2,3 --seconds 4 [--control 1]
        [--fault <name>]

For each seed: the program's set-up and a short window (as a run makes them),
then the comparison of ``jobs/<job>.py``; with ``--control 1`` also the
control's, the reference one precision below the configuration's in the
program's place. With ``--fault`` the program runs with that fault of
``faults.py`` planted under its timed path. One JSON line a seed on standard
output. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time

from run import HERE, OUT, Job, load_cell, load_module  # run.py also puts the paths in place


def main(argv=None) -> int:
    p = argparse.ArgumentParser("bench_h100 control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    _, _, spec, cfg = load_cell(args.workload)
    if args.fault:
        from faults import Patches, plant

        plant(spec["job"], args.fault, Patches())
    jobs = load_module(HERE / "jobs" / f"{spec['job']}.py")
    OUT.mkdir(exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        job = Job(spec, cfg, seed, args.seconds, False, t0)
        run = jobs.setup(job)
        win = jobs.window(job, run)
        kept = jobs.free(run)
        line = {"seed": seed, "steps": win["steps"], "fault": args.fault,
                "program": jobs.check(job, kept)}
        if args.control:
            for name in spec["controls"]:
                line[name] = jobs.check(job, kept, control=name)
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
