"""On the card, at each cell's own size: a run with a short window is
correct, none of the cell's controls is, and neither is a run with each of
its faults planted (``faults.py``). Minutes a cell; run with ``-m cuda``."""

import json
import time

import pytest

from faults import FAULTS, Patches, plant
from harness import run_job
from run import HERE, OUT, Job, load_cell, load_module

BENCHMARK = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
CASES = [(c, None) for c in CELLS] + [
    (c, f) for c in CELLS
    for f in sorted(FAULTS[json.loads((HERE / "workloads" / f"{c}.json").read_text())["job"]])]


def card_job(cell, seed=3333333333):
    _, _, spec, cfg = load_cell(cell)
    OUT.mkdir(exist_ok=True)
    return Job(spec, cfg, seed, 1.0, False, time.time()), load_module(
        HERE / "jobs" / f"{spec['job']}.py")


def correct(job, checks):
    return all(v <= job.spec["limits"][k] for k, v in checks.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell, fault", CASES, ids=lambda x: str(x))
def test_run_on_card(card, cell, fault):
    job, kind = card_job(cell)
    patches = Patches()
    try:
        if fault:
            plant(job.spec["job"], fault, patches)
        assert correct(job, run_job(job, kind)["checks"]) == (fault is None)
    finally:
        patches.undo()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_card(card, cell):
    job, kind = card_job(cell)
    run = kind.setup(job)
    kind.window(job, run)
    kept = kind.free(run)
    for control in job.spec["controls"]:
        assert not correct(job, kind.check(job, kept, control=control)), control
