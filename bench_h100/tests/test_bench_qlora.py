"""A whole run of the QLoRA job on the tiny model on the CPU (the look for a
card skipped), judged by the cell's own limits: a sound run is correct, the
control reads above a limit, and a run with its timed path broken underneath
is not correct, for each fault the cell can have: an optimizer step that
leaves the state unchanged; the teacher's answer altered where it is
produced (one latent frame of its CFG velocity moved by its standard
deviation); half of the batch left out, the loss's mean over the first half
of the sequence's latent frames (``faults.py``). On the tiny model's 32
tokens half of them moves the loss; at the cell's own 32760 on the card it
reads as sound runs do, which is why the cell is not in BENCHMARK.json
(PERF.md §7)."""

import pytest

from faults import FAULTS, plant
from harness import run_job
from run import HERE, load_module
from tiny import job

CELL = "t2v-1.3b.qlora.480p81"
QLORA = load_module(HERE / "jobs" / "qlora.py")


def qjob():
    return job(CELL, steps=None)


def correct(j, checks):
    return all(v <= j.spec["limits"][k] for k, v in checks.items())


def test_sound_run_is_correct():
    j = qjob()
    assert correct(j, run_job(j, QLORA)["checks"])


def test_control_is_not_correct():
    j = qjob()
    state = QLORA.setup(j)
    QLORA.window(j, state)
    kept = QLORA.free(state)
    assert not correct(j, QLORA.check(j, kept, control=j.spec["controls"][0]))


@pytest.mark.parametrize("fault", sorted(FAULTS["qlora"]))
def test_broken_path_is_not_correct(fault, monkeypatch):
    plant("qlora", fault, monkeypatch.setattr)
    j = qjob()
    assert not correct(j, run_job(j, QLORA)["checks"])
