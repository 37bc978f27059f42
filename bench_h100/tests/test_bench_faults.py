"""A whole run of the denoise job on the tiny model on the CPU (the look for
a card skipped), judged by the cell's own limits: a sound run is correct,
the control (the reference one precision below) reads above a limit, and
a run with its timed path broken underneath comes out not correct, once for
each fault the cell can have (``faults.py``): a solver step that returns its
state unchanged; half the CFG batch left out (the conditional half stands in
for both); an answer altered where it is produced (one latent frame of each
forward's output)."""

import pytest

from faults import FAULTS, plant
from harness import run_job
from jobs import denoise
from tiny import cell, job

CELLS = ["t2v-1.3b.w8a8.480p81", "t2v-14b.w4a8.480p81"]


def correct(j, checks):
    return all(v <= j.spec["limits"][k] for k, v in checks.items())


def run_checks(j):
    return run_job(j, denoise)["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    j = job(cell)
    assert correct(j, run_checks(j))


@pytest.mark.parametrize("cell, control", [(c, k) for c in CELLS for k in cell(c)["controls"]])
def test_control_is_not_correct(cell, control):
    """Each of the cell's controls fails through the forward's own number:
    the guidance and the sampler stay f32 under a control."""
    j = job(cell)
    state = denoise.setup(j)
    denoise.window(j, state)
    low = denoise.check(j, denoise.free(state), control=control)
    assert low["sampler_rel_l2"] <= j.spec["limits"]["sampler_rel_l2"]
    assert low["forward_rel_l2"] > j.spec["limits"]["forward_rel_l2"]


@pytest.mark.parametrize("fault", sorted(FAULTS["denoise"]))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    plant("denoise", fault, monkeypatch.setattr)
    j = job(cell)
    assert not correct(j, run_checks(j))
