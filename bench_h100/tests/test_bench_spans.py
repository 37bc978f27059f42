"""The credit of each device op to the program span that launched it
(``spans.py``), on synthetic trace events: the innermost span wins, a
parent's seconds leave out its children's, ops under no span go to
``(outside)``, the spans add up to ``reduce_trace``'s kernel seconds, and
``reduce_trace``'s own readings of the same events do not change. On a card
(``-m cuda``): a traced window of cell 1 credits every span, counts no span
annotation as device work, and adds up."""

import json
import math
import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import spans
from harness import reduce_trace, run_job
from run import HERE, OUT, Job, load_cell, load_module

WINDOW = "bench.window"


def ev(name, a, z, device=DeviceType.CUDA, note=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=note,
                           time_range=SimpleNamespace(start=a, end=z))


def note(name, a, z):
    return ev(name, a, z, note=True)


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


# one step of a forward of one block, on the device's timeline (microseconds)
STEP = [note("pipe.step", 100, 1000), note("dit.forward", 110, 900), note("dit.block", 200, 800),
        note("dit.self_attn", 210, 400), note("dit.cross_attn", 420, 500),
        note("dit.ffn", 520, 780),
        ev("cat", 100, 110), ev("patchify", 110, 120), ev("mod_add", 200, 210),
        ev("flash_fwd_kernel", 210, 390), ev("o_proj", 390, 400), ev("residual", 400, 420),
        ev("cross", 420, 500), ev("residual", 500, 520), ev("w8a8_gemm_kernel", 520, 780),
        ev("residual", 780, 800), ev("head", 800, 900), ev("unipc", 900, 1000)]
WANT = {"pipe.step": 110e-6, "dit.forward": 110e-6, "dit.block": 70e-6,
        "dit.self_attn": 190e-6, "dit.cross_attn": 80e-6, "dit.ffn": 260e-6}


def window(events, w0=0, w1=2000):
    return [ev(WINDOW, w0, w1, device=DeviceType.CPU), note(WINDOW, w0, w1)] + events


def credit(events, w0=0, w1=2000):
    return spans.span_seconds(window(events, w0, w1), WINDOW, w0, w1)


def test_each_op_goes_to_its_innermost_span_exclusive_of_children():
    got = credit(STEP)
    for name, s in WANT.items():
        assert math.isclose(got[name][0], s, rel_tol=1e-12), name
    assert got["dit.block"][1] == 4 and got["pipe.step"][1] == 2
    assert got[spans.OUTSIDE] == [0.0, 0]


def test_ops_under_no_span_go_to_outside():
    got = credit(STEP + [ev("Memcpy DtoH (Device -> Pinned)", 1000, 1040), ev("draw", 20, 30)])
    assert got[spans.OUTSIDE][1] == 2
    assert math.isclose(got[spans.OUTSIDE][0], 50e-6, rel_tol=1e-12)


def test_equal_ranges_go_to_the_deeper_span_and_a_parent_may_end_first():
    """A parent whose own ops end before its child's last op (its
    annotation ends there too) leaves that op to the child; two equal
    ranges give it to the inner name."""
    events = [note("dit.block", 0, 100), note("dit.ffn", 50, 300), ev("mod_add", 0, 10),
              ev("gemm", 60, 300), note("pipe.step", 400, 500), note("dit.forward", 400, 500),
              ev("k", 400, 500)]
    got = credit(events)
    assert math.isclose(got["dit.ffn"][0], 240e-6) and math.isclose(got["dit.block"][0], 10e-6)
    assert got["dit.forward"] == [pytest.approx(100e-6), 1] and got["pipe.step"] == [0.0, 0]


@pytest.mark.parametrize("w0, w1", [(0, 2000), (150, 950), (390, 420)])
def test_the_spans_add_up_to_the_window_kernel_seconds(w0, w1):
    events = window(STEP + [ev("copy", 1000, 1040)], w0, w1)
    got = spans.span_seconds(events, WINDOW, w0, w1)
    kernels = reduce_trace(Prof(events), WINDOW)["kernels"]
    assert math.isclose(sum(s for s, _ in got.values()), sum(s for s, _ in kernels.values()),
                        rel_tol=1e-12)
    assert sum(n for _, n in got.values()) == sum(n for _, n in kernels.values())


def test_reduce_trace_readings_stay_as_they_are():
    events = window(STEP + [ev("copy", 1100, 1140)])
    plain = reduce_trace(Prof(events), WINDOW)
    got = spans.reduce_trace_with_spans(Prof(events), WINDOW)
    assert {k: got[k] for k in plain} == plain and set(got) == set(plain) | {"spans"}
    # the annotations are no device work
    assert not set(spans.SPAN_NAMES) & set(plain["kernels"])


def test_each_spans_top_kernels_come_from_the_same_credit():
    got = spans.reduce_trace_with_spans(Prof(window(STEP + [ev("copy", 1100, 1140)])), WINDOW,
                                        top=2)
    assert got["top"]["dit.block"] == [["residual", pytest.approx(60e-6)],
                                       ["mod_add", pytest.approx(10e-6)]]
    assert got["top"][spans.OUTSIDE] == [["copy", pytest.approx(40e-6)]]
    for span, ops in got["top"].items():
        assert len(ops) <= 2
        assert math.isclose(sum(s for _, s in ops), got["spans"][span][0]) or len(ops) == 2
    assert "top" not in spans.reduce_trace_with_spans(Prof(window(STEP)), WINDOW)


def test_summary_per_step_and_the_span_list_matches_the_program():
    from wanq_tpu_torch.utils import trace

    assert spans.SPAN_NAMES == trace.SPAN_NAMES
    reading = spans.reduce_trace_with_spans(Prof(window(STEP + STEP[6:])), WINDOW)
    line = spans.summary(reading, 2)
    assert line["sum_rel_gap"] < 1e-12
    assert math.isclose(line["ms_per_step"]["dit.ffn"], 0.26)
    assert set(line["ms_per_step"]) == set(spans.SPAN_NAMES) | {spans.OUTSIDE}


@pytest.mark.cuda
def test_traced_window_credits_every_span_on_card(card, monkeypatch):
    import harness

    _, _, spec, cfg = load_cell("t2v-1.3b.w8a8.480p81")
    OUT.mkdir(exist_ok=True)
    job = Job(spec, cfg, 3333333333, 2.0, True, time.time())
    monkeypatch.setattr(harness, "reduce_trace",
                        lambda prof, name: spans.reduce_trace_with_spans(prof, name, top=5))
    res = run_job(job, load_module(HERE / "jobs" / f"{spec['job']}.py"))
    reading = res["layer"]
    line = spans.summary(reading, reading["steps"])
    assert all(line["ms_per_step"][name] > 0 for name in spans.SPAN_NAMES), line
    assert line["sum_rel_gap"] < 0.005, line
    assert not set(spans.SPAN_NAMES) & set(reading["kernels"])
    assert set(reading["top"]) >= set(spans.SPAN_NAMES), reading["top"]
    print(json.dumps(line))
