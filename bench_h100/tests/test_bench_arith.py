"""The yardstick's arithmetic at the published widths against the counts
PERF.md §6 and the benchmark's issue give."""

import json

import pytest

import arith
from reference.scheme import load_scheme
from tiny import BENCH

TRAFFIC = json.loads((BENCH / "workloads" / "t2v-1.3b.w8a8.480p81.json").read_text())["traffic"]


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def scheme(name):
    return load_scheme(str(BENCH / "schemes" / f"{name}.yaml"))


def test_sequence():
    assert arith.seq_tokens(config("t2v-1.3b"), TRAFFIC) == (32760, 32768)


@pytest.mark.parametrize("name, tflop", [("t2v-1.3b", 13.191), ("t2v-14b", 43.970)])
def test_k4_self_ops(name, tflop):
    self_call = arith.attention_calls(config(name), TRAFFIC, 2)[0]
    assert self_call["ops"] / 1e12 == pytest.approx(tflop, abs=5e-4)
    assert self_call["count"] == config(name)["num_layers"]


def test_k4_band_pairs_and_bound():
    """PERF §6: K4's band mode at r = 1 (1.3B, 21 latent frames) visits
    0.1385 of the padded dense pairs, bound 1.848 ms; the model's valid work
    61 of 441 frame pairs. A head with a negative radius is dense."""
    cfg, banded = config("t2v-1.3b"), {**TRAFFIC, "ctx": {"attn_window": 1}}
    dense = arith.attention_calls(cfg, TRAFFIC, 2)[0]
    band = arith.attention_calls(cfg, banded, 2)[0]
    assert band["ops"] / dense["ops"] == pytest.approx(0.1385, abs=5e-5)
    assert band["bound_s"] * 1e3 == pytest.approx(1.848, abs=2e-3)
    assert arith.self_pairs(cfg, banded, 32760) == 32760 ** 2 * 61 / 441
    mixed = {**TRAFFIC, "ctx": {"attn_window": [1] * 6 + [-1] * 6}}
    assert arith.self_pairs(cfg, mixed, 32760) == pytest.approx(32760 ** 2 * (61 / 441 + 1) / 2)


def test_k2_square_ops_and_bound():
    assert arith.gemm_ops(65536, 5120, 5120) / 1e12 == pytest.approx(3.436, abs=5e-4)
    # PERF §6: K2 (1536 -> 1536) at 1.3B is bound by its 0.309 T int8 ops, 0.156 ms
    ops = arith.gemm_ops(65536, 1536, 1536)
    nbytes = arith.int_gemm_bytes(65536, 1536, 1536, 8, 2)
    assert arith.bound_s(ops, nbytes, "int8") * 1e3 == pytest.approx(0.156, abs=1e-3)


def test_least_time_13b():
    """402 T of attention and 18.5 T of FP linears at bf16, 145 T of int8
    linears: about 0.50 s a CFG step."""
    work = arith.forward_work(config("t2v-1.3b"), scheme("wan_w8a8_speed"), TRAFFIC, 2)
    assert work["int8"] / 1e12 == pytest.approx(145, rel=0.01)
    assert arith.least_time_s(work) == pytest.approx(0.498, abs=0.005)


def test_least_time_14b():
    work = arith.forward_work(config("t2v-14b"), scheme("wan_w4a8_14b"), TRAFFIC, 2)
    assert work["int8"] / 1e12 == pytest.approx(1567, rel=0.01)
    assert arith.least_time_s(work) == pytest.approx(2.60, abs=0.03)


@pytest.mark.parametrize("name, cfg, sites", [
    ("wan_w8a8_speed", "t2v-1.3b", ["self_attn.q", "self_attn.k", "self_attn.v", "cross_attn.q",
                                    "ffn.0", "ffn.2"]),
    ("wan_w4a8_14b", "t2v-14b", ["self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o",
                                 "cross_attn.q", "cross_attn.o", "ffn.0", "ffn.2"])])
def test_int_gemm_sites(name, cfg, sites):
    calls = arith.int_gemm_calls(config(cfg), scheme(name), TRAFFIC, 2)
    assert [c["site"] for c in calls] == sites
    mode = [c for c in calls if c["gelu_quant"]]
    assert [c["site"] for c in mode] == ["ffn.0"] and mode[0]["out_bytes"] == 1
    assert all(c["m"] == 65536 for c in calls)


def test_train_step_work():
    """A QLoRA step at 1.3B, B = 1: three forwards of about 283 T each, the
    backward's input gradients (self-attention twice its forward) and the
    adapters: about 1.33 PFLOP, 1.35 s at the bf16 peak."""
    tr = json.loads((BENCH / "workloads" / "t2v-1.3b.qlora.480p81.json").read_text())["traffic"]
    cfg = config("t2v-1.3b")
    assert arith.forward_ops(cfg, tr, 1) / 1e12 == pytest.approx(283.3, rel=0.01)
    assert arith.train_step_work(cfg, tr) / 1e12 == pytest.approx(1333, rel=0.01)
    kinds = {c["kind"]: c for c in arith.train_attention_calls(cfg, tr)}
    # PERF §6's bounds of the training kernels at 12 heads: K12 10.003 ms, K11 13.338 ms
    assert kinds["bwd_dkv.self"]["bound_s"] * 1e3 == pytest.approx(13.33, abs=0.02)
    assert kinds["bwd_dq.self"]["bound_s"] * 1e3 == pytest.approx(10.00, abs=0.02)
