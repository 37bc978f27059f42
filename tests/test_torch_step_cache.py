"""The port's step caches and sequential CFG against wanq_tpu on the CPU.

Both packages run the ``tiny`` DiT (float32) from the same weights and the
same initial noise (JAX's draw, passed to the port as ``noise=``), 8 UniPC
steps at 64x64x5 with guidance 2 (see ``GEN_KW``). Tolerances: latents rel-L2
<= 1e-4 (one forward of the two packages agrees to ~1e-7; the sums run in
another order); ``last_cache_stats`` equal; the adaptive
trace's actions equal and its drifts ``d`` and output changes ``o`` within
1e-5. Sequential CFG against batched in the port: rel-L2 <= 1e-5 (B-sized
and 2B-sized CPU matmuls may sum in another order). The policies built from
the CLI flags and the shipped YAMLs are held equal field by field, and
``simulate_adaptive_actions`` equal on seeded and hypothesis-drawn drift
sequences. Two faults of ``wanq_tpu/cli/common.py`` are corrected in the
port and pinned here: an explicit ``--cache_threshold 0`` turns a YAML's
``cache:`` section off, and explicit ``--cache_warmup`` / ``--cache_tail`` /
``--cache_order`` / ``--cache_poly`` survive the fallback to the section.
"""

import argparse
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.cli import common as jcommon
from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.pipelines import text2video as jt2v
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu_torch.cli import common as tcommon
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.pipelines import text2video as tt2v
from wanq_tpu_torch.quant import QuantConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "quant_configs", "*.yaml")))
W4A8_14B = os.path.join(ROOT, "quant_configs", "wan_w4a8_14b.yaml")
W8A8_14B = os.path.join(ROOT, "quant_configs", "wan_w8a8_14b.yaml")
SPEED = os.path.join(ROOT, "quant_configs", "wan_w8a8_speed.yaml")
# guide 2, not the default 5: on the tiny random model CFG 5 makes the loop
# ill-conditioned (a 1e-7 relative change of the initial noise reaches 6e-5
# rel-L2 in 8 steps, against 1.6e-7 at guide 2), so at 5 the packages' f32
# rounding differences, not the caches, would set the distance
GEN_KW = dict(size=(64, 64), frame_num=5, sampling_steps=8, guide_scale=2.0)
SEED = 11


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.fixture(scope="module")
def models():
    """The same tiny weights in both packages, head.head redrawn (the
    reference zero-inits it), the same text states and JAX's initial noise."""
    cfg_j, cfg_t = jax_tiny_config(), tiny_config()
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = tdit.init_params(cfg_t, 0, device="cpu")
    hw = (np.random.default_rng(123).standard_normal((cfg_t.dim, 64)) * 0.02).astype(np.float32)
    pj["head"]["head"]["w"] = jnp.asarray(hw)
    pt["head"]["head"]["w"] = torch.from_numpy(hw)
    rng = np.random.default_rng(1)
    c, cn = (rng.normal(size=(1, cfg_t.text_len, cfg_t.text_dim)).astype(np.float32)
             for _ in range(2))
    shape = tt2v.compute_target_shape(cfg_t, GEN_KW["size"], GEN_KW["frame_num"])
    noise = np.array(jax.random.normal(jax.random.PRNGKey(SEED), (1, *shape), jnp.float32))
    return cfg_j, pj, cfg_t, pt, c, cn, noise


def _run_both(models, jpol, tpol, cfg_mode="batched"):
    cfg_j, pj, cfg_t, pt, c, cn, noise = models
    jpipe = jt2v.WanT2V(cfg_j, pj)
    want = np.asarray(jpipe.generate(jnp.asarray(c), jnp.asarray(cn), seed=SEED,
                                     cache_policy=jpol, cfg_mode=cfg_mode, **GEN_KW))
    tpipe = tt2v.WanT2V(cfg_t, pt, device="cpu")
    got = tpipe.generate(torch.from_numpy(c), torch.from_numpy(cn),
                         noise=torch.from_numpy(noise), cache_policy=tpol, cfg_mode=cfg_mode,
                         **GEN_KW).numpy()
    return jpipe, want, tpipe, got


def _both(kind, **kw):
    return getattr(jt2v, kind)(**kw), getattr(tt2v, kind)(**kw)


# ---------------------------------------------------------------------------
# the static schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,n", [
    (dict(cfg_interval=2, warmup=2, tail=2), 10),
    (dict(reuse_interval=3, warmup=1, tail=1), 8),
    (dict(cfg_interval=2, reuse_interval=2, warmup=1, tail=1), 6),
    (dict(cfg_interval=2, reuse_interval=2, warmup=2, tail=2), 10),
    (dict(cfg_interval=3, reuse_interval=2, warmup=0, tail=0), 13),
    (dict(warmup=100, tail=0), 5),
])
def test_plan_matches_jax(kw, n):
    jpol, tpol = _both("StepCachePolicy", **kw)
    assert tpol.plan(n) == jpol.plan(n)
    assert tpol.active == jpol.active


@pytest.mark.parametrize("kw", [
    dict(cfg_interval=2, warmup=100, tail=0),                 # all full
    dict(cfg_interval=2, warmup=2, tail=2),                   # cond steps
    dict(reuse_interval=2, warmup=2, tail=2),                 # reuse, order 0
    dict(cfg_interval=2, reuse_interval=2, warmup=1, tail=1),
    dict(reuse_interval=3, warmup=2, tail=1, order=1),
    dict(reuse_interval=3, warmup=3, tail=1, order=2),
    dict(reuse_interval=4, warmup=2, tail=1, order=1, max_horizon=0.5),  # capped
], ids=["all_full", "cfg2", "reuse2", "cfg2_reuse2", "order1", "order2", "order1_capped"])
def test_static_cached_generate_matches_jax(models, kw):
    jpol, tpol = _both("StepCachePolicy", **kw)
    jpipe, want, tpipe, got = _run_both(models, jpol, tpol)
    assert tpipe.last_cache_stats == jpipe.last_cache_stats
    assert tpipe.last_adaptive_trace is None
    assert np.isfinite(got).all() and _rel(want, got) <= 1e-4


def test_all_full_schedule_equals_the_uncached_loop(models):
    """The cached loop's full step is the uncached step's arithmetic: equal
    bits in the port (JAX holds its split and combined jits to 60 dB)."""
    _, _, cfg_t, pt, c, cn, noise = models
    pipe = tt2v.WanT2V(cfg_t, pt, device="cpu")
    args = (torch.from_numpy(c), torch.from_numpy(cn))
    base = pipe.generate(*args, noise=torch.from_numpy(noise), **GEN_KW)
    pol = tt2v.StepCachePolicy(cfg_interval=2, warmup=100, tail=0)
    cached = pipe.generate(*args, noise=torch.from_numpy(noise), cache_policy=pol, **GEN_KW)
    assert pipe.last_cache_stats == {"full": 8, "cond": 0, "reuse": 0}
    assert torch.equal(base, cached)
    # an inactive policy takes the uncached loop and records nothing
    pipe.last_cache_stats = None
    again = pipe.generate(*args, noise=torch.from_numpy(noise),
                          cache_policy=tt2v.StepCachePolicy(), **GEN_KW)
    assert torch.equal(base, again) and pipe.last_cache_stats is None


# ---------------------------------------------------------------------------
# the adaptive policy
# ---------------------------------------------------------------------------


# the tiny trajectory drifts 0.005-0.03 a step: the first three thresholds mix
# reuse with full (and cond) steps, 1e9 reuses every unprotected step
@pytest.mark.parametrize("kw", [
    dict(threshold=0.02, warmup=1, tail=1),
    dict(threshold=0.012, warmup=1, tail=1, cfg_interval=2),
    dict(threshold=0.05, warmup=1, tail=1, poly=(2.0, 0.001)),
    dict(threshold=1e9, warmup=2, tail=2, order=1),
    dict(threshold=1e9, warmup=2, tail=1, order=2),
    dict(threshold=1e9, warmup=3, tail=1, order=1, max_horizon=0.25),
    dict(threshold=1e-9, warmup=2, tail=2, cfg_interval=2),
], ids=["plain", "cfg2", "poly", "order1", "order2", "order1_capped", "every_step_cfg2"])
def test_adaptive_cached_generate_matches_jax(models, kw):
    jpol, tpol = _both("AdaptiveCachePolicy", **kw)
    jpipe, want, tpipe, got = _run_both(models, jpol, tpol)
    assert tpipe.last_cache_stats == jpipe.last_cache_stats
    jtr, ttr = jpipe.last_adaptive_trace, tpipe.last_adaptive_trace
    assert [(e["step"], e["act"], "o" in e) for e in ttr] == \
        [(e["step"], e["act"], "o" in e) for e in jtr]
    for a, b in zip(jtr, ttr):
        for key in ("d", "o", "acc"):
            if key in a:
                assert abs(a[key] - b[key]) <= 1e-5 * max(1.0, abs(a[key])), (key, a, b)
    assert np.isfinite(got).all() and _rel(want, got) <= 1e-4


def test_adaptive_trace_replays_through_simulate(models):
    """``simulate_adaptive_actions`` on the trace's own drifts gives the
    actions the loop took (what the 14B smoke path checks on the card)."""
    _, _, cfg_t, pt, c, cn, noise = models
    pipe = tt2v.WanT2V(cfg_t, pt, device="cpu")
    for pol in (tt2v.AdaptiveCachePolicy(threshold=0.15, warmup=1, tail=1),
                tt2v.AdaptiveCachePolicy(threshold=0.45, warmup=2, tail=1, cfg_interval=2),
                tt2v.AdaptiveCachePolicy(threshold=0.5, warmup=2, tail=2,
                                         poly=QuantConfig.from_yaml(W4A8_14B).cache["poly"])):
        pipe.generate(torch.from_numpy(c), torch.from_numpy(cn),
                      noise=torch.from_numpy(noise), cache_policy=pol, **GEN_KW)
        n = GEN_KW["sampling_steps"]
        drifts, real = [0.0] * n, ["full"] * n
        for e in pipe.last_adaptive_trace:
            drifts[e["step"]], real[e["step"]] = e["d"], e["act"]
        assert tt2v.simulate_adaptive_actions(pol, drifts) == real
        assert {a: real.count(a) for a in ("full", "cond", "reuse")} == pipe.last_cache_stats


def test_fit_drift_poly_matches_jax(models):
    """The all-evaluate pass and the fit: the same (d, o) pairs, so the
    fitted polynomial agrees where it is used (its values on the drifts,
    within 1e-4 of the output changes' scale) and coefficient by coefficient
    within 1e-3 relative to the largest."""
    cfg_j, pj, cfg_t, pt, c, cn, noise = models
    jpipe = jt2v.WanT2V(cfg_j, pj)
    want = jt2v.fit_drift_poly(jpipe, jnp.asarray(c), jnp.asarray(cn), degree=2, seed=SEED,
                               **GEN_KW)
    tpipe = tt2v.WanT2V(cfg_t, pt, device="cpu")
    got = tt2v.fit_drift_poly(tpipe, torch.from_numpy(c), torch.from_numpy(cn), degree=2,
                              noise=torch.from_numpy(noise), **GEN_KW)
    assert len(got) == len(want) == 3
    d = np.asarray([e["d"] for e in tpipe.last_adaptive_trace if "o" in e])
    assert len(d) == 7
    np.testing.assert_allclose(np.polyval(got, d), np.polyval(want, d), atol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


# ---------------------------------------------------------------------------
# sequential CFG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [None, dict(cfg_interval=2, reuse_interval=2, warmup=1, tail=1)],
                         ids=["uncached", "cached"])
def test_sequential_matches_batched_and_jax(models, kw):
    jpol, tpol = _both("StepCachePolicy", **kw) if kw else (None, None)
    jpipe, want, tpipe, got = _run_both(models, jpol, tpol, cfg_mode="sequential")
    assert tpipe.last_cache_stats == jpipe.last_cache_stats
    assert _rel(want, got) <= 1e-4
    _, _, cfg_t, pt, c, cn, noise = models
    batched = tt2v.WanT2V(cfg_t, pt, device="cpu").generate(
        torch.from_numpy(c), torch.from_numpy(cn), noise=torch.from_numpy(noise),
        cache_policy=tpol, **GEN_KW).numpy()
    assert _rel(batched, got) <= 1e-5


def test_calibration_and_unknown_modes_raise(models):
    from wanq_tpu_torch.quant.qlinear import QuantCtx

    _, _, cfg_t, pt, c, cn, _ = models
    args = (torch.from_numpy(c), torch.from_numpy(cn))
    pipe = tt2v.WanT2V(cfg_t, pt, quant_ctx=QuantCtx(mode="calib"), device="cpu")
    with pytest.raises(ValueError, match="batched"):
        pipe.generate(*args, collect_calib=True, cfg_mode="sequential", **GEN_KW)
    with pytest.raises(ValueError, match="cache_policy"):
        pipe.generate(*args, collect_calib=True,
                      cache_policy=tt2v.StepCachePolicy(cfg_interval=2), **GEN_KW)
    with pytest.raises(ValueError, match="cfg_mode"):
        tt2v.WanT2V(cfg_t, pt, device="cpu").generate(*args, cfg_mode="interleaved", **GEN_KW)
    for kind in ("StepCachePolicy", "AdaptiveCachePolicy"):
        for order in (-1, 3):
            with pytest.raises(ValueError, match="order"):
                getattr(tt2v, kind)(order=order)


# ---------------------------------------------------------------------------
# forecasts on an oracle trajectory
# ---------------------------------------------------------------------------


def _poly_step_fns(pipe, power):
    """Replace the forwards by a prediction that is (t / 1000) ** power, as
    wanq_tpu's test does: order >= power then forecasts skipped steps
    exactly."""
    def cond(latents, t, context, ctx, seq_len, extra=None):
        return torch.ones_like(latents) * (t / 1000.0) ** power

    def split(latents, t, context, context_null, ctx, seq_len, sequential=False, extra=None):
        p = cond(latents, t, context, ctx, seq_len)
        return p, p

    pipe._cond, pipe._split = cond, split


@pytest.mark.parametrize("power,exact_order", [(1, 1), (2, 2)])
def test_forecast_is_exact_on_polynomial_trajectories(models, power, exact_order):
    _, _, cfg_t, pt, _, _, noise = models
    pipe = tt2v.WanT2V(cfg_t, pt, device="cpu")
    _poly_step_fns(pipe, power)
    c = torch.zeros((1, cfg_t.text_len, cfg_t.text_dim))
    kw = dict(noise=torch.from_numpy(noise), **GEN_KW)
    base = pipe.generate(c, c, cache_policy=tt2v.StepCachePolicy(cfg_interval=2, warmup=100,
                                                                   tail=0), **kw)

    def pol(o):
        return tt2v.StepCachePolicy(reuse_interval=3, warmup=exact_order + 1, tail=1, order=o)

    exact = pipe.generate(c, c, cache_policy=pol(exact_order), **kw)
    assert pipe.last_cache_stats["reuse"] > 0
    verbatim = pipe.generate(c, c, cache_policy=pol(0), **kw)
    err_exact = (exact - base).abs().max().item()
    err_verbatim = (verbatim - base).abs().max().item()
    assert err_exact < 1e-5 and err_verbatim > 50 * max(err_exact, 1e-9)


def test_lagrange_weights_match_jax():
    for ts, t in (([900.0, 800.0], 700.0), ([950.0, 900.0, 820.0], 640.0)):
        np.testing.assert_allclose(tt2v._lagrange_weights(ts, t), jt2v._lagrange_weights(ts, t),
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# simulate_adaptive_actions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_simulate_adaptive_actions_matches_jax_seeded(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        kw = dict(threshold=float(rng.uniform(0.0, 1.5)), warmup=int(rng.integers(0, 5)),
                  tail=int(rng.integers(0, 5)), cfg_interval=int(rng.integers(1, 4)),
                  poly=tuple(float(x) for x in rng.normal(size=int(rng.integers(1, 5)))))
        drifts = list(rng.uniform(0.0, 0.6, size=int(rng.integers(1, 40))))
        jpol, tpol = _both("AdaptiveCachePolicy", **kw)
        assert tt2v.simulate_adaptive_actions(tpol, drifts) == \
            jt2v.simulate_adaptive_actions(jpol, drifts)


def test_simulate_adaptive_actions_matches_jax_hypothesis():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=150, deadline=None, derandomize=True, database=None)
    @hypothesis.given(
        drifts=st.lists(st.floats(0.0, 2.0, allow_nan=False), min_size=1, max_size=50),
        threshold=st.floats(0.0, 3.0, allow_nan=False), warmup=st.integers(0, 6),
        tail=st.integers(0, 6), cfg_interval=st.integers(1, 4),
        poly=st.lists(st.floats(-5.0, 5.0, allow_nan=False), min_size=1, max_size=5))
    def check(drifts, threshold, warmup, tail, cfg_interval, poly):
        kw = dict(threshold=threshold, warmup=warmup, tail=tail, cfg_interval=cfg_interval,
                  poly=tuple(poly))
        jpol, tpol = _both("AdaptiveCachePolicy", **kw)
        assert tt2v.simulate_adaptive_actions(tpol, drifts) == \
            jt2v.simulate_adaptive_actions(jpol, drifts)

    check()


@pytest.mark.parametrize("yaml", [W8A8_14B, W4A8_14B], ids=["w8a8_14b", "w4a8_14b"])
def test_14b_shipped_cache_policy_skips_on_measured_trajectory(yaml):
    """The mirror of tests/test_step_cache.py's pin, for both 14B YAMLs: on
    drifts in the range measured on the 14B 720p trajectory (0.092-0.243)
    the shipped policy skips at least 8 of 30 steps, keeps its protected
    ends, and skips at least twice as often as the untuned 1.3B policy."""
    pol = tcommon.cache_policy_from_config(QuantConfig.from_yaml(yaml))
    assert isinstance(pol, tt2v.AdaptiveCachePolicy)
    assert pol.threshold == 0.5 and len(pol.poly) == 5
    drifts = list(np.random.default_rng(0).uniform(0.092, 0.243, size=30))
    acts = tt2v.simulate_adaptive_actions(pol, drifts)
    assert acts == jt2v.simulate_adaptive_actions(
        jcommon.cache_policy_from_config(JaxQuantConfig.from_yaml(yaml)), drifts)
    n_reuse = acts.count("reuse")
    assert n_reuse >= 8, acts
    assert acts[:2] == ["full", "full"] and acts[-2:] == ["full", "full"]
    old = tt2v.AdaptiveCachePolicy(threshold=0.10, warmup=2, tail=2)
    assert tt2v.simulate_adaptive_actions(old, drifts).count("reuse") <= n_reuse // 2


# ---------------------------------------------------------------------------
# policies from the YAMLs and the CLI flags
# ---------------------------------------------------------------------------


def _same_policy(tpol, jpol):
    if jpol is None or tpol is None:
        return tpol is None and jpol is None
    return (type(tpol).__name__ == type(jpol).__name__
            and dataclasses.asdict(tpol) == dataclasses.asdict(jpol))


@pytest.mark.parametrize("yaml", YAMLS, ids=[os.path.basename(y) for y in YAMLS])
def test_shipped_yaml_policies_match_jax(yaml):
    tq, jq = QuantConfig.from_yaml(yaml), JaxQuantConfig.from_yaml(yaml)
    assert tq.cache == jq.cache
    assert _same_policy(tcommon.cache_policy_from_config(tq),
                        jcommon.cache_policy_from_config(jq))


def _flags(**given):
    """Parsed quant_generate-style flags with ``given`` on the command line."""
    p = tcommon.add_common_args(argparse.ArgumentParser())
    argv = []
    for k, v in given.items():
        argv += [f"--{k}", str(v)]
    return p.parse_args(argv)


def _jax_namespace(ns):
    """The same flags as wanq_tpu's parser fills them (its defaults for the
    flags not given)."""
    jdef = dict(cache_threshold=0.0, cache_warmup=4, cache_tail=4, cache_order=0, cache_poly="")
    return argparse.Namespace(**{k: (jdef[k] if getattr(ns, k, None) is None and k in jdef
                                     else getattr(ns, k))
                                 for k in ("cache_threshold", "cfg_cache_interval",
                                           "reuse_interval", "cache_warmup", "cache_tail",
                                           "cache_order", "cache_poly")})


@pytest.mark.parametrize("given", [
    {},
    dict(cache_threshold=0.1, cache_warmup=2, cache_tail=2, cache_poly="2.5,0.5,0.0"),
    dict(cache_threshold=0.1, cfg_cache_interval=2, cache_warmup=3, cache_tail=5),
    dict(reuse_interval=2),
    dict(reuse_interval=2, cfg_cache_interval=2, cache_warmup=2, cache_tail=2, cache_order=2),
    dict(cache_threshold=0.1, cache_order=1),
    dict(cfg_cache_interval=3),
], ids=["none", "adaptive_poly", "adaptive_cfg", "reuse", "static_order", "adaptive_order",
        "cfg"])
@pytest.mark.parametrize("yaml", [None, W8A8_14B, SPEED], ids=["no_yaml", "w8a8_14b", "speed"])
def test_cli_cache_flags_match_jax(given, yaml):
    """Where wanq_tpu's builder is right (a threshold > 0, a static
    interval, or no flag at all), the port builds the same policy."""
    ns = _flags(**given)
    tq = QuantConfig.from_yaml(yaml) if yaml else None
    jq = JaxQuantConfig.from_yaml(yaml) if yaml else None
    assert _same_policy(tcommon.cache_policy_from_args(ns, tq),
                        jcommon.cache_policy_from_args(_jax_namespace(ns), jq))


def test_explicit_zero_threshold_turns_the_yaml_cache_off():
    """Reference fault (wanq_tpu/cli/common.py:216): its ``--cache_threshold``
    defaults to 0, so an explicit 0 looks unset and the YAML's section stays
    on. The port's default is None: an explicit 0 turns the section off."""
    tq, jq = QuantConfig.from_yaml(W8A8_14B), JaxQuantConfig.from_yaml(W8A8_14B)
    assert isinstance(tcommon.cache_policy_from_args(_flags(), tq), tt2v.AdaptiveCachePolicy)
    off = _flags(cache_threshold=0)
    assert off.cache_threshold == 0.0
    assert tcommon.cache_policy_from_args(off, tq) is None
    assert isinstance(jcommon.cache_policy_from_args(_jax_namespace(off), jq),
                      jt2v.AdaptiveCachePolicy)  # the reference keeps it
    # with a static interval beside it, the static schedule alone
    pol = tcommon.cache_policy_from_args(_flags(cache_threshold=0, reuse_interval=2), tq)
    assert isinstance(pol, tt2v.StepCachePolicy) and pol.reuse_interval == 2


def test_explicit_flags_survive_the_yaml_fallback():
    """Reference fault (wanq_tpu/cli/common.py:219): when the YAML section
    applies, wanq_tpu drops explicit ``--cache_warmup`` / ``--cache_tail`` /
    ``--cache_order`` / ``--cache_poly``. The port keeps them; unset ones take
    the section's values."""
    tq, jq = QuantConfig.from_yaml(W4A8_14B), JaxQuantConfig.from_yaml(W4A8_14B)
    ns = _flags(cache_warmup=3, cache_tail=1, cache_order=1, cache_poly="0.5,0.0")
    pol = tcommon.cache_policy_from_args(ns, tq)
    assert isinstance(pol, tt2v.AdaptiveCachePolicy)
    assert (pol.threshold, pol.warmup, pol.tail, pol.order, pol.poly) == (0.5, 3, 1, 1, (0.5, 0.0))
    jpol = jcommon.cache_policy_from_args(_jax_namespace(ns), jq)
    assert (jpol.warmup, jpol.tail, jpol.order) == (2, 2, 0)  # the reference drops them
    partial = tcommon.cache_policy_from_args(_flags(cache_tail=3), tq)
    assert (partial.warmup, partial.tail, partial.poly) == (2, 3, tuple(tq.cache["poly"]))


def test_cli_sequential_and_static_cache_on_tiny(tmp_path, capsys):
    """quant_generate on the tiny config: --cfg_mode sequential against the
    batched run (rel-L2 <= 1e-5), and the static schedule of the smoke run's
    1.3B check, whose logged and saved actions equal StepCachePolicy.plan."""
    import json

    from wanq_tpu_torch.cli import get_calib_data, quant_generate

    common = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--random_init",
              "--device", "cpu"]
    calib = get_calib_data.generate(get_calib_data.parse_args(
        common + ["--collect_minmax", "--sample_steps", "1",
                  "--calib_save_path", str(tmp_path / "calib.npz")]))
    lats = {}
    for label, extra in (("batched", []), ("sequential", ["--cfg_mode", "sequential"]),
                         ("static", ["--sample_steps", "8", "--reuse_interval", "2",
                                     "--cfg_cache_interval", "2", "--cache_warmup", "2",
                                     "--cache_tail", "2"])):
        out = quant_generate.generate(quant_generate.parse_args(
            common + ["--quant_config", SPEED, "--calib_data", calib, "--hardware",
                      "--sample_steps", "2", *extra, "--save_file",
                      str(tmp_path / f"{label}.npz")]))
        lats[label] = np.load(out)
    assert _rel(lats["batched"]["latents"], lats["sequential"]["latents"]) <= 1e-5
    plan = tt2v.StepCachePolicy(cfg_interval=2, reuse_interval=2, warmup=2, tail=2).plan(8)
    assert plan == ["full", "full", "full", "reuse", "cond", "reuse", "full", "full"]
    stats = json.loads(str(lats["static"]["cache_stats"]))
    assert stats == {a: plan.count(a) for a in ("full", "cond", "reuse")}
    assert "step cache actions: {'full': 5, 'cond': 1, 'reuse': 2}" in capsys.readouterr().out
