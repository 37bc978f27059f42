"""The port's timestep schedule of quant ctxs (``WanT2V.quant_ctx_schedule``)
and the map capture from a deployed model (``WanT2V.capture_attn_maps``)
against wanq_tpu on the CPU.

Both packages run the ``tiny`` DiT (float32) from the same weights and
JAX's initial noise. The schedule: two sim ctxs (W8A8, W4A8) from one JAX
PTQ each, switched at t = 900 over 4 UniPC steps (shift 5: timesteps ~998,
937, 833, 625), in the plain loop and under a step cache; latents within
rel-L2 1e-4 of wanq_tpu's (guidance 2, see tests/test_torch_step_cache.py),
every step's ctx read from the forward it ran; an unsorted schedule raises;
an fp entry (or None) runs the plain forward.

The capture: one forward at t = 500 through the deployed ctx, pool 4 over
the 48-token grid (3 x 4 x 4). The port captures from the unscaled q, as
calibration does, so its deployed fp capture equals a calib-mode capture of
the same forward bit for bit and wanq_tpu's calib-mode capture within 1e-5
(rel-L2). wanq_tpu's deployed capture applies 1/sqrt(d) to a q that already
carries it (its maps are sharper); that fault is pinned here: the port's
map with q pre-scaled once more reproduces wanq_tpu's within 1e-5 (fp) and
2e-2 (int8, whose q and k differ by the packages' code flips), while the
port's own is 0.1+ away from it. The int8 capture is within 2e-2 of the
FP calibration's (W8A8 error) and every pooled row keeps mass 1/pool
(within 1e-3).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.pipelines import text2video as jt2v
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu.quant.ptq import prepare_quant_state as jax_prepare
from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import quant_state_from_numpy
from wanq_tpu_torch.pipelines import text2video as tt2v
from wanq_tpu_torch.quant.attn import select_temporal_windows
from wanq_tpu_torch.quant.qlinear import QuantCtx

FP_REGEX = r"text_embedding|time_embedding|time_projection|head\.head"
GEN_KW = dict(size=(32, 32), frame_num=5, sampling_steps=4, guide_scale=2.0)
SEED = 11
POOL = 4
CAPTURE = dict(size=(64, 64), frame_num=9, pool=POOL)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = jax_tiny_config(), tiny_config()
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = tdit.init_params(cfg_t, 0, device="cpu")
    hw = (np.random.default_rng(123).standard_normal((cfg_t.dim, 64)) * 0.02).astype(np.float32)
    pj["head"]["head"]["w"] = jnp.asarray(hw)
    pt["head"]["head"]["w"] = torch.from_numpy(hw)
    names = jdit.linear_layer_names(cfg_j)

    def ctxs(w_bits, mode="sim"):
        qcfg = JaxQuantConfig.from_dict({"remain_fp_regex": FP_REGEX,
                                         "weight": {"n_bits": w_bits, "sym": False},
                                         "act": {"n_bits": 8, "sym": True}})
        pol, st, rot = jax_prepare(pj, names, qcfg, targets=mode)
        return (JaxQuantCtx(mode=mode, policies=pol, state=st, rotations=rot),
                QuantCtx(mode=mode, policies=pol, state=quant_state_from_numpy(
                    jax.tree.map(np.asarray, st), device="cpu")))

    rng = np.random.default_rng(2)
    c, cn = (rng.normal(size=(1, cfg_t.text_len, cfg_t.text_dim)).astype(np.float32)
             for _ in range(2))
    shape = tt2v.compute_target_shape(cfg_t, GEN_KW["size"], GEN_KW["frame_num"])
    noise = np.array(jax.random.normal(jax.random.PRNGKey(SEED), (1, *shape), jnp.float32))
    return cfg_j, pj, cfg_t, pt, ctxs, c, cn, noise


def _run(setup, jkw, tkw, **gen):
    cfg_j, pj, cfg_t, pt, _, c, cn, noise = setup
    want = np.asarray(jt2v.WanT2V(cfg_j, pj, **jkw).generate(
        jnp.asarray(c), jnp.asarray(cn), seed=SEED, **GEN_KW,
        **{k: v[0] if isinstance(v, tuple) else v for k, v in gen.items()}))
    pipe = tt2v.WanT2V(cfg_t, pt, device="cpu", **tkw)
    got = pipe.generate(torch.from_numpy(c), torch.from_numpy(cn), noise=torch.from_numpy(noise),
                        **GEN_KW, **{k: v[1] if isinstance(v, tuple) else v
                                     for k, v in gen.items()}).numpy()
    return want, got


def _record_ctxs(monkeypatch):
    """The ctx of every dit_forward the pipeline calls."""
    seen = []
    orig = tt2v.dit_forward

    def fwd(params, cfg, x, t, context, seq_len, ctx=None, **kw):
        seen.append((float(t[0]), ctx))
        return orig(params, cfg, x, t, context, seq_len, ctx=ctx, **kw)

    monkeypatch.setattr(tt2v, "dit_forward", fwd)
    return seen


# ---------------------------------------------------------------------------
# quant_ctx_schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cached", [False, True], ids=["plain", "cached"])
def test_schedule_switches_ctxs_like_jax(setup, monkeypatch, cached):
    (j8, t8), (j4, t4) = setup[4](8), setup[4](4)
    gen = {}
    if cached:
        gen["cache_policy"] = (jt2v.StepCachePolicy(cfg_interval=2, warmup=1, tail=1),
                               tt2v.StepCachePolicy(cfg_interval=2, warmup=1, tail=1))
    seen = _record_ctxs(monkeypatch)
    want, got = _run(setup, dict(quant_ctx_schedule=[(900.0, j8), (0.0, j4)]),
                     dict(quant_ctx_schedule=[(900.0, t8), (0.0, t4)]), **gen)
    assert np.isfinite(got).all() and _rel(want, got) <= 1e-4
    # W8 while t >= 900 (two steps), W4 below
    assert [c is t8 for t, c in seen] == [t >= 900.0 for t, c in seen]
    assert all(c is t4 for _, c in seen if c is not t8)
    w8_only, _ = _run(setup, dict(quant_ctx=j8), {})
    w4_only, _ = _run(setup, dict(quant_ctx=j4), {})
    assert not np.allclose(got, w8_only) and not np.allclose(got, w4_only)


def test_schedule_fp_entry_runs_the_plain_forward(setup, monkeypatch):
    (j8, t8) = setup[4](8)
    seen = _record_ctxs(monkeypatch)
    want, got = _run(setup, dict(quant_ctx_schedule=[(900.0, j8), (0.0, None)]),
                     dict(quant_ctx_schedule=[(900.0, t8), (0.0, QuantCtx(mode="fp"))]))
    assert _rel(want, got) <= 1e-4
    assert [c for t, c in seen if t < 900.0] == [None, None]
    fp, _ = _run(setup, {}, {})
    assert not np.allclose(got, fp)


def test_schedule_falls_back_to_quant_ctx(setup, monkeypatch):
    (j8, t8), (j4, t4) = setup[4](8), setup[4](4)
    seen = _record_ctxs(monkeypatch)
    want, got = _run(setup, dict(quant_ctx=j4, quant_ctx_schedule=[(900.0, j8)]),
                     dict(quant_ctx=t4, quant_ctx_schedule=[(900.0, t8)]))
    assert _rel(want, got) <= 1e-4
    assert [c is t8 for _, c in seen] == [True, True, False, False]


def test_unsorted_schedule_rejected(setup):
    _, _, cfg_t, pt, ctxs, *_ = setup
    _, t8 = ctxs(8)
    with pytest.raises(ValueError, match="descending"):
        tt2v.WanT2V(cfg_t, pt, device="cpu", quant_ctx_schedule=[(0.0, None), (900.0, t8)])


def test_calibration_ignores_the_schedule(setup, monkeypatch):
    _, _, cfg_t, pt, ctxs, c, cn, noise = setup
    _, t8 = ctxs(8)
    calib = QuantCtx(mode="calib")
    seen = _record_ctxs(monkeypatch)
    tt2v.WanT2V(cfg_t, pt, quant_ctx=calib, device="cpu",
                quant_ctx_schedule=[(900.0, t8)]).collect_calibration(
        torch.from_numpy(c), torch.from_numpy(cn), noise=torch.from_numpy(noise), **GEN_KW)
    assert [ctx is calib for _, ctx in seen] == [True] * 4


# ---------------------------------------------------------------------------
# capture_attn_maps
# ---------------------------------------------------------------------------


def _capture_latents(cfg):
    shape = tt2v.compute_target_shape(cfg, CAPTURE["size"], CAPTURE["frame_num"])
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (1, *shape), jnp.float32))


def _jax_calib_maps(cfg_j, pj, lat, c):
    cctx = JaxQuantCtx(mode="calib", attn_map_pool=POOL, attn_map_reduce="mean")
    jdit.dit_forward(pj, cfg_j, jnp.asarray(lat), jnp.full((1,), 500.0, jnp.float32),
                     jnp.asarray(c), 48, ctx=cctx)
    return {k[: -len(".attn_map")]: np.asarray(v) for k, v in cctx.collect.items()
            if k.endswith(".attn_map")}


@pytest.fixture
def double_scaled(monkeypatch):
    """The port's capture with wanq_tpu's fault put back: q scaled once
    more before the map."""
    orig = tdit.pooled_attn_map

    def pooled(q, k, pool, **kw):
        return orig(q * (1.0 / math.sqrt(q.shape[-1])), k, pool, **kw)

    return lambda: monkeypatch.setattr(tdit, "pooled_attn_map", pooled)


def test_capture_fp_equals_calibration_and_pins_the_double_scale(setup, double_scaled):
    cfg_j, pj, cfg_t, pt, _, c, _, _ = setup
    lat = _capture_latents(cfg_t)
    got = tt2v.WanT2V(cfg_t, pt, device="cpu").capture_attn_maps(
        torch.from_numpy(c), latents=torch.from_numpy(lat), **CAPTURE)
    assert set(got) == {f"blocks.{i}.self_attn" for i in range(cfg_t.num_layers)}
    assert got["blocks.0.self_attn"].shape == (cfg_t.num_heads, 12, 12)
    # a calib-mode capture of the same forward in the port: the same bits
    cctx = QuantCtx(mode="calib", attn_map_pool=POOL, attn_map_reduce="mean")
    tdit.dit_forward(pt, cfg_t, torch.from_numpy(lat), torch.full((1,), 500.0),
                     torch.from_numpy(c), 48, ctx=cctx)
    for name, m in got.items():
        np.testing.assert_array_equal(m, cctx.collect[f"{name}.attn_map"].numpy())
    calib_j = _jax_calib_maps(cfg_j, pj, lat, c)
    fault_j = jt2v.WanT2V(cfg_j, pj).capture_attn_maps(jnp.asarray(c), seed=0, **CAPTURE)
    for name in got:
        assert _rel(calib_j[name], got[name]) <= 1e-5
        assert _rel(fault_j[name], got[name]) > 0.1
    double_scaled()
    again = tt2v.WanT2V(cfg_t, pt, device="cpu").capture_attn_maps(
        torch.from_numpy(c), latents=torch.from_numpy(lat), **CAPTURE)
    for name in got:
        assert _rel(fault_j[name], again[name]) <= 1e-5


def test_capture_int8_from_the_deployed_model(setup, double_scaled):
    cfg_j, pj, cfg_t, pt, ctxs, c, _, _ = setup
    j8, t8 = ctxs(8, mode="int8")
    lat = _capture_latents(cfg_t)
    # a deployed ctx with a temporal window, which the capture drops
    pipe = tt2v.WanT2V(cfg_t, pt, quant_ctx=dataclasses.replace(t8, attn_window=0), device="cpu")
    got = pipe.capture_attn_maps(torch.from_numpy(c), latents=torch.from_numpy(lat), **CAPTURE)
    assert pipe.quant_ctx.attn_map_pool == 0 and not pipe.quant_ctx.collect
    calib_j = _jax_calib_maps(cfg_j, pj, lat, c)
    for name, m in got.items():
        assert m.shape == (cfg_t.num_heads, 12, 12)
        np.testing.assert_allclose(m.sum(axis=-1) * POOL, 1.0, atol=1e-3)
        assert _rel(calib_j[name], m) <= 2e-2
    radii = select_temporal_windows(got, tokens_per_frame=16, pool=POOL, threshold=0.9,
                                    valid_len=48)
    assert all(r.shape == (cfg_t.num_heads,) and 0 <= int(r.min()) and int(r.max()) <= 2
               for r in radii.values())
    fault_j = jt2v.WanT2V(cfg_j, pj, quant_ctx=j8).capture_attn_maps(
        jnp.asarray(c), seed=0, **CAPTURE)
    double_scaled()
    again = pipe.capture_attn_maps(torch.from_numpy(c), latents=torch.from_numpy(lat),
                                   **CAPTURE)
    for name in got:
        assert _rel(fault_j[name], again[name]) <= 2e-2


def test_capture_without_a_self_attention_raises(setup):
    c = setup[5]
    cfg = tiny_config(num_layers=0)
    pipe = tt2v.WanT2V(cfg, tdit.init_params(cfg, 0, device="cpu"), device="cpu")
    with pytest.raises(RuntimeError, match="no attention maps"):
        pipe.capture_attn_maps(torch.from_numpy(c), seed=0, **CAPTURE)
