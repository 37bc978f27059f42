"""The temporal-window slice of the port against wanq_tpu on the CPU.

The same numpy inputs go through ``wanq_tpu`` (JAX on the CPU, whose
attention runs ``_sdpa_reference`` with the band mask) and through the port
(whose wrappers run their plain versions on CPU tensors): the band mask and
``TemporalWindow``, attention with shared and per-head radii, K4's visited
kv tiles (``band_kv_tiles``) against the mask, ``dit_forward`` with a window
(resolution, pad tail, calibration, int8 GEMMs, guards), ``--attn_window``,
the calibration helpers that choose radii, and the CLIs.

Tolerances: masks, radii and tile ranges are exact. Attention in f32
within 1e-5 (the same softmax; the f32 sums run in another order).
``dit_forward`` on ``tiny`` (f32) rel-L2 <= 1e-4: JAX runs ``head.head``
with bf16 operands even in f32 configs (see test_torch_slice.py). W8A8
with bf16 params rel-L2 <= 2e-2 and cosine >= 0.999, as the W8A8 slice
test. Pooled maps within 1e-5 absolute (bf16 operands in both, f32 sums in
another order); after a model forward, whose f32 q/k differ by ~1e-6 and
can flip a bf16 rounding, within 1e-3 absolute. Port-only comparisons of
the same arithmetic (pad tail, calibration with and without a window, the
CLI against a direct call) are exact or within 1e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.cli import common as jcommon
from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.pipelines.text2video import WanT2V as JaxWanT2V
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu.quant import attn as jqattn
from wanq_tpu.quant.ptq import prepare_quant_state as jax_prepare
from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
from wanq_tpu_torch.cli import common as tcommon
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import attention as tattn
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models import params as tparams
from wanq_tpu_torch.pipelines.text2video import WanT2V, compute_target_shape
from wanq_tpu_torch.quant import attn as tqattn
from wanq_tpu_torch.quant.qlinear import QuantCtx

# wanq_tpu.models re-exports the function `attention` under the module's name
jattn = importlib.import_module("wanq_tpu.models.attention")

SPEED = "quant_configs/wan_w8a8_speed.yaml"
SMALL = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
             freq_dim=64)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# the window, the mask, the tiles
# ---------------------------------------------------------------------------


# pad rows, r = 0, tpf below and above 128, Sq != Sk, valid None
@pytest.mark.parametrize("sq,sk,tpf,r,valid", [
    (23, 23, 5, 1, 21), (96, 96, 16, 0, 96), (300, 300, 100, 1, 290), (300, 300, 130, 2, 256),
    (33, 40, 200, 0, 37), (64, 50, 7, 3, None), (200, 200, 1, 5, 199),
])
def test_band_mask_equals_jax(sq, sk, tpf, r, valid):
    jw, tw = jattn.TemporalWindow(tpf, r), tattn.TemporalWindow(tpf, r)
    want = np.asarray(jattn.temporal_band_dense_mask(sq, sk, jw, valid))
    got = tattn.temporal_band_dense_mask(sq, sk, tw, valid)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    for r2 in (0, r + 2):  # the per-head override
        np.testing.assert_array_equal(
            tattn.temporal_band_dense_mask(sq, sk, tw, valid, radius=r2).numpy(),
            np.asarray(jattn.temporal_band_dense_mask(sq, sk, jw, valid, radius=r2)))


def test_temporal_window_equals_jax():
    """Validation (both refuse the same per-head windows), resolved_radii,
    density (the mean over heads for per-head radii) and _window_is_dense."""
    for head_radii, radius in (((0, 2, -1), 2), ((1, 3), 2)):
        with pytest.raises(AssertionError):
            jattn.TemporalWindow(16, radius, head_radii)
        with pytest.raises(ValueError):
            tattn.TemporalWindow(16, radius, head_radii)
    with pytest.raises(ValueError):
        tattn.TemporalWindow(16, -1)
    for args in ((16, 1), (16, 0), (5, 4, (0, 4, 1, 1)), (7, 9, [9, 2])):
        jw, tw = jattn.TemporalWindow(*args), tattn.TemporalWindow(*args)
        n = len(tw.head_radii) if tw.head_radii else 3
        assert tw.resolved_radii(n) == jw.resolved_radii(n)
        assert tw.head_radii == jw.head_radii
        for f in (1, 2, 4, 6, 21):
            assert tw.density(f) == pytest.approx(jw.density(f), abs=0)
        for valid in (16, 17, 80, 96, 160):
            assert tattn._window_is_dense(tw, valid) == jattn._window_is_dense(jw, valid)
    with pytest.raises(ValueError, match="radii for"):
        tattn.TemporalWindow(5, 4, (0, 4)).resolved_radii(3)


@pytest.mark.parametrize("tpf", [16, 100, 128, 1560])
@pytest.mark.parametrize("r", [0, 1, 2, 5])
def test_band_kv_tiles_cover_the_band(tpf, r):
    """For every 128-row q tile: every in-band pair lies in a visited kv
    tile, and no visited tile is wholly out of band unless the q tile holds
    pad rows (which see the whole prefix)."""
    bq = bkv = 128
    for s, valid in ((1000, 1000), (1000, 993), (4736, 4700), (640, 513)):
        win = tattn.TemporalWindow(tpf, r)
        mask = tattn.temporal_band_dense_mask(s, s, win, valid).numpy()
        for q0 in range(0, s, bq):
            rows = mask[q0:q0 + bq]
            j_lo, j_hi = tattn.band_kv_tiles(q0, bq, bkv, tpf, r, valid)
            assert 0 <= j_lo < j_hi <= -(-valid // bkv)
            cols = np.nonzero(rows.any(axis=0))[0]
            assert cols.min() >= j_lo * bkv and cols.max() < j_hi * bkv
            if q0 + bq <= valid:
                for j in range(j_lo, j_hi):
                    assert rows[:, j * bkv:(j + 1) * bkv].any(), (q0, j)
            else:
                assert (j_lo, j_hi) == (0, -(-valid // bkv))


@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "per_head"])
@pytest.mark.parametrize("valid", [None, 37])
def test_attention_with_window_matches_jax(rng, per_head, valid):
    """attention (seq-major) and attention_heads_major (scale folded into q)
    against JAX attention(..., window=...) in f32, within 1e-5; also the plain
    version with q_chunk smaller than S, which builds the band a chunk at a
    time."""
    b, s, n, d = 2, 40, 3, 128
    q, k, v = (rng.normal(size=(b, s, n, d)).astype(np.float32) for _ in range(3))
    args = (6, 2, (0, 2, 1)) if per_head else (6, 1)
    jw, tw = jattn.TemporalWindow(*args), tattn.TemporalWindow(*args)
    want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      k_valid_len=valid, window=jw))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn.attention(tq, tk, tv, k_valid_len=valid, window=tw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    scale = 1 / np.sqrt(d)
    hm = tattn.attention_heads_major((tq * scale).transpose(1, 2), tk.transpose(1, 2),
                                     tv.transpose(1, 2), k_valid_len=valid, window=tw)
    assert hm.shape == (b, n, s, d)
    np.testing.assert_allclose(hm.transpose(1, 2).numpy(), want, atol=1e-5)
    chunked = tattn._sdpa_reference(tq, tk, tv, scale, valid, window=tw, q_chunk=7)
    np.testing.assert_allclose(chunked.numpy(), want, atol=1e-5)
    dense = tattn.attention(tq, tk, tv, k_valid_len=valid)
    assert not np.allclose(dense.numpy(), want, atol=1e-3)


def test_window_covering_every_frame_is_the_dense_function(rng):
    b, s, n, d = 1, 40, 2, 128
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(np.float32))
               for _ in range(3))
    dense = tattn.attention(q, k, v, k_valid_len=37)
    for win in (tattn.TemporalWindow(6, 6), tattn.TemporalWindow(6, 9, (9, 6))):
        assert tattn._window_is_dense(win, 37)
        np.testing.assert_allclose(tattn.attention(q, k, v, k_valid_len=37, window=win).numpy(),
                                   dense.numpy(), atol=1e-6)
    with pytest.raises(TypeError, match="TemporalWindow"):
        tattn.attention(q, k, v, window=1)


# ---------------------------------------------------------------------------
# dit_forward on tiny: 6 latent frames -> grid (6, 4, 4), 16 tokens a frame
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg_j, cfg_t = jax_tiny_config(), tiny_config()
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(0))
    hw = (np.random.default_rng(123).standard_normal(pj["head"]["head"]["w"].shape) * 0.02)
    pj["head"]["head"]["w"] = jnp.asarray(hw.astype(np.float32))
    pt = tparams.params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    rs = np.random.default_rng(7)
    x = rs.normal(size=(1, cfg_t.in_dim, 6, 8, 8)).astype(np.float32)
    t = np.asarray([500.0], np.float32)
    txt = rs.normal(size=(1, cfg_t.text_len, cfg_t.text_dim)).astype(np.float32)
    return cfg_j, pj, cfg_t, pt, (x, t, txt)


def _jax_fwd(cfg_j, pj, inputs, seq, ctx):
    x, t, txt = (jnp.asarray(a) for a in inputs)
    return np.asarray(jdit.dit_forward(pj, cfg_j, x, t, txt, seq, ctx=ctx))


def _port_fwd(cfg_t, pt, inputs, seq, ctx):
    x, t, txt = (torch.from_numpy(a) for a in inputs)
    out = tdit.dit_forward(pt, cfg_t, x, t, txt, seq, ctx=ctx).numpy()
    assert np.isfinite(out).all()
    return out


@pytest.mark.parametrize("window", ["1", "2", "tw16r2", "per_head", "wide"])
def test_dit_forward_window_matches_jax(tiny, window):
    """attn_window 1 and 2, a hand-resolved TemporalWindow(16, 2), a per-head
    tuple with a negative (dense) entry, and a radius >= F - 1, which is the
    dense forward."""
    cfg_j, pj, cfg_t, pt, inputs = tiny
    aw = {"1": 1, "2": 2, "per_head": (1, -1, 0, 2), "wide": 9}.get(window)
    jaw = taw = aw
    if window == "tw16r2":
        jaw, taw = jattn.TemporalWindow(16, 2), tattn.TemporalWindow(16, 2)
    want = _jax_fwd(cfg_j, pj, inputs, 96, JaxQuantCtx(mode="fp", attn_window=jaw))
    got = _port_fwd(cfg_t, pt, inputs, 96, QuantCtx(mode="fp", attn_window=taw))
    assert _rel(want, got) <= 1e-4
    dense = _port_fwd(cfg_t, pt, inputs, 96, None)
    if window == "wide":
        np.testing.assert_array_equal(got, dense)
    else:
        assert _rel(dense, got) > 1e-3
    if window == "2":  # the int resolves to the window the hand-made one is
        by_hand = _port_fwd(cfg_t, pt, inputs, 96,
                            QuantCtx(mode="fp", attn_window=tattn.TemporalWindow(16, 2)))
        np.testing.assert_array_equal(got, by_hand)


def test_resolve_window_against_the_grid():
    grid = (6, 4, 4)
    assert tdit.resolve_window(-1, grid, 4) is None
    assert tdit.resolve_window(5, grid, 4) is None          # >= F - 1: dense
    assert tdit.resolve_window(1, grid, 4) == tattn.TemporalWindow(16, 1)
    assert tdit.resolve_window((2, 2, 2, 2), grid, 4) == tattn.TemporalWindow(16, 2)
    assert tdit.resolve_window((1, -1, 0, 2), grid, 4) == tattn.TemporalWindow(
        16, 6, (1, 6, 0, 2))
    assert tdit.resolve_window((-1, 7, 5, 5), grid, 4) is None
    with pytest.raises(ValueError, match="3 window radii for 4 heads"):
        tdit.resolve_window((1, 2, 3), grid, 4)


def test_dit_forward_window_pad_tail(tiny):
    """seq padded 96 -> 112: the pad rows and columns leave the valid
    region as it was, and JAX agrees."""
    cfg_j, pj, cfg_t, pt, inputs = tiny
    unpadded = _port_fwd(cfg_t, pt, inputs, 96, QuantCtx(mode="fp", attn_window=1))
    padded = _port_fwd(cfg_t, pt, inputs, 112, QuantCtx(mode="fp", attn_window=1))
    np.testing.assert_allclose(padded, unpadded, atol=1e-5, rtol=1e-5)
    want = _jax_fwd(cfg_j, pj, inputs, 112, JaxQuantCtx(mode="fp", attn_window=1))
    assert _rel(want, padded) <= 1e-4


def test_dit_forward_fused_path_window_matches_jax(rng):
    """head dim 128 (dim 256, 2 heads): the port's fused q/k path (K3 ->
    attention_heads_major) with per-head radii against JAX's unfused chain,
    f32, 4 latent frames of 20 tokens padded 80 -> 96."""
    cfg_j, cfg_t = jax_tiny_config(**SMALL), tiny_config(**SMALL)
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(2))
    pj["head"]["head"]["w"] = jnp.asarray(
        (rng.standard_normal((256, 64)) * 0.02).astype(np.float32))
    pt = tparams.params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    inputs = (rng.normal(size=(2, 16, 4, 8, 10)).astype(np.float32),
              np.asarray([999.0, 500.0], np.float32),
              rng.normal(size=(2, 32, 64)).astype(np.float32))
    for aw in (1, (0, 2)):
        want = _jax_fwd(cfg_j, pj, inputs, 96, JaxQuantCtx(mode="fp", attn_window=aw))
        got = _port_fwd(cfg_t, pt, inputs, 96, QuantCtx(mode="fp", attn_window=aw))
        assert _rel(want, got) <= 1e-4


def test_calibration_ignores_the_window(tiny):
    """Calibration runs dense: with a window it collects exactly what it
    collects without one (the absmax stats and the pooled maps), and the
    pooled maps agree with JAX's."""
    cfg_j, pj, cfg_t, pt, inputs = tiny
    kw = dict(attn_map_pool=8, attn_map_reduce="mean")
    windowed = QuantCtx(mode="calib", attn_window=1, **kw)
    dense = QuantCtx(mode="calib", **kw)
    _port_fwd(cfg_t, pt, inputs, 96, windowed)
    _port_fwd(cfg_t, pt, inputs, 96, dense)
    assert sorted(windowed.collect) == sorted(dense.collect)
    for key in dense.collect:
        assert torch.equal(windowed.collect[key], dense.collect[key]), key
    jctx = JaxQuantCtx(mode="calib", attn_window=1, **kw)
    _jax_fwd(cfg_j, pj, inputs, 96, jctx)
    for i in range(cfg_t.num_layers):
        key = f"blocks.{i}.self_attn.attn_map"
        assert dense.collect[key].shape == (4, 12, 12)
        np.testing.assert_allclose(dense.collect[key].numpy(), np.asarray(jctx.collect[key]),
                                   atol=1e-3)


def test_window_with_int8_gemms_matches_jax(rng):
    """The deployment the window is for: W8A8 int8 GEMMs (the speed YAML,
    bf16 params) with a banded self-attention, against JAX."""
    cfg_j = jax_tiny_config(**SMALL, param_dtype="bfloat16", residual_dtype="bfloat16")
    cfg_t = tiny_config(**SMALL, param_dtype="bfloat16", residual_dtype="bfloat16")
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(5))
    pj["head"]["head"]["w"] = jnp.asarray(
        (rng.standard_normal((256, 64)) * 0.02).astype(np.float32), dtype=jnp.bfloat16)
    pt = tparams.params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    x = rng.normal(size=(2, 16, 4, 8, 10)).astype(np.float32)
    t = np.asarray([999.0, 500.0], np.float32)
    txt = rng.normal(size=(2, 32, 64)).astype(np.float32)
    cc = QuantCtx(mode="calib", collect_minmax=True, attn_window=1)
    _port_fwd(cfg_t, pt, (x, t, txt), 96, cc)
    calib = {k: v.float().numpy()[None] for k, v in cc.collect.items()}
    pol, st, rot = jax_prepare(pj, jdit.linear_layer_names(cfg_j),
                               JaxQuantConfig.from_yaml(SPEED), calib=calib, targets="int8")
    state = tparams.quant_state_from_numpy(jax.tree.map(np.asarray, st), device="cpu")
    want = _jax_fwd(cfg_j, pj, (x, t, txt), 96, JaxQuantCtx(
        mode="int8", policies=pol, state=st, rotations=rot, attn_window=1))
    got = _port_fwd(cfg_t, pt, (x, t, txt), 96,
                    QuantCtx(mode="int8", policies=pol, state=state, attn_window=1))
    assert _rel(want, got) <= 2e-2 and _cos(want, got) >= 0.999
    dense = _port_fwd(cfg_t, pt, (x, t, txt), 96,
                      QuantCtx(mode="int8", policies=pol, state=state))
    assert _rel(dense, got) > 1e-2


def test_window_guards(tiny):
    """A window does not compose with attention-map quantization (sim or
    int8); a window that resolves to dense does; a per-head tuple must have
    one entry per head; a map capture on a deployed ctx runs dense whatever
    its window (the forward and the maps are the window-free ones)."""
    cfg_j, pj, cfg_t, pt, inputs = tiny
    section = tqattn.AttnQuantCfg.from_dict(
        {"qk": {"n_bits": 8, "sym": True}, "v": {"n_bits": 8, "sym": True}})
    for mode in ("sim", "int8"):
        with pytest.raises(NotImplementedError, match="does not compose"):
            _port_fwd(cfg_t, pt, inputs, 96, QuantCtx(mode=mode, attn=section, attn_window=1))
    _port_fwd(cfg_t, pt, inputs, 96, QuantCtx(mode="sim", attn=section, attn_window=-1))
    with pytest.raises(ValueError, match="window radii for 4 heads"):
        _port_fwd(cfg_t, pt, inputs, 96, QuantCtx(mode="fp", attn_window=(1, 2)))
    maps = []
    for win in (None, 1):
        cap = QuantCtx(mode="fp", attn_window=win, attn_map_pool=4, attn_map_reduce="mean")
        out = _port_fwd(cfg_t, pt, inputs, 96, cap)
        maps.append(cap.collect["blocks.0.self_attn.attn_map"])
    np.testing.assert_array_equal(out, _port_fwd(cfg_t, pt, inputs, 96, None))
    assert maps[0].shape == (cfg_t.num_heads, 24, 24) and torch.equal(maps[0], maps[1])
    with pytest.raises(ValueError, match="attn_map_reduce"):
        QuantCtx(mode="calib", attn_map_reduce="sum")


# ---------------------------------------------------------------------------
# --attn_window and the calibration helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("val", ["", "-1", "1", "1,2,", " 0 , -1", "3", None])
def test_parse_attn_window_equals_jax(val):
    import argparse

    args = argparse.Namespace(attn_window=val)
    assert tcommon.parse_attn_window(args) == jcommon.parse_attn_window(args)


@pytest.mark.parametrize("reduce", ["max", "mean"])
@pytest.mark.parametrize("valid", [None, 45])
def test_pooled_attn_map_equals_jax(rng, reduce, valid):
    """[N, S/p, S/p] within 1e-5, one chunk or several (chunk 16 of S 48);
    the mean form keeps each row's mass (1/pool of the softmax row)."""
    b, s, n, d = 2, 48, 3, 16
    q = rng.normal(size=(b, s, n, d)).astype(np.float32)
    k = rng.normal(size=(b, s, n, d)).astype(np.float32)
    for chunk in (1024, 16):
        want = np.asarray(jqattn.pooled_attn_map(jnp.asarray(q), jnp.asarray(k), 4,
                                                 k_valid_len=valid, chunk=chunk, reduce=reduce))
        got = tqattn.pooled_attn_map(torch.from_numpy(q), torch.from_numpy(k), 4,
                                     k_valid_len=valid, chunk=chunk, reduce=reduce)
        assert got.shape == (n, 12, 12) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if reduce == "mean":
        np.testing.assert_allclose(got.numpy().sum(-1), np.full((n, 12), 0.25), atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        tqattn.pooled_attn_map(torch.from_numpy(q), torch.from_numpy(k), 5)


def _window_maps(rng):
    """Mean-pooled maps of 3 layers x 3 heads, S 24 at pool 2 (12 cells),
    4 tokens a frame: head 0 local, head 1 flat, head 2 random."""
    frames = (np.arange(12) * 2 + 1) // 4
    dist = np.abs(frames[:, None] - frames[None, :])
    maps = {}
    for i in range(3):
        local = np.where(dist <= i % 2, 1.0, 0.02)
        heads = [local / local.sum(-1, keepdims=True), np.full((12, 12), 1 / 12),
                 rng.random((12, 12))]
        maps[f"blocks.{i}.self_attn.attn_map"] = np.stack(heads)
    return maps


@pytest.mark.parametrize("threshold", [0.5, 0.9, 0.99])
def test_select_temporal_windows_equals_jax(rng, threshold):
    maps = _window_maps(rng)
    for valid in (None, 21):
        want = jqattn.select_temporal_windows(maps, 4, 2, threshold, valid_len=valid)
        got = tqattn.select_temporal_windows(maps, 4, 2, threshold, valid_len=valid)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))


def test_collapse_window_radii_equals_jax(rng):
    radii = jqattn.select_temporal_windows(_window_maps(rng), 4, 2, 0.9)
    got = tqattn.collapse_window_radii(radii)
    assert isinstance(got, int) and got == jqattn.collapse_window_radii(radii)


def test_per_head_window_radii_equals_jax(rng):
    radii = jqattn.select_temporal_windows(_window_maps(rng), 4, 2, 0.9)
    radii["blocks.3.self_attn.attn_map"] = np.array([5, 0, 1])
    got = tqattn.per_head_window_radii(radii)
    np.testing.assert_array_equal(got, np.asarray(jqattn.per_head_window_radii(radii)))
    assert got.shape == (3,) and got[0] == 5


# ---------------------------------------------------------------------------
# the pipeline and the CLIs
# ---------------------------------------------------------------------------


def test_fp_ctx_with_only_a_window_reaches_dit_forward(tiny, rng):
    """WanT2V passes an fp-mode ctx on when it carries a window (it dropped
    such a ctx before): 2 UniPC steps equal JAX's with the same window from
    the same noise, and differ from the dense run."""
    cfg_j, pj, cfg_t, pt, _ = tiny
    context = rng.normal(size=(1, cfg_t.text_len, cfg_t.text_dim)).astype(np.float32)
    context_null = rng.normal(size=context.shape).astype(np.float32)
    kw = dict(size=(64, 64), frame_num=13, shift=5.0, sampling_steps=2, guide_scale=5.0)
    shape = compute_target_shape(cfg_t, (64, 64), 13)
    assert shape[1] == 4  # 4 latent frames: r = 1 is a real band
    noise = np.array(jax.random.normal(jax.random.PRNGKey(3), (1, *shape), jnp.float32))
    want = np.asarray(JaxWanT2V(cfg_j, pj, quant_ctx=JaxQuantCtx(mode="fp", attn_window=1))
                      .generate(jnp.asarray(context), jnp.asarray(context_null), seed=3, **kw))

    def port(ctx):
        return WanT2V(cfg_t, pt, quant_ctx=ctx, device="cpu").generate(
            torch.from_numpy(context), torch.from_numpy(context_null),
            noise=torch.from_numpy(noise), **kw).numpy()

    got = port(QuantCtx(mode="fp", attn_window=1))
    assert _rel(want, got) <= 1e-4
    assert _rel(port(None), got) > 1e-3


def test_quant_generate_attn_window_equals_a_direct_call(tmp_path):
    """quant_generate --hardware --attn_window 1 --device cpu on tiny equals
    WanT2V.generate called directly with the same quant state and window,
    and differs from the dense run; get_calib_data --attn_map_pool records
    the maps and the pool factor and ignores --attn_window."""
    from wanq_tpu_torch.cli import get_calib_data, quant_generate
    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.models.dit import linear_layer_names
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state

    common = ["--task", "tiny", "--size", "64*64", "--frame_num", "13", "--random_init",
              "--quant_config", SPEED, "--device", "cpu"]
    calib = get_calib_data.generate(get_calib_data.parse_args(
        common + ["--collect_minmax", "--sample_steps", "1", "--attn_map_pool", "8",
                  "--attn_map_reduce", "mean", "--attn_window", "1",
                  "--calib_save_path", str(tmp_path / "calib.npz")]))
    stats = dict(np.load(calib))
    assert int(stats["attn_map_pool"]) == 8
    assert stats["blocks.1.self_attn.attn_map"].shape == (1, 4, 8, 8)
    dense_calib = get_calib_data.generate(get_calib_data.parse_args(
        common + ["--collect_minmax", "--sample_steps", "1", "--attn_map_pool", "8",
                  "--attn_map_reduce", "mean", "--calib_save_path",
                  str(tmp_path / "calib_dense.npz")]))
    for key, val in np.load(dense_calib).items():
        np.testing.assert_array_equal(stats[key], val)

    def cli(window):
        out = quant_generate.generate(quant_generate.parse_args(
            common + ["--calib_data", calib, "--hardware", "--sample_steps", "2",
                      "--attn_window", window, "--save_file",
                      str(tmp_path / f"lat_{window}.npz")]))
        return np.load(out)["latents"]

    got = cli("1")
    args = quant_generate.parse_args(common + ["--calib_data", calib, "--hardware"])
    cfg = WAN_CONFIGS["tiny"]
    params = tcommon.load_params(args, cfg)
    pol, st, _ = prepare_quant_state(params, linear_layer_names(cfg),
                                     QuantConfig.from_yaml(SPEED), calib=stats, targets="int8")
    context, context_null = tcommon.load_contexts(args, cfg)
    direct = WanT2V(cfg, params, quant_ctx=QuantCtx(mode="int8", policies=pol, state=st,
                                                    attn_window=1), device="cpu").generate(
        torch.from_numpy(context), torch.from_numpy(context_null), size=(64, 64),
        frame_num=13, sampling_steps=2, seed=42).numpy()
    assert got.shape == (1, 16, 4, 8, 8) and np.isfinite(got).all()
    np.testing.assert_allclose(got, direct, rtol=1e-6, atol=1e-6)
    assert _rel(cli("-1"), got) > 1e-3
