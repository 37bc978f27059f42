"""Simulated quantization and the attention-quant slice of the port against
wanq_tpu on the CPU: the fake-quant foundation, PTQ with ``targets="sim"``,
``dit_forward`` in sim mode and with ``attn:`` / ``cross_attn:`` sections,
the pipeline and the CLI chain.

The small config has head_dim 128 (dim 256, 2 heads, 2 layers), bf16 params
and residual, 60 valid tokens padded to 64. Both packages start from the
same init_params seed and run the same quant state (JAX's PTQ through the
port's converter). Tolerances are stated at each test; a forward through
bf16 GEMMs agrees to ~1e-3 rel-L2 between the frameworks (the f32 sums run
in another order and flip bf16 roundings), never to 1e-6.
"""

import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml as pyyaml

from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.pipelines.text2video import WanT2V as JaxWanT2V
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu.quant import attn as jattn
from wanq_tpu.quant import quantizers as jq
from wanq_tpu.quant.ptq import prepare_quant_state as jax_prepare
from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models import params as tparams
from wanq_tpu_torch.pipelines.text2video import WanT2V, compute_target_shape
from wanq_tpu_torch.quant import QuantConfig
from wanq_tpu_torch.quant import attn as tattn
from wanq_tpu_torch.quant import quantizers as tq
from wanq_tpu_torch.quant.ptq import prepare_quant_state
from wanq_tpu_torch.quant.qlinear import QuantCtx, qlinear

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEED = os.path.join(ROOT, "quant_configs", "wan_w8a8_speed.yaml")
ATTN = os.path.join(ROOT, "quant_configs", "wan_w8a8_attn.yaml")
W4A8_MIXED = os.path.join(ROOT, "quant_configs", "wan_w4a8_mixed.yaml")
W4A4 = os.path.join(ROOT, "quant_configs", "wan_w4a4.yaml")
YAML_IDS = {SPEED: "w8a8", W4A8_MIXED: "w4a8_mixed", W4A4: "w4a4"}
SMALL = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
             freq_dim=64)
BF16 = dict(param_dtype="bfloat16", residual_dtype="bfloat16")
SECTION = {"qk": {"n_bits": 8, "sym": True}, "v": {"n_bits": 8, "sym": True},
           "attn_map": {"n_bits": 8, "sym": True, "group": "row"}}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def _models(seed, **kw):
    """The same weights in both packages (head.head redrawn: the reference
    zero-inits it, which would make every output zero)."""
    cfg_j, cfg_t = jax_tiny_config(**SMALL, **kw), tiny_config(**SMALL, **kw)
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(seed))
    pt = tdit.init_params(cfg_t, seed, device="cpu")
    hw = (np.random.default_rng(seed + 100).normal(size=(cfg_t.dim, 64)) * 0.02).astype(
        np.float32)
    pj["head"]["head"]["w"] = jnp.asarray(hw, dtype=cfg_j.dtype)
    pt["head"]["head"]["w"] = torch.from_numpy(hw).to(cfg_t.dtype)
    return cfg_j, pj, cfg_t, pt


def _inputs(rng):
    x = rng.normal(size=(2, 16, 3, 8, 10)).astype(np.float32)  # grid 3x4x5 = 60 tokens
    t = np.asarray([999.0, 500.0], np.float32)
    ctx = rng.normal(size=(2, 32, 64)).astype(np.float32)
    return x, t, ctx


def _calib(cfg_t, pt, x, t, ctx, seq=64):
    cc = QuantCtx(mode="calib", collect_minmax=True)
    tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(ctx), seq, ctx=cc)
    return {k: v.float().numpy()[None] for k, v in cc.collect.items()}


def _ctxs(cfg_j, pj, calib, yaml, mode, attn=None, cross_attn=None, perms=None):
    """JAX PTQ under ``yaml`` -> the converter: the state both packages run,
    with the same attention sections (a dict, parsed by each package)."""
    pol, st, rot = jax_prepare(pj, jdit.linear_layer_names(cfg_j),
                               JaxQuantConfig.from_yaml(yaml), calib=calib, targets=mode)
    jctx = JaxQuantCtx(mode=mode, policies=pol, state=st, rotations=rot,
                       attn=jattn.AttnQuantCfg.from_dict(attn),
                       cross_attn=jattn.AttnQuantCfg.from_dict(cross_attn),
                       attn_perms={k: jnp.asarray(v) for k, v in (perms or {}).items()})
    tctx = QuantCtx(mode=mode, policies=pol,
                    state=tparams.quant_state_from_numpy(jax.tree.map(np.asarray, st),
                                                         device="cpu"),
                    attn=tattn.AttnQuantCfg.from_dict(attn),
                    cross_attn=tattn.AttnQuantCfg.from_dict(cross_attn),
                    attn_perms=tparams.attn_perms_from_numpy(perms or {}, device="cpu"))
    return jctx, tctx


def _forwards(cfg_j, pj, jctx, cfg_t, pt, tctx, x, t, ctx, eager=False):
    def fwd(p, q, a, b, c):
        return jdit.dit_forward(p, cfg_j, a, b, c, 64, ctx=q)

    if eager:
        with jax.disable_jit():
            want = np.asarray(fwd(pj, jctx, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    else:
        want = np.asarray(jax.jit(fwd)(pj, jctx, x, t, ctx))
    got = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(ctx), 64, ctx=tctx).numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    return want, got


# ---------------------------------------------------------------------------
# the fake-quant foundation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "asym"])
def test_fake_quant_foundation_matches_jax(rng, bits, sym):
    """quantize / dequantize / fake_quant / dynamic_fake_quant: the codes
    equal, the dequantized values within rtol 1e-6."""
    x = (rng.normal(size=(37, 96)) * 3).astype(np.float32)
    x[4] = 0.0          # the eps clamp
    x[9, 3] = 50.0      # an outlier
    jc, tc = jq.QuantizerCfg(bits, sym), tq.QuantizerCfg(bits, sym)
    dj, zj = jq.compute_quant_params(jnp.asarray(x), bits, sym)
    dt, zt = tq.compute_quant_params(torch.from_numpy(x), bits, sym)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    qj = np.asarray(jq.quantize(jnp.asarray(x), dj, zj, bits, sym))
    qt = tq.quantize(torch.from_numpy(x), dt, zt, bits, sym)
    np.testing.assert_array_equal(qt.numpy(), qj)
    nl = tq.n_levels_for(bits, sym)
    assert qt.min() >= -nl - 1 and qt.max() <= nl
    np.testing.assert_allclose(tq.dequantize(qt, dt, zt).numpy(),
                               np.asarray(jq.dequantize(jnp.asarray(qj), dj, zj)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tq.fake_quant(torch.from_numpy(x), dt, zt, bits, sym).numpy(),
        np.asarray(jq.fake_quant(jnp.asarray(x), dj, zj, bits, sym)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tq.dynamic_fake_quant(torch.from_numpy(x), tc).numpy(),
        np.asarray(jq.dynamic_fake_quant(jnp.asarray(x), jc)), rtol=1e-6, atol=1e-7)


def test_dynamic_fake_quant_keeps_the_input_dtype(rng):
    x = rng.normal(size=(5, 64)).astype(np.float32)
    got = tq.dynamic_fake_quant(torch.from_numpy(x).bfloat16(), tq.QuantizerCfg(8, True))
    want = jq.dynamic_fake_quant(jnp.asarray(x).astype(jnp.bfloat16), jq.QuantizerCfg(8, True))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert torch.equal(tq.round_ste(torch.tensor([0.5, 1.5, -2.5])),
                       torch.tensor([0.0, 2.0, -2.0]))  # half to even, like jnp.round


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "asym"])
def test_weight_fake_quant_matches_jax(rng, bits, sym):
    w = (rng.normal(size=(128, 48)) * 0.05).astype(np.float32)  # [C_in, C_out]
    w[:, 3] = 0.0
    w[7, 5] = 1.0
    want = np.asarray(jq.weight_fake_quant(jnp.asarray(w), jq.QuantizerCfg(bits, sym)))
    got = tq.weight_fake_quant(torch.from_numpy(w), tq.QuantizerCfg(bits, sym))
    assert got.shape == (128, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-8)
    # at most 2**bits distinct values per output channel
    assert max(len(np.unique(got.numpy()[:, j])) for j in range(48)) <= 2 ** bits


# ---------------------------------------------------------------------------
# PTQ targets and the sim linear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("yaml", [SPEED, W4A8_MIXED, W4A4], ids=YAML_IDS.get)
def test_prepare_quant_state_sim_matches_jax(rng, yaml):
    """targets="sim": the same layers and keys as JAX, ``w_q`` [C_in, C_out]
    within rtol 1e-6, no int entries; "both" is the union."""
    cfg_j, pj, cfg_t, pt = _models(4, **BF16)
    names = jdit.linear_layer_names(cfg_j)
    calib = _calib(cfg_t, pt, *_inputs(rng))
    _, st_j, _ = jax_prepare(pj, names, JaxQuantConfig.from_yaml(yaml), calib=calib,
                             targets="sim")
    pol_t, st_t, rot = prepare_quant_state(pt, names, QuantConfig.from_yaml(yaml), calib=calib,
                                           targets="sim")
    assert rot == {} and sorted(st_t) == sorted(st_j) and st_t
    for name, st in st_t.items():
        assert sorted(st) == sorted(st_j[name]), name
        assert not {"w_int8", "w_int4", "w_int4g", "scale_wg"} & set(st)
        w = tparams_get(pt, name)
        assert st["w_q"].shape == w.shape
        for key, val in st.items():
            np.testing.assert_allclose(val.numpy(), np.asarray(st_j[name][key], np.float32),
                                       rtol=1e-6, atol=1e-9, err_msg=f"{name}.{key}")
    _, st_both, _ = prepare_quant_state(pt, names, QuantConfig.from_yaml(yaml), calib=calib)
    _, st_int, _ = prepare_quant_state(pt, names, QuantConfig.from_yaml(yaml), calib=calib,
                                       targets="int8")
    for name in st_t:
        assert set(st_both[name]) == set(st_t[name]) | set(st_int[name])
        assert "w_q" not in st_int[name]
    with pytest.raises(ValueError, match="targets"):
        prepare_quant_state(pt, names, QuantConfig.from_yaml(yaml), calib=calib, targets="fp")


def tparams_get(params, name):
    from wanq_tpu_torch.quant.ptq import params_get

    return params_get(params, name)["w"]


@pytest.mark.parametrize("kind", ["dynamic", "static", "w4a4", "no_act"])
def test_qlinear_sim_matches_jax(rng, kind):
    """One sim-mode linear on the same state: dynamic and static A8, the
    W4A4 group fake-quant, and a weight-only policy. f32 compute, so only
    the order of the GEMM's f32 sums differs: rel-L2 <= 1e-5."""
    from wanq_tpu.quant.qlinear import qlinear as jax_qlinear
    from wanq_tpu.quant.config import LayerPolicy as JaxPolicy
    from wanq_tpu_torch.quant.config import LayerPolicy

    x = rng.normal(size=(2, 9, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 64)) * 0.05).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    bits = 4 if kind == "w4a4" else 8
    act = None if kind == "no_act" else dict(n_bits=bits, sym=True, dynamic=kind != "static")
    pols = []
    for pkg_q, pol_cls in ((jq, JaxPolicy), (tq, LayerPolicy)):
        pols.append(pol_cls(method="base", weight=pkg_q.QuantizerCfg(bits, kind == "w4a4"),
                            act=None if act is None else pkg_q.QuantizerCfg(**act), group=128))
    st = {"w_q": w * 0.97}
    if kind == "static":
        st.update(delta_a=np.asarray([0.031], np.float32), zp_a=np.asarray([0.0], np.float32))
    jctx = JaxQuantCtx(mode="sim", policies={"l": pols[0]},
                       state={"l": {k: jnp.asarray(v) for k, v in st.items()}})
    tctx = QuantCtx(mode="sim", policies={"l": pols[1]},
                    state=tparams.quant_state_from_numpy({"l": st}, device="cpu"))
    want = np.asarray(jax_qlinear(jctx, "l", {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                  jnp.asarray(x), jnp.float32))
    got = qlinear(tctx, "l", {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                  torch.from_numpy(x), torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 9, 64)
    assert _rel(want, got.numpy()) <= 1e-5


def test_converter_keeps_w_q_layout_and_makes_int64_perms():
    st = tparams.quant_state_from_numpy(
        {"x": {"w_q": np.arange(6, dtype=np.float32).reshape(2, 3),
               "w_int8": np.arange(6, dtype=np.int8).reshape(2, 3)}}, device="cpu")["x"]
    assert st["w_q"].shape == (2, 3) and st["w_int8"].shape == (3, 2)
    perms = tparams.attn_perms_from_numpy({"blocks.0.self_attn": np.zeros((2, 8), np.int32)},
                                          device="cpu")
    assert perms["blocks.0.self_attn"].dtype == torch.int64


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("yaml", [SPEED, W4A8_MIXED, W4A4], ids=YAML_IDS.get)
def test_dit_forward_sim_matches_jax(rng, yaml):
    """Sim mode under each YAML, on the same ``w_q`` state: every linear is
    a fake-quant activation times the fake-quant weight through a bf16 GEMM.
    rel-L2 <= 5e-3 and cosine >= 0.9999 (observed ~1e-3: bf16 rounding flips
    between the frameworks' f32 sum orders). W4A4 is held to JAX eager, as
    the int path's test does: under jit XLA rewrites absmax / 7."""
    cfg_j, pj, cfg_t, pt = _models(3, **BF16)
    x, t, ctx = _inputs(rng)
    jctx, tctx = _ctxs(cfg_j, pj, _calib(cfg_t, pt, x, t, ctx), yaml, "sim")
    want, got = _forwards(cfg_j, pj, jctx, cfg_t, pt, tctx, x, t, ctx, eager=yaml == W4A4)
    assert _rel(want, got) <= 5e-3 and _cos(want, got) >= 0.9999


def test_dit_forward_int8_with_attn_section_matches_jax(rng):
    """int8 mode under wan_w8a8_attn.yaml: self-attention leaves the fused
    q/k path and runs the int8 flash attention. On the CPU JAX takes the
    global-max form (attention_int8_xla) and the port its blocked plain
    version of K10; at 64 tokens both see one 512-block, so they run the
    same arithmetic and differ like the other int8 forwards (bf16 GEMMs
    upstream): rel-L2 <= 2e-2, cosine >= 0.999, the W8A8 forward's limits."""
    cfg_j, pj, cfg_t, pt = _models(3, **BF16)
    x, t, ctx = _inputs(rng)
    calib = _calib(cfg_t, pt, x, t, ctx)
    section = pyyaml.safe_load(open(ATTN))["attn"]
    jctx, tctx = _ctxs(cfg_j, pj, calib, ATTN, "int8", attn=section)
    assert QuantConfig.from_yaml(ATTN).attn_cfg == tctx.attn
    want, got = _forwards(cfg_j, pj, jctx, cfg_t, pt, tctx, x, t, ctx)
    assert _rel(want, got) <= 2e-2 and _cos(want, got) >= 0.999
    # the section changes the forward: it is really taken
    _, plain = _ctxs(cfg_j, pj, calib, ATTN, "int8")
    base = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                            torch.from_numpy(ctx), 64, ctx=plain).numpy()
    assert 1e-4 < _rel(base, got) < 5e-2


def test_self_attention_int8_branch_skips_the_fused_qk_path(rng, monkeypatch):
    """Under an attn section self-attention skips the fused q/k path into K4:
    q's softmax scale is not folded into the rope tables, so K3 runs q and k
    with the same unscaled tables; attention_int8 gets [B, S, N, D] views of
    K3's heads-major outputs and the valid length, and its f32 output reaches
    the o-projection as a [B, S, N*D] view."""
    cfg_j, pj, cfg_t, pt = _models(3, **BF16)
    x, t, ctx = _inputs(rng)
    _, tctx = _ctxs(cfg_j, pj, _calib(cfg_t, pt, x, t, ctx), ATTN, "int8", attn=SECTION)
    calls, o_in, k3 = [], [], []
    real, qlin, real_k3 = tdit.attention_int8, tdit.qlinear, tdit.rms_rope_heads

    def rec(q, k, v, **kw):
        calls.append((q.shape, q.dtype, kw))
        calls.append(real(q, k, v, **kw))
        return calls[-1]

    def qlinear_rec(c, name, p, xx, *a, **k):
        if name.endswith("self_attn.o"):
            o_in.append(xx)
        return qlin(c, name, p, xx, *a, **k)

    def k3_rec(xx, w, ca, sb, **kw):
        k3.append((ca, sb, real_k3(xx, w, ca, sb, **kw)))
        return k3[-1][2]

    monkeypatch.setattr(tdit, "attention_int8", rec)
    monkeypatch.setattr(tdit, "qlinear", qlinear_rec)
    monkeypatch.setattr(tdit, "rms_rope_heads", k3_rec)
    tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(ctx), 64, ctx=tctx)
    assert len(calls) == 2 * cfg_t.num_layers and len(o_in) == cfg_t.num_layers
    assert calls[0] == ((2, 64, 2, 128), torch.bfloat16, {"k_valid_len": 60})
    assert calls[1].dtype == torch.float32 and o_in[0].shape == (2, 64, 256)
    assert o_in[0].untyped_storage().data_ptr() == calls[1].untyped_storage().data_ptr()
    assert len(k3) == 2 * cfg_t.num_layers
    for ca, sb, _ in k3:  # unscaled: cos and sin themselves, identity past 60
        assert ca is k3[0][0] and sb is k3[0][1]
        assert ca.abs().max().item() == 1.0 and torch.equal(ca[60:], torch.ones_like(ca[60:]))


@pytest.mark.parametrize("mode", ["int8", "sim"])
def test_dit_forward_cross_attn_section_matches_jax(rng, mode):
    """A cross_attn section runs the simulated quantizers on
    cross-attention in BOTH modes (the int8 kernel is for the long
    self-attention). rel-L2 <= 2e-2 (int8) / 5e-3 (sim), and the section
    moves the output."""
    cfg_j, pj, cfg_t, pt = _models(3, **BF16)
    x, t, ctx = _inputs(rng)
    calib = _calib(cfg_t, pt, x, t, ctx)
    jctx, tctx = _ctxs(cfg_j, pj, calib, SPEED, mode, cross_attn=SECTION)
    want, got = _forwards(cfg_j, pj, jctx, cfg_t, pt, tctx, x, t, ctx)
    assert _rel(want, got) <= (2e-2 if mode == "int8" else 5e-3)
    assert _cos(want, got) >= 0.999
    _, plain = _ctxs(cfg_j, pj, calib, SPEED, mode)
    base = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                            torch.from_numpy(ctx), 64, ctx=plain).numpy()
    assert 1e-5 < _rel(base, got) < 5e-2


@pytest.mark.parametrize("group", ["row", "block"])
def test_dit_forward_sim_attn_section_matches_jax(rng, group):
    """Sim mode with an attn section: quantized_attention on self-attention,
    group 'row', and group 'block' with int8-quantized deltas and per-layer
    reorder tables (QuantCtx.attn_perms). rel-L2 <= 5e-3, cosine >= 0.9999;
    the tables are really used (without them the output moves)."""
    cfg_j, pj, cfg_t, pt = _models(3, **BF16)
    x, t, ctx = _inputs(rng)
    calib = _calib(cfg_t, pt, x, t, ctx)
    section = dict(SECTION)
    perms = None
    if group == "block":
        section["attn_map"] = {"n_bits": 4, "sym": True, "group": "block", "block_size": 16,
                               "int8_scale": True}
        perms = {f"blocks.{i}.self_attn": np.stack([rng.permutation(64) for _ in range(2)])
                 .astype(np.int32) for i in range(cfg_t.num_layers)}
    jctx, tctx = _ctxs(cfg_j, pj, calib, SPEED, "sim", attn=section, perms=perms)
    want, got = _forwards(cfg_j, pj, jctx, cfg_t, pt, tctx, x, t, ctx)
    assert _rel(want, got) <= 5e-3 and _cos(want, got) >= 0.9999
    if perms:
        no_perm = dataclasses.replace(tctx, attn_perms={}, collect={})
        other = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                                 torch.from_numpy(ctx), 64, ctx=no_perm).numpy()
        assert _rel(got, other) > 1e-5


def test_attn_window_with_attention_quant_is_refused(rng):
    """A window with an attn: section is refused; without the section the
    same sim ctx runs the banded forward, as JAX's does (x has 3 latent
    frames of 20 tokens, so radius 1 is a real band)."""
    cfg_j, pj, cfg_t, pt = _models(3, **BF16)
    x, t, ctx = _inputs(rng)
    tctx = QuantCtx(mode="sim", attn=tattn.AttnQuantCfg.from_dict(SECTION), attn_window=1)
    with pytest.raises(NotImplementedError, match="does not compose"):
        tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                         torch.from_numpy(ctx), 64, ctx=tctx)
    tctx.attn = None
    want = np.asarray(jdit.dit_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(ctx), 64,
                                       ctx=JaxQuantCtx(mode="sim", attn_window=1)))
    got = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(ctx), 64, ctx=tctx).numpy()
    assert _rel(want, got) <= 5e-3 and _cos(want, got) >= 0.9999
    with pytest.raises(ValueError, match="unknown quant mode"):
        QuantCtx(mode="int4")


def test_generate_sim_three_steps_matches_jax(rng):
    """3 UniPC steps in sim mode from JAX's initial noise: latents rel-L2
    <= 2e-2, the limit of the int8 pipeline test."""
    cfg_j, pj, cfg_t, pt = _models(5, **BF16)
    x, t, ctx = _inputs(rng)
    jctx, tctx = _ctxs(cfg_j, pj, _calib(cfg_t, pt, x, t, ctx), SPEED, "sim")
    context = rng.normal(size=(1, 32, 64)).astype(np.float32)
    context_null = rng.normal(size=(1, 32, 64)).astype(np.float32)
    kw = dict(size=(64, 64), frame_num=9, shift=5.0, sampling_steps=3, guide_scale=5.0)
    want = np.asarray(JaxWanT2V(cfg_j, pj, quant_ctx=jctx).generate(
        jnp.asarray(context), jnp.asarray(context_null), seed=7, **kw))
    shape = compute_target_shape(cfg_t, (64, 64), 9)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(7), (1, *shape), jnp.float32))
    got = WanT2V(cfg_t, pt, quant_ctx=tctx, device="cpu").generate(
        torch.from_numpy(context), torch.from_numpy(context_null),
        noise=torch.from_numpy(noise), **kw)
    assert got.shape == want.shape == (1, *shape)
    assert _rel(want, got.numpy()) <= 2e-2
    # the quant ctx is really applied: the FP pipeline gives other latents
    fp = WanT2V(cfg_t, pt, device="cpu").generate(
        torch.from_numpy(context), torch.from_numpy(context_null),
        noise=torch.from_numpy(noise), **kw)
    assert _rel(fp.numpy(), got.numpy()) > 1e-4


@pytest.mark.parametrize("hardware", [False, True], ids=["sim", "hardware"])
def test_cli_chain_attn_yaml_tiny_on_cpu(tmp_path, hardware):
    """get_calib_data -> quant_generate on the tiny task under a copy of
    wan_w8a8_attn.yaml that also carries a cross_attn section: without
    --hardware the mode is sim (w_q state, simulated attention quantizers),
    with it int8 (the int8 attention's plain version on the CPU). The
    default save-file name carries the mode."""
    from wanq_tpu_torch.cli import get_calib_data, quant_generate

    raw = pyyaml.safe_load(open(ATTN))
    raw["cross_attn"] = dict(raw["attn"])
    path = str(tmp_path / "attn.yaml")
    with open(path, "w") as f:
        pyyaml.safe_dump(raw, f)
    common = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--random_init",
              "--quant_config", path, "--device", "cpu"]
    calib = get_calib_data.generate(get_calib_data.parse_args(
        common + ["--collect_minmax", "--sample_steps", "1",
                  "--calib_save_path", str(tmp_path / "calib.npz")]))
    seen = {}
    real = quant_generate.QuantCtx

    def ctx_rec(**kw):
        seen.update(kw)
        return real(**kw)

    quant_generate.QuantCtx = ctx_rec
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        out = quant_generate.generate(quant_generate.parse_args(
            common + ["--calib_data", calib, "--sample_steps", "2"]
            + (["--hardware"] if hardware else [])))
    finally:
        os.chdir(cwd)
        quant_generate.QuantCtx = real
    mode = "int8" if hardware else "sim"
    assert out == f"quant_{mode}_tiny_64x64_seed42.npz"
    lat = np.load(tmp_path / out)["latents"]
    assert lat.shape == (1, 16, 2, 8, 8) and np.isfinite(lat).all()
    assert seen["mode"] == mode and seen["attn"] is not None and seen["cross_attn"] is not None
    st = seen["state"]["blocks.0.ffn.0"]
    assert ("w_q" in st) == (not hardware) and ("w_int8" in st) == hardware


def test_entry_points_default_to_the_card():
    """WanT2V, init_params and the converters run on the card unless the
    caller asks for the CPU, as the CLIs' --device does."""
    from wanq_tpu_torch.cli.common import add_common_args
    import argparse

    fields = {f.name: f.default for f in dataclasses.fields(WanT2V)}
    assert fields["device"] == "cuda"
    assert inspect.signature(tdit.init_params).parameters["device"].default == "cuda"
    for fn in (tparams.params_from_numpy, tparams.quant_state_from_numpy,
               tparams.attn_perms_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    args = add_common_args(argparse.ArgumentParser()).parse_args([])
    assert args.device == "cuda"
