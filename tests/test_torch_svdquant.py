"""SVDQuant low-rank branch in the port (wanq_tpu_torch.quant.svd, the
low-rank step of PTQ, qlinear's branch and wan_svdquant.yaml through the
CLIs) against wanq_tpu on the CPU, on the same numpy inputs.

The port draws its Gaussian sketch with a torch.Generator and wanq_tpu with
jax.random, and on Gaussian weights the top-32 subspace is poorly separated,
so two sketches give different factors. Where a test holds the port against
wanq_tpu's factors it hands in jax.random's draw (monkeypatching
``svd.gaussian_sketch``), and it compares products, never factors (the signs
of SVD columns are arbitrary). Tolerances, stated per test:
- L1 @ L2 from the same sketch: rel <= 1e-4 (QR and SVD in another library),
  1e-3 once the factors are rounded to bf16 (one-ulp flips);
- the split identity L1 @ L2 + R = W: rel <= 1e-6 (f32 round-off);
- the randomized split on a low-rank-plus-noise matrix: within 1% of the
  exact truncation error (Eckart-Young);
- residual codes of a SmoothQuant + low-rank W4A4 site: >= 99.9% equal;
- one quantized site from one state: rel-L2 <= 1e-6 against wanq_tpu's
  eager qlinear (the same rounding; the f32 sums in another order);
- the whole small model from one state: the W4A4 tolerance of
  tests/test_torch_slice.py against wanq_tpu's jitted forward, rel-L2 <= 2e-2
  and cosine >= 0.9999. Its eager 2e-3 is not held here: the port's sites
  agree to 1e-7, but the .5 ties that bf16 inputs hit at 15 levels flip
  with f32 sum order and two blocks amplify them (plain W4A4 on these draws
  reads 3.7e-3 to 4e-3 from the eager forward, the SVDQuant YAML 5e-3 to
  7e-3);
- SQNR on the synthetic outlier layer: W4 +3 dB and W4A4 +2 dB over the
  plain quantization, the gates of tests/test_svdquant.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml as pyyaml

from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.quant import config as jconfig
from wanq_tpu.quant import ptq as jptq
from wanq_tpu.quant import quantizers as jquant
from wanq_tpu.quant import svd as jsvd
from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
from wanq_tpu.quant.qlinear import qlinear as jax_qlinear
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import quant_state_from_numpy
from wanq_tpu_torch.quant import config as tconfig
from wanq_tpu_torch.quant import ptq as tptq
from wanq_tpu_torch.quant import quantizers as tquant
from wanq_tpu_torch.quant import svd as tsvd
from wanq_tpu_torch.quant.config import LayerPolicy
from wanq_tpu_torch.quant.qlinear import QuantCtx, int8_fusable, int8_static_fusable, qlinear
from wanq_tpu_torch.quant.quantizers import QuantizerCfg, unpack_int4
from wanq_tpu_torch.quant.synthetic import (
    correlated_outlier_acts,
    outlier_channel_scales,
    sqnr_db,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SVD_YAML = os.path.join(ROOT, "quant_configs", "wan_svdquant.yaml")
SMALL = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
             freq_dim=64, param_dtype="bfloat16", residual_dtype="bfloat16")
C, O, M = 256, 256, 1024
W4 = {"weight": {"n_bits": 4, "sym": False}, "act": {"n_bits": 8, "sym": True}}
W4A4 = {"weight": {"n_bits": 4, "sym": True}, "act": {"n_bits": 4, "sym": True, "group": 32}}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def lr(d, rank):
    return {**d, "weight": dict(d["weight"], lowrank_rank=rank)}


@pytest.fixture
def jax_sketch(monkeypatch):
    """The port's sketch replaced by jax.random's draw for the same seed."""
    def draw(n, r, seed, device):
        g = jax.random.normal(jax.random.PRNGKey(seed), (n, r), jnp.float32)
        return torch.from_numpy(np.array(g)).to(device)

    monkeypatch.setattr(tsvd, "gaussian_sketch", draw)


def _outlier_weight(seed=0, k=C, n=O):
    rng = np.random.default_rng(seed)
    scale = outlier_channel_scales(k, n_hot=4, spread_sigma=1.0, seed=5)
    return (rng.normal(size=(k, n)).astype(np.float32) * scale[:, None])


@pytest.mark.parametrize("shape,rank", [((256, 256), 32), ((128, 96), 8)])
def test_svd_lowrank_product_matches_jax_from_its_sketch(jax_sketch, shape, rank):
    w = _outlier_weight(1, *shape)
    l1j, l2j = jsvd.svd_lowrank(jnp.asarray(w), rank, seed=0)
    l1, l2 = tsvd.svd_lowrank(torch.from_numpy(w), rank, seed=0)
    assert l1.shape == (shape[0], rank) and l2.shape == (rank, shape[1])
    assert _rel(np.asarray(l1j @ l2j), (l1 @ l2).numpy()) <= 1e-4


def test_lowrank_split_identity():
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 80)).astype(np.float32))
    l1, l2, resid = tsvd.lowrank_split(w, 4)
    assert _rel(w.numpy(), (l1 @ l2 + resid).numpy()) <= 1e-6


def test_randomized_split_near_the_exact_truncation():
    """Low rank plus noise (the port's own sketch): the residual's norm is
    within 1% of the Eckart-Young optimum."""
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(192, 16)) @ rng.normal(size=(16, 160))
         + 0.05 * rng.normal(size=(192, 160))).astype(np.float32)
    _, _, resid = tsvd.lowrank_split(torch.from_numpy(w), 16, seed=4)
    s = np.linalg.svd(w.astype(np.float64), compute_uv=False)
    assert np.linalg.norm(resid.numpy()) <= 1.01 * np.linalg.norm(s[16:])


def _w4a4_lowrank_policy(config, quantizers):
    return config.LayerPolicy("smooth_quant", quantizers.QuantizerCfg(4, True),
                              quantizers.QuantizerCfg(4, True), alpha=0.5665, group=32,
                              lowrank=32)


def test_smooth_lowrank_w4a4_site_matches_jax(jax_sketch):
    """PTQ of one SmoothQuant + low-rank W4A4 site from jax.random's sketch:
    the mask within rel 1e-6, the group scales within rel 1e-4 (the
    residual's group absmax moves with the products' ~1e-5 differences:
    observed 7.5e-6), the product of the bf16
    factors within rel 1e-3 (the f32 factors agree at 1e-4, above; their
    bf16 rounding flips a few elements by one ulp, 2^-8 relative), the
    residual's int4 codes equal at >= 99.9%."""
    w = _outlier_weight(2)
    absmax = np.abs(correlated_outlier_acts(M, C, n_hot=4, seed=0, draw_seed=1)).max(0)
    st_j = jptq.prepare_layer_state(_w4a4_lowrank_policy(jconfig, jquant), jnp.asarray(w),
                                    absmax, None)
    st = tptq.prepare_layer_state(_w4a4_lowrank_policy(tconfig, tquant), torch.from_numpy(w),
                                  absmax)
    assert sorted(st) == sorted(st_j) == ["channel_mask", "lowrank_a", "lowrank_b", "scale_wg",
                                          "w_int4g", "w_q"]
    assert st["lowrank_a"].dtype == st["lowrank_b"].dtype == torch.bfloat16
    np.testing.assert_allclose(st["channel_mask"].numpy(), np.asarray(st_j["channel_mask"]),
                               rtol=1e-6, atol=0)
    prod_j = np.asarray(st_j["lowrank_a"], np.float32) @ np.asarray(st_j["lowrank_b"],
                                                                    np.float32)
    assert _rel(prod_j, (st["lowrank_a"].float() @ st["lowrank_b"].float()).numpy()) <= 1e-3
    codes = unpack_int4(st["w_int4g"]).t().numpy()
    codes_j = np.asarray(jquant.unpack_int4(st_j["w_int4g"]))
    assert (codes == codes_j).mean() >= 0.999
    np.testing.assert_allclose(st["scale_wg"].numpy(), np.asarray(st_j["scale_wg"]), rtol=1e-4,
                               atol=0)


def test_gptq_composes_with_lowrank(jax_sketch):
    """W4A8 with GPTQ on the low-rank residual (the Hessian taken through the
    mask): the state against wanq_tpu's from the same sketch (codes >= 99%
    equal, never more than one apart), and GPTQ's residual error below
    RTN's on the calibration Hessian."""
    x = correlated_outlier_acts(M, C, n_hot=4, seed=0, draw_seed=3)
    w = _outlier_weight(3)
    h = (x.T @ x).astype(np.float32)
    absmax = np.abs(x).max(0)
    kw = dict(alpha=0.5, lowrank=16)
    st_j = jptq.prepare_layer_state(
        jconfig.LayerPolicy("smooth_quant", jquant.QuantizerCfg(4, False), gptq=True, **kw),
        jnp.asarray(w), absmax, None, hessian=jnp.asarray(h))
    sts = {g: tptq.prepare_layer_state(
        LayerPolicy("smooth_quant", QuantizerCfg(4, False), gptq=g, **kw), torch.from_numpy(w),
        absmax, hessian=h) for g in (True, False)}
    st = sts[True]
    assert sorted(st) == sorted(st_j)
    codes = unpack_int4(st["w_int4"]).t().numpy().astype(np.int32)
    diff = np.abs(codes - np.asarray(jquant.unpack_int4(st_j["w_int4"]), np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    m = st["channel_mask"].double().numpy()
    hm = h.astype(np.float64) * m[:, None] * m[None, :]
    resid = w / m[:, None] - (st["lowrank_a"].double() @ st["lowrank_b"].double()).numpy()
    obj = {g: float(np.sum((hm @ (resid - s["w_q"].double().numpy())) * (
        resid - s["w_q"].double().numpy()))) for g, s in sts.items()}
    assert obj[True] < obj[False], obj


@pytest.fixture(scope="module")
def layer_setup():
    """tests/test_svdquant.py's outlier-heavy layer: lognormal per-input-
    channel weight spread and hot activation channels."""
    rng = np.random.default_rng(0)
    x_cal = correlated_outlier_acts(M, C, n_hot=4, seed=0, draw_seed=1)
    x_test = correlated_outlier_acts(M, C, n_hot=4, seed=0, draw_seed=2)
    scale = outlier_channel_scales(C, n_hot=4, spread_sigma=1.0, seed=5)
    w = rng.normal(size=(C, O)).astype(np.float32) * scale[:, None]
    params = {"lin": {"w": torch.from_numpy(w)}}
    calib = {"lin": np.abs(x_cal).max(0)[None, :]}
    y_fp = x_test.astype(np.float64) @ w.astype(np.float64)
    return params, calib, torch.from_numpy(x_test[None]), y_fp[None]


def _run(layer_setup, qdict, mode="sim"):
    params, calib, x_test, _ = layer_setup
    pol, st, rot = tptq.prepare_quant_state(params, ["lin"], tconfig.QuantConfig.from_dict(qdict),
                                            calib=calib, targets=mode)
    ctx = QuantCtx(mode=mode, policies=pol, state=st, rotations=rot)
    return qlinear(ctx, "lin", params["lin"], x_test, compute_dtype=torch.float32), st


@pytest.mark.parametrize("mode", ["sim", "int8"])
@pytest.mark.parametrize("base,gain", [(W4, 3.0), (W4A4, 2.0)], ids=["w4", "w4a4"])
def test_lowrank_sqnr_gain_on_outlier_weights(layer_setup, base, gain, mode):
    """The port reproduces tests/test_svdquant.py's gates, in both modes:
    the rank-32 branch buys W4 +3 dB and W4A4 +2 dB over the plain route."""
    y_fp = layer_setup[3]
    plain, _ = _run(layer_setup, base, mode)
    boosted, st = _run(layer_setup, lr(base, 32), mode)
    assert st["lin"]["lowrank_a"].dtype == torch.bfloat16
    assert sqnr_db(boosted, y_fp) > sqnr_db(plain, y_fp) + gain


def test_fused_paths_refuse_lowrank_sites(layer_setup):
    params, calib, _, _ = layer_setup
    w8 = {"weight": {"n_bits": 8, "sym": False}, "act": {"n_bits": 8, "sym": True}}
    for qd, fusable in ((lr(w8, 16), False), (w8, True)):
        pol, st, rot = tptq.prepare_quant_state(params, ["lin"], tconfig.QuantConfig.from_dict(qd),
                                                calib=calib, targets="int8")
        ctx = QuantCtx(mode="int8", policies=pol, state=st, rotations=rot)
        assert int8_fusable(ctx, ["lin"]) is fusable
    static = dict(w8, act={"n_bits": 8, "sym": True, "static_regex": "lin"})
    calib_mm = {**calib, "lin.act_max": calib["lin"], "lin.act_min": -calib["lin"]}
    for qd, fusable in ((lr(static, 16), False), (static, True)):
        pol, st, rot = tptq.prepare_quant_state(params, ["lin"], tconfig.QuantConfig.from_dict(qd),
                                                calib=calib_mm, targets="int8")
        ctx = QuantCtx(mode="int8", policies=pol, state=st, rotations=rot)
        assert int8_static_fusable(ctx, "lin") is fusable


@pytest.mark.parametrize("targets", ["sim", "int8"])
def test_bf16_factors_round_trip_through_the_npz(layer_setup, tmp_path, targets):
    """The port's npz (the |bf16 tag) and wanq_tpu's give the factors back
    bit for bit under load_quant_state(targets=...), which keeps them in
    both modes; the loaded state's forward equals the fresh one's."""
    params, calib, x_test, _ = layer_setup
    qd = lr({**W4A4, "smooth_quant": {"alpha": 0.5665, "layer_name_regex": ""}}, 16)
    pol, st, rot = tptq.prepare_quant_state(params, ["lin"], tconfig.QuantConfig.from_dict(qd),
                                            calib=calib)
    path = str(tmp_path / "port.npz")
    tptq.save_quant_state(path, st, seed=3)
    assert "lin|lowrank_a|bf16" in np.load(path).files
    _, st_j, _ = jptq.prepare_quant_state({"lin": {"w": jnp.asarray(params["lin"]["w"].numpy())}},
                                          ["lin"], jconfig.QuantConfig.from_dict(qd), calib=calib)
    jpath = str(tmp_path / "jax.npz")
    jptq.save_quant_state(jpath, st_j, seed=3)
    for p, want in ((path, st["lin"]), (jpath, quant_state_from_numpy(
            jax.tree.map(np.asarray, st_j), "cpu")["lin"])):
        back, seed = tptq.load_quant_state(p, device="cpu", targets=targets)
        assert seed == 3
        for key in ("lowrank_a", "lowrank_b"):
            assert back["lin"][key].dtype == torch.bfloat16
            assert torch.equal(back["lin"][key], want[key]), key
        assert ("w_q" in back["lin"]) == (targets == "sim")
    back, _ = tptq.load_quant_state(path, device="cpu", targets=targets)
    outs = [qlinear(QuantCtx(mode=targets, policies=pol, state=s), "lin", params["lin"], x_test)
            for s in ({"lin": st["lin"]}, back)]
    assert torch.equal(outs[0], outs[1])


def _small_models(seed):
    cfg_j, cfg_t = jax_tiny_config(**SMALL), tiny_config(**SMALL)
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(seed))
    pt = tdit.init_params(cfg_t, seed, device="cpu")
    hw = (np.random.default_rng(seed + 100).normal(size=(cfg_t.dim, 64)) * 0.02).astype(
        np.float32)
    pj["head"]["head"]["w"] = jnp.asarray(hw, dtype=cfg_j.dtype)
    pt["head"]["head"]["w"] = torch.from_numpy(hw).to(cfg_t.dtype)
    return cfg_j, pj, cfg_t, pt


@pytest.mark.parametrize("mode", ["sim", "int8"])
def test_jax_svdquant_state_deploys_in_the_port(rng, mode):
    """wanq_tpu's PTQ under wan_svdquant.yaml (masks, rank-32 branches, W4A4
    residuals at group 128) through the converter, in sim and int8 mode
    (K9's plain version and the branch): one site's qlinear against
    wanq_tpu's eager one on the same bf16 input at rel-L2 1e-6, and the
    port's dit_forward against wanq_tpu's jitted one at the W4A4 model
    tolerance."""
    cfg_j, pj, cfg_t, pt = _small_models(3)
    x = rng.normal(size=(2, 16, 3, 8, 10)).astype(np.float32)
    t = np.asarray([999.0, 500.0], np.float32)
    ctx = rng.normal(size=(2, 32, 64)).astype(np.float32)
    cc = QuantCtx(mode="calib")
    tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(ctx), 64, ctx=cc)
    calib = {k: v.float().numpy()[None] for k, v in cc.collect.items()}
    pol_j, st_j, rot_j = jptq.prepare_quant_state(
        pj, jdit.linear_layer_names(cfg_j), jconfig.QuantConfig.from_yaml(SVD_YAML),
        calib=calib, targets=mode)
    assert "lowrank_a" in st_j["blocks.1.ffn.2"] and "channel_mask" in st_j["blocks.1.ffn.2"]
    jctx = JaxQuantCtx(mode=mode, policies=pol_j, state=st_j)
    tctx = QuantCtx(mode=mode, policies=pol_j,
                    state=quant_state_from_numpy(jax.tree.map(np.asarray, st_j), "cpu"))
    xs = np.asarray(torch.from_numpy(rng.normal(size=(2, 64, 512)).astype(np.float32))
                    .bfloat16().float())
    site = "blocks.1.ffn.2"
    with jax.disable_jit():
        want = np.asarray(jax_qlinear(jctx, site, pj["blocks"][1]["ffn"]["2"],
                                      jnp.asarray(xs, jnp.bfloat16)))
    got = qlinear(tctx, site, pt["blocks"][1]["ffn"]["2"], torch.from_numpy(xs).bfloat16())
    assert _rel(want, got.numpy()) <= 1e-6
    want = np.asarray(jax.jit(lambda p, q, a, b, c: jdit.dit_forward(p, cfg_j, a, b, c, 64,
                                                                     ctx=q))(pj, jctx, x, t, ctx))
    got = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(ctx), 64, ctx=tctx).numpy()
    assert np.isfinite(got).all()
    assert _rel(want, got) <= 2e-2 and _cos(want, got) >= 0.9999


@pytest.mark.parametrize("hardware", [True, False], ids=["int8", "sim"])
def test_cli_chain_svdquant_tiny_on_cpu(tmp_path, hardware):
    """get_calib_data -> cli.ptq -> quant_generate --quant_params
    [--hardware] --strip_fp and generate from the same artifact under
    wan_svdquant.yaml on the CPU. The tiny task's widths (96, 192) are not
    multiples of the YAML's group 128, so a copy with group 32 runs the
    route. The artifact holds the masks and the bf16 factors; the latents
    equal an on-the-fly quantization's."""
    from wanq_tpu_torch.cli import generate, get_calib_data, ptq, quant_generate

    raw = pyyaml.safe_load(open(SVD_YAML))
    raw["act"]["group"] = 32
    yaml = str(tmp_path / "svdquant_group32.yaml")
    with open(yaml, "w") as f:
        pyyaml.safe_dump(raw, f)
    common = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--random_init",
              "--device", "cpu", "--quant_config", yaml]
    calib = get_calib_data.generate(get_calib_data.parse_args(common + [
        "--sample_steps", "1", "--calib_save_path", str(tmp_path / "calib.npz")]))
    art = ptq.generate(ptq.parse_args(common + ["--calib_data", calib,
                                                "--save_path", str(tmp_path / "qp.npz")]))
    keys = np.load(art).files
    assert "blocks.0.ffn.0|lowrank_b|bf16" in keys and "blocks.0.ffn.0|channel_mask" in keys
    hw = ["--hardware"] if hardware else []
    lat = {}
    for tag, extra in (("art", ["--quant_params", art, "--strip_fp"]),
                       ("fly", ["--calib_data", calib])):
        out = quant_generate.generate(quant_generate.parse_args(common + extra + hw + [
            "--sample_steps", "2", "--save_file", str(tmp_path / f"lat_{tag}.npz")]))
        lat[tag] = np.load(out)["latents"]
    assert lat["art"].shape == (1, 16, 2, 8, 8) and np.isfinite(lat["art"]).all()
    np.testing.assert_array_equal(lat["art"], lat["fly"])
    out = generate.generate(generate.parse_args(common + hw + [
        "--quant_params", art, "--sample_steps", "2",
        "--save_file", str(tmp_path / "gen.npz")]))
    np.testing.assert_array_equal(np.load(out)["latents"], lat["art"])
