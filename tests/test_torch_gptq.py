"""GPTQ in the port (wanq_tpu_torch.quant.gptq, the Hessian calibration, the
GPTQ branch of PTQ and wan_w4a8_gptq.yaml through the CLIs) against
wanq_tpu on the CPU, on the same numpy inputs.

Tolerances, stated per test:
- an identity Hessian: RTN's codes bit for bit (every propagation term is
  an exact zero);
- transform_hessian: rel <= 1e-5 (the port transforms in f64, wanq_tpu in f32);
- gptq_quantize: delta and zp rel <= 1e-6 (the same grid code); codes equal
  at >= 99% of entries and never more than one apart (the inverse Hessian is
  cho_solve in f32 in JAX, cholesky_inverse in f64 here: rounding-level
  differences that move a few .5 ties); the objective tr(dW^T H dW) within
  1% of JAX's;
- calibration Hessians: rel <= 1e-5 (the port sums in f64, wanq_tpu in f32);
- forwards from one artifact: the 4-bit tolerances of tests/test_torch_slice.py,
  rel-L2 <= 2e-3 and cosine >= 0.9999.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.pipelines.text2video import WanT2V as JaxWanT2V
from wanq_tpu.quant import config as jconfig
from wanq_tpu.quant import gptq as jgptq
from wanq_tpu.quant import ptq as jptq
from wanq_tpu.quant import quantizers as jquant
from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.pipelines.text2video import WanT2V, compute_target_shape
from wanq_tpu_torch.quant import config as tconfig
from wanq_tpu_torch.quant import gptq as tgptq
from wanq_tpu_torch.quant import ptq as tptq
from wanq_tpu_torch.quant import quantizers as tquant
from wanq_tpu_torch.quant.config import LayerPolicy
from wanq_tpu_torch.quant.qlinear import QuantCtx
from wanq_tpu_torch.quant.quantizers import QuantizerCfg, unpack_int4

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPTQ_YAML = os.path.join(ROOT, "quant_configs", "wan_w4a8_gptq.yaml")
HESS_REGEX = r"self_attn|cross_attn\.(q|o)|ffn\.0"  # the YAML's calibration recipe


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def _correlated_batch(rng, m, k, scale=1.0):
    x = rng.normal(size=(m, k)).astype(np.float32)
    mix = rng.normal(size=(k, k)).astype(np.float32) * 0.3 + np.eye(k, dtype=np.float32)
    return (x @ mix) * scale


def _objective(w, wq, h) -> float:
    """GPTQ's objective tr(dW^T H dW), dW = W - W_q, in f64."""
    d = np.asarray(w, np.float64) - np.asarray(wq, np.float64)
    return float(np.sum((np.asarray(h, np.float64) @ d) * d))


@pytest.mark.parametrize("sym", [False, True])
def test_identity_hessian_gives_rtn_codes(sym):
    """H = I: every propagation term is an exact zero, so GPTQ is RTN bit for
    bit, against the port's weight_int_quant and wanq_tpu's codes."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(64, 48)) * 0.05).astype(np.float32)
    cfg = QuantizerCfg(n_bits=4, sym=sym)
    wq, codes, delta, zp = tgptq.gptq_quantize(torch.from_numpy(w), torch.eye(64), cfg,
                                               block=32)
    ref_codes, ref_d, ref_z = tquant.weight_int_quant(torch.from_numpy(w), cfg)
    assert torch.equal(codes.t(), ref_codes)
    assert torch.equal(delta, ref_d) and torch.equal(zp, ref_z)
    assert torch.equal(wq, tquant.weight_fake_quant(torch.from_numpy(w), cfg))
    j_codes, _, _ = jquant.weight_int_quant(jnp.asarray(w), jquant.QuantizerCfg(4, sym))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))


def test_transform_hessian_matches_jax():
    rng = np.random.default_rng(2)
    k = 32
    x = rng.normal(size=(512, k)).astype(np.float32)
    h = x.T @ x
    mask = (0.5 + rng.random(k)).astype(np.float32)
    q_mat = np.linalg.qr(rng.normal(size=(k, k)))[0].astype(np.float32)
    for m, q in ((mask, None), (None, q_mat), (mask, q_mat)):
        want = np.asarray(jgptq.transform_hessian(
            jnp.asarray(h), None if m is None else jnp.asarray(m),
            None if q is None else jnp.asarray(q)))
        got = tgptq.transform_hessian(torch.from_numpy(h),
                                      None if m is None else torch.from_numpy(m),
                                      None if q is None else torch.from_numpy(q)).numpy()
        assert _rel(want, got) <= 1e-5


@pytest.mark.parametrize("act_order", [False, True], ids=["rows", "act_order"])
@pytest.mark.parametrize("k", [256, 200], ids=["k256", "ragged_k200"])
def test_gptq_quantize_matches_jax(k, act_order):
    """Correlated inputs with one dead channel (H_ii = 0), K = 256 (two
    blocks) and K = 200 (the identity padding to 256), 4-bit asymmetric."""
    rng = np.random.default_rng(k + act_order)
    x = _correlated_batch(rng, 2048, k)
    x[:, 17] = 0.0
    h = x.T @ x
    w = (rng.normal(size=(k, 64)) * 0.05).astype(np.float32)
    cfg = QuantizerCfg(n_bits=4, sym=False)
    wq_j, codes_j, d_j, z_j = jgptq.gptq_quantize(
        jnp.asarray(w), jnp.asarray(h), jquant.QuantizerCfg(4, False), act_order=act_order)
    wq, codes, d, z = tgptq.gptq_quantize(torch.from_numpy(w), torch.from_numpy(h), cfg,
                                          act_order=act_order)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-6, atol=0)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=1e-6, atol=0)
    diff = np.abs(codes.numpy().astype(np.int32) - np.asarray(codes_j, np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    obj, obj_j = _objective(w, wq.numpy(), h), _objective(w, np.asarray(wq_j), h)
    assert abs(obj - obj_j) <= 0.01 * obj_j
    # the codes dequantize to w_q exactly: the state is a drop-in
    recon = (codes.float() + z[None, :]) * d[None, :]
    assert torch.equal(recon, wq)


def test_gptq_reduces_output_error():
    """Mirrors tests/test_gptq.py::test_gptq_reduces_output_error: on
    correlated inputs GPTQ cuts ||X W - X W_q||^2 below 0.8x RTN's at 4 bits
    (ragged K 96 against block 64: the identity padding)."""
    rng = np.random.default_rng(1)
    k, n, m = 96, 48, 4096
    x = _correlated_batch(rng, m, k)
    w = torch.from_numpy((rng.normal(size=(k, n)) * 0.05).astype(np.float32))
    cfg = QuantizerCfg(n_bits=4, sym=False)
    wq, codes, delta, zp = tgptq.gptq_quantize(w, torch.from_numpy(x.T @ x), cfg, block=64)

    def mse(wq_):
        return float(((x @ (w.numpy() - wq_.numpy())) ** 2).mean())

    assert mse(wq) < 0.8 * mse(tquant.weight_fake_quant(w, cfg))
    assert codes.dtype == torch.int8 and int(codes.min()) >= -8 and int(codes.max()) <= 7


def test_act_order_unpermutes_and_improves():
    """Mirrors tests/test_gptq.py::test_act_order_unpermutes_and_improves:
    with H = I act_order is still RTN in the original row order, and on
    outlier-channel inputs it beats plain GPTQ on held-out error."""
    rng = np.random.default_rng(9)
    k, n, m = 96, 48, 4096
    scales = np.ones(k, np.float32)
    scales[rng.choice(k, 8, replace=False)] = 10.0
    mix = rng.normal(size=(k, k)).astype(np.float32) * 0.3 + np.eye(k, dtype=np.float32)

    def draw(mm):
        return (rng.normal(size=(mm, k)).astype(np.float32) * scales) @ mix

    xc, xt = draw(m), draw(m)
    w = torch.from_numpy((rng.normal(size=(k, n)) * 0.05).astype(np.float32))
    cfg = QuantizerCfg(n_bits=3, sym=False)
    wq_i, *_ = tgptq.gptq_quantize(w, torch.eye(k), cfg, block=32, act_order=True)
    assert torch.equal(wq_i, tquant.weight_fake_quant(w, cfg))
    err = {}
    for ao in (False, True):
        wq, *_ = tgptq.gptq_quantize(w, torch.from_numpy(xc.T @ xc), cfg, block=32,
                                     act_order=ao)
        err[ao] = float(((xt @ (w.numpy() - wq.numpy())) ** 2).mean())
    assert err[True] < err[False], err


def test_cholesky_failure_raises():
    """A Hessian that damping cannot make positive definite raises; nothing
    falls back to RTN."""
    h = torch.ones(8, 8)
    h[0, 1] = h[1, 0] = -50.0
    with pytest.raises(torch.linalg.LinAlgError):
        tgptq.gptq_quantize(torch.ones(8, 4), h, QuantizerCfg(4, False))


def test_gptq_site_without_a_hessian_is_rtn():
    """A gptq policy with no Hessian (ffn.2 under the YAML's regex) gives the
    RTN state, key for key and bit for bit, as in the JAX package."""
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(96, 64)).astype(np.float32))
    wcfg = QuantizerCfg(4, False)
    rtn = tptq.prepare_layer_state(LayerPolicy("base", wcfg, QuantizerCfg(8, True)), w)
    gq = tptq.prepare_layer_state(LayerPolicy("base", wcfg, QuantizerCfg(8, True), gptq=True,
                                              gptq_act_order=True), w)
    assert sorted(rtn) == sorted(gq)
    for key in rtn:
        assert torch.equal(rtn[key], gq[key]), key


def test_prepare_layer_state_gptq_matches_jax():
    """The GPTQ branch of PTQ (a SmoothQuant mask transforms the Hessian)
    against wanq_tpu's: the same keys, the grid within rel 1e-6, packed
    codes >= 99% equal and never more than one apart, w_q the codes'
    dequantization."""
    rng = np.random.default_rng(4)
    k, n = 64, 32
    x = _correlated_batch(rng, 2048, k)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    absmax = np.abs(x).max(axis=0)
    wcfg = dict(n_bits=4, sym=False)
    st_j = jptq.prepare_layer_state(
        jconfig.LayerPolicy("smooth_quant", jquant.QuantizerCfg(**wcfg), alpha=0.5, gptq=True),
        jnp.asarray(w), absmax, None, hessian=jnp.asarray(x.T @ x))
    st = tptq.prepare_layer_state(
        LayerPolicy("smooth_quant", QuantizerCfg(**wcfg), alpha=0.5, gptq=True),
        torch.from_numpy(w), absmax, hessian=x.T @ x)
    assert sorted(st) == sorted(st_j)
    for key in ("delta_w", "zp_w", "scale_w", "zp_w_int", "channel_mask"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(st_j[key]), rtol=1e-6, atol=0)
    codes = unpack_int4(st["w_int4"]).t().numpy().astype(np.int32)
    codes_j = np.asarray(jquant.unpack_int4(st_j["w_int4"]), np.int32)
    diff = np.abs(codes - codes_j)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    recon = (codes + st["zp_w_int"].numpy()[None, :]) * st["scale_w"].numpy()[None, :]
    np.testing.assert_allclose(recon, st["w_q"].numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# calibration Hessians and the CLI chain
# ---------------------------------------------------------------------------


def _tiny_models(seed):
    cfg_j, cfg_t = jax_tiny_config(), tiny_config()
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(seed))
    pt = tdit.init_params(cfg_t, seed, device="cpu")
    hw = (np.random.default_rng(seed + 100).normal(size=(cfg_t.dim, 64)) * 0.02).astype(
        np.float32)
    pj["head"]["head"]["w"] = jnp.asarray(hw, dtype=cfg_j.dtype)
    pt["head"]["head"]["w"] = torch.from_numpy(hw).to(cfg_t.dtype)
    return cfg_j, pj, cfg_t, pt


KW = dict(size=(64, 64), frame_num=5, shift=5.0, sampling_steps=2, guide_scale=5.0)


def test_calibration_hessians_match_jax_over_rounds_and_steps(tmp_path):
    """2 rounds x 2 steps on the tiny model: the Hessians JAX's pipeline sums
    (seeds 7 and 8) against the port's from the same noise, rel <= 1e-5; the
    regex decides which sites; the port's get_calib_data --calib_rounds 2
    writes the sum of its own two sweeps bit for bit and concatenates the
    absmax stacks."""
    cfg_j, pj, cfg_t, pt = _tiny_models(0)
    rng = np.random.default_rng(5)
    context = rng.normal(size=(1, cfg_t.text_len, cfg_t.text_dim)).astype(np.float32)
    context_null = rng.normal(size=(1, cfg_t.text_len, cfg_t.text_dim)).astype(np.float32)
    jpipe = JaxWanT2V(cfg_j, pj, quant_ctx=JaxQuantCtx(mode="calib", hessian_regex=HESS_REGEX))
    tpipe = WanT2V(cfg_t, pt, quant_ctx=QuantCtx(mode="calib", hessian_regex=HESS_REGEX),
                   device="cpu")
    shape = compute_target_shape(cfg_t, KW["size"], KW["frame_num"])
    want, got = {}, {}
    for seed in (7, 8):
        sj = jpipe.collect_calibration(jnp.asarray(context), jnp.asarray(context_null),
                                       seed=seed, **KW)
        noise = np.array(jax.random.normal(jax.random.PRNGKey(seed), (1, *shape), jnp.float32))
        st = tpipe.collect_calibration(torch.from_numpy(context),
                                       torch.from_numpy(context_null),
                                       noise=torch.from_numpy(noise), **KW)
        for k in sj:
            if k.endswith(".hess"):
                want[k] = want.get(k, 0) + np.asarray(sj[k], np.float64)
                got[k] = got.get(k, 0) + st[k].double().numpy()
    names = tdit.linear_layer_names(cfg_t)
    assert sorted(got) == sorted(want) == sorted(
        f"{n}.hess" for n in names if n.startswith("blocks.") and (
            ".self_attn." in n or n.endswith(("cross_attn.q", "cross_attn.o", "ffn.0"))))
    for k in want:
        assert got[k].shape == (cfg_t.dim, cfg_t.dim) and _rel(want[k], got[k]) <= 1e-5, k

    from wanq_tpu_torch.cli import get_calib_data

    common = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--random_init",
              "--device", "cpu", "--sample_steps", "2", "--base_seed", "11"]
    path = get_calib_data.generate(get_calib_data.parse_args(common + [
        "--collect_hessian", HESS_REGEX, "--calib_rounds", "2",
        "--calib_save_path", str(tmp_path / "calib.npz")]))
    saved = np.load(path)
    from wanq_tpu_torch.cli.common import load_contexts, load_params

    args = get_calib_data.parse_args(common)
    pipe = WanT2V(cfg_t, load_params(args, cfg_t),
                  quant_ctx=QuantCtx(mode="calib", hessian_regex=HESS_REGEX), device="cpu")
    c, cn = (torch.from_numpy(a) for a in load_contexts(args, cfg_t))
    runs = [pipe.collect_calibration(c, cn, seed=11 + r, **dict(KW, size=(64, 64)))
            for r in range(2)]
    h = "blocks.1.ffn.0.hess"
    assert saved[h].dtype == np.float32
    assert runs[0][h].dtype == torch.float64  # summed in f64, saved as f32
    np.testing.assert_array_equal(saved[h], (runs[0][h] + runs[1][h]).float().numpy())
    np.testing.assert_array_equal(saved["blocks.1.ffn.0"], np.concatenate(
        [runs[0]["blocks.1.ffn.0"], runs[1]["blocks.1.ffn.0"]]))
    assert saved["blocks.1.ffn.0"].shape == (4, cfg_t.dim)


def test_jax_calibration_npz_through_the_port_ptq_deploys_in_both(tmp_path):
    """A calibration npz with Hessians written by wanq_tpu's pipeline feeds the
    port's cli.ptq under wan_w4a8_gptq.yaml; the artifact loads in both
    packages and their int8 forwards agree at the 4-bit tolerances; it holds
    GPTQ codes where a Hessian was collected and RTN's at ffn.2."""
    from wanq_tpu_torch.cli import ptq

    seed = 3
    cfg_j, pj, cfg_t, pt = _tiny_models(seed)
    rng = np.random.default_rng(6)
    context = rng.normal(size=(1, cfg_t.text_len, cfg_t.text_dim)).astype(np.float32)
    stats = JaxWanT2V(cfg_j, pj, quant_ctx=JaxQuantCtx(
        mode="calib", collect_minmax=True, hessian_regex=HESS_REGEX)).collect_calibration(
        jnp.asarray(context), jnp.asarray(context[:, ::-1]), seed=9, **KW)
    calib = str(tmp_path / "calib_jax.npz")
    np.savez(calib, **stats)
    art = ptq.generate(ptq.parse_args([
        "--task", "tiny", "--random_init", "--base_seed", str(seed), "--device", "cpu",
        "--quant_config", GPTQ_YAML, "--calib_data", calib,
        "--save_path", str(tmp_path / "qp.npz")]))
    st_t, _ = tptq.load_quant_state(art, device="cpu", targets="int8")
    st_j, _ = jptq.load_quant_state(art)
    names = tdit.linear_layer_names(cfg_t)
    qcfg_j = jconfig.QuantConfig.from_yaml(GPTQ_YAML)
    pol_j = qcfg_j.resolve_all(names)
    pol_t = tconfig.QuantConfig.from_yaml(GPTQ_YAML).resolve_all(names)
    # GPTQ where a Hessian came: not RTN's codes; RTN's at ffn.2
    wcfg = pol_t["blocks.0.ffn.0"].weight
    for name, gptq in (("blocks.0.ffn.0", True), ("blocks.0.ffn.2", False)):
        rtn, _, _ = tquant.weight_int_quant(pt["blocks"][0]["ffn"][name[-1]]["w"].float(), wcfg)
        assert torch.equal(unpack_int4(st_t[name]["w_int4"]), rtn) != gptq, name
    x = rng.normal(size=(2, 16, 2, 8, 8)).astype(np.float32)
    t = np.asarray([999.0, 500.0], np.float32)
    c = rng.normal(size=(2, cfg_t.text_len, cfg_t.text_dim)).astype(np.float32)
    want = np.asarray(jdit.dit_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(c), 32, ctx=JaxQuantCtx(
                                           mode="int8", policies=pol_j, state=st_j)))
    got = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(c), 32,
                           ctx=QuantCtx(mode="int8", policies=pol_t, state=st_t)).numpy()
    assert np.isfinite(got).all()
    assert _rel(want, got) <= 2e-3 and _cos(want, got) >= 0.9999


def test_resolve_all_matches_jax():
    names = tdit.linear_layer_names(tiny_config())
    got = tconfig.QuantConfig.from_yaml(GPTQ_YAML).resolve_all(names)
    want = jconfig.QuantConfig.from_yaml(GPTQ_YAML).resolve_all(names)
    assert list(got) == list(want) == names
    for n in names:
        a, b = got[n], want[n]
        assert (a.method, a.quant_mode, a.gptq, a.gptq_act_order, a.lowrank, a.is_quantized) == (
            b.method, b.quant_mode, b.gptq, b.gptq_act_order, b.lowrank, b.is_quantized), n
        for q, r in ((a.weight, b.weight), (a.act, b.act)):
            assert (q is None) == (r is None)
            if q is not None:
                assert (q.active_bits, q.sym, q.dynamic) == (r.active_bits, r.sym, r.dynamic), n


@pytest.mark.parametrize("hardware", [True, False], ids=["int8", "sim"])
def test_cli_chain_w4a8_gptq_tiny_on_cpu(tmp_path, hardware):
    """get_calib_data --collect_minmax --collect_hessian (the YAML's regex)
    --calib_rounds 2 -> cli.ptq -> quant_generate --quant_params [--hardware]
    --strip_fp and generate from the same artifact, on the CPU; quant_generate
    from the artifact equals quant_generate quantizing on the fly."""
    from wanq_tpu_torch.cli import generate, get_calib_data, ptq, quant_generate

    common = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--random_init",
              "--device", "cpu", "--quant_config", GPTQ_YAML]
    calib = get_calib_data.generate(get_calib_data.parse_args(common + [
        "--collect_minmax", "--collect_hessian", HESS_REGEX, "--calib_rounds", "2",
        "--sample_steps", "1", "--calib_save_path", str(tmp_path / "calib.npz")]))
    assert np.load(calib)["blocks.0.self_attn.q.hess"].shape == (96, 96)
    art = ptq.generate(ptq.parse_args(common + ["--calib_data", calib,
                                                "--save_path", str(tmp_path / "qp.npz")]))
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
