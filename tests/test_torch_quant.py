"""Parity of the port's quantization modules (wanq_tpu_torch.quant, rope,
converters) with wanq_tpu on the CPU, on the same numpy inputs."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.models import rope as jrope
from wanq_tpu.quant import config as jconfig
from wanq_tpu.quant import ptq as jptq
from wanq_tpu.quant import quantizers as jq
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models import rope as trope
from wanq_tpu_torch.models.params import params_from_numpy, quant_state_from_numpy
from wanq_tpu_torch.quant import config as tconfig
from wanq_tpu_torch.quant import ptq as tptq
from wanq_tpu_torch.quant import quantizers as tq
from wanq_tpu_torch.quant.qlinear import QuantCtx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "quant_configs", "*.yaml")))
SPEED = os.path.join(ROOT, "quant_configs", "wan_w8a8_speed.yaml")


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_quant_config_fields_match_jax(path):
    jc = jconfig.QuantConfig.from_yaml(path)
    tc = tconfig.QuantConfig.from_yaml(path)
    assert tc.raw == jc.raw
    for field in ("remain_fp_regex", "calib_save_path", "weight_gptq", "weight_gptq_act_order",
                  "weight_lowrank", "act_static_regex", "act_group", "methods",
                  "mixed_precision"):
        assert getattr(tc, field) == getattr(jc, field), field
    for qa, qb in ((jc.weight_cfg, tc.weight_cfg), (jc.act_cfg, tc.act_cfg)):
        assert (qa is None) == (qb is None)
        if qa is not None:
            assert (qa.n_bits, qa.sym, qa.dynamic) == (qb.n_bits, qb.sym, qb.dynamic)
    # the attention sections, field by field
    for aa, ab in ((jc.attn_cfg, tc.attn_cfg), (jc.cross_attn_cfg, tc.cross_attn_cfg)):
        assert (aa is None) == (ab is None)
        if aa is None:
            continue
        for field in ("attn_map_group", "n_text_tokens", "block_size", "int8_scale"):
            assert getattr(aa, field) == getattr(ab, field), field
        for qa, qb in ((aa.qk, ab.qk), (aa.v, ab.v), (aa.attn_map, ab.attn_map)):
            assert (qa is None) == (qb is None)
            if qa is not None:
                assert (qa.n_bits, qa.sym, qa.dynamic, qa.active_bits) == (
                    qb.n_bits, qb.sym, qb.dynamic, qb.active_bits)


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_policy_resolution_matches_jax(path):
    names = jdit.linear_layer_names(jax_tiny_config(num_layers=2))
    jc = jconfig.QuantConfig.from_yaml(path)
    tc = tconfig.QuantConfig.from_yaml(path)
    for name in names:
        a, b = jc.resolve(name), tc.resolve(name)
        for field in ("method", "alpha", "quant_mode", "gptq", "gptq_act_order",
                      "group", "lowrank", "is_quantized", "is_w4a4"):
            assert getattr(a, field) == getattr(b, field), (name, field)
        for qa, qb in ((a.weight, b.weight), (a.act, b.act)):
            assert (qa is None) == (qb is None)
            if qa is not None:
                assert (qa.active_bits, qa.sym, qa.dynamic) == (qb.active_bits, qb.sym,
                                                                 qb.dynamic)


@pytest.mark.parametrize("sym", [True, False])
def test_quantizers_match_jax(rng, sym):
    w = (rng.normal(size=(96, 64)) * 0.05).astype(np.float32)  # [C_in, C_out]
    w[:, 3] = 0.0  # an all-zero channel exercises the eps clamp
    cfg_j, cfg_t = jq.QuantizerCfg(8, sym), tq.QuantizerCfg(8, sym)
    d_j, z_j = jq.compute_quant_params(jnp.asarray(w), 8, sym)
    d_t, z_t = tq.compute_quant_params(torch.from_numpy(w), 8, sym)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    q_j, s_j, zp_j = jq.weight_int_quant(jnp.asarray(w), cfg_j)
    q_t, s_t, zp_t = tq.weight_int_quant(torch.from_numpy(w), cfg_t)
    assert q_t.shape == (64, 96)  # K-major [C_out, C_in]
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j).T)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(zp_t.numpy(), np.asarray(zp_j))
    mx, mn = np.asarray([3.5], np.float32), np.asarray([-1.25], np.float32)
    for a, b in zip(tq.params_from_minmax(torch.from_numpy(mx), torch.from_numpy(mn), cfg_t),
                    jq.params_from_minmax(jnp.asarray(mx), jnp.asarray(mn), cfg_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fp_linear_keeps_f32_output_like_jax(rng, dtype, with_bias):
    """Operands rounded to the compute dtype, f32 sums and f32 output: a
    bf16-rounded output would be ~1e-3 off, the limit is 1e-6."""
    from wanq_tpu.quant.qlinear import fp_linear as jax_fp_linear
    from wanq_tpu_torch.quant.qlinear import fp_linear

    x = rng.normal(size=(2, 33, 96)).astype(np.float32)
    p = {"w": (rng.normal(size=(96, 80)) * 0.1).astype(np.float32),
         "b": rng.normal(size=(80,)).astype(np.float32) if with_bias else None}
    got = fp_linear({k: None if v is None else torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), getattr(torch, dtype))
    want = np.asarray(jax_fp_linear({k: None if v is None else jnp.asarray(v)
                                     for k, v in p.items()},
                                    jnp.asarray(x), getattr(jnp, dtype)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-6, rel


def test_act_dynamic_int_quant_matches_jax(rng):
    """The port's dynamic per-token int8 quant is ops.fused.quant_sum
    (kernel K7 on the card), which qlinear calls."""
    from wanq_tpu_torch.ops.fused import quant_sum

    x = (rng.normal(size=(2, 17, 64)) * 3).astype(np.float32)
    x[0, 0] = 0.0
    got = quant_sum(torch.from_numpy(x))
    want = jq.act_dynamic_int_quant(jnp.asarray(x))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tq.n_levels_for(8, True) == jq.n_levels_for(8, True) == 127


def test_rope_tables_and_apply_match_jax(rng):
    grid, d = (3, 4, 5), 24
    for a, b in zip(trope.rope_tables_interleaved(grid, d),
                    jrope.rope_tables_interleaved(grid, d)):
        np.testing.assert_array_equal(a, b)
    ca, sb = jrope.rope_tables_interleaved(grid, d)
    x = rng.normal(size=(2, 64, 2, d)).astype(np.float32)
    got = trope.rope_apply_interleaved(torch.from_numpy(x), torch.from_numpy(ca.copy()),
                                       torch.from_numpy(sb.copy()), 60, scale=0.3)
    want = jrope.rope_apply_interleaved(jnp.asarray(x), jnp.asarray(ca), jnp.asarray(sb),
                                        60, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _calib_minmax(rng, names, cfg):
    """Synthetic calibration stacks [T, C] for every linear of ``cfg``."""
    calib = {}
    for name in names:
        c_in = cfg.ffn_dim if name.endswith("ffn.2") else (
            cfg.text_dim if name == "text_embedding.0" else
            cfg.freq_dim if name == "time_embedding.0" else cfg.dim)
        calib[name] = np.abs(rng.normal(size=(2, c_in))).astype(np.float32)
        calib[f"{name}.act_max"] = np.abs(rng.normal(size=(2, c_in))).astype(np.float32) * 4
        calib[f"{name}.act_min"] = -np.abs(rng.normal(size=(2, c_in))).astype(np.float32) * 3
    return calib


def test_ptq_prepare_quant_state_matches_jax(rng):
    """W8A8 speed config on the same weights and calibration min/max: int
    codes and zero points exactly equal, scales within rtol 1e-6."""
    import jax

    cfg_j = jax_tiny_config(dim=128, num_heads=2, ffn_dim=256)
    cfg_t = tiny_config(dim=128, num_heads=2, ffn_dim=256)
    names = jdit.linear_layer_names(cfg_j)
    assert names == tdit.linear_layer_names(cfg_t)
    params_j = jdit.init_params(cfg_j, jax.random.PRNGKey(4))
    params_t = tdit.init_params(cfg_t, 4, device="cpu")
    calib = _calib_minmax(rng, names, cfg_t)
    pol_j, st_j, _ = jptq.prepare_quant_state(
        params_j, names, jconfig.QuantConfig.from_yaml(SPEED), calib=calib, targets="int8")
    pol_t, st_t, rot = tptq.prepare_quant_state(
        params_t, names, tconfig.QuantConfig.from_yaml(SPEED), calib=calib, targets="int8")
    assert rot == {} and sorted(st_t) == sorted(st_j)
    assert "delta_a" in st_t["blocks.0.ffn.2"] and "delta_a" not in st_t["blocks.0.ffn.0"]
    conv = quant_state_from_numpy(jax.tree.map(np.asarray, st_j), device="cpu")
    for name, st in st_t.items():
        assert sorted(st) == sorted(conv[name])
        for key, val in st.items():
            want = conv[name][key]
            if key in ("w_int8", "zp_w_int", "zp_w", "zp_a"):
                assert torch.equal(val, want), (name, key)
            else:
                np.testing.assert_allclose(val.numpy(), want.numpy(), rtol=1e-6, atol=0,
                                           err_msg=f"{name}.{key}")
    red_t, red_j = tptq.reduce_calib(calib), jptq.reduce_calib(calib)
    for key in red_j:
        np.testing.assert_array_equal(red_t[key], red_j[key])


def test_converters_keep_params_and_transpose_int8(rng):
    import jax

    cfg_j = jax_tiny_config(param_dtype="bfloat16")
    params_j = jdit.init_params(cfg_j, jax.random.PRNGKey(1))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    own = tdit.init_params(tiny_config(param_dtype="bfloat16"), 1, device="cpu")
    w_conv = params_t["blocks"][1]["ffn"]["0"]["w"]
    assert w_conv.dtype == torch.bfloat16 and w_conv.shape == (96, 192)
    assert torch.equal(w_conv, own["blocks"][1]["ffn"]["0"]["w"])
    assert params_t["blocks"][0]["norm3"]["w"].dtype == torch.float32
    st = quant_state_from_numpy({"x": {"w_int8": np.arange(6, dtype=np.int8).reshape(2, 3)}},
                                device="cpu")
    assert st["x"]["w_int8"].shape == (3, 2) and st["x"]["w_int8"].is_contiguous()


def test_unported_quant_branches_raise():
    # the window is ported: the ctx keeps it for dit_forward to resolve
    assert QuantCtx(mode="int8", attn_window=1).attn_window == 1
    # map capture from a deployed model is not (item 6)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6"):
        QuantCtx(mode="int8", attn_map_pool=8)
    # GPTQ and SVDQuant low-rank are ported: with an empty calibration their
    # YAMLs stop at its checks, not at a refusal
    params = tdit.init_params(tiny_config(), 0, device="cpu")
    names = tdit.linear_layer_names(tiny_config())
    for yaml in ("wan_w4a8_gptq.yaml", "wan_svdquant.yaml"):
        with pytest.raises(ValueError, match="calibration"):
            tptq.prepare_quant_state(params, names, tconfig.QuantConfig.from_yaml(
                os.path.join(ROOT, "quant_configs", yaml)), calib={})
