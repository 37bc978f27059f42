"""Parity of the port's 4-bit routes with wanq_tpu on the CPU: the int4
packing and its converter, the 4-bit quantizers, the plain versions of
kernels K7 (quant_sum), K8 (w4a8_linear) and K9 (w4a4_linear), and the PTQ
state under the two 4-bit YAMLs.

The same numpy inputs go through the JAX function -- its XLA form and its
Pallas kernel in interpret mode -- and through the port's wrapper, which on
CPU tensors runs the kernel's plain PyTorch version. Tolerances: int codes
and zero points exactly equal; scales rtol 1e-6; GEMM outputs rel-L2
<= 1e-6 (and bit-exact against an int64 product with the reference's
epilogue order); K7 codes exact without GELU (where the scales agree bit
for bit, which the XLA form always does) and equal except <= 0.1%
one-unit flips with it (torch's and XLA's tanh differ by ulps).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.ops import fused as jfused
from wanq_tpu.ops import qgemm as jqgemm
from wanq_tpu.quant import config as jconfig
from wanq_tpu.quant import ptq as jptq
from wanq_tpu.quant import quantizers as jq
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import quant_state_from_numpy
from wanq_tpu_torch.ops import fused as tfused
from wanq_tpu_torch.ops import qgemm as tqgemm
from wanq_tpu_torch.quant import config as tconfig
from wanq_tpu_torch.quant import ptq as tptq
from wanq_tpu_torch.quant import quantizers as tq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W4_YAMLS = [os.path.join(ROOT, "quant_configs", n)
            for n in ("wan_w4a8_mixed.yaml", "wan_w4a4.yaml")]
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(v):
    return None if v is None else torch.from_numpy(np.array(v, order="C"))


def _j(v):
    return None if v is None else jnp.asarray(v)


# ---------------------------------------------------------------------------
# int4 packing, converter, quantizers
# ---------------------------------------------------------------------------


def test_pack_int4_and_converter_match_jax(rng):
    """The port's K-major packed layout is the transpose of JAX's bytes:
    byte (n, j) holds k = 2j (low nibble) and k = 2j + 1 (high nibble)."""
    codes = rng.integers(-8, 8, size=(256, 96)).astype(np.int8)  # JAX [K, N]
    codes[:2, :2] = [[-8, 7], [7, -8]]
    packed_j = np.asarray(jq.pack_int4(jnp.asarray(codes)))
    packed_t = tq.pack_int4(_t(codes.T))
    assert packed_t.shape == (96, 128) and packed_t.dtype == torch.int8
    np.testing.assert_array_equal(packed_t.numpy(), packed_j.T)
    np.testing.assert_array_equal(tq.unpack_int4(packed_t).numpy(), codes.T)
    n, j = 5, 17
    byte = int(packed_t[n, j]) & 0xFF
    assert ((byte & 0xF) ^ 8) - 8 == codes[2 * j, n]
    assert ((byte >> 4) ^ 8) - 8 == codes[2 * j + 1, n]
    scale_g = rng.uniform(1e-3, 1e-1, size=(2, 96)).astype(np.float32)
    st = quant_state_from_numpy({"x": {"w_int4": packed_j, "w_int4g": packed_j,
                                       "scale_wg": scale_g}},
                                device="cpu")["x"]
    for key in ("w_int4", "w_int4g"):
        assert st[key].is_contiguous() and torch.equal(st[key], packed_t)
    np.testing.assert_array_equal(st["scale_wg"].numpy(), scale_g)


@pytest.mark.parametrize("kind", ["weight_int4_sym", "weight_int4_asym", "weight_group_int4",
                                  "act_group_int4"])
def test_4bit_quantizers_match_jax(rng, kind):
    w = (rng.normal(size=(256, 96)) * 0.05).astype(np.float32)  # [C_in, C_out]
    w[:, 3] = 0.0   # an all-zero channel / group exercises the eps clamp
    w[7, 5] = 1.0   # an outlier
    if kind.startswith("weight_int4"):
        sym = kind.endswith("_sym")
        q_j, s_j, z_j = jq.weight_int_quant(jnp.asarray(w), jq.QuantizerCfg(4, sym))
        q_t, s_t, z_t = tq.weight_int_quant(_t(w), tq.QuantizerCfg(4, sym))
        assert q_t.shape == (96, 256) and int(q_t.min()) >= -8 and int(q_t.max()) <= 7
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j).T)
        np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    elif kind == "weight_group_int4":
        q_j, s_j = jq.weight_group_int4_quant(jnp.asarray(w), 128)
        q_t, s_t = tq.weight_group_int4_quant(_t(w), 128)
        assert q_t.shape == (96, 256) and s_t.shape == (2, 96)
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j).T)
    else:
        x = (rng.normal(size=(77, 256)) * 3).astype(np.float32)
        x[0, :128] = 0.0
        q_j, s_j = jq.act_group_int4_quant(jnp.asarray(x), 128)
        q_t, s_t = tq.act_group_int4_quant(_t(x), 128)
        assert s_t.shape == (77, 2) and int(q_t.min()) >= -8 and int(q_t.max()) <= 7
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# K7: quant_sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channel_scale", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu", [False, True])
def test_k7_quant_sum_matches_jax(rng, gelu, dtype, channel_scale):
    m, c = 77, 384  # ragged M: not a multiple of the Pallas block
    x = (rng.normal(size=(m, c)) * 2.0 + 0.2).astype(np.float32)
    x[3] = 0.0      # an all-zero row takes the 1e-6 scale floor
    cs = rng.uniform(0.5, 2.0, size=(c,)).astype(np.float32) if channel_scale else None
    jx = jnp.asarray(x).astype(_JDT[dtype])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(_TDT[dtype])
    got = tfused.quant_sum(tx, gelu=gelu, channel_scale=_t(cs))
    ref = jfused.gelu_quant_sum_xla if gelu else jfused.quant_sum_xla
    wants = [ref(jx, channel_scale=_j(cs))]
    if cs is None:  # the Pallas kernel has no channel_scale
        wants.append(jfused.quant_sum_pallas(jx, gelu=gelu, block_m=32, interpret=True))
    assert got[0].shape == (m, c) and got[1].shape == got[2].shape == (m,)
    for want in wants:
        diff = np.abs(got[0].numpy().astype(np.int32) - np.asarray(want[0]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        if not gelu:
            # exact wherever the scales agree bit for bit: always against the
            # XLA form (what JAX's quant_sum runs); the interpreted Pallas
            # kernel's absmax / 127 can come out one ulp off on a row
            same_scale = got[1].numpy() == np.asarray(want[1])
            assert diff[same_scale].max() == 0
            if want is wants[0]:
                assert same_scale.all()
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=0)
        same = diff.max(axis=-1) == 0
        np.testing.assert_allclose(got[2].numpy()[same], np.asarray(want[2])[same],
                                   rtol=1e-6, atol=0)
    # the 3-D form the block paths pass keeps its leading dims
    got3 = tfused.quant_sum(tx.reshape(7, 11, c), gelu=gelu, channel_scale=_t(cs))
    assert got3[0].shape == (7, 11, c) and torch.equal(got3[0].reshape(m, c), got[0])


# ---------------------------------------------------------------------------
# K8: w4a8_linear
# ---------------------------------------------------------------------------


def _epilogue_ref(acc, s_a, s_w, sum_a, zp_w, bias):
    """The reference's epilogue order in numpy f32 on an exact int64 acc."""
    out = acc.astype(np.float32) * (s_a[:, None] * s_w)
    if zp_w is not None:
        out = out + sum_a[:, None] * (zp_w * s_w)
    if bias is not None:
        out = out + bias
    return out.astype(np.float32)


@pytest.mark.parametrize("m", [77, 256])
@pytest.mark.parametrize("asym,with_bias", [(True, True), (False, False), (True, False)])
def test_k8_w4a8_linear_matches_jax(rng, m, asym, with_bias):
    k, n = 512, 256
    a = rng.integers(-128, 128, size=(m, k), dtype=np.int8)
    w4 = rng.integers(-8, 8, size=(k, n)).astype(np.int8)  # JAX layout [K, N]
    packed_j = np.asarray(jq.pack_int4(jnp.asarray(w4)))
    s_a = rng.uniform(1e-3, 2e-2, size=(m,)).astype(np.float32)
    s_w = rng.uniform(1e-3, 2e-2, size=(n,)).astype(np.float32)
    sum_a = (s_a * a.astype(np.float32).sum(-1)).astype(np.float32) if asym else None
    zp_w = rng.integers(-8, 8, size=(n,)).astype(np.float32) if asym else None
    bias = rng.normal(size=(n,)).astype(np.float32) if with_bias else None

    got = tqgemm.w4a8_linear(_t(a), _t(packed_j.T), _t(s_a), _t(s_w), _t(sum_a), _t(zp_w),
                             _t(bias)).numpy()
    args = (_j(a), _j(packed_j), _j(s_a), _j(s_w), _j(sum_a), _j(zp_w), _j(bias))
    for want in (jqgemm.w4a8_linear_xla(*args),
                 jqgemm.w4a8_linear_pallas(*args, block_m=128, block_n=128, block_k=256,
                                           interpret=True)):
        assert _rel(got, want) <= 1e-6
    acc = a.astype(np.int64) @ w4.astype(np.int64)
    np.testing.assert_array_equal(got, _epilogue_ref(acc, s_a, s_w, sum_a, zp_w, bias))


# ---------------------------------------------------------------------------
# K9: w4a4_linear (Atom)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [77, 256])
@pytest.mark.parametrize("with_bias", [True, False])
def test_k9_w4a4_linear_matches_jax(rng, m, with_bias):
    k, n, group = 512, 256, 128
    x = (rng.normal(size=(m, k)) * 2).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    q_w, s_w = jq.weight_group_int4_quant(jnp.asarray(w), group)
    packed_j = np.asarray(jq.pack_int4(q_w))
    q_a, s_a = jq.act_group_int4_quant(jnp.asarray(x), group)
    q_a, s_a, s_w = np.asarray(q_a), np.asarray(s_a), np.asarray(s_w)

    got = tqgemm.w4a4_linear_plain(_t(q_a), _t(packed_j.T), _t(s_a), _t(s_w), _t(bias)).numpy()
    args = (_j(q_a), _j(packed_j), _j(s_a), _j(s_w), _j(bias))
    for want in (jqgemm.w4a4_linear_xla(*args),
                 jqgemm.w4a4_linear_pallas(*args, block_m=128, block_n=128, block_k=256,
                                           interpret=True)):
        assert _rel(got, want) <= 1e-6
    # bit-exact against the reference's loop on exact int64 partial sums
    acc = np.zeros((m, n), np.float32)
    for g in range(k // group):
        ks = slice(g * group, (g + 1) * group)
        p = q_a[:, ks].astype(np.int64) @ np.asarray(q_w)[ks].astype(np.int64)
        acc = acc + p.astype(np.float32) * (s_a[:, g, None] * s_w[g][None, :])
    if with_bias:
        acc = acc + bias
    np.testing.assert_array_equal(got, acc)
    # the full linear from the FP activation (group act quant first)
    full_t = tqgemm.w4a4_linear(_t(x), _t(packed_j.T), _t(s_w), _t(bias)).numpy()
    full_j = jqgemm.w4a4_linear(jnp.asarray(x), jnp.asarray(packed_j), jnp.asarray(s_w),
                                _j(bias))
    np.testing.assert_array_equal(full_t, got)
    assert _rel(full_t, full_j) <= 1e-6


# ---------------------------------------------------------------------------
# PTQ under the 4-bit YAMLs
# ---------------------------------------------------------------------------


def _calib_minmax(rng, names, cfg):
    calib = {}
    for name in names:
        c_in = cfg.ffn_dim if name.endswith("ffn.2") else (
            cfg.text_dim if name == "text_embedding.0" else
            cfg.freq_dim if name == "time_embedding.0" else cfg.dim)
        calib[name] = np.abs(rng.normal(size=(2, c_in))).astype(np.float32)
        calib[f"{name}.act_max"] = np.abs(rng.normal(size=(2, c_in))).astype(np.float32) * 4
        calib[f"{name}.act_min"] = -np.abs(rng.normal(size=(2, c_in))).astype(np.float32) * 3
    return calib


@pytest.mark.parametrize("path", W4_YAMLS, ids=os.path.basename)
def test_ptq_w4_state_matches_jax(rng, path):
    """A head-dim-128 config (dim 256, 2 heads) under each 4-bit YAML: the
    port's PTQ against JAX's prepare_quant_state(targets="int8") through
    the converter, codes and zero points exactly, scales rtol 1e-6."""
    small = dict(dim=256, num_heads=2, ffn_dim=512, text_dim=64, freq_dim=64)
    cfg_j, cfg_t = jax_tiny_config(**small), tiny_config(**small)
    names = jdit.linear_layer_names(cfg_j)
    params_j = jdit.init_params(cfg_j, jax.random.PRNGKey(4))
    params_t = tdit.init_params(cfg_t, 4, device="cpu")
    calib = _calib_minmax(rng, names, cfg_t)
    _, st_j, _ = jptq.prepare_quant_state(params_j, names, jconfig.QuantConfig.from_yaml(path),
                                          calib=calib, targets="int8")
    pol_t, st_t, _ = tptq.prepare_quant_state(params_t, names,
                                              tconfig.QuantConfig.from_yaml(path), calib=calib,
                                              targets="int8")
    assert sorted(st_t) == sorted(st_j)
    keys = {k for st in st_t.values() for k in st}
    if "w4a4" in path:
        assert keys == {"w_int4g", "scale_wg"} and len(st_t) == 2 * 8
        assert st_t["blocks.0.ffn.2"]["w_int4g"].shape == (256, 256)
        assert st_t["blocks.0.ffn.2"]["scale_wg"].shape == (4, 256)
    else:
        assert "w_int4" in st_t["blocks.0.ffn.0"] and "w_int8" in st_t["blocks.1.self_attn.o"]
        assert "blocks.0.cross_attn.q" not in st_t
    conv = quant_state_from_numpy(jax.tree.map(np.asarray, st_j), device="cpu")
    for name, st in st_t.items():
        assert sorted(st) == sorted(conv[name]), name
        for key, val in st.items():
            want = conv[name][key]
            if key in ("w_int8", "w_int4", "w_int4g", "zp_w_int", "zp_w"):
                assert torch.equal(val, want), (name, key)
            else:
                np.testing.assert_allclose(val.numpy(), want.numpy(), rtol=1e-6, atol=0,
                                           err_msg=f"{name}.{key}")


def test_ptq_w4a4_refusals_match_jax():
    """The W4A4 branch's two ValueErrors (GPTQ, static A4) and an odd C_in
    keeping 4-bit codes unpacked in w_int8, as in the JAX package."""
    from wanq_tpu_torch.quant.config import LayerPolicy
    from wanq_tpu_torch.quant.quantizers import QuantizerCfg

    w = torch.from_numpy(np.random.default_rng(0).normal(size=(128, 128)).astype(np.float32))
    w4 = QuantizerCfg(4, True)
    with pytest.raises(ValueError, match="GPTQ"):
        tptq.prepare_layer_state(LayerPolicy("base", w4, QuantizerCfg(4, True), gptq=True), w)
    with pytest.raises(ValueError, match="static A4"):
        tptq.prepare_layer_state(
            LayerPolicy("base", w4, QuantizerCfg(4, True, dynamic=False)), w)
    st = tptq.prepare_layer_state(LayerPolicy("base", QuantizerCfg(4, False),
                                              QuantizerCfg(8, True)), w[:127])
    assert "w_int4" not in st and st["w_int8"].shape == (128, 127)
    assert int(st["w_int8"].min()) >= -8 and int(st["w_int8"].max()) <= 7
