"""K2's GELU + static-quant mode and the arithmetic identities of the wgmma
int GEMMs, on the CPU.

``w8a8_linear_gelu_quant`` (the ffn.0 GEMM whose epilogue goes on through
tanh-GELU to the int8 codes of a static-scale ffn.2) runs its plain version
here. It is held bit for bit against the elementwise chain that the block
ran before the mode existed, against the same lines of ``wanq_tpu``
(``models/dit.py``: bf16 GEMM output, ``gelu_tanh`` in f32, ``round(g /
scale2)``, ``sum(codes, dtype=f32)``) on the same numpy inputs, and through
one block under ``wan_w8a8_speed.yaml`` with a static ffn.2 scale.

Tolerances: against the former chain everything is equal. Against JAX the
GEMM's bf16 output is equal (exact int32 sum, the same f32 epilogue), and the
two tanh implementations may differ in the last bit, which can move a value
across a rounding tie: codes may differ by one unit on at most 1e-4 of the
elements, and the scaled row sums by those flips (atol of 4 code units times
the scale, rtol 1e-6). The block matches at ``tests/test_torch_slice.py``'s
int8 tolerance (rel-L2 <= 2e-2, cosine >= 0.999).

K9 writes its unpacked weight codes times 16 and folds 1/16 into the
activation scale; both are exact in f32, which the last tests hold.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.models.rope import rope_tables_interleaved
from wanq_tpu.ops import qgemm as jqgemm
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu.quant.ptq import prepare_quant_state as jax_prepare
from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import quant_state_from_numpy
from wanq_tpu_torch.ops import _lib
from wanq_tpu_torch.ops import qgemm as tqgemm
from wanq_tpu_torch.quant import qlinear as tqlinear
from wanq_tpu_torch.quant.qlinear import QuantCtx
from wanq_tpu_torch.quant.quantizers import unpack_int4

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEED = os.path.join(ROOT, "quant_configs", "wan_w8a8_speed.yaml")
# ragged M; (K, N) are the three shapes of the path (1536 -> 1536, 1536 -> 8960,
# 8960 -> 1536) at an eighth of their widths
SHAPES = [(37, 192, 192), (130, 192, 1120), (77, 1120, 192)]


def _operands(rng, m, k, n, asym):
    a = rng.integers(-128, 128, size=(m, k), dtype=np.int8)
    w_kn = rng.integers(-128, 128, size=(k, n), dtype=np.int8)  # JAX layout
    s_a = rng.uniform(1e-3, 2e-2, size=(m,)).astype(np.float32)
    s_w = (rng.uniform(1e-3, 2e-2, size=(n,)) / np.sqrt(k)).astype(np.float32)
    sum_a = (s_a * a.astype(np.float32).sum(-1)).astype(np.float32) if asym else None
    zp_w = rng.integers(-20, 20, size=(n,)).astype(np.float32) if asym else None
    bias = rng.normal(size=(n,)).astype(np.float32)
    return a, w_kn, s_a, s_w, sum_a, zp_w, bias


def _t(v):
    return None if v is None else torch.from_numpy(np.ascontiguousarray(v))


def _j(v):
    return None if v is None else jnp.asarray(v)


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gelu_quant_plain_equals_the_elementwise_chain(rng, m, k, n, asym):
    """The plain version of the mode is the chain the block ran between
    ffn.0 and a static ffn.2, operation for operation: equal bit for bit."""
    a, w_kn, s_a, s_w, sum_a, zp_w, bias = _operands(rng, m, k, n, asym)
    w = _t(w_kn.T)
    scale2 = torch.tensor(0.0173)
    got = tqgemm.w8a8_linear_gelu_quant(_t(a), w, _t(s_a), _t(s_w), scale2, _t(sum_a),
                                        _t(zp_w), _t(bias))
    h = tqgemm.w8a8_linear_plain(_t(a), w, _t(s_a), _t(s_w), _t(sum_a), _t(zp_w), _t(bias),
                                 torch.bfloat16)
    g = F.gelu(h.float(), approximate="tanh")
    h8b = torch.clamp(torch.round(g / scale2), -128, 127).to(torch.int8)
    s2 = scale2.expand(m).contiguous()
    sm2 = scale2 * h8b.float().sum(dim=-1)
    assert got[0].dtype == torch.int8 and got[0].shape == (m, n)
    assert torch.equal(got[0], h8b) and torch.equal(got[1], s2) and torch.equal(got[2], sm2)
    assert got[0].abs().max() > 64  # the codes use their range
    assert _lib.launch_counts().get("w8a8_linear_gelu_quant", 0) == 0  # CPU: the plain version


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gelu_quant_plain_matches_jax_chain(rng, m, k, n, asym):
    a, w_kn, s_a, s_w, sum_a, zp_w, bias = _operands(rng, m, k, n, asym)
    scale2 = np.float32(0.0173)
    got = tqgemm.w8a8_linear_gelu_quant(
        _t(a[None]), _t(w_kn.T), _t(s_a[None]), _t(s_w), torch.tensor(scale2),
        _t(None if sum_a is None else sum_a[None]), _t(zp_w), _t(bias))
    # wanq_tpu/models/dit.py, the ffn2_static branch of block_forward
    h = jqgemm.w8a8_linear_xla(_j(a[None]), _j(w_kn), _j(s_a[None]), _j(s_w),
                               _j(None if sum_a is None else sum_a[None]), _j(zp_w), _j(bias),
                               out_dtype=jnp.bfloat16)
    g = jdit.gelu_tanh(h.astype(jnp.float32))
    h8b = jnp.clip(jnp.round(g / scale2), -128, 127).astype(jnp.int8)
    s2 = jnp.full(h.shape[:2], scale2, jnp.float32)
    sm2 = scale2 * jnp.sum(h8b, axis=-1, dtype=jnp.float32)

    assert got[0].shape == (1, m, n) and got[1].shape == got[2].shape == (1, m)
    diff = np.abs(got[0].numpy().astype(np.int32) - np.asarray(h8b).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(s2))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(sm2), rtol=1e-6, atol=4 * scale2)


def test_block_forward_static_ffn2_runs_the_mode_and_matches_jax(rng, monkeypatch):
    """One block under wan_w8a8_speed.yaml with a calibrated static ffn.2
    scale: the port takes K2's GELU + quant route (counted here) and matches
    wanq_tpu's block at the int8 tolerance of tests/test_torch_slice.py."""
    small = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
                 freq_dim=64, param_dtype="bfloat16", residual_dtype="bfloat16")
    cfg_j, cfg_t = jax_tiny_config(**small), tiny_config(**small)
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(3))
    pt = tdit.init_params(cfg_t, 3, device="cpu")
    x = rng.normal(size=(2, 64, 256)).astype(np.float32)
    e = (rng.normal(size=(2, 6, 256)) * 0.1).astype(np.float32)
    c = rng.normal(size=(2, 32, 256)).astype(np.float32)
    ca, sb = rope_tables_interleaved((3, 4, 5), 128)

    def port_block(ctx):
        return tdit.block_forward(pt["blocks"][1], "blocks.1", ctx, torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(e), torch.from_numpy(c).bfloat16(), cfg_t,
                                  torch.from_numpy(ca.copy()), torch.from_numpy(sb.copy()), 60)

    cc = QuantCtx(mode="calib", collect_minmax=True)
    port_block(cc)
    calib = {k: v.float().numpy()[None] for k, v in cc.collect.items()}
    assert "blocks.1.ffn.2.act_max" in calib
    names = [n for n in jdit.linear_layer_names(cfg_j) if n.startswith("blocks.1.")]
    pol_j, st_j, rot_j = jax_prepare(pj, names, JaxQuantConfig.from_yaml(SPEED), calib=calib,
                                     targets="int8")
    jctx = JaxQuantCtx(mode="int8", policies=pol_j, state=st_j, rotations=rot_j)
    tctx = QuantCtx(mode="int8", policies=pol_j,
                    state=quant_state_from_numpy(jax.tree.map(np.asarray, st_j), device="cpu"))
    assert tqlinear.int8_static_fusable(tctx, "blocks.1.ffn.2")

    calls = []
    real = tqlinear.w8a8_linear_gelu_quant
    monkeypatch.setattr(tqlinear, "w8a8_linear_gelu_quant",
                        lambda *a, **k: calls.append(tuple(a[1].shape)) or real(*a, **k))
    got = port_block(tctx).float().numpy()
    assert calls == [(512, 256)]  # once, on ffn.0's weight [ffn_dim, dim]
    want = np.asarray(jdit.block_forward(
        pj["blocks"][1], "blocks.1", jctx, jnp.asarray(x, jnp.bfloat16), jnp.asarray(e),
        jnp.asarray(c, jnp.bfloat16), cfg_j, jnp.asarray(ca), jnp.asarray(sb), 60
    ).astype(jnp.float32))
    rel = np.linalg.norm(want.astype(np.float64) - got) / np.linalg.norm(want.astype(np.float64))
    cos = (want.ravel().astype(np.float64) @ got.ravel()) / np.linalg.norm(want) / np.linalg.norm(got)
    assert np.isfinite(got).all() and rel <= 2e-2 and cos >= 0.999


def test_packed_int4_block_keeps_the_elementwise_chain(rng):
    """``gelu_static_quant`` behind a bf16 GEMM output, the chain a packed
    int4 ffn.0 ran before K8 had the GELU + quant mode, is the same function as
    the mode's plain version, for K2 and for K8."""
    a, w_kn, s_a, s_w, sum_a, zp_w, bias = _operands(rng, 33, 192, 256, True)
    scale2 = torch.tensor(0.02)
    h = tqgemm.w8a8_linear_plain(_t(a), _t(w_kn.T), _t(s_a), _t(s_w), _t(sum_a), _t(zp_w),
                                 _t(bias), torch.bfloat16)
    got = tqgemm.gelu_static_quant(h, scale2)
    want = tqgemm.w8a8_linear_gelu_quant_plain(_t(a), _t(w_kn.T), _t(s_a), _t(s_w), scale2,
                                               _t(sum_a), _t(zp_w), _t(bias))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    wp = _t(rng.integers(-128, 128, size=(256, 96), dtype=np.int8))
    h = tqgemm.w4a8_linear_plain(_t(a), wp, _t(s_a), _t(s_w), _t(sum_a), _t(zp_w), _t(bias),
                                 torch.bfloat16)
    got = tqgemm.gelu_static_quant(h, scale2)
    want = tqgemm.w4a8_linear_gelu_quant_plain(_t(a), wp, _t(s_a), _t(s_w), scale2, _t(sum_a),
                                               _t(zp_w), _t(bias))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_nibble_at_the_top_of_its_byte_is_sixteen_times_the_code():
    """K9's unpack: ``(b << 4) & 0xF0`` and ``b & 0xF0`` read as int8 are 16
    times the signed low and high nibble, for every byte."""
    b = np.arange(256, dtype=np.uint8)
    lo16 = ((b.astype(np.uint16) << 4) & 0xF0).astype(np.uint8).view(np.int8).astype(np.int32)
    hi16 = (b & 0xF0).view(np.int8).astype(np.int32)
    codes = unpack_int4(torch.from_numpy(b.view(np.int8).reshape(256, 1))).numpy()  # [256, 2]
    np.testing.assert_array_equal(lo16, 16 * codes[:, 0].astype(np.int32))
    np.testing.assert_array_equal(hi16, 16 * codes[:, 1].astype(np.int32))


@pytest.mark.parametrize("m,k,n", [(37, 128, 128), (70, 384, 256)])
def test_w4a4_codes_times_16_with_scales_over_16_is_exact(rng, m, k, n):
    """K9's arithmetic: the group sums of 16 x the weight codes, scaled by
    (s_a / 16) * s_w in the plain version's order, give the plain version's
    f32 values bit for bit (both scalings are by powers of two)."""
    a = torch.from_numpy(rng.integers(-8, 8, size=(m, k), dtype=np.int8))
    wp = torch.from_numpy(rng.integers(-128, 128, size=(n, k // 2), dtype=np.int8))
    s_a = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(m, k // 128)).astype(np.float32))
    s_w = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(k // 128, n)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    want = tqgemm.w4a4_linear_plain(a, wp, s_a, s_w, bias)
    w16 = unpack_int4(wp).double() * 16
    acc = torch.zeros((m, n), dtype=torch.float32)
    for g in range(k // 128):
        ks = slice(128 * g, 128 * (g + 1))
        p16 = (a[:, ks].double() @ w16[:, ks].t()).float()
        assert p16.abs().max() < 2 ** 24  # exact as int32 and as f32
        acc = acc + p16 * ((s_a[:, g, None] * 0.0625) * s_w[g][None, :])
    assert torch.equal(acc + bias[None, :], want)
