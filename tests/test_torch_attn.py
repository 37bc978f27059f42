"""The port's attention quantization against wanq_tpu on the CPU, on the same
numpy inputs: the int8 flash attention's plain versions (ops/attn_int8.py)
against the Pallas kernel in interpret mode and the global-max reference,
and the simulated attention quantizers (quant/attn.py).

Tolerances. The q/k/v producer: codes and scales equal. The blocked plain
version of K10 runs the interpreted Pallas kernel's steps; what differs is
the order of the f32 sum of p and the last bit of exp, which flips a
rounded prob by one of 127 steps on rare elements: <= 1e-4 abs (observed
<= 4e-6 on outputs of size ~0.3). Against the global-max form both are a few
prob steps away by design (the running block max moves the rounding grid):
atol 4/127, the limit the JAX package holds its own kernel to. The
simulated quantizers: rel-L2 <= 1e-5 against the eager JAX functions.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.models.attention import attention as jax_attention
from wanq_tpu.ops import attn_int8 as JA
from wanq_tpu.quant import attn as jattn
from wanq_tpu.quant import quantizers as jq
from wanq_tpu_torch.ops import attn_int8 as TA
from wanq_tpu_torch.quant import attn as tattn
from wanq_tpu_torch.quant import quantizers as tq


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _qkv(rng, shape=(1, 2, 256, 128)):
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# ops/attn_int8.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [256, 200], ids=["aligned", "ragged_200_to_256"])
def test_quantize_qkv_int8_plain_equals_jax(rng, s):
    q, k, v = _qkv(rng, (1, 2, s, 128))
    q[0, 0, :3] *= 25.0  # one block with a far larger absmax
    want = JA.quantize_qkv_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), blk=128)
    got = TA.quantize_qkv_int8(_t(q), _t(k), _t(v), blk=128)
    assert got[0].shape == (1, 2, 256, 128) and got[3].shape == (1, 2, 2)
    for g, w in zip(got, want):
        assert g.dtype == (torch.int8 if w.dtype == jnp.int8 else torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if s == 200:
        assert not got[0][:, :, 200:].any() and not got[2][:, :, 200:].any()


def test_quantize_qkv_int8_bf16_inputs_equal_jax(rng):
    """The model hands bf16 operands over: the same codes from both."""
    q, k, v = [jnp.asarray(a).astype(jnp.bfloat16) for a in _qkv(rng, (2, 2, 128, 128))]
    want = JA.quantize_qkv_int8(q, k, v, blk=128)
    got = TA.quantize_qkv_int8(*[_t(np.asarray(a, np.float32)).bfloat16() for a in (q, k, v)],
                               blk=128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_v_kernel_layout_roundtrip_and_positions(rng):
    """K10's v operand: transposed, and inside each 32-kv group the actual
    kv 8t + 2i + lo sits at position 16 (t // 2) + 4 i + 2 (t % 2) + lo."""
    vi = _t(rng.integers(-127, 128, size=(1, 2, 64, 8)).astype(np.int8))
    vt = TA.v_kernel_layout(vi)
    assert vt.shape == (1, 2, 8, 64) and vt.is_contiguous()
    assert torch.equal(TA.v_from_kernel_layout(vt), vi)
    for a in range(64):
        grp, a32 = divmod(a, 32)
        t, w = divmod(a32, 8)
        pos = 32 * grp + 16 * (t // 2) + 4 * (w // 2) + 2 * (t % 2) + (w % 2)
        assert torch.equal(vt[0, 1, :, pos], vi[0, 1, a, :])


@pytest.mark.parametrize("k_valid_len", [None, 200])
def test_k10_blocked_plain_matches_pallas_interpret(rng, k_valid_len):
    q, k, v = _qkv(rng)
    sm = 1.0 / math.sqrt(128)
    jqs = JA.quantize_qkv_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), blk=128)
    tqs = [_t(a) for a in jqs]
    pallas = np.asarray(JA.attention_int8_pallas(*jqs, sm, k_valid_len, blk_q=128, blk_k=128,
                                                 interpret=True))
    xla = np.asarray(JA.attention_int8_xla(*jqs, sm, k_valid_len))
    blocked = TA.attention_int8_blocked(*tqs, sm, k_valid_len).numpy()
    glob = TA.attention_int8_global(*tqs, sm, k_valid_len).numpy()
    assert blocked.shape == pallas.shape == (1, 2, 256, 128)
    # the same steps: tight
    assert np.abs(blocked - pallas).max() <= 1e-4
    # q rows in chunks: rows are independent
    chunked = TA.attention_int8_blocked(*tqs, sm, k_valid_len, q_chunk=96).numpy()
    np.testing.assert_array_equal(chunked, blocked)
    # the global-max form equals JAX's, and the blocked form is a few prob
    # steps from it, as the JAX package's own kernel is
    assert np.abs(glob - xla).max() <= 1e-5
    np.testing.assert_allclose(blocked, xla, atol=4 / JA.P_LEVELS)


def test_k10_blocked_plain_skips_blocks_past_the_valid_prefix(rng):
    """kv blocks wholly past k_valid_len add p = 0 and alpha = 1 exactly:
    garbage there changes nothing, and the result equals the interpreted
    Pallas kernel's, which visits them."""
    q, k, v = _qkv(rng)
    sm = 1.0 / math.sqrt(128)
    jqs = JA.quantize_qkv_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), blk=128)
    tqs = [_t(a).clone() for a in jqs]
    base = TA.attention_int8_blocked(*tqs, sm, 100)
    tqs[1][:, :, 128:] = 127
    tqs[2][:, :, 100:] = -127
    assert torch.equal(TA.attention_int8_blocked(*tqs, sm, 100), base)
    pallas = np.asarray(JA.attention_int8_pallas(*jqs, sm, 100, blk_q=128, blk_k=128,
                                                 interpret=True))
    assert np.abs(base.numpy() - pallas).max() <= 1e-4


@pytest.mark.parametrize("s,valid", [(256, None), (200, None), (200, 190)])
def test_attention_int8_wrapper_matches_jax_and_is_near_fp(rng, s, valid):
    """Model layout [B, S, H, D] in and out. JAX's wrapper takes the
    global-max form on the CPU, so the two are a few prob steps apart
    (atol 4/127), and both stay within 0.15 of FP attention."""
    q, k, v = [np.swapaxes(a, 1, 2) for a in _qkv(rng, (1, 2, s, 128))]
    want = np.asarray(JA.attention_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        k_valid_len=valid, blk=128))
    got = TA.attention_int8(_t(q), _t(k), _t(v), k_valid_len=valid, blk=128)
    assert got.shape == (1, s, 2, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=4 / JA.P_LEVELS)
    fp = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  k_valid_len=valid, force_reference=True))
    assert np.abs(got.numpy() - fp).max() / np.abs(fp).max() < 0.15
    # the default block is 512: one block here, which is the global form
    got512 = TA.attention_int8(_t(q), _t(k), _t(v), k_valid_len=valid)
    want512 = np.asarray(JA.attention_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           k_valid_len=valid))
    assert np.abs(got512.numpy() - want512).max() <= 1e-5


def test_int8_attention_cuda_wrappers_refuse_cpu_tensors():
    """On a CUDA tensor the wrappers launch the kernels or raise; the kernel
    launchers themselves never take a CPU tensor."""
    x = torch.zeros((1, 2, 512, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        TA.quantize_qkv_int8_cuda(x, x, x)
    qi = torch.zeros((1, 2, 512, 128), dtype=torch.int8)
    sc = torch.ones((1, 2, 1))
    with pytest.raises(ValueError, match="CUDA"):
        TA.attention_int8_cuda(qi, qi, qi.transpose(2, 3).contiguous(), sc, sc,
                               torch.ones((1, 2, 128)), 1.0)


# ---------------------------------------------------------------------------
# quant/attn.py
# ---------------------------------------------------------------------------


def _cfg(pkg, bits=8, sym=True):
    return pkg.QuantizerCfg(n_bits=bits, sym=sym)


@pytest.mark.parametrize("bits,sym", [(8, True), (4, True), (8, False)])
def test_quantize_qk_and_v_match_jax(rng, bits, sym):
    x = rng.normal(size=(2, 3, 40, 16)).astype(np.float32)
    x[0, 1, 5] = 0.0  # an all-zero row: the eps clamp
    for jf, tf in ((jattn.quantize_qk, tattn.quantize_qk), (jattn.quantize_v, tattn.quantize_v)):
        want = np.asarray(jf(jnp.asarray(x), _cfg(jq, bits, sym)))
        got = tf(_t(x), _cfg(tq, bits, sym))
        assert got.shape == x.shape
        assert _rel(want, got.numpy()) <= 1e-6


def test_attn_quant_cfg_from_dict_matches_jax():
    d = {"qk": {"n_bits": [8, 4], "sym": False}, "v": {"n_bits": 8},
         "attn_map": {"n_bits": 4, "group": "block", "block_size": 16, "int8_scale": True},
         "n_text_tokens": 7}
    a, b = jattn.AttnQuantCfg.from_dict(d), tattn.AttnQuantCfg.from_dict(d)
    for field in ("attn_map_group", "n_text_tokens", "block_size", "int8_scale"):
        assert getattr(a, field) == getattr(b, field)
    for qa, qb in ((a.qk, b.qk), (a.v, b.v), (a.attn_map, b.attn_map)):
        assert (qa.n_bits, qa.sym, qa.dynamic, qa.active_bits) == (
            qb.n_bits, qb.sym, qb.dynamic, qb.active_bits)
    assert tattn.AttnQuantCfg.from_dict(None) is None and tattn.AttnQuantCfg.from_dict({}) is None
    assert tattn.AttnQuantCfg.from_dict({"v": {"n_bits": 8}}).attn_map is None


def _softmax_map(rng, b=1, h=2, s=40):
    a = rng.normal(size=(b, h, s, s)).astype(np.float32) * 2
    a = np.exp(a - a.max(-1, keepdims=True))
    return (a / a.sum(-1, keepdims=True)).astype(np.float32)


def test_attn_map_row_quant_matches_jax(rng):
    a = _softmax_map(rng)
    for bits in (8, 4):
        want = np.asarray(jattn.quantize_attn_map_row(jnp.asarray(a), _cfg(jq, bits)))
        got = tattn.quantize_attn_map_row(_t(a), _cfg(tq, bits))
        assert _rel(want, got.numpy()) <= 1e-6


@pytest.mark.parametrize("case", ["plain", "text_tokens", "int8_scale", "bits_mask", "perm",
                                  "everything"])
def test_attn_map_block_quant_matches_jax(rng, case):
    """Blockwise map quant: text rows/cols stay FP, int8-quantized deltas, a
    bits mask with a pruned (0-bit) block, a per-head reorder."""
    nt = 8 if case in ("text_tokens", "everything") else 0
    a = _softmax_map(rng, s=32 + nt)
    kw = dict(n_text_tokens=nt, int8_scale=case in ("int8_scale", "everything"))
    bm = perm = None
    if case in ("bits_mask", "everything"):
        bm = np.asarray([[8, 4, 0, 2], [4, 8, 8, 0], [2, 8, 8, 4], [0, 2, 4, 8]], np.float32)
    if case in ("perm", "everything"):
        perm = np.stack([rng.permutation(32) for _ in range(2)]).astype(np.int32)
    want = np.asarray(jattn.quantize_attn_map_block(
        jnp.asarray(a), _cfg(jq), 8, bits_mask=None if bm is None else jnp.asarray(bm),
        perm=None if perm is None else jnp.asarray(perm), **kw))
    got = tattn.quantize_attn_map_block(
        _t(a), _cfg(tq), 8, bits_mask=None if bm is None else _t(bm),
        perm=None if perm is None else _t(perm), **kw).numpy()
    assert _rel(want, got) <= 1e-5
    if nt:
        np.testing.assert_array_equal(got[:, :, :nt], a[:, :, :nt])
        np.testing.assert_array_equal(got[:, :, :, :nt], a[:, :, :, :nt])
    if bm is not None and perm is None:
        assert not got[:, :, nt:nt + 8, nt + 16:nt + 24].any()  # the 0-bit block
    with pytest.raises(ValueError, match="reorder table shape"):
        tattn.quantize_attn_map_block(_t(a), _cfg(tq), 8, n_text_tokens=nt,
                                      perm=torch.zeros((2, 5), dtype=torch.int64))


@pytest.mark.parametrize("group", ["row", "block"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_attention_matches_jax(rng, group, dtype):
    """The whole simulation with a masked kv tail. f32: rel-L2 <= 1e-5. bf16
    operands: the two frameworks round the bf16 products' f32 sums at the
    same places, but a fake-quant scale one f32 ulp apart flips a bf16
    rounding now and then: rel-L2 <= 5e-3 (bf16 has 8 bits)."""
    q, k, v = [rng.normal(size=(2, 32, 2, 16)).astype(np.float32) for _ in range(3)]
    d = {"qk": {"n_bits": 8}, "v": {"n_bits": 8},
         "attn_map": {"n_bits": 8, "group": group, "block_size": 8, "int8_scale": True}}
    perm = np.stack([rng.permutation(32) for _ in range(2)]).astype(np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jattn.quantized_attention(
        *[jnp.asarray(a).astype(jd) for a in (q, k, v)], jattn.AttnQuantCfg.from_dict(d),
        perm=jnp.asarray(perm) if group == "block" else None, k_valid_len=29)
    got = tattn.quantized_attention(
        *[_t(a).to(td) for a in (q, k, v)], tattn.AttnQuantCfg.from_dict(d),
        perm=_t(perm) if group == "block" else None, k_valid_len=29)
    assert got.shape == (2, 32, 2, 16) and got.dtype == td
    rel = _rel(np.asarray(want.astype(jnp.float32)), got.float().numpy())
    assert rel <= (1e-5 if dtype == "float32" else 5e-3), rel


def test_quantized_attention_without_quantizers_is_plain_attention(rng):
    q, k, v = [rng.normal(size=(1, 24, 2, 16)).astype(np.float32) for _ in range(3)]
    got = tattn.quantized_attention(_t(q), _t(k), _t(v), tattn.AttnQuantCfg())
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    force_reference=True))
    assert _rel(want, got.numpy()) <= 1e-5


def test_generate_reorder_tables_equal_jax(rng):
    maps = {f"blocks.{i}.self_attn": _softmax_map(rng, b=1, h=3, s=12)[0] for i in range(2)}
    for pool in (1, 4):
        want = jattn.generate_reorder_tables(maps, pool=pool)
        got = tattn.generate_reorder_tables(maps, pool=pool)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == np.int32 and got[name].shape == (3, 12 * pool)
            np.testing.assert_array_equal(got[name], np.asarray(want[name]))
            assert sorted(got[name][0]) == list(range(12 * pool))
