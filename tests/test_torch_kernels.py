"""Parity of the port's kernel modules (wanq_tpu_torch.ops / models.attention)
with wanq_tpu on the CPU.

The same numpy inputs go through the JAX function -- its XLA form and its
Pallas kernel in interpret mode, or ``_sdpa_reference`` for attention --
and through the port's wrapper, which on CPU tensors runs the kernel's
plain PyTorch version. The CUDA kernels themselves are checked against
those plain versions on the card (tests/test_torch_cuda.py).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.models.rope import rope_tables_interleaved
from wanq_tpu.ops import fused as jfused
from wanq_tpu.ops import qgemm as jqgemm
from wanq_tpu.ops import rmsnorm_rope as jrr
from wanq_tpu_torch.models import attention as tattn
from wanq_tpu_torch.ops import fused as tfused
from wanq_tpu_torch.ops import qgemm as tqgemm
from wanq_tpu_torch.ops import rmsnorm_rope as trr
from wanq_tpu_torch.ops.rmsnorm_rope import merge_heads, split_heads

# wanq_tpu.models re-exports the function `attention` under the module's name
jattn = importlib.import_module("wanq_tpu.models.attention")
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(_JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TDT[dtype])
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_one_bf16_ulp(got: np.ndarray, want: np.ndarray) -> bool:
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return bool(np.all(np.abs(got - want) <= ulp))


# ---------------------------------------------------------------------------
# K1: ln_modulate_quant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channel_scale", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_ln_modulate_quant_matches_jax(rng, dtype, channel_scale):
    b, n, c = 2, 72, 256
    x = (rng.normal(size=(b, n, c)) * 2.0 + 0.3).astype(np.float32)
    shift = (rng.normal(size=(b, c)) * 0.5).astype(np.float32)
    scale = (rng.normal(size=(b, c)) * 0.5).astype(np.float32)
    cs = rng.uniform(0.5, 2.0, size=(c,)).astype(np.float32) if channel_scale else None
    jx, tx = _pair(x, dtype)

    got = tfused.ln_modulate_quant(
        tx, torch.from_numpy(shift), torch.from_numpy(scale),
        channel_scale=None if cs is None else torch.from_numpy(cs))
    wants = [jfused.ln_modulate_quant_xla(
        jx, jnp.asarray(shift), jnp.asarray(scale),
        channel_scale=None if cs is None else jnp.asarray(cs))]
    if cs is None:  # the Pallas kernel has no channel_scale
        wants.append(jfused.ln_modulate_quant_pallas(
            jx, jnp.asarray(shift), jnp.asarray(scale), block_n=16, interpret=True))
    for want in wants:
        q_t, q_j = got[0].numpy().astype(np.int32), np.asarray(want[0]).astype(np.int32)
        diff = np.abs(q_t - q_j)
        # reduction order may flip a rounding tie by one code
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)
        same_rows = (diff.max(axis=-1) == 0)
        np.testing.assert_allclose(got[2].numpy()[same_rows],
                                   np.asarray(want[2])[same_rows], rtol=1e-5, atol=1e-6)


def test_k1_static_and_quant_sum_match_jax(rng):
    """The plain-only producers (off the W8A8 speed path)."""
    x = rng.normal(size=(2, 40, 128)).astype(np.float32)
    shift = rng.normal(size=(2, 128)).astype(np.float32)
    scale = rng.normal(size=(2, 128)).astype(np.float32)
    d = np.asarray([0.03], np.float32)
    got = tfused.ln_modulate_quant_static(torch.from_numpy(x), torch.from_numpy(shift),
                                          torch.from_numpy(scale), torch.from_numpy(d))
    want = jfused.ln_modulate_quant_static(jnp.asarray(x), jnp.asarray(shift),
                                           jnp.asarray(scale), jnp.asarray(d))
    assert (np.abs(got[0].numpy().astype(int) - np.asarray(want[0]).astype(int)) <= 1).all()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    for gelu in (False, True):
        got = tfused.quant_sum(torch.from_numpy(x[0]), gelu=gelu)
        want = jfused.quant_sum(jnp.asarray(x[0]), gelu=gelu)
        assert (np.abs(got[0].numpy().astype(int) - np.asarray(want[0]).astype(int)) <= 1).all()
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)


# ---------------------------------------------------------------------------
# K2: w8a8_linear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 77, 256])
@pytest.mark.parametrize("asym,with_bias", [(True, True), (False, False), (True, False)])
def test_k2_w8a8_linear_matches_jax(rng, m, asym, with_bias):
    k, n = 256, 384
    a = rng.integers(-128, 128, size=(m, k), dtype=np.int8)
    w_kn = rng.integers(-128, 128, size=(k, n), dtype=np.int8)  # JAX layout
    s_a = rng.uniform(1e-3, 2e-2, size=(m,)).astype(np.float32)
    s_w = rng.uniform(1e-3, 2e-2, size=(n,)).astype(np.float32)
    sum_a = (s_a * a.astype(np.float32).sum(-1)).astype(np.float32) if asym else None
    zp_w = rng.integers(-20, 20, size=(n,)).astype(np.float32) if asym else None
    bias = rng.normal(size=(n,)).astype(np.float32) if with_bias else None

    def j(v):
        return None if v is None else jnp.asarray(v)

    def t(v):
        return None if v is None else torch.from_numpy(v)

    got = tqgemm.w8a8_linear(t(a), torch.from_numpy(np.ascontiguousarray(w_kn.T)), t(s_a),
                             t(s_w), t(sum_a), t(zp_w), t(bias)).numpy()
    want_xla = np.asarray(jqgemm.w8a8_linear_xla(j(a), j(w_kn), j(s_a), j(s_w), j(sum_a),
                                                 j(zp_w), j(bias)))
    want_pl = np.asarray(jqgemm.w8a8_linear_pallas(
        j(a), j(w_kn), j(s_a), j(s_w), j(sum_a), j(zp_w), j(bias),
        block_m=128, block_n=128, block_k=128, interpret=True))
    for want in (want_xla, want_pl):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the K-major [N, K] storage computes the same exact integer product
    acc = a.astype(np.int64) @ w_kn.astype(np.int64)
    ref = acc.astype(np.float32) * (s_a[:, None] * s_w)
    if asym:
        ref = ref + sum_a[:, None] * (zp_w * s_w)
    if with_bias:
        ref = ref + bias
    np.testing.assert_array_equal(got, ref.astype(np.float32))


def test_k2_bf16_out_and_3d_activations_match_jax(rng):
    b, s, k, n = 2, 9, 128, 256
    a = rng.integers(-128, 128, size=(b, s, k), dtype=np.int8)
    w_kn = rng.integers(-128, 128, size=(k, n), dtype=np.int8)
    s_a = rng.uniform(1e-3, 2e-2, size=(b, s)).astype(np.float32)
    s_w = rng.uniform(1e-3, 2e-2, size=(n,)).astype(np.float32)
    sum_a = (s_a * a.astype(np.float32).sum(-1)).astype(np.float32)
    zp_w = rng.integers(-20, 20, size=(n,)).astype(np.float32)
    got = tqgemm.w8a8_linear(
        torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(w_kn.T)),
        torch.from_numpy(s_a), torch.from_numpy(s_w), torch.from_numpy(sum_a),
        torch.from_numpy(zp_w), None, out_dtype=torch.bfloat16)
    want = jqgemm.w8a8_linear_xla(jnp.asarray(a), jnp.asarray(w_kn), jnp.asarray(s_a),
                                  jnp.asarray(s_w), jnp.asarray(sum_a), jnp.asarray(zp_w),
                                  None, out_dtype=jnp.bfloat16)
    assert got.shape == (b, s, n) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# K3: rms_rope_heads / rms_split_heads
# ---------------------------------------------------------------------------


def _tables(d, s, valid, scale):
    ca, sb = rope_tables_interleaved((2, 3, 6), d)
    ca = np.concatenate([ca[:valid], np.ones((s - valid, d), np.float32)]) * scale
    sb = np.concatenate([sb[:valid], np.zeros((s - valid, d), np.float32)]) * scale
    return ca.astype(np.float32), sb.astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 0.088388])
def test_k3_rms_rope_heads_matches_jax(rng, scale):
    b, s, n, d, valid = 2, 40, 2, 64, 36
    x = rng.normal(size=(b, s, n * d)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(n * d,)).astype(np.float32)
    ca, sb = _tables(d, s, valid, scale)
    jx, tx = _pair(x, "bfloat16")
    got = trr.rms_rope_heads(tx, torch.from_numpy(w), torch.from_numpy(ca),
                             torch.from_numpy(sb), num_heads=n)
    want = jrr.rms_rope_heads(jx, jnp.asarray(w), jnp.asarray(ca), jnp.asarray(sb),
                              num_heads=n, interpret=True)
    assert got.shape == (b, n, s, d) and got.dtype == torch.bfloat16
    assert _within_one_bf16_ulp(_np(got), _np(want))


def test_k3_rms_split_heads_matches_jax(rng):
    b, s, n, d = 2, 24, 2, 64
    x = rng.normal(size=(b, s, n * d)).astype(np.float32) * 3.0
    w = rng.uniform(0.5, 1.5, size=(n * d,)).astype(np.float32)
    jx, tx = _pair(x, "bfloat16")
    got = trr.rms_split_heads(tx, torch.from_numpy(w), n)
    want = jrr.rms_split_heads(jx, jnp.asarray(w), n, interpret=True)
    assert got.shape == (b, n, s, d)
    assert _within_one_bf16_ulp(_np(got), _np(want))


# ---------------------------------------------------------------------------
# K4: attention
# ---------------------------------------------------------------------------


def _qkv(rng, b, sq, sk, n, d):
    return (rng.normal(size=(b, sq, n, d)).astype(np.float32),
            rng.normal(size=(b, sk, n, d)).astype(np.float32),
            rng.normal(size=(b, sk, n, d)).astype(np.float32))


def test_k4_self_attention_heads_major_matches_jax(rng):
    """Heads-major self-attention with k_valid_len < S (pad q rows included),
    v read through a split_heads view of [B, S, N*D]."""
    b, s, n, d, valid = 2, 40, 2, 128, 35
    q, k, v = _qkv(rng, b, s, s, n, d)
    want = np.asarray(jattn._sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), 1.0, valid))
    tq, tk = torch.from_numpy(q).transpose(1, 2), torch.from_numpy(k).transpose(1, 2)
    v_flat = torch.from_numpy(v).reshape(b, s, n * d)
    vh = split_heads(v_flat, n)
    assert vh.data_ptr() == v_flat.data_ptr()  # a view: no layout pass
    y = tattn.attention_heads_major(tq, tk, vh, k_valid_len=valid)
    assert y.shape == (b, n, s, d)
    np.testing.assert_allclose(y.transpose(1, 2).numpy(), want, atol=1e-5)
    # the output's memory is seq-major: the head merge is a view too
    merged = merge_heads(y)
    assert merged.data_ptr() == y.data_ptr() and merged.shape == (b, s, n * d)
    np.testing.assert_allclose(merged.numpy(), want.reshape(b, s, n * d), atol=1e-5)


@pytest.mark.parametrize("valid", [1, 35])
def test_k4_pad_tail_never_leaks(rng, valid):
    """k/v rows past ``valid`` planted (k = 0, v = 100): every q row, pad
    rows included, equals attention over the valid prefix alone, and JAX
    agrees."""
    b, s, n, d = 1, 40, 2, 128
    q, k, v = _qkv(rng, b, s, s, n, d)
    k[:, valid:], v[:, valid:] = 0.0, 100.0
    want = np.asarray(jattn._sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), 1.0, valid))
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = tattn.attention_heads_major(tq, tk, tv, k_valid_len=valid).transpose(1, 2)
    prefix = tattn.attention_heads_major(tq, tk[:, :, :valid], tv[:, :, :valid]).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), prefix.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.abs(got.numpy()).max() < 10.0


def test_k4_cross_attention_matches_jax(rng):
    b, sq, sk, n, d = 2, 33, 16, 2, 128
    q, k, v = _qkv(rng, b, sq, sk, n, d)
    want = np.asarray(jattn.cross_attention_heads_major(
        jnp.swapaxes(jnp.asarray(q), 1, 2), jnp.asarray(k), jnp.asarray(v)))
    got = tattn.cross_attention_heads_major(torch.from_numpy(q).transpose(1, 2),
                                            torch.from_numpy(k), torch.from_numpy(v))
    assert got.shape == (b, n, sq, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("valid", [None, 20])
def test_k4_attention_seq_major_matches_jax(rng, valid):
    b, sq, sk, n, d = 1, 24, 24, 3, 128
    q, k, v = _qkv(rng, b, sq, sk, n, d)
    want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      k_valid_len=valid))
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          k_valid_len=valid)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    chunked = tattn._sdpa_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), 1 / np.sqrt(d), valid, q_chunk=7)
    np.testing.assert_allclose(chunked.numpy(), want, atol=1e-5)


def test_k4_window_is_not_ported(rng):
    """The window is ported (tests/test_torch_window.py holds it against
    wanq_tpu); what stays refused is a window that is no TemporalWindow, on
    every entry point, and any window on cross-attention."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 8, 8, 1, 128))
    for fn in (tattn.attention, tattn.attention_heads_major):
        with pytest.raises(TypeError, match="TemporalWindow"):
            fn(q, k, v, window=object())
    with pytest.raises(TypeError):
        tattn.cross_attention_heads_major(q.transpose(1, 2), k, v,
                                          window=tattn.TemporalWindow(4, 0))
