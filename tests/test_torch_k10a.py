"""K10a's plain version (ops/attn_int8.py::quantize_qkv_int8_plain) against
wanq_tpu's quantize_qkv_int8 at the deployed block of 512 tokens, on the same
numpy inputs, and the host-side helpers of the kernel: the tensor-map layout
of the views the main path hands it, and the bytes it moves.

Tolerance: codes and scales equal. The function is a max, one true division
per scale and a correctly rounded quotient per code, so both frameworks give
the same bits (the kernel is held to the plain version code for code on the
card, tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.ops import attn_int8 as JA
from wanq_tpu_torch.models.attention import tensor_map_layout
from wanq_tpu_torch.ops import attn_int8 as TA

BLK = 512


@pytest.fixture
def rng():
    return np.random.default_rng(9)


def _check(q, k, v):
    """q, k, v numpy [B, H, S, 128] (f32, or bf16 through jnp) through both."""
    want = JA.quantize_qkv_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), blk=BLK)
    conv = [torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))) for a in (q, k, v)]
    if jnp.asarray(q).dtype == jnp.bfloat16:
        conv = [t.bfloat16() for t in conv]
    got = TA.quantize_qkv_int8_plain(*conv, blk=BLK)
    for g, w in zip(got, want):
        assert g.dtype == (torch.int8 if w.dtype == jnp.int8 else torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("s", [1, 511, 513, 1000])
def test_ragged_s_pads_with_zero_rows(rng, s):
    q, k, v = (rng.normal(size=(2, 3, s, 128)).astype(np.float32) for _ in range(3))
    q[1, 2, :4] *= 40.0
    qi, ki, vi, s_q, _, s_v = _check(q, k, v)
    s_pad = -(-s // BLK) * BLK
    assert qi.shape == (2, 3, s_pad, 128) and s_q.shape == (2, 3, s_pad // BLK)
    assert s_v.shape == (2, 3, 128)
    assert not qi[:, :, s:].any() and not ki[:, :, s:].any() and not vi[:, :, s:].any()


def test_main_path_views(rng):
    """q and k heads-major (K3's outputs), v a view of the seq-major
    [B, S, H * 128] (K2's output), as models/dit.py hands them over."""
    b, s, h = 2, 700, 3
    q = rng.normal(size=(b, h, s, 128)).astype(np.float32)
    k = rng.normal(size=(b, h, s, 128)).astype(np.float32)
    v_flat = rng.normal(size=(b, s, h * 128)).astype(np.float32)
    want = JA.quantize_qkv_int8(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v_flat.reshape(b, s, h, 128).transpose(0, 2, 1, 3)),
                                blk=BLK)
    vh = torch.from_numpy(v_flat).view(b, s, h, 128).transpose(1, 2)
    assert not vh.is_contiguous()
    got = TA.quantize_qkv_int8_plain(torch.from_numpy(q), torch.from_numpy(k), vh, blk=BLK)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_zero_block_takes_the_floor_scale(rng):
    q, k, v = (rng.normal(size=(1, 2, 1536, 128)).astype(np.float32) for _ in range(3))
    q[0, 1, 512:1024] = 0.0
    v[0, 0, :, 17] = 0.0
    v[0, 1, :, 3] = 1e-30
    _, _, vi, s_q, _, s_v = _check(q, k, v)
    assert s_q[0, 1, 1].item() == np.float32(1e-6)
    assert s_v[0, 0, 17].item() == np.float32(1e-6) and s_v[0, 1, 3].item() == np.float32(1e-6)
    assert not vi[0, 0, :, 17].any() and not vi[0, 1, :, 3].any()


def test_exact_half_quotients_round_to_even(rng):
    """A block whose absmax is 127 has scale 1, so every value x.5 is a tie:
    both round it to the even neighbour."""
    ties = np.arange(-254, 255) / 2.0
    q = rng.choice(ties, size=(1, 1, BLK, 128)).astype(np.float32)
    q[0, 0, 0, 0] = 127.0
    k = q[..., ::-1].copy()
    v = rng.choice(ties, size=(1, 1, BLK, 128)).astype(np.float32)
    v[0, 0, 0] = 127.0
    qi, _, vi, s_q, _, s_v = _check(q, k, v)
    assert s_q.item() == 1.0 and torch.all(s_v == 1.0)
    np.testing.assert_array_equal(qi.numpy(), np.rint(q).astype(np.int8))
    assert set(np.unique(np.abs(qi.numpy()) % 2)) == {0, 1}
    half = np.abs(q - np.trunc(q)) == 0.5
    assert half.any() and not (qi.numpy()[half] % 2).any()


def test_bf16_inputs(rng):
    q, k, v = (jnp.asarray(rng.normal(size=(2, 2, 900, 128)).astype(np.float32) * 3)
               .astype(jnp.bfloat16) for _ in range(3))
    _check(q, k, v)


def test_v_kernel_layout_round_trip_at_the_deployed_block(rng):
    """K10's v operand at S = 1024 (two 512-blocks): each row of the kernel
    layout is a channel, and inside each 32-kv group kv 8t + 2i + lo sits at
    position 16 (t // 2) + 4 i + 2 (t % 2) + lo."""
    vi = torch.from_numpy(rng.integers(-127, 128, size=(2, 3, 1024, 128)).astype(np.int8))
    vt = TA.v_kernel_layout(vi)
    assert vt.shape == (2, 3, 128, 1024) and vt.is_contiguous()
    assert torch.equal(TA.v_from_kernel_layout(vt), vi)
    pos = np.empty(1024, np.int64)
    for a in range(1024):
        grp, a32 = divmod(a, 32)
        t, w = divmod(a32, 8)
        pos[a] = 32 * grp + 16 * (t // 2) + 4 * (w // 2) + 2 * (t % 2) + (w % 2)
    np.testing.assert_array_equal(vt[..., pos].transpose(2, 3).numpy(), vi.numpy())


def _offsets(dims, strides):
    """Every element's byte offset from a tensor map's dims (d, s, n, b) and
    byte strides (s, n, b), bf16 elements."""
    d, s, n, b = dims
    idx = np.indices((b, n, s, d))
    return idx[3] * 2 + idx[2] * strides[0] + idx[1] * strides[1] + idx[0] * strides[2]


@pytest.mark.parametrize("layout", ["heads_major", "seq_major_view", "padded_rows", "one_head"])
def test_tensor_map_layout_of_k10a_operands(layout):
    """The dims and byte strides K10a's tensor maps get address every element
    of the view where the view has it."""
    b, s, h = 2, 20, 3
    if layout == "heads_major":
        t = torch.zeros((b, h, s, 128), dtype=torch.bfloat16)
    elif layout == "seq_major_view":
        t = torch.zeros((b, s, h * 128), dtype=torch.bfloat16).view(b, s, h, 128).transpose(1, 2)
    elif layout == "padded_rows":
        t = torch.zeros((b, s, h * 128 + 64), dtype=torch.bfloat16)[..., :h * 128] \
            .unflatten(-1, (h, 128)).transpose(1, 2)
    else:
        t = torch.zeros((b, s, 1, 128), dtype=torch.bfloat16).transpose(1, 2)
    dims, strides = tensor_map_layout(t, "t")
    assert dims == (128, s, t.shape[1], b)
    want = np.empty(t.shape, np.int64)
    for bi, ni, si in np.ndindex(*t.shape[:3]):
        want[bi, ni, si] = 2 * (np.arange(128) * t.stride(3) + bi * t.stride(0)
                                + ni * t.stride(1) + si * t.stride(2))
    got = _offsets(dims, strides)
    if t.shape[1] == 1:  # a dimension of one never moves
        got, want = got[:, 0], want[:, 0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("what", ["seq stride 8 bytes past 16", "head dim 64", "head dim strided",
                                  "base 2 bytes off"])
def test_tensor_map_layout_refuses_what_k10a_cannot_take(what):
    b, s, h = 1, 8, 2
    if what == "seq stride 8 bytes past 16":
        t = torch.zeros((b, s, h * 128 + 4), dtype=torch.bfloat16)[..., :h * 128] \
            .unflatten(-1, (h, 128)).transpose(1, 2)
    elif what == "head dim 64":
        t = torch.zeros((b, h, s, 64), dtype=torch.bfloat16)
    elif what == "head dim strided":
        t = torch.zeros((b, h, s, 256), dtype=torch.bfloat16)[..., ::2]
    else:
        t = torch.zeros(b * h * s * 128 + 8, dtype=torch.bfloat16)[1:1 + b * h * s * 128] \
            .view(b, h, s, 128)
    with pytest.raises(ValueError):
        tensor_map_layout(t, "v")


@pytest.mark.parametrize("b,h,s", [(2, 12, 32768), (2, 40, 75776), (1, 3, 1000)])
def test_traffic_counts_every_byte(b, h, s):
    """The bound reads q, k, v once and writes the codes and scales once; the
    kernel also reads v a second time and writes and reads its partial maxima
    of v (one f32 row of 128 per 512-token block)."""
    bound, moved = TA.quantize_qkv_int8_traffic(b, h, s)
    s_pad = -(-s // BLK) * BLK
    reads = sum(2 * b * h * s * 128 for _ in "qkv")
    writes = 3 * b * h * s_pad * 128 + 4 * (2 * b * h * (s_pad // BLK) + b * h * 128)
    assert bound == reads + writes
    assert moved - bound == 2 * b * h * s * 128 + 2 * 4 * b * h * (s_pad // BLK) * 128
    if (b, h, s) == (2, 12, 32768):
        assert round(bound / 1e6, 1) == 906.0
