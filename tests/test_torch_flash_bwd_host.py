"""The host side of K11 and K12 (``csrc/flash_attention_bwd.cu``) on the CPU:
the row table both kernels read (``flash_bwd_rows``), the byte strides of
their tensor maps (``flash_bwd_strides``) and what the entry point
``flash_attention_bwd`` refuses.

Tolerances: the row table's lse plane is lse * log2(e) in f32, equal to
torch's own product; its di plane sums exact f32 products of bf16 values, so
it equals the di of ``attention_bwd_reference`` bit for bit and an f64 sum
within 1e-4 (an f32 sum of 128 products of unit normals); the pad rows are
exact (+inf, 0); the dq recovered from the table within rel-L2 1e-6 of
``attention_bwd_reference``'s (f32, exp2 of a product by log2(e) against exp).
"""

import math

import numpy as np
import pytest
import torch

from wanq_tpu_torch.models.attention import (
    attention_bwd_reference, flash_attention_bwd, flash_bwd_rows, flash_bwd_strides)

LOG2E = 1.4426950408889634


def _bf16(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("sq", [1, 64, 127, 128, 129, 300])
def test_row_table_pads_to_128_rows(sq):
    """[B, N, 2, Sq rounded up to 128]: lse log2e then di; the pad rows hold
    +inf (P = 0 there) and 0."""
    rng = np.random.default_rng(sq)
    lse = torch.from_numpy(rng.normal(size=(2, 3, sq)).astype(np.float32))
    o, do = _bf16(rng, (2, sq, 3, 128)), _bf16(rng, (2, sq, 3, 128))
    rows = flash_bwd_rows(lse, o, do)
    pad = -(-sq // 128) * 128
    assert rows.shape == (2, 3, 2, pad) and rows.dtype == torch.float32
    assert rows.is_contiguous()
    assert torch.equal(rows[:, :, 0, :sq], lse * LOG2E)
    assert torch.isinf(rows[:, :, 0, sq:]).all() and (rows[:, :, 0, sq:] > 0).all()
    assert not rows[:, :, 1, sq:].any()
    want = np.einsum("bsnd,bsnd->bns", o.double().numpy(), do.double().numpy())
    # an f32 sum of 128 products of N(0, 1) values: ~1e-5 of absolute error
    np.testing.assert_allclose(rows[:, :, 1, :sq].numpy(), want, rtol=1e-6, atol=1e-4)


def test_row_table_di_is_the_plain_backward_di():
    """di of the table equals the one attention_bwd_reference forms, bit for
    bit, on strided bf16 views (the products of two bf16 values are exact in
    f32), and the table on those views equals the table on contiguous
    copies."""
    rng = np.random.default_rng(3)
    b, s, n = 2, 77, 4
    fused = _bf16(rng, (b, s, 2 * n * 128))
    o = fused[..., :n * 128].view(b, s, n, 128)
    do = fused[..., n * 128:].view(b, s, n, 128)
    lse = torch.from_numpy(rng.normal(size=(b, n, s)).astype(np.float32))
    rows = flash_bwd_rows(lse, o, do)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2)  # attention_bwd_reference's
    assert torch.equal(rows[:, :, 1, :s], di)
    assert torch.equal(rows, flash_bwd_rows(lse, o.contiguous(), do.contiguous()))


def test_row_table_recovers_the_plain_backward():
    """P from the table's planes, exp2(s scale log2e - lse log2e), and dS from
    its di give attention_bwd_reference's dq (f32, rel-L2 1e-6): the table
    carries what K12 and K11 need of the forward."""
    rng = np.random.default_rng(5)
    b, sq, sk, n, d, valid, scale = 1, 40, 29, 2, 128, 25, 0.09
    q, k, v, do = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                   for sh in ((b, sq, n, d), (b, sk, n, d), (b, sk, n, d), (b, sq, n, d)))
    s = torch.einsum("bsnd,btnd->bnst", q, k) * scale
    s[..., valid:] = -math.inf
    lse = torch.logsumexp(s, -1)
    o = torch.einsum("bnst,btnd->bsnd", torch.softmax(s, -1), v)
    o_before = o.clone()
    rows = flash_bwd_rows(lse, o, do)
    assert torch.equal(o, o_before)  # f32 o: .float() is o itself, and it stays untouched
    p = torch.exp2(torch.einsum("bsnd,btnd->bnst", q, k) * (scale * LOG2E)
                   - rows[:, :, 0, :sq, None])
    p[..., valid:] = 0.0
    ds = p * (torch.einsum("bsnd,btnd->bnst", do, v) - rows[:, :, 1, :sq, None])
    dq = torch.einsum("bnst,btnd->bsnd", ds, k) * scale
    want = attention_bwd_reference(q, k, v, o, lse, do, scale, valid)[0]
    assert ((dq - want).norm() / want.norm()).item() <= 1e-6


def test_strides_of_fused_projection_views():
    """q, k, v as views of one [B, S, 3 N D] projection and a contiguous dO:
    the byte strides of (seq, head, batch) each, in that order."""
    b, s, n = 2, 50, 3
    fused = torch.zeros((b, s, 3 * n * 128), dtype=torch.bfloat16)
    q, k, v = (fused[..., i * n * 128:(i + 1) * n * 128].view(b, s, n, 128) for i in range(3))
    do = torch.zeros((b, s, n, 128), dtype=torch.bfloat16)
    row = 3 * n * 128 * 2
    assert flash_bwd_strides(q, k, v, do) == (row, 256, s * row) * 3 + (n * 256, 256,
                                                                        s * n * 256)


@pytest.mark.parametrize("b,s,n", [(1, 50, 3), (2, 1, 3), (2, 50, 1), (1, 1, 1)])
def test_strides_of_size_one_dims(b, s, n):
    """A dimension of size 1 never moves, so its byte stride is one row's
    (256 bytes) whatever the view's stride says; the others are the tensor's
    own, here of contiguous [B, S, N, 128] operands."""
    t = torch.zeros((b, s, n, 128), dtype=torch.bfloat16)
    want = tuple(256 if size == 1 else st for size, st in
                 ((s, n * 256), (n, 256), (b, s * n * 256)))
    assert flash_bwd_strides(t, t, t, t) == want * 4


@pytest.mark.parametrize("bad", ["head_dim", "row_stride", "head_stride", "base"])
def test_strides_refuse_what_tma_cannot_address(bad):
    b, s, n = 1, 8, 2
    ok = torch.zeros((b, s, n, 128), dtype=torch.bfloat16)
    if bad == "head_dim":
        t = torch.zeros((b, s, n, 256), dtype=torch.bfloat16)[..., ::2]
    elif bad == "row_stride":  # rows of n 128 + 4 elements: not a multiple of 16 bytes
        t = torch.zeros((b, s, n * 128 + 4), dtype=torch.bfloat16)[..., :n * 128]
        t = t.view(b, s, n, 128)
    elif bad == "head_stride":
        t = torch.zeros((b, s, n, 132), dtype=torch.bfloat16)[..., :128]
    else:  # a base 8 bytes past a 16-byte boundary
        t = torch.zeros((b * s * n * 128 + 4,), dtype=torch.bfloat16)[4:].view(b, s, n, 128)
    with pytest.raises(ValueError):
        flash_bwd_strides(t, ok, ok, ok)


@pytest.mark.parametrize("dq,dkv", [(True, True), (True, False), (False, True)])
def test_launch_refuses_cpu_tensors(dq, dkv):
    """The entry point takes CUDA tensors only, whichever gradients are asked
    for: no plain fallback."""
    q = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, q, q, q, lse, q, 1.0, 8, dq=dq, dkv=dkv)
