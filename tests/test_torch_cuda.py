"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (a CUDA kernel has no CPU
mode) and skips without one. This file imports no JAX, so it also runs on
a machine that has only PyTorch; the repository's conftest.py imports JAX,
so run it there as

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: K1 int8 codes may differ by one on <= 0.1% of elements
(reduction order at rounding ties), scales rtol 1e-5, scaled sums rtol 1e-4
on rows whose codes agree; K2 and K8 are exact (the
int32 sums are exact and the shared epilogue runs in the plain version's
order), and so is their GELU + quant mode (the GELU is PyTorch's expression,
the division a true one, the row sum an integer sum); K3 within
one bf16 ulp except on <= 1e-4 of elements, where the norm's f32 sum
order flips the bf16 rounding of the normalized value by one unit; K4
within rel-L2 1e-2 and 4 bf16 ulps of max|want| (bf16 P in the PV product
and online-softmax order), with the pad tail of k/v planted so that a
missed mask moves the output by far more; ``fp_linear`` on the card
within rel-L2 1e-5 of the CPU's f32 product (a bf16-rounded output would
be ~1e-3 off). K7 codes equal except <= 0.1% one-unit flips (none without
GELU; with it the kernel's tanhf and torch's may differ by ulps), scale
rtol 1e-6, sum rtol 1e-6 on rows whose codes agree; K9 exact (exact
int32 sums, and the rescale in the plain version's operation order). K10a
(the q/k/v producer) is exact: max is order-free and the division is IEEE.
K10 (int8 attention) runs its plain version's steps; the f32 sum of p is
taken in another order and expf may differ from torch.exp in the last bit,
which flips a rounded prob by one of 127 steps on rare elements: rel-L2
<= 1e-3 against the blocked plain version, and <= 1e-4 of elements further
than one step (max|want| / 127) from it. K4's band mode is held to K4's
limits against the plain version with the band mask; a stage or phase that
producer and consumers count differently hangs the card instead of failing,
so each band test waits for the card with a deadline and ends the process
past it (``_finish_within``), and so do the tests of K3's and K7's
persistent forms. K7's GELU table is held on every bf16 value bit for bit.
At the T2V-14B shapes (dim 5120, ffn 13824, 40 heads): K1 and K7 at 5120 over
ragged rows, K2 and K8 at every 14B site shape with ragged M, and K4 at 720p
(S 75776, 75600 valid) against the plain version on the q rows at both ends,
each at the limits above; ``init_params_on_device`` on the card: equal bits
per seed and a peak below the model plus twice its largest tensor. K1,
K2, K3, K4 (self and cross) and K7 give a row of a batch of 2 the bits
they give it alone. Whole generate: the full-width VAE decodes on the card
as on the CPU (f32 rel-L2 <= 1e-4, bf16 PSNR >= 35 dB), umT5's widths at 2
layers encode on the card as on the CPU (rel-L2 <= 4e-3), and
``load_wan_checkpoint`` reads every tensor straight onto the card. Training:
K4's residual mode at K4's limits with its LSE within 1e-3 (abs), K12 and K11
within rel-L2 1e-2 of ``attention_bwd_reference`` on the kernel's own output
and LSE (bf16 P and dS in their products; a floor of 1e-5 a element where a
single valid key makes dq and dk zero), dk = dv = 0 past kv_valid, two calls
of K12 and K11 equal bit for bit (no atomics), and
``attention(trainable=True)``'s launches under autograd and without it; the
K11 / K12 tests wait for the card with the deadline of the band tests. K13
(the block's gated residual update) is exact: each of its steps is one IEEE
rounding in the plain version's order, at the 1.3B update's shape and a 14B
width, one launch a call; under autograd its backward gives the plain
chain's gradients bit for bit, alone and in a training block.
"""

import math
import os
import sys
import time

import numpy as np
import pytest
import torch

from wanq_tpu_torch.ops import _lib

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


def test_k1_kernel_matches_plain(dev, gen):
    from wanq_tpu_torch.ops.fused import ln_modulate_quant_cuda, ln_modulate_quant_plain

    b, n, c = 2, 300, 1536
    x = (torch.randn((b, n, c), device=dev, generator=gen) * 2 + 0.3).bfloat16()
    shift = torch.randn((b, c), device=dev, generator=gen) * 0.5
    scale = torch.randn((b, c), device=dev, generator=gen) * 0.5
    for cs in (None, torch.rand((c,), device=dev, generator=gen) + 0.5):
        got = ln_modulate_quant_cuda(x, shift, scale, channel_scale=cs)
        want = ln_modulate_quant_plain(x, shift, scale, channel_scale=cs)
        diff = (got[0].int() - want[0].int()).abs()
        assert diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 1e-3
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k2_kernel_matches_plain_ragged_m(dev, gen, out_dtype):
    from wanq_tpu_torch.ops.qgemm import w8a8_linear_cuda, w8a8_linear_plain

    m, k, n = 333, 1536, 384
    a = torch.randint(-128, 128, (m, k), device=dev, generator=gen, dtype=torch.int8)
    w = torch.randint(-128, 128, (n, k), device=dev, generator=gen, dtype=torch.int8)
    s_a = torch.rand((m,), device=dev, generator=gen) * 0.02 + 1e-3
    s_w = torch.rand((n,), device=dev, generator=gen) * 0.02 + 1e-3
    sum_a = s_a * a.float().sum(-1)
    zp = torch.randint(-20, 20, (n,), device=dev, generator=gen).float()
    bias = torch.randn((n,), device=dev, generator=gen)
    got = w8a8_linear_cuda(a, w, s_a, s_w, sum_a, zp, bias, out_dtype)
    want = w8a8_linear_plain(a, w, s_a, s_w, sum_a, zp, bias, out_dtype)
    assert torch.equal(got, want)
    got = w8a8_linear_cuda(a, w, s_a, s_w, None, None, None, out_dtype)
    assert torch.equal(got, w8a8_linear_plain(a, w, s_a, s_w, out_dtype=out_dtype))


def _check_k3(got, want):
    g, wv = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(wv.abs().clamp_min(1e-30))) - 7)
    beyond = ((g - wv).abs() > ulp).float().mean().item()
    assert beyond <= 1e-4 and (g - wv).abs().max().item() <= 1e-2 * wv.abs().max().item()


# 12 heads (C = 1536, one warp a row), 40 (C = 5120, four warps a row), 3 (C =
# 384: lanes idle past the row); B * S no multiple of the warps of a block, so
# the groups' runs of positions are ragged
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "split"])
@pytest.mark.parametrize("b,s,n", [(2, 100, 12), (3, 301, 12), (3, 301, 40), (1, 301, 3),
                                   (1, 301, 40)])
def test_k3_kernel_matches_plain(dev, gen, b, s, n, rope):
    """K3 at the 1.3B and 14B widths and a narrow one, with the rope (the
    tables' identity tail from token s - 11 on, q-scaled as K4's q takes them)
    and without (the cross-q split), within one bf16 ulp but for <= 1e-4 of
    elements; the kernel's launch is counted."""
    from wanq_tpu_torch.models.rope import pad_tables
    from wanq_tpu_torch.ops.rmsnorm_rope import (
        rms_rope_heads, rms_rope_heads_plain, rms_split_heads, rms_split_heads_plain)

    d, valid = 128, s - 11
    x = (torch.randn((b, s, n * d), device=dev, generator=gen) * 3).bfloat16()
    w = torch.rand((n * d,), device=dev, generator=gen) + 0.5
    ang = torch.rand((valid, d // 2), device=dev, generator=gen) * 6
    ca = torch.cos(ang).repeat_interleave(2, dim=1)
    sb = torch.sin(ang).repeat_interleave(2, dim=1)
    sb[:, 0::2] *= -1
    ca, sb = (t * 0.0884 for t in pad_tables(ca, sb, valid, s))
    _lib.reset_launch_counts()
    if rope:
        got, want = rms_rope_heads(x, w, ca, sb, n), rms_rope_heads_plain(x, w, ca, sb, n)
    else:
        got, want = rms_split_heads(x, w, n), rms_split_heads_plain(x, w, n)
    _finish_within(60, f"K3 B={b} S={s} heads={n} rope={rope}")
    assert _lib.launch_counts() == {"rms_rope_heads": 1}
    assert got.shape == (b, n, s, d) and got.dtype == torch.bfloat16
    _check_k3(got, want)


def test_k3_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    """Head dim 128 only, at most 6144 channels, bf16 x, [S, 128] tables, [C]
    gains: anything else raises on a CUDA tensor (no plain fallback)."""
    from wanq_tpu_torch.ops.rmsnorm_rope import rms_rope_heads, rms_split_heads

    x = torch.zeros((1, 8, 256), device=dev).bfloat16()
    w = torch.ones((256,), device=dev)
    ca, sb = torch.ones((8, 128), device=dev), torch.zeros((8, 128), device=dev)
    wide = torch.zeros((1, 8, 6272), device=dev).bfloat16()
    bad = [
        lambda: rms_split_heads(x, w, 4),                                  # head dim 64
        lambda: rms_rope_heads(x, w, ca[:, :64], sb[:, :64], 4),
        lambda: rms_split_heads(wide, torch.ones((6272,), device=dev), 49),  # C > 6144
        lambda: rms_split_heads(x.float(), w, 2),                          # dtype
        lambda: rms_split_heads(x, w[:128], 2),                            # gains
        lambda: rms_rope_heads(x, w, ca[:4], sb[:4], 2),                   # tables
        lambda: rms_rope_heads(x, w, ca.cpu(), sb.cpu(), 2),               # CPU tables
        lambda: rms_split_heads(x, w, 2, out_dtype=torch.float32),
    ]
    for fn in bad:
        with pytest.raises(ValueError):
            fn()


def _k4_close(got, want):
    assert torch.isfinite(got.float()).all()
    g, w = got.float(), want.float()
    ulp = 2.0 ** (math.floor(math.log2(w.abs().max().item())) - 7)
    assert (g - w).abs().max().item() <= 4 * ulp
    assert ((g - w).norm() / w.norm()).item() <= 1e-2


# kv_valid on a 128-key tile boundary, one past it, a single key, ragged Sq
# and Sk, more than one ring round (valid 700 = 6 tiles over 2 stages)
@pytest.mark.parametrize("sq,sk,valid", [(300, 300, 290), (257, 77, 77), (256, 256, 128),
                                         (256, 300, 129), (130, 200, 1), (200, 384, 384),
                                         (129, 777, 700)])
def test_k4_kernel_matches_plain(dev, gen, sq, sk, valid):
    """q seq-major, k seq-major, v a strided view over [B, S, N*D]."""
    from wanq_tpu_torch.models.attention import _flash_cuda, _sdpa_reference

    b, n, d = 2, 3, 128
    q = torch.randn((b, sq, n, d), device=dev, generator=gen).bfloat16()
    k = torch.randn((b, sk, n, d), device=dev, generator=gen).bfloat16()
    v = torch.randn((b, sk, n * d), device=dev, generator=gen).bfloat16()
    k[:, valid:] = 0.0      # a missed mask would mix in v = 100
    v[:, valid:] = 100.0
    vh = v.view(b, sk, n, d)
    got = _flash_cuda(q.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 0.0884, valid)
    _k4_close(got, _sdpa_reference(q, k, vh, 0.0884, valid))


@pytest.mark.parametrize("sq,sk", [(640, 640), (300, 512)])
def test_k4_operand_layouts_match_plain(dev, gen, sq, sk):
    """The three layouts of the model: q heads-major [B, N, S, D] with v over
    [B, S, N*D] (self), q heads-major with k/v seq-major [B, Sk, N, D]
    (cross), and everything seq-major through ``attention``."""
    from wanq_tpu_torch.models.attention import (
        _sdpa_reference, attention, attention_heads_major, cross_attention_heads_major)

    b, n, d = 2, 3, 128
    qh = torch.randn((b, n, sq, d), device=dev, generator=gen).bfloat16()
    kh = torch.randn((b, n, sq, d), device=dev, generator=gen).bfloat16()
    v = torch.randn((b, sq, n * d), device=dev, generator=gen).bfloat16()
    vh = v.view(b, sq, n, d).transpose(1, 2)
    got = attention_heads_major(qh * 0.0884, kh, vh, k_valid_len=sq - 3)
    assert got.shape == (b, n, sq, d) and got.transpose(1, 2).is_contiguous()
    want = _sdpa_reference((qh * 0.0884).transpose(1, 2), kh.transpose(1, 2),
                           vh.transpose(1, 2), 1.0, sq - 3)
    _k4_close(got.transpose(1, 2), want)
    ck = torch.randn((b, sk, n, d), device=dev, generator=gen).bfloat16()
    cv = torch.randn((b, sk, n, d), device=dev, generator=gen).bfloat16()
    got = cross_attention_heads_major(qh, ck, cv)
    want = _sdpa_reference(qh.transpose(1, 2), ck, cv, 1.0 / math.sqrt(d), None)
    _k4_close(got.transpose(1, 2), want)
    qs = qh.transpose(1, 2).contiguous()
    _k4_close(attention(qs, ck, cv, k_valid_len=sk - 1),
              _sdpa_reference(qs, ck, cv, 1.0 / math.sqrt(d), sk - 1))


def test_k4_reads_v_as_it_lies(dev, gen):
    """q, k, v that are not symmetric in kv and d: each query row picks one
    key (a permutation) and v[t, c] = (7 t + 3 c) mod 251, so a V tile read
    transposed, or with its 8-row groups or 64-column halves swapped,
    returns another number."""
    from wanq_tpu_torch.models.attention import _flash_cuda

    s, d = 384, 128
    perm = torch.randperm(s, device=dev, generator=gen)
    k = torch.randn((1, 1, s, d), device=dev, generator=gen).bfloat16()
    q = (k[:, :, perm].float() * 8.0).bfloat16()       # row i scores key perm[i] far highest
    v = ((7 * torch.arange(s, device=dev)[:, None] + 3 * torch.arange(d, device=dev)[None, :])
         % 251).bfloat16().view(1, 1, s, d)
    out = _flash_cuda(q, k, v, 1.0, s)
    torch.testing.assert_close(out[0, :, 0].float(), v[0, 0, perm].float(), rtol=0, atol=0)


def test_k4_fully_masked_tail_tiles_stay_finite(dev, gen):
    """kv_valid = 1: every tile past the first is skipped and the first is
    almost all masked; no row may turn into NaN."""
    from wanq_tpu_torch.models.attention import _flash_cuda

    q = torch.randn((1, 2, 130, 128), device=dev, generator=gen).bfloat16()
    k = torch.randn((1, 2, 200, 128), device=dev, generator=gen).bfloat16()
    v = torch.randn((1, 2, 200, 128), device=dev, generator=gen).bfloat16()
    out = _flash_cuda(q, k, v, 1.0, 1)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), v[:, :, :1].transpose(1, 2).expand(1, 130, 2, 128)
                               .float(), rtol=0, atol=0)


def _finish_within(seconds: float, what: str) -> None:
    """Waits for the card's queued work. A hung kernel cannot be stopped from
    inside the process, so past the deadline the process ends (exit 124), which
    releases the card, and the run stops here instead of at its own limit."""
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > deadline:
            sys.stderr.write(f"{what}: the card did not finish within {seconds} s (hang)\n")
            sys.stderr.flush()
            os._exit(124)
        time.sleep(1e-3)


def _band_inputs(dev, gen, b, n, s, valid, plant_rows=None):
    """q, k heads-major [B, N, S, 128] and v a strided view over [B, S, N*128]
    (the main path's layouts); the pad rows of k/v are planted (k 0, v 100),
    and so are the v rows ``plant_rows`` (v 100)."""
    q = (torch.randn((b, n, s, 128), device=dev, generator=gen) * 0.0884).bfloat16()
    k = torch.randn((b, n, s, 128), device=dev, generator=gen).bfloat16()
    v = torch.randn((b, s, n * 128), device=dev, generator=gen).bfloat16()
    k[:, :, valid:] = 0.0
    v[:, valid:] = 100.0
    if plant_rows is not None:
        v[:, plant_rows] = 100.0
    return q, k, v.view(b, s, n, 128).transpose(1, 2)


# (S, tpf, radii, valid): radius 0; tpf 16, 100, 128 and 1560 (no multiple of
# 128 but one); bands that end inside a tile; valid inside the band and inside
# a tile; pad q rows; per-head radii with a head that covers every frame
@pytest.mark.parametrize("s,tpf,radii,valid", [
    (640, 16, (0, 0, 0), 640), (700, 100, (1, 1, 1), 690), (1024, 128, (0, 0, 0), 1000),
    (4700, 1560, (1, 1, 1), 4680), (900, 100, (0, 1, 9, 3), 850), (300, 100, (2, 2, 2), 300),
    (1280, 100, (0, 2, 1), 1279),
])
def test_k4_band_matches_plain(dev, gen, s, tpf, radii, valid):
    """K4's band mode against the plain version with the band mask, on the
    main path's operand layouts. The v rows that lie outside the band of
    every row of the first q tile are planted (v 100): a tile visited and
    left unmasked there moves those rows' outputs by far more than the
    limits, so the first q tile is also held on its own."""
    from wanq_tpu_torch.models.attention import (
        TemporalWindow, _flash_cuda, _sdpa_reference, temporal_band_dense_mask)

    b, n = 2, len(radii)
    win = TemporalWindow(tpf, max(radii), radii if len(set(radii)) > 1 else None)
    tile0 = temporal_band_dense_mask(128, s, win, valid, radius=max(radii), device=dev)
    outside = torch.nonzero(~tile0.any(dim=0)[:valid]).flatten()
    q, k, vh = _band_inputs(dev, gen, b, n, s, valid, plant_rows=outside)
    _lib.reset_launch_counts()
    got = _flash_cuda(q, k, vh, 1.0, valid, tokens_per_frame=tpf, radii=radii)
    _finish_within(60, f"K4 band S={s} tpf={tpf} radii={radii}")
    assert _lib.launch_counts() == {"attention_band": 1}
    want = _sdpa_reference(q.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 1.0,
                           valid, window=win, q_chunk=512)
    _k4_close(got[:, :128], want[:, :128])
    _k4_close(got, want)  # all rows, at the scale of the planted 100s
    if outside.numel():
        rows = torch.arange(s, device=dev)
        clean = ~(temporal_band_dense_mask(s, s, win, valid, device=dev)[:, outside].any(dim=1))
        _k4_close(got[:, clean & (rows < valid)], want[:, clean & (rows < valid)])
    # the pad q rows attend the whole valid prefix
    if valid < s:
        dense = _sdpa_reference(q.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 1.0,
                                valid, q_chunk=512)
        _k4_close(got[:, valid:], dense[:, valid:])


def test_k4_band_rows_fully_masked_in_a_tile_stay_finite(dev, gen):
    """tpf 100, radius 0: the q tile [128, 256) visits kv tiles 0..2, and its
    rows of frame 2 see nothing of tile 0, their first visited tile (the
    running max is still -inf there). No row may turn into NaN."""
    from wanq_tpu_torch.models.attention import TemporalWindow, _flash_cuda, _sdpa_reference

    q, k, vh = _band_inputs(dev, gen, 1, 2, 512, 512)
    got = _flash_cuda(q, k, vh, 1.0, 512, tokens_per_frame=100, radii=(0, 0))
    _finish_within(60, "K4 band, fully masked first tile")
    want = _sdpa_reference(q.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 1.0, 512,
                           window=TemporalWindow(100, 0))
    _k4_close(got, want)


def test_k4_band_through_the_wrappers(dev, gen):
    """attention_heads_major and attention launch the band mode for a window
    and the dense mode for a window that covers every frame pair; bad band
    arguments raise."""
    from wanq_tpu_torch.models.attention import (
        TemporalWindow, _flash_cuda, _sdpa_reference, attention, attention_heads_major)

    q, k, vh = _band_inputs(dev, gen, 2, 3, 640, 630)
    win = TemporalWindow(64, 2, (0, 2, 1))
    _lib.reset_launch_counts()
    got = attention_heads_major(q, k, vh, k_valid_len=630, window=win)
    seq = attention(q.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), scale=1.0,
                    k_valid_len=630, window=win)
    wide = attention_heads_major(q, k, vh, k_valid_len=630, window=TemporalWindow(64, 9))
    _finish_within(60, "K4 band through the wrappers")
    assert _lib.launch_counts() == {"attention_band": 2, "attention": 1}
    want = _sdpa_reference(q.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 1.0, 630,
                           window=win)
    _k4_close(got.transpose(1, 2), want)
    _k4_close(seq, want)
    _k4_close(wide.transpose(1, 2), _sdpa_reference(q.transpose(1, 2), k.transpose(1, 2),
                                                    vh.transpose(1, 2), 1.0, 630))
    d64 = torch.zeros((1, 2, 128, 64), device=dev, dtype=torch.bfloat16)
    many = torch.zeros((1, 65, 128, 128), device=dev, dtype=torch.bfloat16)
    for fn in (lambda: _flash_cuda(d64, d64, d64, 1.0, 128, tokens_per_frame=16, radii=(1, 1)),
               lambda: _flash_cuda(many, many, many, 1.0, 128, tokens_per_frame=16,
                                   radii=(1,) * 65),
               lambda: _flash_cuda(q, k, vh, 1.0, 630, tokens_per_frame=16, radii=(1, 1)),
               lambda: _flash_cuda(q, k, vh, 1.0, 630, tokens_per_frame=0, radii=(1, 1, 1)),
               lambda: _flash_cuda(q, k, vh, 1.0, 630, tokens_per_frame=16, radii=(1, -1, 1))):
        with pytest.raises(ValueError):
            fn()


def _check_partial(got, want):
    """K4's partial mode against ``ring.partial_attention_plain``: rows that
    see a key at K4's limits with their LSE within 1e-3; rows that see none
    exactly 0 and -inf."""
    (o, lse), (o_w, lse_w) = got, want
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    empty = torch.isneginf(lse_w)
    assert torch.equal(torch.isneginf(lse), empty) and not torch.isnan(lse).any()
    assert (o.float().transpose(1, 2)[empty] == 0).all()
    seen = ~empty
    if seen.any():
        _k4_close(o.transpose(1, 2)[seen], o_w.transpose(1, 2)[seen])
        assert (lse[seen] - lse_w[seen]).abs().max().item() <= 1e-3


# (Sq, Sk, q_offset, kv_offset, kv_len, tpf, radius): offsets inside a tile and
# a frame, dense and banded; a shard of pad q rows only; radius 0; a shard the
# band meets in one frame (most rows empty); a shard it misses (every q tile
# visits no tile)
@pytest.mark.parametrize("case", [
    (300, 400, 1000, 77, 1300, 0, None), (300, 400, 1033, 905, 2000, 100, 1),
    (256, 384, 2000, 1800, 1990, 100, 1), (640, 640, 640, 0, 1280, 128, 0),
    (512, 512, 0, 600, 1200, 100, 1), (256, 256, 0, 1000, 1256, 100, 1),
    (129, 777, 4000, 3500, 4100, 1560, 1)],
    ids=["dense_mid_tile", "band_mid_frame", "pad_q_shard", "radius0", "band_meets_one_frame",
         "band_misses_shard", "tpf1560"])
def test_k4_partial_mode_matches_plain(dev, gen, case):
    """One ring hop (K4's partial mode, counter attention_partial) against
    ring._partial_attn's fold from the empty state, on the main path's
    layouts (q heads-major, k/v heads-major views of the rotating shards);
    pad k/v rows (past kv_len) planted."""
    from wanq_tpu_torch.models.attention import TemporalWindow, flash_partial
    from wanq_tpu_torch.parallel.ring import partial_attention_plain

    sq, sk, q_off, kv_off, kv_len, tpf, radius = case
    b, n = 2, 3
    q = (torch.randn((b, n, sq, 128), device=dev, generator=gen) * 0.0884).bfloat16()
    k = torch.randn((b, n, sk, 128), device=dev, generator=gen).bfloat16()
    v = torch.randn((b, n, sk, 128), device=dev, generator=gen).bfloat16()
    valid = min(sk, kv_len - kv_off)
    k[:, :, valid:] = 0.0
    v[:, :, valid:] = 100.0
    win = None if radius is None else TemporalWindow(tpf, radius)
    _lib.reset_launch_counts()
    got = flash_partial(q, k, v, 1.0, q_off, kv_off, kv_len, window=win)
    _finish_within(60, f"K4 partial {case}")
    assert _lib.launch_counts() == {"attention_partial": 1}
    want = partial_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 1.0,
                                   q_off, kv_off, kv_len, win, q_chunk=256)
    _check_partial(got, want)


@pytest.mark.parametrize("radius", [None, 0, 1], ids=["dense", "r0", "r1"])
def test_ring_hops_fold_to_one_k4_launch(dev, gen, radius):
    """Four virtual ranks of a 1024-token sequence (1000 valid, frames of 100):
    every rank's hops, skipped where hop_visits says so (band-distant shards,
    the last rank's pad rows see every valid shard), folded by LSE, equal one
    dense or banded K4 launch over the whole sequence; empty rows weigh zero
    (no NaN), and a shard without a valid key is refused by the kernel's
    wrapper and never launched."""
    from wanq_tpu_torch.models.attention import TemporalWindow, _flash_cuda, flash_partial
    from wanq_tpu_torch.parallel import ring

    s, valid, n = 1024, 1000, 4
    q, k, vh = _band_inputs(dev, gen, 1, 2, s, valid)
    win = None if radius is None else TemporalWindow(100, radius)
    band = None if win is None else (100, radius)
    whole = _flash_cuda(q, k, vh, 1.0, valid,
                        **({} if win is None else {"tokens_per_frame": 100, "radii": (radius,) * 2}))
    s_loc = s // n
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, vh))
    out, hops = [], 0
    for idx in range(n):
        acc = None
        for src in range(n):
            if not ring.hop_visits(idx * s_loc, s_loc, src * s_loc, s_loc, valid, band):
                continue
            hops += 1
            sl = slice(src * s_loc, (src + 1) * s_loc)
            acc = ring.fold_partial(acc, *ring.partial_attention(
                qs[:, idx * s_loc:(idx + 1) * s_loc], ks[:, sl], vs[:, sl], 1.0, idx * s_loc,
                src * s_loc, valid, win))
        out.append(acc[0])
    _finish_within(60, f"ring hops radius {radius}")
    _k4_close(torch.cat(out, dim=1).bfloat16(), whole)
    assert hops < n * n if radius == 0 else hops <= n * n
    with pytest.raises(ValueError):
        flash_partial(q[:, :, :256], k[:, :, 768:], vh[:, :, 768:], 1.0, 0, 1000, 1000)


def test_fp_linear_on_card_keeps_the_f32_accumulator(dev, gen):
    from wanq_tpu_torch.quant.qlinear import fp_linear

    x = torch.randn((2, 300, 1536), device=dev, generator=gen)
    p = {"w": torch.randn((1536, 640), device=dev, generator=gen).bfloat16() * 0.03,
         "b": torch.randn((640,), device=dev, generator=gen)}
    got = fp_linear(p, x)
    want = fp_linear({k: t.cpu() for k, t in p.items()}, x.cpu())
    assert got.dtype == torch.float32
    assert ((got.cpu() - want).norm() / want.norm()).item() <= 1e-5


# the 1.3B dim and ffn width (one warp a row; six warps), the 14B dim and ffn
# width (four and nine warps a row)
@pytest.mark.parametrize("c", [1536, 8960, 5120, 13824])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k7_kernel_matches_plain(dev, gen, c, dtype):
    from wanq_tpu_torch.ops.fused import quant_sum_cuda, quant_sum_plain

    m = 301  # ragged: no multiple of anything
    x = (torch.randn((m, c), device=dev, generator=gen) * 2 + 0.2).to(dtype)
    x[5] = 0.0
    for gelu in (False, True):
        for cs in (None, torch.rand((c,), device=dev, generator=gen) + 0.5):
            got = quant_sum_cuda(x, gelu, cs)
            want = quant_sum_plain(x, gelu, cs)
            diff = (got[0].int() - want[0].int()).abs()
            assert diff.max().item() <= (1 if gelu else 0)
            assert (diff > 0).float().mean().item() <= 1e-3
            torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
            same = diff.amax(dim=-1) == 0
            torch.testing.assert_close(got[2][same], want[2][same], rtol=1e-6, atol=0)
    got = quant_sum_cuda(x.reshape(7, 43, c), True)
    _finish_within(60, f"K7 C={c} {dtype}")
    assert got[0].shape == (7, 43, c) and got[1].shape == (7, 43)


def test_k7_gelu_table_on_every_bf16_value(dev):
    """K7 takes the GELU of a bf16 x from a table of 1 + tanh(inner) built with
    the kernels' own gelu_tanh_factor, and from the identities f = 1, 2, 0 past
    its range: all 65536 bf16 values, NaNs and infinities included, give
    gelu_tanh's bits exactly (a NaN may only meet a NaN)."""
    from wanq_tpu_torch.ops.fused import gelu_bf16_table_check

    _lib.reset_launch_counts()
    table, direct = gelu_bf16_table_check(dev)
    _finish_within(60, "K7 GELU table check")
    assert _lib.launch_counts() == {"gelu_bf16_check": 1}
    nan = torch.isnan(direct)
    assert torch.equal(torch.isnan(table), nan) and nan.sum().item() == 254 + 1  # -inf too
    assert torch.equal(table[~nan].view(torch.int32), direct[~nan].view(torch.int32))


def test_k7_wrapper_raises_on_rows_wider_than_it_holds(dev):
    from wanq_tpu_torch.ops.fused import quant_sum_cuda

    for c, dtype in ((18440, torch.bfloat16), (20000, torch.bfloat16), (13828, torch.float32)):
        with pytest.raises(ValueError):
            quant_sum_cuda(torch.zeros((2, c), device=dev, dtype=dtype))
    got = quant_sum_cuda(torch.ones((3, 18432), device=dev).bfloat16(), gelu=True)
    _finish_within(60, "K7 C=18432")
    assert torch.equal(got[0], torch.full((3, 18432), 127, dtype=torch.int8, device=dev))


@pytest.mark.parametrize("m", [333, 1024 + 3])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k8_kernel_matches_plain_ragged_m(dev, gen, m, out_dtype):
    from wanq_tpu_torch.ops.qgemm import w4a8_linear_cuda, w4a8_linear_plain

    k, n = 1536, 384
    a = torch.randint(-128, 128, (m, k), device=dev, generator=gen, dtype=torch.int8)
    wp = torch.randint(-128, 128, (n, k // 2), device=dev, generator=gen, dtype=torch.int8)
    s_a = torch.rand((m,), device=dev, generator=gen) * 0.02 + 1e-3
    s_w = torch.rand((n,), device=dev, generator=gen) * 0.02 + 1e-3
    sum_a = s_a * a.float().sum(-1)
    zp = torch.randint(-8, 8, (n,), device=dev, generator=gen).float()
    bias = torch.randn((n,), device=dev, generator=gen)
    got = w4a8_linear_cuda(a, wp, s_a, s_w, sum_a, zp, bias, out_dtype)
    assert torch.equal(got, w4a8_linear_plain(a, wp, s_a, s_w, sum_a, zp, bias, out_dtype))
    got = w4a8_linear_cuda(a, wp, s_a, s_w, None, None, None, out_dtype)
    assert torch.equal(got, w4a8_linear_plain(a, wp, s_a, s_w, out_dtype=out_dtype))


@pytest.mark.parametrize("m", [333, 1024 + 3])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k9_kernel_matches_plain_ragged_m(dev, gen, m, out_dtype):
    from wanq_tpu_torch.ops.qgemm import w4a4_linear_cuda, w4a4_linear, w4a4_linear_plain

    k, n = 1536, 384
    a = torch.randint(-8, 8, (m, k), device=dev, generator=gen, dtype=torch.int8)
    wp = torch.randint(-128, 128, (n, k // 2), device=dev, generator=gen, dtype=torch.int8)
    s_a = torch.rand((m, k // 128), device=dev, generator=gen) * 0.02 + 1e-3
    s_w = torch.rand((k // 128, n), device=dev, generator=gen) * 0.02 + 1e-3
    bias = torch.randn((n,), device=dev, generator=gen)
    for b in (bias, None):
        got = w4a4_linear_cuda(a, wp, s_a, s_w, b, 128, out_dtype)
        assert torch.equal(got, w4a4_linear_plain(a, wp, s_a, s_w, b, 128, out_dtype))
    x = torch.randn((m, k), device=dev, generator=gen).bfloat16()
    got = w4a4_linear(x, wp, s_w, bias)
    want = w4a4_linear(x.cpu(), wp.cpu(), s_w.cpu(), bias.cpu())
    assert torch.equal(got.cpu(), want)


def _k2_operands(dev, gen, m, k, n):
    a = torch.randint(-128, 128, (m, k), device=dev, generator=gen, dtype=torch.int8)
    w = torch.randint(-128, 128, (n, k), device=dev, generator=gen, dtype=torch.int8)
    s_a = torch.rand((m,), device=dev, generator=gen) * 0.02 + 1e-3
    s_w = torch.rand((n,), device=dev, generator=gen) * 0.02 / k ** 0.5 + 1e-5
    sum_a = s_a * a.float().sum(-1)
    zp = torch.randint(-20, 20, (n,), device=dev, generator=gen).float()
    bias = torch.randn((n,), device=dev, generator=gen)
    return a, w, s_a, s_w, sum_a, zp, bias


@pytest.mark.parametrize("m", [50, 333, 1024 + 3])
@pytest.mark.parametrize("k,n", [(64, 128), (192, 512), (320, 384), (1536, 1536)])
def test_k2_tiles_k_tails_and_small_m(dev, gen, m, k, n):
    """Both tile widths (N of 128 and 384 take the 128-wide tile, 512 and
    1536 the 256-wide one), M below one tile and ragged, K = 64 * odd (the
    last 128-byte K step is half outside the matrix and loads as zeros), with
    and without the optional operands: exact."""
    from wanq_tpu_torch.ops.qgemm import w8a8_linear_cuda, w8a8_linear_plain

    a, w, s_a, s_w, sum_a, zp, bias = _k2_operands(dev, gen, m, k, n)
    for out_dtype in (torch.float32, torch.bfloat16):
        want = w8a8_linear_plain(a, w, s_a, s_w, sum_a, zp, bias, out_dtype)
        want_bare = w8a8_linear_plain(a, w, s_a, s_w, bias=bias, out_dtype=out_dtype)
        got = w8a8_linear_cuda(a, w, s_a, s_w, sum_a, zp, bias, out_dtype)
        assert torch.equal(got, want), out_dtype
        got = w8a8_linear_cuda(a, w, s_a, s_w, bias=bias, out_dtype=out_dtype)
        assert torch.equal(got, want_bare), out_dtype


def _check_gelu_quant(got, want, scale2):
    """Codes equal; the row sums are exactly the sums of the kernel's own
    codes; s2 and sm2 as the plain version computes them from those codes."""
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], scale2 * got[0].float().sum(-1))
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("m", [50, 333, 1024 + 3])
@pytest.mark.parametrize("k,n", [(192, 1152), (1152, 256), (192, 384), (192, 1024)])
def test_k2_gelu_quant_mode_matches_plain_chain(dev, gen, m, k, n):
    """K2's GELU + quant mode against the plain chain (GEMM with a bf16
    output, tanh-GELU in f32, static-scale int8 quant, row sum) at both tile
    widths (N of 256 and 1024: 256 wide; 384 and 1152: 128 wide), with and
    without zp_w / bias (the straight-line and the general
    epilogue), with scales inside and outside the range of the branch-free
    division: codes, scales and sums exact. The int32 row sums are zeroed for
    every call: a second call gives the same sums."""
    from wanq_tpu_torch.ops.qgemm import (
        w8a8_linear_gelu_quant_cuda, w8a8_linear_gelu_quant_plain)

    a, w, s_a, s_w, sum_a, zp, bias = _k2_operands(dev, gen, m, k, n)
    for scale in (0.03, 1e-14, 3e7):
        scale2 = torch.tensor(scale, device=dev)
        for opt in ((sum_a, zp, bias), (None, None, bias), (None, None, None)):
            want = w8a8_linear_gelu_quant_plain(a, w, s_a, s_w, scale2, *opt)
            got = w8a8_linear_gelu_quant_cuda(a, w, s_a, s_w, scale2, *opt)
            _check_gelu_quant(got, want, scale2)
            again = w8a8_linear_gelu_quant_cuda(a, w, s_a, s_w, scale2, *opt)
            assert torch.equal(again[2], got[2])
    got = w8a8_linear_gelu_quant_cuda(a.reshape(1, m, k), w, s_a.reshape(1, m), s_w,
                                      torch.tensor(0.03, device=dev), bias=bias)
    assert got[0].shape == (1, m, n) and got[1].shape == got[2].shape == (1, m)


def _every_bf16_as_bias(dev, pad):
    """Operands that make K2's dequantized h run over every finite bf16
    value: A = 0, so h is the bias, and the bias holds all 65280 finite bf16
    patterns (255 tiles of 256) plus ``pad`` zeros (pad = 128: 511 tiles of
    128). Returns (a, w, s_a, s_w, opts): opts[0] has zp_w and bias (the
    straight-line epilogue where the scale allows it), opts[1] the bias alone
    (the general epilogue)."""
    bits = torch.arange(65536, device=dev, dtype=torch.int32).to(torch.int16)
    vals = bits.view(torch.bfloat16).float()
    vals = vals[torch.isfinite(vals)]
    assert vals.numel() == 65280
    vals = torch.cat([vals, torch.zeros((pad,), device=dev)])
    n = vals.numel()
    a = torch.zeros((20, 64), dtype=torch.int8, device=dev)
    w = torch.ones((n, 64), dtype=torch.int8, device=dev)
    s_a, s_w = torch.ones((20,), device=dev), torch.ones((n,), device=dev)
    opts = ((torch.zeros((20,), device=dev), torch.zeros((n,), device=dev), vals),
            (None, None, vals))
    return a, w, s_a, s_w, opts


@pytest.mark.parametrize("pad", [0, 128])
@pytest.mark.parametrize("scale", [0.02, 0.4])
def test_k2_gelu_quant_epilogue_on_every_bf16_value(dev, scale, pad):
    """The epilogue's chain behind the GEMM (bf16 h -> GELU -> division ->
    code) on every finite bf16 value, at both tile widths: exact, in the
    straight-line epilogue (branch-free division) and the general one."""
    from wanq_tpu_torch.ops.qgemm import (
        w8a8_linear_gelu_quant_cuda, w8a8_linear_gelu_quant_plain)

    a, w, s_a, s_w, opts = _every_bf16_as_bias(dev, pad)
    scale2 = torch.tensor(scale, device=dev)
    for opt in opts:
        want = w8a8_linear_gelu_quant_plain(a, w, s_a, s_w, scale2, *opt)
        assert want[0].unique().numel() > 100  # the codes do span the range
        got = w8a8_linear_gelu_quant_cuda(a, w, s_a, s_w, scale2, *opt)
        _check_gelu_quant(got, want, scale2)


def test_k2_branch_free_division_over_its_range_of_scales(dev):
    """The straight-line epilogue divides without div.rn's branch for scales
    in [2**-40, 2**20] and must round as the true division does for every one
    of them, not only the calibrated ones: 300 scales spread log-uniformly
    over that range, its two ends, and values just outside it (which take the
    general epilogue), each on every finite bf16 value of h. The codes of the
    straight-line epilogue, of the general one (__fdiv_rn) and of the plain
    chain are equal."""
    from wanq_tpu_torch.ops.qgemm import (
        w8a8_linear_gelu_quant_cuda, w8a8_linear_gelu_quant_plain)

    a, w, s_a, s_w, opts = _every_bf16_as_bias(dev, 0)
    rng = np.random.default_rng(5)
    scales = np.concatenate([
        np.exp2(rng.uniform(-40.0, 20.0, size=300)),
        np.exp2([-40.0, 20.0]),
        np.exp2([-40.0, 20.0]) * [1 + 2.0 ** -20, 1 - 2.0 ** -20],  # just inside
        np.exp2([-40.0, 20.0]) * [1 - 2.0 ** -20, 1 + 2.0 ** -20],  # just outside
        np.exp2([-41.0, -60.0, 21.0, 40.0]),
    ]).astype(np.float32)
    for scale in scales:
        scale2 = torch.tensor(scale, device=dev)
        fast = w8a8_linear_gelu_quant_cuda(a, w, s_a, s_w, scale2, *opts[0])
        general = w8a8_linear_gelu_quant_cuda(a, w, s_a, s_w, scale2, *opts[1])
        want = w8a8_linear_gelu_quant_plain(a, w, s_a, s_w, scale2, *opts[1])
        assert torch.equal(fast[0], general[0]), float(scale)
        assert torch.equal(fast[2], general[2]), float(scale)
        _check_gelu_quant(general, want, scale2)


def _k8_operands(dev, gen, m, k, n):
    a = torch.randint(-128, 128, (m, k), device=dev, generator=gen, dtype=torch.int8)
    wp = torch.randint(-128, 128, (n, k // 2), device=dev, generator=gen, dtype=torch.int8)
    s_a = torch.rand((m,), device=dev, generator=gen) * 0.02 + 1e-3
    s_w = torch.rand((n,), device=dev, generator=gen) * 0.2 / k ** 0.5 + 1e-4
    sum_a = s_a * a.float().sum(-1)
    zp = torch.randint(0, 16, (n,), device=dev, generator=gen).float()
    bias = torch.randn((n,), device=dev, generator=gen)
    return a, wp, s_a, s_w, sum_a, zp, bias


@pytest.mark.parametrize("m", [1, 127, 129, 1024 + 3])
@pytest.mark.parametrize("k,n", [(128, 128), (128, 384), (384, 256), (8960, 640), (1536, 1536)])
def test_k8_all_modes_tiles_and_ragged_m(dev, gen, m, k, n):
    """K8 in its three modes at both tile widths (N = 128 * odd: the 128-wide
    tile; N = 256 * k: the 256-wide one), one K step and the paths' K, M of one
    row, one row short of a tile, one past it and ragged, with and without
    zp_w / bias: f32 and bf16 outputs equal; in the GELU + quant mode codes,
    s2 and sm2 equal and the row sums those of the kernel's own codes, with
    scales inside and outside the branch-free division's range."""
    from wanq_tpu_torch.ops.qgemm import (
        w4a8_linear_cuda, w4a8_linear_gelu_quant_cuda, w4a8_linear_gelu_quant_plain,
        w4a8_linear_plain)

    a, wp, s_a, s_w, sum_a, zp, bias = _k8_operands(dev, gen, m, k, n)
    opts = ((sum_a, zp, bias), (None, None, bias), (None, None, None))
    for out_dtype in (torch.float32, torch.bfloat16):
        for opt in opts:
            got = w4a8_linear_cuda(a, wp, s_a, s_w, *opt, out_dtype)
            assert torch.equal(got, w4a8_linear_plain(a, wp, s_a, s_w, *opt, out_dtype)), out_dtype
    for scale in (0.03, 1e-14, 3e7):
        scale2 = torch.tensor(scale, device=dev)
        for opt in opts:
            want = w4a8_linear_gelu_quant_plain(a, wp, s_a, s_w, scale2, *opt)
            got = w4a8_linear_gelu_quant_cuda(a, wp, s_a, s_w, scale2, *opt)
            _check_gelu_quant(got, want, scale2)
    again = w4a8_linear_gelu_quant_cuda(a, wp, s_a, s_w, scale2, *opts[-1])
    assert torch.equal(again[2], got[2])  # the int32 row sums are zeroed for every call
    got = w4a8_linear_gelu_quant_cuda(a.reshape(1, m, k), wp, s_a.reshape(1, m), s_w,
                                      torch.tensor(0.03, device=dev), bias=bias)
    assert got[0].shape == (1, m, n) and got[1].shape == got[2].shape == (1, m)


def test_k8_full_m_ragged_tail(dev, gen):
    """M = 65536 - 5 rows (the paths' M, ragged) against K = 1536 -> N = 256:
    every persistent block walks several tiles and the last tile is ragged."""
    from wanq_tpu_torch.ops.qgemm import (
        w4a8_linear_cuda, w4a8_linear_gelu_quant_cuda, w4a8_linear_gelu_quant_plain,
        w4a8_linear_plain)

    m = 65536 - 5
    a, wp, s_a, s_w, sum_a, zp, bias = _k8_operands(dev, gen, m, 1536, 256)
    got = w4a8_linear_cuda(a, wp, s_a, s_w, sum_a, zp, bias, torch.bfloat16)
    assert torch.equal(got, w4a8_linear_plain(a, wp, s_a, s_w, sum_a, zp, bias, torch.bfloat16))
    scale2 = torch.tensor(0.05, device=dev)
    _check_gelu_quant(w4a8_linear_gelu_quant_cuda(a, wp, s_a, s_w, scale2, sum_a, zp, bias),
                      w4a8_linear_gelu_quant_plain(a, wp, s_a, s_w, scale2, sum_a, zp, bias),
                      scale2)


@pytest.mark.parametrize("pad", [0, 128])
@pytest.mark.parametrize("scale", [0.02, 0.4])
def test_k8_gelu_quant_epilogue_on_every_bf16_value(dev, scale, pad):
    """As test_k2_gelu_quant_epilogue_on_every_bf16_value, through K8: A = 0,
    so h is the bias, which runs over all 65280 finite bf16 patterns, at both
    tile widths, in the straight-line and the general epilogue: exact."""
    from wanq_tpu_torch.ops.qgemm import (
        w4a8_linear_gelu_quant_cuda, w4a8_linear_gelu_quant_plain)

    a, w, s_a, s_w, opts = _every_bf16_as_bias(dev, pad)
    a = torch.zeros((20, 128), dtype=torch.int8, device=dev)
    wp = torch.full((w.shape[0], 64), 0x11, dtype=torch.int8, device=dev)  # every code 1
    scale2 = torch.tensor(scale, device=dev)
    for opt in opts:
        want = w4a8_linear_gelu_quant_plain(a, wp, s_a, s_w, scale2, *opt)
        assert want[0].unique().numel() > 100
        got = w4a8_linear_gelu_quant_cuda(a, wp, s_a, s_w, scale2, *opt)
        _check_gelu_quant(got, want, scale2)


def test_k8_extreme_codes_do_not_overflow_the_scaled_sum(dev):
    """The kernel sums 16 x the weight codes: at K = 8960 with every product
    at its extreme (-128 * -8 and -128 * 7) the int32 tile holds 16 * acc
    exactly and the shift gives acc back."""
    from wanq_tpu_torch.ops.qgemm import w4a8_linear_cuda, w4a8_linear_plain

    k, n, m = 8960, 128, 130
    a = torch.full((m, k), -128, dtype=torch.int8, device=dev)
    wp = torch.full((n, k // 2), 0x88 - 256, dtype=torch.int8, device=dev)  # every code -8
    wp[1::2] = 0x77                                                          # every code 7
    s_a, s_w = torch.ones((m,), device=dev), torch.ones((n,), device=dev)
    got = w4a8_linear_cuda(a, wp, s_a, s_w)
    assert torch.equal(got, w4a8_linear_plain(a, wp, s_a, s_w))
    assert got[0, 0].item() == 128.0 * 8 * k and got[0, 1].item() == -128.0 * 7 * k


def _check_k1(got, want):
    diff = (got[0].int() - want[0].int()).abs()
    assert diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 1e-3
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    same = diff.amax(dim=-1) == 0
    torch.testing.assert_close(got[2][same], want[2][same], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("with_cs", [False, True], ids=["nocs", "cs"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [64, 1536, 3072, 5120])
def test_k1_kernel_forms_match_plain(dev, gen, c, dtype, with_cs):
    """K1 at C = 64 (most lanes idle), 1536 (one warp a row), 3072 (two warps
    a row) and 5120 (four warps a row), both input types, with and without
    channel_scale; B = 3 batch rows of 301 tokens, so tiles straddle batch
    boundaries and the last tile of each batch row is ragged. One row of
    zeros (s = 1e-6, codes 0) and a batch row whose scales leave the
    branch-free division's range (an outlier channel modulated by 3e8: s >
    2**20, the true division)."""
    from wanq_tpu_torch.ops.fused import ln_modulate_quant_cuda, ln_modulate_quant_plain

    b, n = 3, 301
    x = (torch.randn((b, n, c), device=dev, generator=gen) * 2 + 0.3).to(dtype)
    shift = torch.randn((b, c), device=dev, generator=gen) * 0.5
    scale = torch.randn((b, c), device=dev, generator=gen) * 0.5
    x[1, 7] = 0.0
    shift[1] = 0.0       # the zero row stays zero after the modulation
    x[2, :, 0] = 50.0    # batch row 2: an outlier channel, |ln| >= 5 at every width,
    scale[2, 0] = 3e8    # modulated by 3e8: s = absmax / 127 > 1e7 > 2**20
    cs = torch.rand((c,), device=dev, generator=gen) + 0.5 if with_cs else None
    got = ln_modulate_quant_cuda(x, shift, scale, channel_scale=cs)
    want = ln_modulate_quant_plain(x, shift, scale, channel_scale=cs)
    _check_k1(got, want)
    assert got[1][1, 7].item() == np.float32(1e-6) and not got[0][1, 7].any()
    assert got[2][1, 7].item() == 0.0
    assert got[1][2].min().item() > 2.0 ** 20


def test_k1_single_rows_and_many_batches(dev, gen):
    """N = 1 with B = 37: every tile holds one valid row and every block
    restages its modulation for each tile."""
    from wanq_tpu_torch.ops.fused import ln_modulate_quant_cuda, ln_modulate_quant_plain

    for c in (1536, 3072, 5120):
        x = torch.randn((37, 1, c), device=dev, generator=gen).bfloat16()
        shift = torch.randn((37, c), device=dev, generator=gen)
        scale = torch.randn((37, c), device=dev, generator=gen)
        _check_k1(ln_modulate_quant_cuda(x, shift, scale),
                  ln_modulate_quant_plain(x, shift, scale))


@pytest.mark.parametrize("m", [50, 333, 1024 + 3])
@pytest.mark.parametrize("k,n", [(128, 128), (384, 256), (1536, 384)])
def test_k9_groups_and_small_m(dev, gen, m, k, n):
    """One group, an odd number of groups (the two accumulator sets take
    turns) and the path's K; M below one tile and ragged; both out types,
    with and without bias: exact."""
    from wanq_tpu_torch.ops.qgemm import w4a4_linear_cuda, w4a4_linear_plain

    a = torch.randint(-8, 8, (m, k), device=dev, generator=gen, dtype=torch.int8)
    wp = torch.randint(-128, 128, (n, k // 2), device=dev, generator=gen, dtype=torch.int8)
    s_a = torch.rand((m, k // 128), device=dev, generator=gen) * 0.02 + 1e-3
    s_w = torch.rand((k // 128, n), device=dev, generator=gen) * 0.02 + 1e-3
    bias = torch.randn((n,), device=dev, generator=gen)
    for out_dtype in (torch.float32, torch.bfloat16):
        for b in (bias, None):
            got = w4a4_linear_cuda(a, wp, s_a, s_w, b, 128, out_dtype)
            assert torch.equal(got, w4a4_linear_plain(a, wp, s_a, s_w, b, 128, out_dtype))


def test_k2_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    """K must be a multiple of 64 (rows of 16-byte multiples for the tensor
    map, and the contract of the first kernel), N of 128, operands 16-byte
    aligned."""
    from wanq_tpu_torch.ops.qgemm import w8a8_linear_cuda, w8a8_linear_gelu_quant_cuda

    a = torch.zeros((5, 128), dtype=torch.int8, device=dev)
    w = torch.zeros((384, 128), dtype=torch.int8, device=dev)
    s, sw = torch.ones((5,), device=dev), torch.ones((384,), device=dev)
    sc = torch.tensor(0.1, device=dev)
    odd = torch.zeros((5 * 128 + 1,), dtype=torch.int8, device=dev)[1:].view(5, 128)
    bad = [
        lambda: w8a8_linear_cuda(a[:, :96].contiguous(), w[:, :96].contiguous(), s, sw),  # K % 64
        lambda: w8a8_linear_cuda(a, w[:200].contiguous(), s, sw[:200]),                   # N % 128
        lambda: w8a8_linear_cuda(odd, w, s, sw),                                          # alignment
        lambda: w8a8_linear_cuda(a, w, s, sw, out_dtype=torch.float16),
        lambda: w8a8_linear_gelu_quant_cuda(a, w[:200].contiguous(), s, sw[:200], sc),    # N % 128
        lambda: w8a8_linear_gelu_quant_cuda(a, w, s, sw, sc.cpu()),
        lambda: w8a8_linear_gelu_quant_cuda(a, w, s, sw, sc, zp_w=sw),                    # no sum_a
    ]
    for fn in bad:
        with pytest.raises(ValueError):
            fn()


@pytest.mark.parametrize("yaml", ["wan_w8a8_speed.yaml", "wan_w4a8_mixed.yaml",
                                  "wan_w4a4.yaml"])
def test_ptq_state_on_card_equals_cpu(dev, yaml):
    """PTQ on the card gives the CPU's state bit for bit. PyTorch's CUDA
    kernels multiply by the reciprocal when dividing by a Python scalar,
    one ulp off the reference's division for some inputs; the quantizers
    divide by a device tensor (ops.fused.true_div) instead."""
    import os

    from wanq_tpu_torch.configs import tiny_config
    from wanq_tpu_torch.models.dit import init_params, linear_layer_names
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state

    cfg = tiny_config(dim=256, num_heads=2, ffn_dim=512, text_dim=64, freq_dim=64,
                      param_dtype="bfloat16")
    qcfg = QuantConfig.from_yaml(os.path.join(os.path.dirname(__file__), "..",
                                              "quant_configs", yaml))
    rng = np.random.default_rng(0)
    calib = {}  # min/max of the static ffn.2 inputs (the only static sites)
    for name in linear_layer_names(cfg):
        if name.endswith("ffn.2"):
            calib[f"{name}.act_max"] = np.abs(rng.normal(size=(1, 512))).astype(np.float32)
            calib[f"{name}.act_min"] = -np.abs(rng.normal(size=(1, 512))).astype(np.float32)
    p_cpu = init_params(cfg, 1, device="cpu")
    _, st_cpu, _ = prepare_quant_state(p_cpu, linear_layer_names(cfg), qcfg, calib=calib)
    _, st_dev, _ = prepare_quant_state(init_params(cfg, 1, device=dev),
                                       linear_layer_names(cfg), qcfg, calib=calib)
    assert sorted(st_cpu) == sorted(st_dev)
    for name, st in st_cpu.items():
        for key, val in st.items():
            assert torch.equal(st_dev[name][key].cpu(), val), (name, key)


def _codes_close(got, want, what, flip_frac=1e-3):
    """int codes equal except one-unit flips on <= flip_frac."""
    diff = (got.int() - want.int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() <= flip_frac, what


@pytest.mark.parametrize("dim", [96, 256])
def test_viditq_state_on_card_equals_cpu(dev, dim):
    """config.yaml (ViDiT-Q W8A8 on q/k/v) made on the card against the CPU:
    the f64 weight rotation, the mask (torch.pow on the card may differ by
    an ulp: rel <= 1e-6) and the double fake-quant; codes equal except
    one-unit flips on <= 1e-3 of them, scales rel <= 1e-6, w_q within one
    step where a code flipped; the rotations equal (dim 96: base order 12,
    a K x K f64 product on the card; 256: butterflies only)."""
    import os

    from wanq_tpu_torch.configs import tiny_config
    from wanq_tpu_torch.models.dit import init_params, linear_layer_names
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state

    cfg = tiny_config(dim=dim, num_heads=2, ffn_dim=2 * dim, param_dtype="bfloat16")
    qcfg = QuantConfig.from_yaml(os.path.join(os.path.dirname(__file__), "..",
                                              "quant_configs", "config.yaml"))
    rng = np.random.default_rng(1)
    calib = {n: np.abs(rng.normal(size=(2, dim))).astype(np.float32)
             for n in linear_layer_names(cfg) if ".self_attn." in n}
    p_cpu = init_params(cfg, 1, device="cpu")
    _, st_cpu, rot_cpu = prepare_quant_state(p_cpu, linear_layer_names(cfg), qcfg, calib=calib)
    _, st_dev, rot_dev = prepare_quant_state(init_params(cfg, 1, device=dev),
                                             linear_layer_names(cfg), qcfg, calib=calib)
    assert sorted(st_cpu) == sorted(st_dev) and len(st_cpu) == 6
    for name, st in st_cpu.items():
        got = {k: v.cpu() for k, v in st_dev[name].items()}
        assert sorted(got) == sorted(st)
        _codes_close(got["w_int8"], st["w_int8"], name)
        step = st["delta_w"][None, :]
        assert bool(((got["w_q"] - st["w_q"]).abs() <= 1.001 * step).all()), name
        for key in ("channel_mask", "delta_w", "scale_w", "zp_w", "zp_w_int"):
            torch.testing.assert_close(got[key], st[key], rtol=1e-6, atol=0)
    assert sorted(rot_dev) == sorted(rot_cpu) == [dim]
    assert rot_dev[dim].is_cuda and torch.equal(rot_dev[dim].cpu(), rot_cpu[dim])


@pytest.mark.parametrize("n", [96, 1536, 5120])
def test_rotation_for_dim_on_card_equals_cpu(dev, n):
    """The dense activation-side rotation built in f64 on the card equals
    the CPU's in f32 (the K x K base product's f64 rounding is absorbed by
    the cast)."""
    from wanq_tpu_torch.quant.hadamard import rotation_for_dim

    got = rotation_for_dim(n, seed=0, device=dev)
    assert got.is_cuda and got.dtype == torch.float32
    assert torch.equal(got.cpu(), rotation_for_dim(n, seed=0, device="cpu"))


@pytest.mark.parametrize("c_in,c_out", [(1536, 1536), (8960, 1536)])
def test_rotate_weight_fwht_on_card_equals_cpu(dev, c_in, c_out):
    """The f64 weight rotation at the 1.3B q/k/v and ffn.2 shapes on the
    card against the CPU: equal in f32."""
    from wanq_tpu_torch.quant.hadamard import rotate_weight_fwht

    w = torch.from_numpy(np.random.default_rng(2).normal(size=(c_in, c_out)).astype(np.float32))
    got = rotate_weight_fwht(w.to(dev), 17)
    assert got.is_cuda and got.dtype == torch.float32 and got.shape == (c_in, c_out)
    assert torch.equal(got.cpu(), rotate_weight_fwht(w, 17))


@pytest.mark.parametrize("method", ["smooth_quant", "viditq"])
def test_qlinear_masked_and_rotated_int8_on_card(dev, method):
    """One int8 site under each method on the card against the CPU on the
    same state: a mask-only site gives K7 the mask as channel_scale, a
    rotated one quantizes the f32 rotated rows in K7 (the rotation product
    sums in another order than the CPU's, so a code can flip): one K7 and
    one K2 launch, rel-L2 <= 1e-3."""
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state
    from wanq_tpu_torch.quant.qlinear import QuantCtx, qlinear

    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(1536, 1536)).astype(np.float32) * 0.03)
    x = torch.from_numpy(rng.normal(size=(2, 700, 1536)).astype(np.float32)).bfloat16()
    x[..., 11] *= 40
    qcfg = QuantConfig.from_dict({"weight": {"n_bits": 8, "sym": False},
                                  "act": {"n_bits": 8, "sym": True},
                                  method: {"alpha": 0.5665, "layer_name_regex": ""}})
    calib = {"lin": x.float().abs().reshape(-1, 1536).amax(0).numpy()[None]}
    pol, st, rot = prepare_quant_state({"lin": {"w": w}}, ["lin"], qcfg, calib=calib,
                                       targets="int8")
    ctx = QuantCtx(mode="int8", policies=pol, state=st, rotations=rot)
    want = qlinear(ctx, "lin", {"w": w}, x)
    ctx_dev = QuantCtx(mode="int8", policies=pol,
                       state={"lin": {k: v.to(dev) for k, v in st["lin"].items()}},
                       rotations={d: r.to(dev) for d, r in rot.items()})
    _lib.reset_launch_counts()
    got = qlinear(ctx_dev, "lin", {"w": w.to(dev)}, x.to(dev))
    torch.cuda.synchronize()
    assert _lib.launch_counts() == {"quant_sum": 1, "w8a8_linear": 1}
    assert got.dtype == torch.float32
    rel = float((got.cpu() - want).norm() / want.norm())
    assert rel <= 1e-3, rel


@pytest.mark.parametrize("act_order", [False, True], ids=["rows", "act_order"])
def test_gptq_solve_on_card_matches_cpu(dev, act_order):
    """GPTQ at a 1.3B site's K (1536, 12 blocks) on the card against the CPU
    solve on the same weight and Hessian (one dead channel): cuSOLVER's
    Cholesky and cuBLAS's block products sum in another order, so codes are
    equal at >= 99% and never more than one apart, and the objective
    tr(dW^T H dW) is within 1%."""
    from wanq_tpu_torch.quant.gptq import gptq_quantize
    from wanq_tpu_torch.quant.quantizers import QuantizerCfg

    rng = np.random.default_rng(4)
    k, n = 1536, 512
    x = rng.normal(size=(4096, k)).astype(np.float32)
    x = x @ (rng.normal(size=(k, k)).astype(np.float32) * 0.03 + np.eye(k, dtype=np.float32))
    x[:, 100] = 0.0
    h = torch.from_numpy(x.T @ x)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.03)
    cfg = QuantizerCfg(4, False)
    want = gptq_quantize(w, h, cfg, act_order=act_order)
    got = gptq_quantize(w.to(dev), h.to(dev), cfg, act_order=act_order)
    assert all(t.is_cuda for t in got)
    diff = (got[1].cpu().int() - want[1].int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.99

    def objective(wq):
        d = w.double() - wq.cpu().double()
        return float(((h.double() @ d) * d).sum())

    assert abs(objective(got[0]) - objective(want[0])) <= 0.01 * objective(want[0])


def test_svd_lowrank_on_card_matches_cpu_from_one_sketch(dev, monkeypatch):
    """The randomized SVD of an ffn.0-shaped weight [1536, 8960] with
    outlier input channels on the card (cuBLAS, cuSOLVER) against the CPU's
    from one sketch: L1 @ L2 within rel 1e-4."""
    from wanq_tpu_torch.quant import svd

    sketch = torch.randn((8960, 40), generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(svd, "gaussian_sketch", lambda n, r, seed, device: sketch.to(device))
    rng = np.random.default_rng(5)
    scale = np.exp(rng.normal(0.0, 1.0, size=(1536, 1))).astype(np.float32)
    w = torch.from_numpy(rng.normal(size=(1536, 8960)).astype(np.float32) * 0.03 * scale)
    want = svd.svd_lowrank(w, 32)
    got = svd.svd_lowrank(w.to(dev), 32)
    prod_want, prod_got = want[0] @ want[1], (got[0] @ got[1]).cpu()
    rel = float((prod_got - prod_want).norm() / prod_want.norm())
    assert rel <= 1e-4, rel


def test_qlinear_w4a4_mask_lowrank_int8_on_card(dev):
    """An SVDQuant site (SmoothQuant mask, rank-32 bf16 branch, W4A4 residual)
    in int8 mode on the card against its plain route on the CPU from one
    state: one K9 launch on the masked f32 rows. Without the branch the two
    are equal (the act quant is plain on both, K9 exact). The branch rounds
    its rank-32 intermediate to bf16 before the second product, as wanq_tpu
    does; cuBLAS sums the first in another order (~1e-6 relative), which
    flips ~1e-3 of those roundings by one bf16 ulp: rel-L2 <= 1e-3 (1.7e-4
    on an H100)."""
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state
    from wanq_tpu_torch.quant.qlinear import QuantCtx, qlinear

    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.normal(size=(1536, 8960)).astype(np.float32) * 0.03)
    x = torch.from_numpy(rng.normal(size=(2, 700, 1536)).astype(np.float32)).bfloat16()
    x[..., 11] *= 40
    qcfg = QuantConfig.from_yaml(os.path.join(os.path.dirname(__file__), "..",
                                              "quant_configs", "wan_svdquant.yaml"))
    calib = {"lin": x.float().abs().reshape(-1, 1536).amax(0).numpy()[None]}
    pol, st, _ = prepare_quant_state({"lin": {"w": w}}, ["lin"], qcfg, calib=calib,
                                     targets="int8")
    assert sorted(st["lin"]) == ["channel_mask", "lowrank_a", "lowrank_b", "scale_wg",
                                 "w_int4g"]
    want = qlinear(QuantCtx(mode="int8", policies=pol, state=st), "lin", {"w": w}, x)
    ctx_dev = QuantCtx(mode="int8", policies=pol,
                       state={"lin": {k: v.to(dev) for k, v in st["lin"].items()}})
    _lib.reset_launch_counts()
    got = qlinear(ctx_dev, "lin", {"w": w.to(dev)}, x.to(dev))
    torch.cuda.synchronize()
    assert _lib.launch_counts() == {"w4a4_linear": 1}
    rel = float((got.cpu() - want).norm() / want.norm())
    assert rel <= 1e-3, rel
    for s in (st["lin"], ctx_dev.state["lin"]):
        del s["lowrank_a"], s["lowrank_b"]
    want = qlinear(QuantCtx(mode="int8", policies=pol, state=st), "lin", {"w": w}, x)
    got = qlinear(ctx_dev, "lin", {"w": w.to(dev)}, x.to(dev))
    assert torch.equal(got.cpu(), want)


def test_w4_wrappers_raise_on_bad_layouts(dev):
    from wanq_tpu_torch.ops.fused import ln_modulate_quant_cuda, quant_sum_cuda
    from wanq_tpu_torch.ops.qgemm import (
        w4a4_linear_cuda, w4a8_linear_cuda, w4a8_linear_gelu_quant_cuda)

    a = torch.zeros((5, 256), dtype=torch.int8, device=dev)
    wp = torch.zeros((128, 128), dtype=torch.int8, device=dev)
    s, sw = torch.ones((5,), device=dev), torch.ones((128,), device=dev)
    sc = torch.tensor(0.1, device=dev)
    odd = torch.zeros((5 * 256 + 1,), dtype=torch.int8, device=dev)[1:].view(5, 256)
    sa4, sw4 = torch.ones((5, 2), device=dev), torch.ones((2, 128), device=dev)
    bad = [
        lambda: w4a8_linear_cuda(a[:, :192].contiguous(), wp[:, :96].contiguous(), s, sw),
        lambda: w4a8_linear_cuda(a, wp[:100].contiguous(), s, sw[:100]),       # N % 128
        lambda: w4a8_linear_cuda(a.float(), wp, s, sw),                        # dtype
        lambda: w4a8_linear_cuda(a, wp.cpu(), s, sw),                          # CPU operand
        lambda: w4a8_linear_cuda(odd, wp, s, sw),                              # alignment
        lambda: w4a8_linear_cuda(a, wp, s, sw, out_dtype=torch.float16),
        lambda: w4a8_linear_gelu_quant_cuda(a, wp[:100].contiguous(), s, sw[:100], sc),
        lambda: w4a8_linear_gelu_quant_cuda(a, wp, s, sw, sc.cpu()),
        lambda: w4a8_linear_gelu_quant_cuda(a, wp, s, sw, sc, zp_w=sw),        # no sum_a
        lambda: ln_modulate_quant_cuda(torch.zeros((1, 2, 6152), device=dev).bfloat16(),
                                       torch.zeros((1, 6152), device=dev),
                                       torch.zeros((1, 6152), device=dev)),    # C > 6144
        lambda: ln_modulate_quant_cuda(torch.zeros((1, 2, 12), device=dev).bfloat16(),
                                       torch.zeros((1, 12), device=dev),
                                       torch.zeros((1, 12), device=dev)),      # C % 8
        lambda: w4a4_linear_cuda(a[:, :192].contiguous(), wp[:, :96].contiguous(), sa4, sw4),
        lambda: w4a4_linear_cuda(a, wp[:100].contiguous(), sa4, sw4[:, :100]),   # N % 128
        lambda: w4a4_linear_cuda(a, wp.cpu(), sa4, sw4),                         # CPU operand
        lambda: w4a4_linear_cuda(a, wp, sa4, sw4, group=64),                     # group
        lambda: w4a4_linear_cuda(a, wp, sa4[:, :1], sw4),                        # scales
        lambda: quant_sum_cuda(torch.zeros((4, 12), device=dev).bfloat16()),   # C % 8
        lambda: quant_sum_cuda(torch.zeros((4, 16), device=dev).half()),       # dtype
    ]
    for fn in bad:
        with pytest.raises(ValueError):
            fn()


def test_wrappers_count_launches_and_raise_on_bad_input(dev):
    from wanq_tpu_torch.ops.qgemm import w8a8_linear

    _lib.reset_launch_counts()
    a = torch.zeros((5, 128), dtype=torch.int8, device=dev)
    w = torch.zeros((128, 128), dtype=torch.int8, device=dev)
    s = torch.ones((5,), device=dev)
    sw = torch.ones((128,), device=dev)
    w8a8_linear(a, w, s, sw)
    assert _lib.launch_counts() == {"w8a8_linear": 1}
    with pytest.raises(ValueError):
        w8a8_linear(a, w[:, :100].contiguous(), s, sw)
    from wanq_tpu_torch.ops.fused import quant_sum
    from wanq_tpu_torch.ops.qgemm import (
        w4a4_linear, w4a8_linear, w4a8_linear_gelu_quant, w8a8_linear_gelu_quant)

    scale2 = torch.tensor(0.1, device=dev)
    w8a8_linear_gelu_quant(a, w, s, sw, scale2)
    w8a8_linear_gelu_quant(a.cpu(), w.cpu(), s.cpu(), sw.cpu(), scale2.cpu())  # plain: no launch
    assert _lib.launch_counts() == {"w8a8_linear": 1, "w8a8_linear_gelu_quant": 1}
    x = torch.randn((5, 128), device=dev)
    quant_sum(x, gelu=True)
    w4a8_linear(a, w[:, :64].contiguous(), s, sw)
    w4a8_linear_gelu_quant(a, w[:, :64].contiguous(), s, sw, scale2)
    w4a8_linear_gelu_quant(a.cpu(), w[:, :64].contiguous().cpu(), s.cpu(), sw.cpu(), scale2.cpu())
    w4a4_linear(x, w[:, :64].contiguous(), torch.ones((1, 128), device=dev))
    quant_sum(x.cpu())  # the plain version launches nothing
    assert _lib.launch_counts() == {"w8a8_linear": 1, "w8a8_linear_gelu_quant": 1,
                                    "quant_sum": 1, "w4a8_linear": 1,
                                    "w4a8_linear_gelu_quant": 1, "w4a4_linear": 1}
    assert np.isfinite(_lib.last_build.get("seconds", 0.0))


def _int8_attn_inputs(dev, gen, b, s, h):
    q = torch.randn((b, s, h, 128), device=dev, generator=gen).bfloat16()
    k = torch.randn((b, s, h, 128), device=dev, generator=gen).bfloat16()
    v = torch.randn((b, s, h * 128), device=dev, generator=gen).bfloat16().view(b, s, h, 128)
    return q, k, v


@pytest.mark.parametrize("s", [1024, 700])
def test_k10a_producer_equals_plain(dev, gen, s):
    """Scales and codes equal the plain version's exactly, ragged S (700 ->
    1024, zero rows) included, through strided [B, H, S, D] views."""
    from wanq_tpu_torch.ops.attn_int8 import (
        quantize_qkv_int8_cuda, quantize_qkv_int8_plain, v_from_kernel_layout, v_kernel_layout)

    q, k, v = _int8_attn_inputs(dev, gen, 2, s, 3)
    q[0, :5] *= 30.0  # one block with a far larger absmax
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = quantize_qkv_int8_cuda(*views)
    want = quantize_qkv_int8_plain(*views)
    for i in (0, 1, 3, 4, 5):
        assert torch.equal(got[i], want[i]), i
    assert torch.equal(got[2], v_kernel_layout(want[2]))
    assert torch.equal(v_from_kernel_layout(got[2]), want[2])


def _check_k10a(views, what):
    """K10a code for code against its plain version, the card waited for with
    a deadline (a ring stage counted differently by the producer and the
    block hangs the card)."""
    from wanq_tpu_torch.ops.attn_int8 import (
        quantize_qkv_int8_cuda, quantize_qkv_int8_plain, v_kernel_layout)

    got = quantize_qkv_int8_cuda(*views)
    _finish_within(60, what)
    want = quantize_qkv_int8_plain(*views)
    for i, name in zip((0, 1, 3, 4, 5), ("qi", "ki", "s_q", "s_k", "s_v")):
        assert torch.equal(got[i], want[i]), f"{what}: {name}"
    assert torch.equal(got[2], v_kernel_layout(want[2])), f"{what}: vt"
    return got, want


def _k10a_views(dev, gen, b, s, h, layout):
    """q, k, v as [B, H, S, 128] views. "path": q and k heads-major and
    contiguous (K3's outputs), v over a seq-major [B, S, H * 128] (K2's
    output), as models/dit.py passes them; "strided": q and k over
    [B, S, H, 128] (the plain chain's), v over rows padded to H * 128 + 64
    channels, every stride a multiple of 16 bytes and none contiguous."""
    def rnd(*shape):
        return torch.randn(shape, device=dev, generator=gen).bfloat16()

    if layout == "path":
        q, k = rnd(b, h, s, 128), rnd(b, h, s, 128)
    else:
        q, k = rnd(b, s, h, 128).transpose(1, 2), rnd(b, s, h, 128).transpose(1, 2)
    pad = 0 if layout == "path" else 64
    v = rnd(b, s, h * 128 + pad)[..., :h * 128].unflatten(-1, (h, 128)).transpose(1, 2)
    return q, k, v


@pytest.mark.parametrize("layout", ["path", "strided"])
@pytest.mark.parametrize("b,h", [(1, 1), (2, 12), (1, 40)])
@pytest.mark.parametrize("s", [1, 511, 512, 513, 32760])
def test_k10a_shapes_and_layouts_equal_plain(dev, gen, s, b, h, layout):
    """Ragged S (the pad rows of the last block arrive as zeros from the
    tensor map, also where a whole 64-row box lies past S), one head to the
    14B's 40, the main path's views and strided ones."""
    _check_k10a(_k10a_views(dev, gen, b, s, h, layout), f"K10a S={s} B={b} H={h} {layout}")


def test_k10a_zero_blocks_ties_and_extreme_magnitudes(dev, gen):
    """A zero q block (scale 1e-6), a k block whose absmax is 127 (scale 1:
    every .5 value is a tie that rounds to even), a k block near bf16's
    largest value (scale > 2**20, the division outside FastDiv's range), v
    channels at 3e38, 1e-30 (scale 1e-6) and zero, and one v channel at 2**-60."""
    b, h, s = 2, 3, 2048
    q, k, v = _k10a_views(dev, gen, b, s, h, "path")
    q[0, 1, 512:1024] = 0.0
    ties = (torch.arange(-254, 255, device=dev) / 2.0).bfloat16()  # -127, -126.5, ..., 127
    k[1, 2, :512] = ties[torch.randint(0, len(ties), (512, 128), device=dev, generator=gen)]
    k[1, 2, 0, 0] = 127.0
    k[0, 0, 1024:1536] *= 3e37
    v[0, 0, :, 5] = (torch.linspace(-1.0, 1.0, s, device=dev) * 3e38).bfloat16()
    v[1, 1, :, 7] = 1e-30
    v[1, 2, :, 9] = 0.0
    v[0, 2, :, 100] = 2.0 ** -60
    got, _ = _check_k10a((q, k, v), "K10a zero blocks, ties, extremes")
    assert got[3][0, 1, 1].item() == pytest.approx(1e-6) and got[4][1, 2, 0].item() == 1.0
    assert got[4][0, 0, 2].item() > 2.0 ** 20


def test_k10a_raises_on_what_its_tensor_maps_do_not_take(dev, gen):
    from wanq_tpu_torch.ops.attn_int8 import quantize_qkv_int8_cuda

    b, h, s = 1, 2, 600
    q, k, v = _k10a_views(dev, gen, b, s, h, "path")
    flat = torch.zeros((b, s, h * 128 + 4), device=dev).bfloat16()
    bad = {
        "head dim 64": q[..., :64],
        "f32": q.float(),
        "head dim strided": torch.zeros((b, h, s, 256), device=dev).bfloat16()[..., ::2],
        "seq stride of 8 bytes past 16": flat[..., :h * 128].unflatten(-1, (h, 128))
        .transpose(1, 2),
        "base 2 bytes off": torch.zeros(b * h * s * 128 + 1, device=dev).bfloat16()[1:]
        .view(b, h, s, 128),
        "CPU tensor": q.cpu(),
        "shape": q[:, :, :500],
    }
    for what, t in bad.items():
        with pytest.raises(ValueError):
            quantize_qkv_int8_cuda(q, k, t)
        with pytest.raises(ValueError):
            quantize_qkv_int8_cuda(t, k, v)
    _lib.reset_launch_counts()
    quantize_qkv_int8_cuda(q, k, v)
    _finish_within(60, "K10a after refusals")
    assert _lib.launch_counts() == {"quantize_qkv_int8": 1}


@pytest.mark.parametrize("s,valid", [(1024, None), (1024, 1000), (1536, 520), (512, 1)])
def test_k10_kernel_matches_blocked_plain(dev, gen, s, valid):
    from wanq_tpu_torch.ops.attn_int8 import (
        attention_int8_blocked, attention_int8_cuda, quantize_qkv_int8_cuda,
        v_from_kernel_layout)

    q, k, v = _int8_attn_inputs(dev, gen, 2, s, 3)
    if valid is not None:
        k[:, valid:] = 3.0      # a missed mask would mix in v = 100
        v[:, valid:] = 100.0
    qi, ki, vt, s_q, s_k, s_v = quantize_qkv_int8_cuda(*(t.transpose(1, 2) for t in (q, k, v)))
    got = attention_int8_cuda(qi, ki, vt, s_q, s_k, s_v, 0.0884, valid).transpose(1, 2)
    want = attention_int8_blocked(qi, ki, v_from_kernel_layout(vt), s_q, s_k, s_v, 0.0884, valid)
    assert torch.isfinite(got).all()
    step = want.abs().max().item() / 127
    assert ((got - want).norm() / want.norm()).item() <= 1e-3
    assert ((got - want).abs() > step).float().mean().item() <= 1e-4


def test_k10_kernel_sq_differs_from_sk(dev, gen):
    """512 query rows against 1536 keys (1300 valid): q and its scales from
    one producer call, k, v and theirs from another."""
    from wanq_tpu_torch.ops.attn_int8 import (
        attention_int8_blocked, attention_int8_cuda, quantize_qkv_int8_cuda,
        v_from_kernel_layout)

    valid = 1300
    q, _, _ = _int8_attn_inputs(dev, gen, 2, 512, 3)
    _, k, v = _int8_attn_inputs(dev, gen, 2, 1536, 3)
    k[:, valid:] = 3.0
    v[:, valid:] = 100.0
    qi, _, _, s_q, _, _ = quantize_qkv_int8_cuda(*(q.transpose(1, 2),) * 3)
    _, ki, vt, _, s_k, s_v = quantize_qkv_int8_cuda(*(t.transpose(1, 2) for t in (k, k, v)))
    got = attention_int8_cuda(qi, ki, vt, s_q, s_k, s_v, 0.0884, valid).transpose(1, 2)
    want = attention_int8_blocked(qi, ki, v_from_kernel_layout(vt), s_q, s_k, s_v, 0.0884, valid)
    assert got.shape == (2, 3, 512, 128) and torch.isfinite(got).all()
    step = want.abs().max().item() / 127
    assert ((got - want).norm() / want.norm()).item() <= 1e-3
    assert ((got - want).abs() > step).float().mean().item() <= 1e-4


def test_k10_wrapper_runs_both_kernels_and_is_near_fp(dev, gen):
    from wanq_tpu_torch.models.attention import attention
    from wanq_tpu_torch.ops.attn_int8 import attention_int8

    q, k, v = _int8_attn_inputs(dev, gen, 1, 700, 2)
    _lib.reset_launch_counts()
    got = attention_int8(q, k, v, k_valid_len=690)
    assert _lib.launch_counts() == {"quantize_qkv_int8": 1, "attention_int8": 1}
    assert got.shape == (1, 700, 2, 128) and got.dtype == torch.float32
    want = attention(q, k, v, k_valid_len=690).float()
    assert ((got - want).abs().max() / want.abs().max()).item() < 0.15
    cpu = attention_int8(q.cpu(), k.cpu(), v.cpu(), k_valid_len=690)
    assert ((got.cpu() - cpu).norm() / cpu.norm()).item() <= 1e-3


def test_k10_wrappers_raise_on_bad_input(dev):
    from wanq_tpu_torch.ops.attn_int8 import attention_int8, attention_int8_cuda

    x = torch.zeros((1, 512, 2, 64), device=dev).bfloat16()
    with pytest.raises(ValueError):
        attention_int8(x, x, x)                       # head dim
    y = torch.zeros((1, 512, 2, 128), device=dev)
    with pytest.raises(ValueError):
        attention_int8(y, y, y)                       # dtype
    qi = torch.zeros((1, 2, 500, 128), dtype=torch.int8, device=dev)
    vt = torch.zeros((1, 2, 128, 500), dtype=torch.int8, device=dev)
    sc = torch.ones((1, 2, 1), device=dev)
    with pytest.raises(ValueError):
        attention_int8_cuda(qi, qi, vt, sc, sc, torch.ones((1, 2, 128), device=dev), 1.0)


def test_k10_full_shape_against_plain(dev, gen):
    """The 1.3B path's shape, [2, 32768, 12, 128] with 32760 valid: K10a
    exact, K10 within the stated limits on 3 of the 12 heads (the plain
    version at all heads takes seconds), and CUDA-event times."""
    from wanq_tpu_torch.ops.attn_int8 import (
        attention_int8_blocked, attention_int8_cuda, quantize_qkv_int8_cuda,
        quantize_qkv_int8_plain, v_from_kernel_layout, v_kernel_layout)

    b, s, h, valid = 2, 32768, 12, 32760
    q, k, v = _int8_attn_inputs(dev, gen, b, s, h)
    k[:, valid:] = 3.0
    v[:, valid:] = 100.0
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = quantize_qkv_int8_cuda(*views)
    want = quantize_qkv_int8_plain(*views)
    for i in (0, 1, 3, 4, 5):
        assert torch.equal(got[i], want[i]), i
    assert torch.equal(got[2], v_kernel_layout(want[2]))
    del want
    qi, ki, vt, s_q, s_k, s_v = got
    out = attention_int8_cuda(qi, ki, vt, s_q, s_k, s_v, 0.0884, valid).transpose(1, 2)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    hs = slice(0, 12, 5)
    ref = attention_int8_blocked(
        qi[:, hs], ki[:, hs], v_from_kernel_layout(vt[:, hs].contiguous()), s_q[:, hs],
        s_k[:, hs], s_v[:, hs], 0.0884, valid, q_chunk=8192)
    g = out[:, hs]
    step = ref.abs().max().item() / 127
    rel = ((g - ref).norm() / ref.norm()).item()
    far = ((g - ref).abs() > step).float().mean().item()

    def ms(fn, reps=3):
        fn()
        ts = []
        for _ in range(reps):
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            z.record()
            z.synchronize()
            ts.append(a.elapsed_time(z))
        return sorted(ts)[len(ts) // 2]

    t10 = ms(lambda: attention_int8_cuda(qi, ki, vt, s_q, s_k, s_v, 0.0884, valid))
    t10a = ms(lambda: quantize_qkv_int8_cuda(*views))
    print(f"K10 full shape: rel-L2 {rel:.3e}, beyond one step {far:.3e}; K10 {t10:.3f} ms, "
          f"K10a {t10a:.3f} ms")
    assert rel <= 1e-3 and far <= 1e-4


# ---------------------------------------------------------------------------
# T2V-14B shapes (dim 5120, ffn 13824, 40 heads) and the draw on the card
# ---------------------------------------------------------------------------


def test_k1_k7_at_14b_width_ragged_rows(dev, gen):
    """K1 and K7 (bf16, the o input: no GELU) at C = 5120 over 2 x 1003 rows
    (no multiple of a block's rows), at their stated limits."""
    from wanq_tpu_torch.ops.fused import (
        ln_modulate_quant_cuda, ln_modulate_quant_plain, quant_sum_cuda, quant_sum_plain)

    b, s, c = 2, 1003, 5120
    x = (torch.randn((b, s, c), device=dev, generator=gen) * 2 + 0.3).bfloat16()
    shift = torch.randn((b, c), device=dev, generator=gen) * 0.5
    scale = torch.randn((b, c), device=dev, generator=gen) * 0.5
    got = ln_modulate_quant_cuda(x, shift, scale)
    want = ln_modulate_quant_plain(x, shift, scale)
    diff = (got[0].int() - want[0].int()).abs()
    assert diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 1e-3
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    got = quant_sum_cuda(x.reshape(b * s, c))
    want = quant_sum_plain(x.reshape(b * s, c))
    _finish_within(60, "K7 C=5120")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)


# (K, N, mode) of T2V-14B's int GEMM sites: the square sites (q/k/v/o, cross
# q/o) with a bf16 output, ffn.0 with a bf16 output and in the GELU + quant
# mode, ffn.2 with an f32 output; M ragged
@pytest.mark.parametrize("k,n,mode", [(5120, 5120, "bf16"), (5120, 13824, "bf16"),
                                      (5120, 13824, "gelu_quant"), (13824, 5120, "f32")])
@pytest.mark.parametrize("kernel", ["w8a8_linear", "w4a8_linear"], ids=["K2", "K8"])
def test_int_gemms_at_14b_shapes_match_plain(dev, gen, kernel, k, n, mode):
    from wanq_tpu_torch.ops import qgemm

    m = 1024 + 3
    a = torch.randint(-128, 128, (m, k), device=dev, generator=gen, dtype=torch.int8)
    w = torch.randint(-128, 128, (n, k // 2 if kernel == "w4a8_linear" else k), device=dev,
                      generator=gen, dtype=torch.int8)
    s_a = torch.rand((m,), device=dev, generator=gen) * 0.02 + 1e-3
    s_w = torch.rand((n,), device=dev, generator=gen) * 0.1 / k ** 0.5 + 1e-5
    sum_a = s_a * a.float().sum(-1)
    zp = torch.randint(0, 16, (n,), device=dev, generator=gen).float()
    bias = torch.randn((n,), device=dev, generator=gen)
    if mode == "gelu_quant":
        scale2 = torch.tensor(0.021, device=dev)
        ops = (a, w, s_a, s_w, scale2, sum_a, zp, bias)
        got = getattr(qgemm, f"{kernel}_gelu_quant_cuda")(*ops)
        want = getattr(qgemm, f"{kernel}_gelu_quant_plain")(*ops)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    else:
        ops = (a, w, s_a, s_w, sum_a, zp, bias, getattr(torch, {"bf16": "bfloat16",
                                                                 "f32": "float32"}[mode]))
        got = getattr(qgemm, f"{kernel}_cuda")(*ops)
        assert torch.equal(got, getattr(qgemm, f"{kernel}_plain")(*ops))


def test_k4_40_heads_720p_pad_planted(dev, gen):
    """K4's dense self-attention at T2V-14B 720p: 40 heads, S 75776 with 75600
    valid, the pad rows of k/v planted (k 0, v 100), q heads-major with the
    scale folded in and v the strided view over [1, S, 5120]. The plain
    version runs on the first 512 q rows and on the last 1024 (the valid
    boundary and the pad rows), which see every key; K4's limits."""
    from wanq_tpu_torch.models.attention import _flash_cuda, _sdpa_reference

    s, valid = 75776, 75600
    q, k, vh = _band_inputs(dev, gen, 1, 40, s, valid)
    got = _flash_cuda(q, k, vh, 1.0, valid)
    _finish_within(120, "K4 40 heads at 720p")
    for rows in (slice(0, 512), slice(s - 1024, s)):
        want = _sdpa_reference(q[:, :, rows].transpose(1, 2), k.transpose(1, 2),
                               vh.transpose(1, 2), 1.0, valid, q_chunk=256)
        _k4_close(got[:, rows], want)


def test_init_params_on_device_on_the_card(dev):
    """T2V-14B's tree at 2 of its 40 layers, drawn on the card: the same
    seed gives the same bits, another seed other bits, the tensors land on
    the card in the config's dtypes, and the draw's peak allocation stays
    below the model plus twice its largest tensor (it holds one f32 block of
    64 MB beside the model)."""
    import dataclasses

    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.models.dit import init_params_on_device

    cfg = dataclasses.replace(WAN_CONFIGS["t2v-14B"], num_layers=2)

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [] if tree is None else [tree]

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a = leaves(init_params_on_device(cfg, 42, device=dev))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    model = sum(t.numel() * t.element_size() for t in a)
    largest = max(t.numel() * t.element_size() for t in a)
    assert largest == 5120 * 6 * 5120 * 2  # time_projection.1
    assert peak < model + 2 * largest, (peak, model, largest)
    assert all(t.is_cuda for t in a)
    assert {t.dtype for t in a if t.ndim == 2} == {torch.bfloat16}
    b = leaves(init_params_on_device(cfg, 42, device=dev))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    del b
    c = leaves(init_params_on_device(cfg, 43, device=dev))
    drawn = [(x, y) for x, y in zip(a, c) if x.ndim >= 2 and x.float().std() > 0]
    assert drawn and not any(torch.equal(x, y) for x, y in drawn)


def test_forward_row_equals_a_lone_forward_on_the_card(dev):
    """The conditional row of a batched CFG forward equals a lone B = 1
    forward bit for bit on the card (a small config with head dim 128, so
    the fused routes, bf16 residual): what makes sequential CFG the same
    function as batched. The time embedding runs row by row for this."""
    from wanq_tpu_torch.configs import tiny_config
    from wanq_tpu_torch.models.dit import dit_forward, init_params_on_device

    cfg = tiny_config(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32,
                      text_dim=64, freq_dim=64, param_dtype="bfloat16",
                      residual_dtype="bfloat16")
    params = init_params_on_device(cfg, 3, device=dev)
    params["head"]["head"]["w"] = (torch.randn((256, 64), device=dev) * 0.02).bfloat16()
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((1, 16, 3, 8, 10), device=dev, generator=g)
    c = torch.randn((2, 32, 64), device=dev, generator=g)
    t = torch.full((2,), 999.0, device=dev)
    with torch.no_grad():
        pair = dit_forward(params, cfg, torch.cat([x, x]), t, c, 64)
        lone = dit_forward(params, cfg, x, t[:1], c[:1], 64)
    assert torch.equal(pair[:1], lone)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4 self", "K4 cross", "K7"])
def test_kernel_row_of_a_batch_equals_it_alone(dev, gen, kernel):
    """Each hand kernel of the bf16 and W8A8 forwards gives the first row of
    a batch of 2 the bits it gives that row alone (for the GEMM, the first
    half of the token rows): with the row-by-row time embedding, this is
    what makes sequential CFG the batched forward's function."""
    from wanq_tpu_torch.models.attention import _flash_cuda
    from wanq_tpu_torch.models.rope import pad_tables, rope_tables_interleaved
    from wanq_tpu_torch.ops.fused import ln_modulate_quant_cuda, quant_sum_cuda
    from wanq_tpu_torch.ops.qgemm import w8a8_linear_cuda
    from wanq_tpu_torch.ops.rmsnorm_rope import _k3_cuda

    b, s, valid, c, n, d = 2, 2048, 2040, 1536, 12, 128
    x = (torch.randn((b, s, c), device=dev, generator=gen) * 2).bfloat16()
    one = x[:1].contiguous()
    if kernel == "K1":
        shift, scale = (torch.randn((b, c), device=dev, generator=gen) for _ in range(2))
        pair = ln_modulate_quant_cuda(x, shift, scale)
        lone = ln_modulate_quant_cuda(one, shift[:1].contiguous(), scale[:1].contiguous())
        pair = tuple(t[:1] for t in pair[:2])
        lone = lone[:2]
    elif kernel == "K2":
        a = torch.randint(-128, 128, (b * s, c), device=dev, generator=gen, dtype=torch.int8)
        w = torch.randint(-128, 128, (c, c), device=dev, generator=gen, dtype=torch.int8)
        s_a = torch.rand((b * s,), device=dev, generator=gen) * 0.02 + 1e-3
        s_w = torch.rand((c,), device=dev, generator=gen) * 0.01
        pair = (w8a8_linear_cuda(a, w, s_a, s_w, None, None, None, torch.bfloat16)[:s],)
        lone = (w8a8_linear_cuda(a[:s].contiguous(), w, s_a[:s].contiguous(), s_w, None, None,
                                 None, torch.bfloat16),)
    elif kernel == "K3":
        ca, sb = (torch.from_numpy(t.copy()).to(dev)
                  for t in rope_tables_interleaved((2, 30, 34), d))
        ca, sb = pad_tables(ca, sb, valid, s)
        wn = torch.rand((c,), device=dev, generator=gen) + 0.5
        pair = (_k3_cuda(x, wn, ca, sb, n, 1e-6, torch.bfloat16)[:1],)
        lone = (_k3_cuda(one, wn, ca, sb, n, 1e-6, torch.bfloat16),)
    elif kernel == "K7":
        pair = tuple(t[:1] for t in quant_sum_cuda(x))
        lone = quant_sum_cuda(one)
    else:
        q = (torch.randn((b, n, s, d), device=dev, generator=gen) * 0.09).bfloat16()
        sk = s if kernel == "K4 self" else 512
        k, v = (torch.randn((b, n, sk, d), device=dev, generator=gen).bfloat16()
                for _ in range(2))
        kv_valid, sc = (valid, 1.0) if kernel == "K4 self" else (512, 0.088)
        pair = (_flash_cuda(q, k, v, sc, kv_valid)[:1],)
        lone = (_flash_cuda(q[:1], k[:1], v[:1], sc, kv_valid),)
    _finish_within(60, f"{kernel} batch of 2 and of 1")
    assert all(torch.equal(u, w) for u, w in zip(pair, lone))


# ---------------------------------------------------------------------------
# whole generate: the VAE, umT5 and the checkpoint loader on the card
# ---------------------------------------------------------------------------


def _rel(want, got) -> float:
    want, got = want.double().cpu(), got.double().cpu()
    return float((want - got).norm() / want.norm())


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def test_vae_decode_card_vs_cpu_f32_and_bf16(dev):
    """The full-width VAE (WAN_VAE_CFG) decodes 3 latent frames of 8x8 on
    the card as on the CPU: f32 (cuDNN, TF32 off) rel-L2 <= 1e-4, bf16
    PSNR >= 35 dB over [-1, 1] against the CPU's f32."""
    from wanq_tpu_torch.models import vae as vaem

    params = vaem.init_vae_params(vaem.WAN_VAE_CFG, seed=1, device="cpu")
    z = torch.randn((1, 16, 3, 8, 8), generator=torch.Generator().manual_seed(2))
    host = vaem.WanVAE(params=params, device="cpu").decode(z)
    card = vaem.WanVAE(params=params, device=dev).decode(z.to(dev))
    card16 = vaem.WanVAE(params=params, device=dev, compute_dtype=torch.bfloat16).decode(z.to(dev))
    assert card.shape == card16.shape == host.shape == (1, 3, 9, 64, 64)
    assert card16.dtype == torch.float32
    assert _rel(host, card) <= 1e-4
    mse = float((host.double() - card16.double().cpu()).square().mean())
    assert 10 * math.log10(4.0 / mse) >= 35.0


def test_t5_encoder_two_layers_card_vs_cpu(dev):
    """umT5-XXL's widths (dim 4096, ffn 10240, 64 heads; a 1024-token
    vocabulary), 2 layers, bf16, 512 ids with a ragged mask: the card's
    states against the CPU's rel-L2 <= 4e-3 (both multiply bf16 operands
    in f32; chip_smoke.py read 1.6e-3 at umT5-XXL's vocabulary), exactly zero
    past the mask."""
    import dataclasses

    from wanq_tpu_torch.models import t5 as t5m

    cfg = dataclasses.replace(t5m.UMT5_XXL, num_layers=2, vocab_size=1024)
    params = t5m.init_t5_params_on_device(cfg, seed=3, device=dev)
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(0, cfg.vocab_size, (2, 512), generator=g)
    mask = (torch.arange(512)[None] < torch.tensor([[77], [301]])).long()
    card = t5m.T5EncoderModel(512, cfg=cfg, params=params, device=dev).encode_ids(ids, mask)
    host_params = _tree_to(params, "cpu")
    host = t5m.T5EncoderModel(512, cfg=cfg, params=host_params, device="cpu").encode_ids(ids, mask)
    assert card.shape == (2, 512, 4096) and bool(torch.isfinite(card).all())
    assert float(card[0, 77:].abs().max()) == 0.0 and float(card[1, 301:].abs().max()) == 0.0
    assert _rel(host, card) <= 4e-3


def test_load_wan_checkpoint_reads_straight_onto_the_card(dev, tmp_path, monkeypatch):
    """safe_open(..., framework="pt", device=<the card>): every tensor the
    loader reads is already on the card (no host copy of the model), and
    every param lands there with the bits that were written."""
    import safetensors

    from wanq_tpu_torch.configs import tiny_config
    from wanq_tpu_torch.models import dit as tdit
    from wanq_tpu_torch.models.params import load_wan_checkpoint

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    cfg = tiny_config(param_dtype="bfloat16")
    params = tdit.init_params(cfg, 5, device="cpu")
    chip_smoke.write_dit_checkpoint(params, cfg, str(tmp_path), shards=3)
    opened, read = [], []
    real = safetensors.safe_open

    class Spy:
        def __init__(self, path, framework, device="cpu"):
            opened.append((framework, device))
            self.f = real(path, framework=framework, device=device)

        def __enter__(self):
            self.f.__enter__()
            return self

        def __exit__(self, *exc):
            return self.f.__exit__(*exc)

        def keys(self):
            return self.f.keys()

        def get_tensor(self, key):
            t = self.f.get_tensor(key)
            read.append(t.device.type)
            return t

    monkeypatch.setattr(safetensors, "safe_open", Spy)
    got = load_wan_checkpoint(str(tmp_path), dtype=cfg.dtype, device=dev)
    assert len(opened) == 3 and all(o == ("pt", str(dev)) for o in opened)
    assert read and set(read) == {"cuda"}
    want = chip_smoke.reference_state_dict(params, cfg)
    back = chip_smoke.reference_state_dict(got, cfg)
    assert sorted(want) == sorted(back)
    for k in want:
        assert back[k].is_cuda and torch.equal(back[k].cpu(), want[k]), k


# ---------------------------------------------------------------------------
# image to video: the new shapes of the kernels, CLIP, the VAE encoder, the
# i2v tree and forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,sk", [(3060, 3060), (1000, 257), (700, 512)],
                         ids=["self_ragged", "cross_image_257", "cross_text_ragged_q"])
def test_k4_at_the_i2v_shapes_matches_plain(dev, gen, sq, sk):
    """K4 with 40 heads where I2V runs it: self-attention over a sequence
    that is no multiple of the 128-row tile, every key valid (I2V pads no
    token: the q and kv tiles at the end are partial, read through tensor
    maps whose outer dimension ends there), and cross-attention against the
    257 CLIP tokens (three kv tiles, the last with one valid key) and the
    512 text tokens at a ragged q length; q heads-major, k/v seq-major for
    cross. K4's limits."""
    from wanq_tpu_torch.models.attention import _flash_cuda, _sdpa_reference

    b, n, d = 2, 40, 128
    q = torch.randn((b, n, sq, d), device=dev, generator=gen).bfloat16()
    if sq == sk:
        q = (q.float() * d ** -0.5).bfloat16()
        k = torch.randn((b, n, sk, d), device=dev, generator=gen).bfloat16()
        vh = torch.randn((b, sk, n * d), device=dev, generator=gen).bfloat16().view(
            b, sk, n, d).transpose(1, 2)
        got = _flash_cuda(q, k, vh, 1.0, sk)
        want = _sdpa_reference(q.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 1.0,
                               None, q_chunk=512)
    else:
        ck = torch.randn((b, sk, n, d), device=dev, generator=gen).bfloat16()
        cv = torch.randn((b, sk, n, d), device=dev, generator=gen).bfloat16()
        got = _flash_cuda(q, ck.transpose(1, 2), cv.transpose(1, 2), d ** -0.5, sk)
        want = _sdpa_reference(q.transpose(1, 2), ck, cv, d ** -0.5, None)
    _finish_within(60, f"K4 at Sq {sq}, Sk {sk}")
    assert got.shape == (b, sq, n, d)
    _k4_close(got, want)


def test_k1_k3_k7_at_the_i2v_rows_match_plain(dev, gen):
    """K1, K3 (rope and the cross-q split) and K7 (no GELU at 5120, GELU at
    13824) over 2 x 1587 rows (a 3 x 23 x 23 latent grid: no multiple of any
    block's rows; I2V-14B's 480p path has 2 x 31668), at their stated
    limits."""
    from wanq_tpu_torch.models.rope import pad_tables, rope_tables_interleaved
    from wanq_tpu_torch.ops.fused import (
        ln_modulate_quant_cuda, ln_modulate_quant_plain, quant_sum_cuda, quant_sum_plain)
    from wanq_tpu_torch.ops.rmsnorm_rope import (
        _k3_cuda, rms_rope_heads_plain, rms_split_heads_plain)

    grid = (3, 23, 23)
    b, s, c = 2, grid[0] * grid[1] * grid[2], 5120
    x = (torch.randn((b, s, c), device=dev, generator=gen) * 2 + 0.3).bfloat16()
    shift = torch.randn((b, c), device=dev, generator=gen) * 0.5
    scale = torch.randn((b, c), device=dev, generator=gen) * 0.5
    got, want = ln_modulate_quant_cuda(x, shift, scale), ln_modulate_quant_plain(x, shift, scale)
    diff = (got[0].int() - want[0].int()).abs()
    assert diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 1e-3
    ca, sb = rope_tables_interleaved(grid, 128)
    ca, sb = pad_tables(torch.from_numpy(ca.copy()).to(dev), torch.from_numpy(sb.copy()).to(dev),
                        s, s)
    wn = torch.rand((c,), device=dev, generator=gen) + 0.5
    for got, want in ((_k3_cuda(x, wn, ca, sb, 40, 1e-6, torch.bfloat16),
                       rms_rope_heads_plain(x, wn, ca, sb, 40)),
                      (_k3_cuda(x, wn, None, None, 40, 1e-6, torch.bfloat16),
                       rms_split_heads_plain(x, wn, 40))):
        g, w = got.float(), want.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
        assert ((g - w).abs() > ulp).float().mean().item() <= 1e-4
    for cw, gelu in ((5120, False), (13824, True)):
        xr = (torch.randn((b * s, cw), device=dev, generator=gen) * 2 + 0.2).bfloat16()
        got, want = quant_sum_cuda(xr, gelu), quant_sum_plain(xr, gelu)
        _finish_within(60, f"K7 C={cw}")
        d7 = (got[0].int() - want[0].int()).abs()
        assert d7.max().item() <= 1 and (d7 > 0).float().mean().item() <= 1e-3
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)


@pytest.mark.parametrize("kernel", ["K2", "K9"])
def test_k2_k9_at_the_image_context_rows_match_plain(dev, gen, kernel):
    """The image k/v projections of an I2V-14B config that quantizes them
    (wan_w4a4.yaml: K9; a W8A8 config: K7 -> K2): M = 2 x 257 = 514 rows
    (ragged), K = N = 5120, f32 out with bias. Both exact."""
    from wanq_tpu_torch.ops.qgemm import (
        w4a4_linear_cuda, w4a4_linear_plain, w8a8_linear_cuda, w8a8_linear_plain)

    m, k, n = 514, 5120, 5120
    bias = torch.randn((n,), device=dev, generator=gen)
    if kernel == "K9":
        a = torch.randint(-8, 8, (m, k), device=dev, generator=gen, dtype=torch.int8)
        wp = torch.randint(-128, 128, (n, k // 2), device=dev, generator=gen, dtype=torch.int8)
        s_a = torch.rand((m, k // 128), device=dev, generator=gen) * 0.02 + 1e-3
        s_w = torch.rand((k // 128, n), device=dev, generator=gen) * 0.02 + 1e-3
        args = (a, wp, s_a, s_w, bias)
        got, want = w4a4_linear_cuda(*args), w4a4_linear_plain(*args)
    else:
        a = torch.randint(-128, 128, (m, k), device=dev, generator=gen, dtype=torch.int8)
        w = torch.randint(-128, 128, (n, k), device=dev, generator=gen, dtype=torch.int8)
        s_a = torch.rand((m,), device=dev, generator=gen) * 0.02 + 1e-3
        s_w = torch.rand((n,), device=dev, generator=gen) * 0.02 / k ** 0.5 + 1e-5
        sum_a = s_a * a.float().sum(-1)
        zp = torch.randint(-20, 20, (n,), device=dev, generator=gen).float()
        args = (a, w, s_a, s_w, sum_a, zp, bias, torch.float32)
        got, want = w8a8_linear_cuda(*args), w8a8_linear_plain(*args)
    assert got.shape == (m, n) and torch.equal(got, want)


def test_clip_visual_and_resize_card_vs_cpu(dev):
    """CLIP's vision tower at ViT-H/14's width (1280, 16 heads, 224 x 224,
    257 tokens) with 3 blocks, f32 with TF32 off: the card's visual() of a
    480 x 832 frame (the cubic resize to 224 x 224 included) against the
    CPU's, rel-L2 <= 1e-4; the resize alone <= 1e-6."""
    import dataclasses

    from wanq_tpu_torch.models import clip as clipm

    cfg = dataclasses.replace(clipm.CLIP_XLM_ROBERTA_VIT_H_14, vision_layers=3)
    params = clipm.init_clip_params_on_device(cfg, seed=5, device=dev)
    vis = {k: v for k, v in params.items() if k.startswith("visual.")}
    video = torch.rand((1, 3, 1, 480, 832), generator=torch.Generator().manual_seed(6)) * 2 - 1
    card = clipm.CLIPModel(cfg, params=vis, device=dev).visual(video.to(dev))
    host = clipm.CLIPModel(cfg, params=_tree_to(vis, "cpu"), device="cpu").visual(video)
    assert card.shape == (1, 257, 1280) and bool(torch.isfinite(card).all())
    assert _rel(host, card) <= 1e-4
    r_card = clipm.resize_cubic(video[:, :, 0].to(dev), (224, 224))
    assert _rel(clipm.resize_cubic(video[:, :, 0], (224, 224)), r_card) <= 1e-6


def test_vae_encode_card_vs_cpu_f32_and_bf16(dev):
    """The full-width VAE (WAN_VAE_CFG) encodes a 5-frame 64 x 96 video on
    the card as on the CPU: f32 (cuDNN, TF32 off) rel-L2 <= 1e-4, bf16 rel-L2
    <= 2e-2 against the CPU's f32 (the latents are normalized, O(1))."""
    from wanq_tpu_torch.models import vae as vaem

    params = vaem.init_vae_params(vaem.WAN_VAE_CFG, seed=1, device="cpu")
    video = torch.rand((1, 3, 5, 64, 96), generator=torch.Generator().manual_seed(2)) * 2 - 1
    host = vaem.WanVAE(params=params, device="cpu").encode(video)
    card = vaem.WanVAE(params=params, device=dev).encode(video.to(dev))
    card16 = vaem.WanVAE(params=params, device=dev, compute_dtype=torch.bfloat16).encode(
        video.to(dev))
    assert card.shape == card16.shape == host.shape == (1, 16, 2, 8, 12)
    assert _rel(host, card) <= 1e-4
    assert _rel(host, card16.float()) <= 2e-2


def test_init_params_on_device_i2v_on_the_card(dev):
    """I2V-14B's tree at 2 of its 40 layers drawn on the card: the i2v
    leaves (img_emb, k_img, v_img, norm_k_img) with the host draw's shapes
    and dtypes, equal bits per seed, k_img's xavier bound and spread."""
    import dataclasses

    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.models.dit import init_params, init_params_on_device

    cfg = dataclasses.replace(WAN_CONFIGS["i2v-14B"], num_layers=2)
    a = init_params_on_device(cfg, 42, device=dev)
    b = init_params_on_device(cfg, 42, device=dev)
    small = dataclasses.replace(cfg, dim=256, num_heads=2, ffn_dim=512)
    host = init_params(small, 0, device="cpu")
    assert sorted(a["img_emb"]["proj"]) == sorted(host["img_emb"]["proj"]) == ["0", "1", "3", "4"]
    assert sorted(a["blocks"][1]["cross_attn"]) == sorted(host["blocks"][1]["cross_attn"])
    w = a["blocks"][1]["cross_attn"]["k_img"]["w"]
    assert w.shape == (5120, 5120) and w.dtype == torch.bfloat16 and w.is_cuda
    assert torch.equal(w, b["blocks"][1]["cross_attn"]["k_img"]["w"])
    bound = math.sqrt(6.0 / (2 * 5120))
    assert float(w.float().abs().max()) <= bound * 1.001
    assert abs(float(w.float().std()) / (bound / math.sqrt(3)) - 1) < 0.01
    assert a["img_emb"]["proj"]["1"]["w"].shape == (1280, 1280)
    assert a["img_emb"]["proj"]["3"]["w"].shape == (1280, 5120)
    assert torch.equal(a["blocks"][0]["cross_attn"]["norm_k_img"], torch.ones(5120, device=dev))


def test_i2v_forward_row_equals_a_lone_forward_on_the_card(dev):
    """An i2v forward (head dim 128: the fused routes, the two K4 cross
    launches, bf16 residual): the conditional row of a batched CFG pair
    equals a lone B = 1 forward bit for bit, the img_emb MLP included."""
    from wanq_tpu_torch.configs import tiny_config
    from wanq_tpu_torch.models.dit import dit_forward, init_params_on_device

    cfg = tiny_config(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32,
                      text_dim=64, freq_dim=64, param_dtype="bfloat16",
                      residual_dtype="bfloat16", model_type="i2v", in_dim=36, clip_dim=64)
    params = init_params_on_device(cfg, 3, device=dev)
    params["head"]["head"]["w"] = (torch.randn((256, 64), device=dev) * 0.02).bfloat16()
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((1, 16, 3, 8, 10), device=dev, generator=g)
    y = torch.randn((1, 20, 3, 8, 10), device=dev, generator=g)
    cf = torch.randn((1, 257, 64), device=dev, generator=g)
    c = torch.randn((2, 32, 64), device=dev, generator=g)
    t = torch.full((2,), 999.0, device=dev)
    with torch.no_grad():
        pair = dit_forward(params, cfg, torch.cat([x, x]), t, c, 60, clip_fea=torch.cat([cf, cf]),
                           y=torch.cat([y, y]))
        lone = dit_forward(params, cfg, x, t[:1], c[:1], 60, clip_fea=cf, y=y)
    assert bool(torch.isfinite(lone).all()) and torch.equal(pair[:1], lone)


def _bwd_inputs(dev, gen, b, n, sq, sk, valid):
    """q, k, v (v a strided view over [B, Sk, N*D]) and dO, bf16, with the pad
    tail of k/v planted (k = 0, v = 100): a missed mask in the forward, in P
    or in dP moves every gradient by far more than the limits."""
    d = 128
    q = torch.randn((b, sq, n, d), device=dev, generator=gen).bfloat16()
    k = torch.randn((b, sk, n, d), device=dev, generator=gen).bfloat16()
    v = torch.randn((b, sk, n * d), device=dev, generator=gen).bfloat16()
    k[:, valid:] = 0.0
    v[:, valid:] = 100.0
    do = torch.randn((b, sq, n, d), device=dev, generator=gen).bfloat16()
    return q, k, v.view(b, sk, n, d), do


def _grad_rel(got, want):
    """rel-L2, with a floor of 1e-5 a element under the norm: with a single
    valid key P = 1, so dS and with it dq and dk are 0 up to rounding."""
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    return ((g - w).norm() / max(w.norm().item(), 1e-3 * math.sqrt(w.numel()))).item()


# the shapes of K4's tests and the backward's edges (K12: 128-row q tiles,
# 128-key kv tiles in a 2-stage ring; K11: 128-key blocks, 64-row q steps in a
# 3-stage ring): Sq not a multiple of 64 or 128, a single valid key, more tiles and
# steps than the rings hold, kv_valid inside the last tile (290, 700, 513) and
# at a tile and K11-block boundary (384, 256: the blocks past it store zeros),
# Sk 257 (the I2V CLIP tokens)
@pytest.mark.parametrize("sq,sk,valid", [(300, 300, 290), (257, 77, 77), (130, 200, 1),
                                         (129, 777, 700), (256, 512, 512), (700, 640, 513),
                                         (191, 512, 384), (333, 257, 257), (64, 300, 256)])
def test_k4_residual_mode_k11_k12_match_plain(dev, gen, sq, sk, valid):
    """K4's residual mode against the plain forward with its LSE (output at
    K4's limits, LSE abs <= 1e-3), then K12 and K11 against
    attention_bwd_reference on the same o and LSE: rel-L2 <= 1e-2 (bf16 P and
    dS in the products), dk = dv = 0 exactly at the keys past kv_valid."""
    from wanq_tpu_torch.models.attention import (
        _flash_cuda, _sdpa_lse_reference, attention_bwd_reference, flash_attention_bwd)

    q, k, vh, do = _bwd_inputs(dev, gen, 2, 3, sq, sk, valid)
    _lib.reset_launch_counts()
    out, lse = _flash_cuda(q.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 0.0884,
                           valid, lse=True)
    want_o, want_lse = _sdpa_lse_reference(q, k, vh, 0.0884, valid)
    _k4_close(out, want_o)
    assert lse.shape == (2, 3, sq) and (lse - want_lse).abs().max().item() <= 1e-3
    dq, dk, dv = flash_attention_bwd(q, k, vh, out, lse, do, 0.0884, valid)
    _finish_within(60, f"K11/K12 sq {sq} sk {sk} valid {valid}")
    rq, rk, rv = attention_bwd_reference(q, k, vh, out, lse, do, 0.0884, valid)
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.shape == want.shape and _grad_rel(got, want) <= 1e-2
    assert not dk[:, valid:].any() and not dv[:, valid:].any()
    assert _lib.launch_counts() == {"attention_lse": 1, "attention_bwd_dq": 1,
                                    "attention_bwd_dkv": 1}


def test_trainable_attention_runs_the_kernels_under_autograd(dev, gen):
    """attention(trainable=True) on the card: the residual mode forward, K12
    and K11 backward, gradients within rel-L2 1e-2 of the plain route
    (force_reference); k and v that need no gradient skip K11; without
    autograd (a no-grad teacher) the plain K4 launch runs."""
    from wanq_tpu_torch.models.attention import attention

    q, k, vh, do = _bwd_inputs(dev, gen, 1, 2, 384, 300, 290)
    grads = []
    for ref in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, vh)]
        _lib.reset_launch_counts()
        out = attention(*leaves, scale=0.0884, k_valid_len=290, trainable=True,
                        force_reference=ref)
        out.backward(do)
        grads.append([t.grad for t in leaves])
        if not ref:
            assert _lib.launch_counts() == {"attention_lse": 1, "attention_bwd_dq": 1,
                                            "attention_bwd_dkv": 1}
    for got, want in zip(*grads):
        assert _grad_rel(got, want) <= 1e-2
    ql = q.clone().requires_grad_()
    _lib.reset_launch_counts()
    attention(ql, k, vh, scale=0.0884, k_valid_len=290, trainable=True).backward(do)
    assert _lib.launch_counts() == {"attention_lse": 1, "attention_bwd_dq": 1}
    _lib.reset_launch_counts()
    with torch.no_grad():
        attention(ql, k, vh, scale=0.0884, k_valid_len=290, trainable=True)
    assert _lib.launch_counts() == {"attention": 1}


def test_k11_k12_at_40_heads_and_cross_shape(dev, gen):
    """The T2V-14B head count and cross-attention shapes (Sk 512 and the 257
    CLIP tokens, every key valid) at small Sq, and 40 heads with kv_valid one
    key into the last tile and more steps than K11's ring holds, at the
    limits above."""
    from wanq_tpu_torch.models.attention import (
        _flash_cuda, attention_bwd_reference, flash_attention_bwd)

    for n, sq, sk, valid in ((40, 200, 200, 190), (4, 333, 512, 512), (12, 300, 257, 257),
                             (40, 321, 700, 513)):
        q, k, vh, do = _bwd_inputs(dev, gen, 1, n, sq, sk, valid)
        out, lse = _flash_cuda(q.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 0.0884,
                               valid, lse=True)
        got = flash_attention_bwd(q, k, vh, out, lse, do, 0.0884, valid)
        _finish_within(60, f"K11/K12 {n} heads sq {sq} sk {sk}")
        want = attention_bwd_reference(q, k, vh, out, lse, do, 0.0884, valid)
        for g_, w_ in zip(got, want):
            assert _grad_rel(g_, w_) <= 1e-2
        assert not got[1][:, valid:].any() and not got[2][:, valid:].any()


def _strided_bwd_inputs(dev, gen, b, n, s, valid):
    """q, k, v as [B, S, N, D] views of one fused [B, S + 5, 3 N D] projection
    (row stride 3 N D, batch stride (S + 5) 3 N D: neither is the contiguous
    one) and dO a view of [B, S, 2 N D] rows; the pad keys planted as in
    _bwd_inputs."""
    d = 128
    qkv = torch.randn((b, s + 5, 3 * n * d), device=dev, generator=gen).bfloat16()[:, :s]
    q, k, v = (qkv[..., i * n * d:(i + 1) * n * d].view(b, s, n, d) for i in range(3))
    k[:, valid:] = 0.0
    v[:, valid:] = 100.0
    do = torch.randn((b, s, 2 * n * d), device=dev, generator=gen).bfloat16()
    return q, k, v, do[..., n * d:].view(b, s, n, d)


def test_k11_k12_read_strided_views_and_give_equal_bits(dev, gen):
    """B = 2, q / k / v / dO as strided views of wider rows (batch and row
    strides not the contiguous ones): K12 and K11 against
    attention_bwd_reference on contiguous copies at the limits above, and a
    second call equal to the first bit for bit (no atomics: one order of
    every sum)."""
    from wanq_tpu_torch.models.attention import (
        _flash_cuda, attention_bwd_reference, flash_attention_bwd)

    sq, valid = 450, 391
    q, k, v, do = _strided_bwd_inputs(dev, gen, 2, 3, sq, valid)
    assert q.stride(1) == 3 * 3 * 128 and q.stride(0) == (sq + 5) * 3 * 3 * 128
    out, lse = _flash_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 0.0884,
                           valid, lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do, 0.0884, valid)
    again = flash_attention_bwd(q, k, v, out, lse, do, 0.0884, valid)
    _finish_within(60, "K11/K12 strided views")
    want = attention_bwd_reference(*(t.contiguous() for t in (q, k, v)), out, lse,
                                   do.contiguous(), 0.0884, valid)
    for g_, a_, w_ in zip(got, again, want):
        assert g_.is_contiguous() and g_.shape == w_.shape
        assert _grad_rel(g_, w_) <= 1e-2
        assert torch.equal(g_, a_)
    assert not got[1][:, valid:].any() and not got[2][:, valid:].any()


# ring hops: shards of a 4-rank ring of 1024 tokens (the last 24 pad: the last
# shard's valid length 232), of a 3-rank ring of 900 (Sq 300, not a multiple of
# 128: the row table's +inf rows), and of a 2-rank ring of 640 with one valid key
# in the last shard
@pytest.mark.parametrize("n,s,valid", [(4, 1024, 1000), (3, 900, 890), (2, 640, 321)])
def test_k11_k12_accumulate_mode_matches_plain(dev, gen, n, s, valid):
    """K12 and K11's accumulate mode, one launch of each a visited hop, from one
    row table of the rank's rows (the whole sequence's LSE and output): each
    hop added into non-zero f32 buffers equals the plain version
    (attention_bwd_reference(rows=)) added into the same, rel-L2 <= 1e-2 of
    the hop's part; over all hops the f32 sums equal flash_attention_bwd's
    whole backward at its limits; dk = dv = 0 added past a shard's valid keys;
    a second run gives equal bits; the launches are one of each a hop."""
    from wanq_tpu_torch.models.attention import (
        _flash_cuda, attention_bwd_reference, flash_attention_bwd, flash_attention_bwd_acc,
        flash_bwd_rows)

    q, k, vh, do = _bwd_inputs(dev, gen, 2, 3, s, s, valid)
    out, lse = _flash_cuda(q.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 0.0884,
                           valid, lse=True)
    s_loc = s // n
    whole = flash_attention_bwd(q, k, vh, out, lse, do, 0.0884, valid)
    for idx in (0, n - 1):
        rows_sl = slice(idx * s_loc, (idx + 1) * s_loc)
        qs, dos = q[:, rows_sl], do[:, rows_sl]
        rows = flash_bwd_rows(lse[:, :, rows_sl].contiguous(), out[:, rows_sl], dos)
        runs = []
        start = (torch.randn((2, s_loc, 3, 128), device=dev, generator=gen),
                 *(torch.randn((2, s, 3, 128), device=dev, generator=gen) for _ in range(2)))
        for _ in range(2):
            dq, dk, dv = (t.clone() for t in start)
            _lib.reset_launch_counts()
            hops = 0
            for src in range(n):
                kv_valid = min(s_loc, valid - src * s_loc)
                if kv_valid < 1:
                    continue
                hops += 1
                sl = slice(src * s_loc, (src + 1) * s_loc)
                before = (dq.clone(), dk[:, sl].clone(), dv[:, sl].clone())
                dks, dvs = dk[:, sl].contiguous(), dv[:, sl].contiguous()
                flash_attention_bwd_acc(qs, k[:, sl], vh[:, sl], dos, rows, 0.0884, kv_valid,
                                        dq, dks, dvs)
                dk[:, sl], dv[:, sl] = dks, dvs
                want = attention_bwd_reference(qs, k[:, sl], vh[:, sl], None, None, dos, 0.0884,
                                               kv_valid, rows=rows)
                for got, b0, w in zip((dq, dks, dvs), before, want):
                    assert _grad_rel(got - b0, w) <= 1e-2
                assert torch.equal(dks[:, kv_valid:], before[1][:, kv_valid:])
                assert torch.equal(dvs[:, kv_valid:], before[2][:, kv_valid:])
            _finish_within(60, f"K11/K12 accumulate n {n} rank {idx}")
            assert _lib.launch_counts() == {"attention_bwd_dq_acc": hops,
                                            "attention_bwd_dkv_acc": hops}
            assert _grad_rel(dq - start[0], whole[0][:, rows_sl]) <= 1e-2
            runs.append((dq, dk, dv))
        assert all(torch.equal(a, z) for a, z in zip(*runs))
    with pytest.raises(ValueError):
        flash_attention_bwd_acc(qs, k[:, :s_loc], vh[:, :s_loc], dos, rows, 0.0884, 0, dq)


def test_ring_attention_autograd_on_one_rank_runs_the_hop_kernels(dev, gen):
    """ring_attention under autograd with no ring group (one rank, one hop):
    K4's partial mode forward, K12 / K11's accumulate mode backward, its
    gradients within rel-L2 1e-2 of attention(trainable=True)'s (K4's
    residual mode, K12, K11); a window under training raises."""
    from wanq_tpu_torch.models.attention import TemporalWindow, attention
    from wanq_tpu_torch.parallel.ring import ring_attention

    q, k, vh, do = _bwd_inputs(dev, gen, 1, 2, 384, 384, 290)
    grads = []
    for route in ("ring", "single"):
        leaves = [t.clone().requires_grad_() for t in (q, k, vh)]
        _lib.reset_launch_counts()
        if route == "ring":
            out = ring_attention(*leaves, scale=0.0884, k_valid_len=290)
        else:
            out = attention(*leaves, scale=0.0884, k_valid_len=290, trainable=True)
        out.backward(do)
        grads.append([t.grad for t in leaves])
        if route == "ring":
            assert _lib.launch_counts() == {"attention_partial": 1, "attention_bwd_dq_acc": 1,
                                            "attention_bwd_dkv_acc": 1}
    for got, want in zip(*grads):
        assert _grad_rel(got, want) <= 1e-2
    with pytest.raises(NotImplementedError, match="dense"):
        ring_attention(q.clone().requires_grad_(), k, vh, scale=0.0884, k_valid_len=290,
                       window=TemporalWindow(100, 1))


# ---------------------------------------------------------------------------
# evaluation (utils/fvd.py, image_metrics.py, clip_metrics.py, flow.py,
# cli/evaluate.py) on the card against the CPU
# ---------------------------------------------------------------------------


def _eval_videos(shape, seed=0):
    rng = np.random.default_rng(seed)
    fp = rng.uniform(-1, 1, shape).astype(np.float32)
    return fp, (fp + 0.1 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("net", ["I3DLike", "InceptionLike"])
def test_feature_nets_card_vs_cpu_ragged(dev, net):
    """The random feature nets at odd and even sides (XLA's asymmetric SAME
    pads) on the card against the CPU within rel-L2 1e-5, with TF32 turned on
    by the caller: the nets turn it off inside and give the setting back."""
    from wanq_tpu_torch.utils import fvd, image_metrics

    fp, _ = _eval_videos((2, 9, 37, 50, 3))
    cls = fvd.I3DLikeFeatures if net == "I3DLike" else image_metrics.InceptionLikeFeatures
    x = fp if net == "I3DLike" else fp[:, 0]
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = cls(device=dev)(x)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    host = cls(device="cpu")(x)
    assert card.shape == host.shape == (2, 256)
    assert np.linalg.norm(card - host) / np.linalg.norm(host) <= 1e-5


def test_clip_frame_features_card_vs_cpu(dev):
    """The full 32-block ViT-H tower at 2 x 3 frames of 96 x 160 (chunk 4, a
    ragged tail) on the card against the CPU within 1e-5 abs, and the text
    tower at 4 layers."""
    import dataclasses

    from wanq_tpu_torch.models import clip as clipm
    from wanq_tpu_torch.utils import clip_metrics as cm

    cfg = dataclasses.replace(clipm.CLIP_XLM_ROBERTA_VIT_H_14, text_layers=4,
                              vocab_size=1000)
    params = clipm.init_clip_params_on_device(cfg, seed=1, device=dev)
    fp, _ = _eval_videos((2, 3, 96, 160, 3))
    card = cm.clip_frame_features(params, cfg, fp, frame_chunk=4, device=dev)
    host_p = {k: v.cpu() for k, v in params.items()}
    host = cm.clip_frame_features(host_p, cfg, fp, frame_chunk=4, device="cpu")
    assert card.shape == host.shape == (2, 3, 1024)
    assert np.abs(card - host).max() <= 1e-5
    ids = np.random.default_rng(2).integers(2, 1000, (2, 9))
    t_card = cm.text_features(params, cfg, ids, device=dev)
    t_host = cm.text_features(host_p, cfg, ids, device="cpu")
    assert np.abs(t_card - t_host).max() <= 1e-5


def test_flow_score_card_vs_cpu(dev):
    """Two 9-frame 200 x 300 videos (one halving to <= 128 px, a moving
    pattern and noise) on the card against the CPU within 1e-4 relative."""
    from wanq_tpu_torch.utils.flow import flow_score

    yy, xx = np.mgrid[0:200, 0:300] / 100.0
    base = 0.5 + 0.3 * np.sin(3 * xx) * np.cos(2 * yy)
    moving = np.stack([np.stack([np.roll(base, 2 * i, axis=1)] * 3, -1) for i in range(9)])
    noisy = _eval_videos((1, 9, 200, 300, 3))[0]
    v = np.concatenate([moving[None], noisy]).astype(np.float32)
    card, host = flow_score(v, device=dev), flow_score(v, device="cpu")
    assert host > 0 and abs(card - host) <= 1e-4 * host


def test_evaluate_on_the_card_end_to_end(dev, tmp_path, monkeypatch):
    """cli.evaluate --device cuda with --clip_metrics --flow_score on a small
    pair (a 2-layer CLIP tower standing in for ViT-H): every value finite,
    the same keys as --device cpu, and the entries that do not read the CLIP
    tower (whose random draw differs by device) within 1e-4 of the CPU's."""
    import dataclasses

    from wanq_tpu_torch.cli import evaluate
    from wanq_tpu_torch.models import clip as clipm

    small = dataclasses.replace(clipm.CLIP_XLM_ROBERTA_VIT_H_14, vision_layers=2, text_layers=2,
                                vocab_size=1000)
    monkeypatch.setattr(clipm, "CLIP_XLM_ROBERTA_VIT_H_14", small)
    fp, q = _eval_videos((2, 5, 48, 64, 3), seed=3)
    np.savez(tmp_path / "fp.npz", videos=fp)
    np.savez(tmp_path / "q.npz", videos=q)
    flags = ["--fp", str(tmp_path / "fp.npz"), "--quant", str(tmp_path / "q.npz"),
             "--clip_metrics", "--flow_score"]
    card = evaluate.main(flags + ["--device", "cuda"])
    host = evaluate.main(flags + ["--device", "cpu"])
    assert set(card) == set(host) and all(np.isfinite(v) for v in card.values())
    for k, want in host.items():
        if not k.startswith("clip_"):
            assert abs(card[k] - want) <= 1e-4 * max(abs(want), 1e-12), k


# ---------------------------------------------------------------------------
# the W4/W8 capacity plan's ffn pair, the streamed base, QLoRA at 14B x 9 frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 129, 1024 + 3, 2 * 4680 - 5])
def test_k8_gelu_quant_mode_feeds_k2(dev, gen, m):
    """The ffn pair of quant_generate --auto_bits_gib's plans (a W4 ffn.0, a
    static W8 ffn.2): K8's GELU + quant mode hands K2 the int8 codes, scale
    and row sums that K2's own mode gives on the unpacked weight, bit for
    bit, and the pair K8 mode -> K2 equals the plain chain exactly, ragged M
    too (narrow widths; chip_smoke.py phase 2 runs each mode at the 14B
    widths)."""
    from wanq_tpu_torch.ops.qgemm import (
        w4a8_linear_gelu_quant_cuda, w4a8_linear_gelu_quant_plain, w8a8_linear_cuda,
        w8a8_linear_gelu_quant_cuda, w8a8_linear_plain)
    from wanq_tpu_torch.quant.quantizers import unpack_int4

    k, n, n2 = 512, 1280, 256  # ffn.0: k -> n at W4; ffn.2: n -> n2 at W8
    a, wp, s_a, s_w, sum_a, zp, bias = _k8_operands(dev, gen, m, k, n)
    scale2 = torch.tensor(0.03, device=dev)
    got = w4a8_linear_gelu_quant_cuda(a, wp, s_a, s_w, scale2, sum_a, zp, bias)
    plain = w4a8_linear_gelu_quant_plain(a, wp, s_a, s_w, scale2, sum_a, zp, bias)
    _check_gelu_quant(got, plain, scale2)
    k2_mode = w8a8_linear_gelu_quant_cuda(a, unpack_int4(wp), s_a, s_w, scale2, sum_a, zp, bias)
    assert all(torch.equal(x, y) for x, y in zip(got, k2_mode))
    _, w2, _, s_w2, _, zp2, bias2 = _k2_operands(dev, gen, 1, n, n2)
    out = w8a8_linear_cuda(got[0], w2, got[1], s_w2, got[2], zp2, bias2, torch.float32)
    want = w8a8_linear_plain(plain[0], w2, plain[1], s_w2, plain[2], zp2, bias2, torch.float32)
    assert out.shape == (m, n2) and torch.equal(out, want)


def test_streamed_base_matches_conventional_build_at_14b_width(dev):
    """quant/stream.py at T2V-14B's width (dim 5120, 40 heads, ffn 13824), one
    block: every state leaf equal bit for bit to prepare_quant_state on the
    same generators' draws, and the int8 forward within rel-L2 1e-3 of the
    conventional build's (chip_smoke.py phase 9 (i) runs 2 blocks)."""
    import dataclasses

    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.models import dit
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state
    from wanq_tpu_torch.quant.qlinear import QuantCtx
    from wanq_tpu_torch.quant.stream import (
        BLOCK_SEED, PRELUDE_SEED, build_streamed_quant_base, head_draw)

    cfg = dataclasses.replace(WAN_CONFIGS["t2v-14B"], num_layers=1)
    qcfg = QuantConfig.from_dict({
        "remain_fp_regex": r"text_embedding|time_embedding|time_projection|head\.head",
        "weight": {"n_bits": 4, "sym": False}, "act": {"n_bits": 8, "sym": True}})
    params_s, qctx_s, qbytes = build_streamed_quant_base(cfg, qcfg, device=dev)
    params = dit.make_nonblock_generator(cfg, device=dev)(PRELUDE_SEED)
    w = params["head"]["head"]["w"]
    params["head"]["head"]["w"] = head_draw(w.shape, w.dtype, dev)
    params["blocks"] = [dit.make_block_generator(cfg, device=dev)(BLOCK_SEED)]
    pol, state, rot = prepare_quant_state(params, dit.linear_layer_names(cfg), qcfg,
                                          targets="int8")
    assert sorted(state) == sorted(qctx_s.state) and len(state) == 10
    for name, st in state.items():
        assert all(torch.equal(v, qctx_s.state[name][key]) for key, v in st.items()), name
    assert qbytes == sum(v.numel() * v.element_size() for st in state.values()
                         for v in st.values())
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((1, 16, 2, 16, 32), device=dev, generator=g)
    c = torch.randn((1, cfg.text_len, cfg.text_dim), device=dev, generator=g)
    t = torch.tensor([500.0], device=dev)
    with torch.no_grad():
        out_s = dit.dit_forward(params_s, cfg, x, t, c, 256, ctx=qctx_s)
        out_c = dit.dit_forward(params, cfg, x, t, c, 256,
                                ctx=QuantCtx(mode="int8", policies=pol, state=state,
                                             rotations=rot))
    assert torch.isfinite(out_s).all()
    assert ((out_s.float() - out_c.float()).norm() / out_c.float().norm()).item() <= 1e-3


@pytest.mark.parametrize("sk", [4680, 512], ids=["self", "cross"])
def test_k4_residual_k11_k12_at_14b_nine_frames(dev, gen, sk):
    """K4's residual mode, K12 and K11 at the 14B QLoRA shape of chip_smoke.py
    phase 9: q [1, 4680, 40, 128] (36 full 128-row tiles and 72 rows, no pad
    keys) against itself or the 512 text tokens, at the limits above; the row
    table's 56 pad rows hold (+inf, 0)."""
    from wanq_tpu_torch.models.attention import (
        _flash_cuda, _sdpa_lse_reference, attention_bwd_reference, flash_attention_bwd,
        flash_bwd_rows)

    sq = 4680
    q, k, vh, do = _bwd_inputs(dev, gen, 1, 40, sq, sk, sk)
    out, lse = _flash_cuda(q.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 0.0884, sk,
                           lse=True)
    want_o, want_lse = _sdpa_lse_reference(q, k, vh, 0.0884, sk, q_chunk=1024)
    _k4_close(out, want_o)
    assert (lse - want_lse).abs().max().item() <= 1e-3
    rows = flash_bwd_rows(lse, out, do)
    assert rows.shape == (1, 40, 2, 4736)
    assert (rows[:, :, 0, sq:] == math.inf).all() and not rows[:, :, 1, sq:].any()
    got = flash_attention_bwd(q, k, vh, out, lse, do, 0.0884, sk)
    _finish_within(120, f"K11/K12 at [1, 40, {sq}, 128], Sk {sk}")
    want = attention_bwd_reference(q, k, vh, out, lse, do, 0.0884, sk, q_chunk=1024)
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape and _grad_rel(g_, w_) <= 1e-2


# ---------------------------------------------------------------------------
# the trainable quantized linear (QLoRA's route) at the 14B shapes
# ---------------------------------------------------------------------------


def _trainable_layer(dev, gen, c_in, c_out, static):
    """A W4 trainable layer 'lin' with a rank-16 adapter (b != 0): (ctx, bias)."""
    from wanq_tpu_torch.quant.config import LayerPolicy
    from wanq_tpu_torch.quant.qlinear import QuantCtx
    from wanq_tpu_torch.quant.quantizers import QuantizerCfg, pack_int4, weight_int_quant

    w = torch.randn((c_in, c_out), device=dev, generator=gen) * 0.02
    wcfg = QuantizerCfg(n_bits=4, sym=False)
    codes, scale, zp = weight_int_quant(w, wcfg)
    st = {"w_int4": pack_int4(codes), "scale_w": scale, "zp_w_int": zp,
          "lora_a": torch.randn((c_in, 16), device=dev, generator=gen) * 0.02,
          "lora_b": torch.randn((16, c_out), device=dev, generator=gen) * 0.5}
    if static:
        st["delta_a"] = torch.tensor([8.0 / 127], device=dev)
        st["zp_a"] = torch.zeros(1, device=dev)
    pol = LayerPolicy(method="base", weight=wcfg,
                      act=QuantizerCfg(n_bits=8, sym=True, dynamic=not static))
    return (QuantCtx(mode="int8", policies={"lin": pol}, state={"lin": st}, trainable=True),
            torch.randn((c_out,), device=dev, generator=gen) * 0.1)


def _chain_trainable_qlinear(st, bias, x):
    """The trainable route as the autograd chain it replaced (f32 fake-quant,
    f32 dequant, fp_linear, the adapter on x.float()): the reference."""
    from wanq_tpu_torch.quant.qlinear import fp_linear
    from wanq_tpu_torch.quant.quantizers import compute_quant_params, fake_quant, unpack_int4

    b, n, c = x.shape
    xf = x.float()
    if "delta_a" in st:
        xq = fake_quant(xf, st["delta_a"], st["zp_a"], 8, True)
    else:
        d_a, zp_a = compute_quant_params(xf.reshape(b * n, c), 8, True)
        xq = fake_quant(xf.reshape(b * n, c), d_a, zp_a, 8, True).reshape(b, n, c)
    w_deq = (unpack_int4(st["w_int4"]).float() + st["zp_w_int"][:, None]) * st["scale_w"][:, None]
    y = fp_linear({"w": w_deq.t(), "b": bias}, xq)
    return y + (x.float() @ st["lora_a"].float()) @ st["lora_b"].float()


@pytest.mark.parametrize("c_in,c_out,static", [(5120, 5120, False), (13824, 5120, False),
                                               (5120, 13824, True)],
                         ids=["self_o", "ffn2", "ffn0_static"])
def test_trainable_linear_matches_the_chain_at_14b_shapes(dev, gen, c_in, c_out, static):
    """The trainable route on the card at the 14B 9-frame rows (M = 4680,
    bf16 input, one row chunk) against the chain it replaced: the forward and
    the gradients to x, the adapters and a static delta_a equal bit for bit
    (the same products, the same elementwise passes, and row sums that do not
    depend on the chunk). Planted: a tied absmax, a row under the eps, codes
    on -128 / 127 (static)."""
    from wanq_tpu_torch.quant.qlinear import qlinear

    ctx, bias = _trainable_layer(dev, gen, c_in, c_out, static)
    x = (torch.randn((1, 4680, c_in), device=dev, generator=gen) * 2).bfloat16()
    x[0, 0, 3], x[0, 0, 7] = 9.0, -9.0
    x[0, 1] = 1e-8
    x[0, 2, :4] = torch.tensor([-8.0, 8.0, -9.0, 9.0])
    g = torch.randn((1, 4680, c_out), device=dev, generator=gen)
    grads, outs = [], []
    for route in ("function", "chain"):
        st = dict(ctx.state["lin"])
        keys = ["lora_a", "lora_b"] + (["delta_a"] if static else [])
        for k in keys:
            st[k] = st[k].clone().requires_grad_()
        xl = x.clone().requires_grad_()
        if route == "function":
            import dataclasses

            y = qlinear(dataclasses.replace(ctx, state={"lin": st}), "lin", {"b": bias}, xl)
        else:
            y = _chain_trainable_qlinear(st, bias, xl)
        outs.append(y)
        grads.append(torch.autograd.grad(y, [xl] + [st[k] for k in keys], g))
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    for name, got, want in zip(("x", "lora_a", "lora_b", "delta_a"), *grads):
        rel = ((got.double() - want.double()).norm() / want.double().norm()).item()
        assert got.dtype == want.dtype and torch.equal(got, want), (name, rel)


def test_trainable_linear_keeps_no_f32_copy_at_81_frames(dev, gen):
    """ffn.2's trainable route at 832x480x81 (M = 32760, C_in 13824, bf16, 7
    row chunks of 4680): after the forward it holds its f32 output and per-row
    tensors only (the chain it replaced held five f32 copies of its input,
    8.4 GiB), and the input's gradient is the chain's bit for bit."""
    from wanq_tpu_torch.quant.qlinear import qlinear

    ctx, bias = _trainable_layer(dev, gen, 13824, 5120, False)
    st = ctx.state["lin"]
    st["lora_a"].requires_grad_()
    st["lora_b"].requires_grad_()
    x = (torch.randn((1, 32760, 13824), device=dev, generator=gen) * 2).bfloat16()
    x.requires_grad_()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    y = qlinear(ctx, "lin", {"b": bias}, x)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before - y.numel() * y.element_size()
    assert held <= 32760 * 64 * 4, f"{held / 2**20:.1f} MiB held beside the output"
    g = torch.randn(y.shape, device=dev, generator=gen)
    gx, = torch.autograd.grad(y, [x], g)
    del y
    want, = torch.autograd.grad(_chain_trainable_qlinear(st, bias, x), [x], g)
    assert torch.equal(gx, want)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


# K13 at the whole 1.3B update [2, 32768, 1536], a 14B width, and a ragged
# shape whose vectors do not fill the last block
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("with_gate", [False, True], ids=["nogate", "gate"])
@pytest.mark.parametrize("shape", [(2, 32768, 1536), (2, 4096, 5120), (3, 301, 40)],
                         ids=["1.3b", "14b", "ragged"])
def test_k13_kernel_matches_plain_bit_for_bit(dev, gen, shape, with_gate, with_bias):
    from wanq_tpu_torch.ops.fused import gate_residual_cuda, gate_residual_plain

    b, s, c = shape
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(shape, device=dev, generator=gen) * 4).to(dtype)
        y = torch.randn(shape, device=dev, generator=gen) * 3
        x[0, 0, :8] = -0.0  # -0 + -0 keeps its sign only where no bias is added
        y[0, 0, :8] = -0.0
        # the gate as the block passes it: a column of its [B, 6, C] modulation
        gate = torch.randn((b, 6, c), device=dev, generator=gen)[:, 2] if with_gate else None
        bias = torch.randn((c,), device=dev, generator=gen).bfloat16() if with_bias else None
        _lib.reset_launch_counts()
        got = gate_residual_cuda(x, y, gate, bias)
        _finish_within(60, f"K13 {shape} {dtype}")
        assert _lib.launch_counts() == {"gate_residual": 1}
        want = gate_residual_plain(x, y, gate, bias)
        assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))


def test_k13_dispatch_launches_under_autograd_too(dev, gen):
    from wanq_tpu_torch.ops.fused import gate_residual, gate_residual_plain

    x = torch.randn((2, 64, 256), device=dev, generator=gen).bfloat16()
    y = torch.randn((2, 64, 256), device=dev, generator=gen).requires_grad_()
    gate = torch.randn((2, 256), device=dev, generator=gen)
    want = gate_residual_plain(x, y.detach(), gate)
    _lib.reset_launch_counts()
    out = gate_residual(x, y, gate)
    torch.cuda.synchronize()
    assert out.grad_fn is not None and _lib.launch_counts() == {"gate_residual": 1}
    with torch.no_grad():
        got = gate_residual(x, y, gate)
    torch.cuda.synchronize()
    assert _lib.launch_counts() == {"gate_residual": 2}
    assert torch.equal(_bits(got), _bits(want)) and torch.equal(_bits(out.detach()), _bits(want))


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("with_gate", [False, True], ids=["nogate", "gate"])
def test_k13_backward_matches_the_plain_chains_autograd(dev, gen, with_gate, with_bias):
    """K13 under autograd at the 1.3B update's shape: output and the
    gradients of x, y, gate and bias equal bit for bit to autograd through
    the plain chain, one launch."""
    from wanq_tpu_torch.ops.fused import gate_residual, gate_residual_plain

    shape = (2, 32768, 1536)
    x = (torch.randn(shape, device=dev, generator=gen) * 4).bfloat16()
    y = torch.randn(shape, device=dev, generator=gen) * 3
    gate = torch.randn((2, 6, 1536), device=dev, generator=gen) if with_gate else None
    bias = torch.randn((1536,), device=dev, generator=gen).bfloat16() if with_bias else None
    up = torch.randn(shape, device=dev, generator=gen).bfloat16()

    def run(fn):
        leaves = [t.clone().requires_grad_() if t is not None else None
                  for t in (x, y, gate, bias)]
        g = leaves[2][:, 2] if with_gate else None  # a column, as the block passes it
        out = fn(leaves[0], leaves[1], g, leaves[3])
        out.backward(up)
        return [out.detach()] + [t.grad for t in leaves if t is not None]

    _lib.reset_launch_counts()
    got = run(gate_residual)
    _finish_within(60, "K13 backward")
    assert _lib.launch_counts() == {"gate_residual": 1}
    want = run(gate_residual_plain)
    assert len(got) == len(want)
    assert all(a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


def test_k13_training_block_gradients_equal_the_plain_chain(dev):
    """A training block on the card (bf16 residual, K4's residual mode, K12
    and K11): its three residual updates through K13 give the output and the
    gradients of the plain chain bit for bit."""
    import wanq_tpu_torch.models.dit as tdit
    from wanq_tpu_torch.configs import tiny_config
    from wanq_tpu_torch.models.rope import rope_tables_interleaved
    from wanq_tpu_torch.ops.fused import gate_residual_plain

    cfg = tiny_config(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32,
                      text_dim=64, freq_dim=64, param_dtype="bfloat16",
                      residual_dtype="bfloat16")
    params = tdit.init_params_on_device(cfg, 6, device=dev)
    bp = params["blocks"][1]
    leaves = [bp["modulation"], bp["self_attn"]["o"]["w"], bp["cross_attn"]["o"]["b"],
              bp["ffn"]["2"]["w"]]
    g = torch.Generator(device=dev).manual_seed(5)
    x0 = torch.randn((2, 64, 256), device=dev, generator=g).bfloat16()
    e = torch.randn((2, 6, 256), device=dev, generator=g) * 0.1
    c = torch.randn((2, 32, 256), device=dev, generator=g).bfloat16()
    ca, sb = (torch.as_tensor(np.array(t), device=dev)
              for t in rope_tables_interleaved((3, 4, 5), cfg.head_dim))

    def grads():
        for leaf in leaves:
            leaf.grad = None
            leaf.requires_grad_(True)
        x = x0.clone().requires_grad_(True)
        out = tdit.block_forward(bp, "blocks.1", None, x, e, c, cfg, ca, sb, 60,
                                 training=True)
        out.float().square().sum().backward()
        return [out.detach()] + [t.grad.clone() for t in leaves + [x]]

    _lib.reset_launch_counts()
    got = grads()
    assert _lib.launch_counts()["gate_residual"] == 3
    real = tdit.gate_residual
    tdit.gate_residual = gate_residual_plain
    try:
        want = grads()
    finally:
        tdit.gate_residual = real
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


def test_k13_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    from wanq_tpu_torch.ops.fused import gate_residual_cuda

    shape = (2, 64, 48)
    x = torch.zeros(shape, device=dev, dtype=torch.bfloat16)
    y = torch.zeros(shape, device=dev)
    y_off = torch.zeros(y.numel() + 1, device=dev)[1:].view(shape)  # 4 bytes off 16
    x_off = torch.zeros(x.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(shape)
    bad = [
        (x, y.bfloat16(), None),                                # y not f32
        (x, y.double(), None),
        (x[..., :44].contiguous(), y[..., :44].contiguous(), None),  # C not a multiple of 8
        (x, y_off, None),                                       # y misaligned
        (x_off, y, None),                                       # x misaligned
        (x, y.transpose(0, 1).contiguous().transpose(0, 1), None),  # y not contiguous
        (x, y[:1], None),                                       # shapes differ
        (x, y, torch.zeros((2, 40), device=dev)),               # gate not [B, C]
    ]
    _lib.reset_launch_counts()
    for xi, yi, gi in bad:
        with pytest.raises(ValueError):
            gate_residual_cuda(xi, yi, gi)
    assert not _lib.launch_counts()


# K1 and K13 reading a per-frame table (Wan2.2 TI2V-5B: 31 latent frames of 880
# tokens over 27648 padded ones, the pads on the last row) and ragged rows (the
# last row shorter than the others; 5120 wide, four warps a K1 row)
_TABLES = [((2, 27648, 3072), 880, 31), ((3, 301, 1536), 37, 9), ((2, 300, 5120), 41, 8)]
_TABLE_IDS = ["ti2v-5b", "ragged-1536", "ragged-5120"]


def _table_rows(n, tpr, rows):
    """The token slices of a table's rows (the last row takes the rest)."""
    return [slice(r * tpr, n if r == rows - 1 else (r + 1) * tpr) for r in range(rows)]


@pytest.mark.parametrize("shape, tpr, rows", _TABLES, ids=_TABLE_IDS)
def test_k1_table_rows_are_their_one_row_calls(dev, gen, shape, tpr, rows):
    """A table call gives each row's tokens the bits of a one-row call on
    those tokens with that row, and agrees with the plain version as K1
    does; shift and scale are columns of a [B, R, 6, C] modulation, read
    where they lie."""
    from wanq_tpu_torch.ops.fused import ln_modulate_quant_cuda, ln_modulate_quant_plain

    b, n, c = shape
    x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.3).bfloat16()
    mod = torch.randn((b, rows, 6, c), device=dev, generator=gen) * 0.5
    shift, scale = mod[:, :, 0], mod[:, :, 1]
    _lib.reset_launch_counts()
    got = ln_modulate_quant_cuda(x, shift, scale, tokens_per_row=tpr)
    _finish_within(60, f"K1 table {shape}")
    assert _lib.launch_counts() == {"ln_modulate_quant": 1, "ln_modulate_quant_rows": 1}
    for r, seg in enumerate(_table_rows(n, tpr, rows)):
        one = ln_modulate_quant_cuda(x[:, seg].contiguous(), shift[:, r], scale[:, r])
        for g, o in zip(got, one):
            assert torch.equal(g[:, seg], o), (r, seg)
    _check_k1(got, ln_modulate_quant_plain(x, shift, scale, tokens_per_row=tpr))


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("shape, tpr, rows", _TABLES + [((3, 301, 40), 37, 9)],
                         ids=_TABLE_IDS + ["ragged-40"])
def test_k13_table_matches_plain_bit_for_bit(dev, gen, shape, tpr, rows, with_bias):
    from wanq_tpu_torch.ops.fused import gate_residual, gate_residual_cuda, gate_residual_plain

    b, s, c = shape
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(shape, device=dev, generator=gen) * 4).to(dtype)
        y = torch.randn(shape, device=dev, generator=gen) * 3
        gate = torch.randn((b, rows, 6, c), device=dev, generator=gen)[:, :, 2]
        bias = torch.randn((c,), device=dev, generator=gen) if with_bias else None
        _lib.reset_launch_counts()
        got = gate_residual_cuda(x, y, gate, bias, tokens_per_row=tpr)
        _finish_within(60, f"K13 table {shape} {dtype}")
        assert _lib.launch_counts() == {"gate_residual": 1, "gate_residual_rows": 1}
        want = gate_residual_plain(x, y, gate, bias, tokens_per_row=tpr)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(gate_residual(x, y, gate, bias, tokens_per_row=tpr)),
                           _bits(want))


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_k13_table_backward_matches_the_plain_chains_autograd(dev, gen, with_bias):
    """K13 under autograd with TI2V-5B's per-frame gate table ([2, 27648,
    3072], 31 rows of 880 tokens, the gate a column of the [B, 31, 6, C]
    modulation): one launch through the dispatch, and the output and the
    gradients of x, y, the modulation and the bias equal bit for bit to
    autograd through the plain chain's broadcast."""
    from wanq_tpu_torch.ops.fused import gate_residual, gate_residual_plain

    (b, s, c), tpr, rows = _TABLES[0]
    x = (torch.randn((b, s, c), device=dev, generator=gen) * 4).bfloat16()
    y = torch.randn((b, s, c), device=dev, generator=gen) * 3
    mod = torch.randn((b, rows, 6, c), device=dev, generator=gen)
    bias = torch.randn((c,), device=dev, generator=gen).bfloat16() if with_bias else None
    up = torch.randn((b, s, c), device=dev, generator=gen).bfloat16()
    up[0, 5] = 0.0  # -0 products, which autograd's sum of the table's views makes +0
    up[1, -1] = 0.0

    def run(fn):
        leaves = [t.clone().requires_grad_() if t is not None else None
                  for t in (x, y, mod, bias)]
        out = fn(leaves[0], leaves[1], leaves[2][:, :, 2], leaves[3], tokens_per_row=tpr)
        out.backward(up)
        return [out.detach()] + [t.grad for t in leaves if t is not None]

    _lib.reset_launch_counts()
    got = run(gate_residual)
    _finish_within(60, "K13 table backward")
    assert _lib.launch_counts() == {"gate_residual": 1, "gate_residual_rows": 1}
    want = run(gate_residual_plain)
    assert len(got) == len(want)
    assert all(a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


@pytest.mark.parametrize("c", [1536, 5120])
def test_one_row_calls_are_the_per_sample_form(dev, gen, c):
    """At Wan2.1's widths the per-sample call ([B, C] operands, the path of
    the existing cells), a table of one row and a table whose rows are all
    that row give the same bits, and the per-sample call counts no table
    rows."""
    from wanq_tpu_torch.ops.fused import gate_residual_cuda, ln_modulate_quant_cuda

    b, s = 2, 4096
    x = (torch.randn((b, s, c), device=dev, generator=gen) * 2).bfloat16()
    y = torch.randn((b, s, c), device=dev, generator=gen)
    mod = torch.randn((b, 6, c), device=dev, generator=gen) * 0.5
    _lib.reset_launch_counts()
    k1 = ln_modulate_quant_cuda(x, mod[:, 0], mod[:, 1])
    k13 = gate_residual_cuda(x, y, mod[:, 2])
    assert _lib.launch_counts() == {"ln_modulate_quant": 1, "gate_residual": 1}
    for rows in (1, 4):
        tab = mod[:, None].expand(b, rows, 6, c)
        t1 = ln_modulate_quant_cuda(x, tab[:, :, 0], tab[:, :, 1], tokens_per_row=1024)
        assert all(torch.equal(g, w) for g, w in zip(t1, k1))
        t13 = gate_residual_cuda(x, y, tab[:, :, 2], tokens_per_row=1024)
        assert torch.equal(_bits(t13), _bits(k13))


def test_k1_k13_table_wrappers_refuse_rows_past_the_sequence(dev):
    from wanq_tpu_torch.ops.fused import gate_residual_cuda, ln_modulate_quant_cuda

    x = torch.zeros((2, 64, 48), device=dev, dtype=torch.bfloat16)
    y = torch.zeros((2, 64, 48), device=dev)
    tab = torch.zeros((2, 4, 48), device=dev)
    _lib.reset_launch_counts()
    for tpr in (None, 0, 22):  # none given; none a row; row 3 would start past token 63
        with pytest.raises(ValueError):
            ln_modulate_quant_cuda(x, tab, tab, tokens_per_row=tpr)
        with pytest.raises(ValueError):
            gate_residual_cuda(x, y, tab, tokens_per_row=tpr)
    with pytest.raises(ValueError):  # shift and scale of different rows
        ln_modulate_quant_cuda(x, tab, tab[:, :2], tokens_per_row=16)
    assert not _lib.launch_counts()


def test_ti2v_blocks_on_the_card_read_the_table(dev):
    """Two blocks of TI2V-5B's widths on W8A8's fused routes, per-frame
    timesteps over 3 latent frames of 20 tokens and 4 pad tokens: the forward
    launches K1 and K13 with the table (2 of 3 a block each) and runs the time
    MLP on its two distinct timesteps; a block and the head give the bits of
    the per-token form (the table gathered to one row a token)."""
    import dataclasses
    import os

    from wanq_tpu_torch.configs import WAN_CONFIGS
    from wanq_tpu_torch.models import dit as tdit
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state
    from wanq_tpu_torch.quant.qlinear import QuantCtx

    cfg = dataclasses.replace(WAN_CONFIGS["ti2v-5B"], num_layers=2)
    params = tdit.init_params_on_device(cfg, 5, device=dev)
    params["head"]["head"]["w"].normal_(0.0, 0.02)
    qcfg = QuantConfig.from_yaml(os.path.join(os.path.dirname(__file__), "..",
                                              "quant_configs", "wan_w8a8_speed.yaml"))
    rng = np.random.default_rng(0)
    calib = {}
    for name in tdit.linear_layer_names(cfg):
        if name.endswith("ffn.2"):
            calib[f"{name}.act_max"] = np.abs(rng.normal(size=(1, cfg.ffn_dim))).astype(np.float32)
            calib[f"{name}.act_min"] = -calib[f"{name}.act_max"]
    pol, st, rot = prepare_quant_state(params, tdit.linear_layer_names(cfg), qcfg, calib=calib,
                                       targets="int8")
    ctx = QuantCtx(mode="int8", policies=pol, state=st, rotations=rot)
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((2, 48, 3, 8, 10), device=dev, generator=g)
    text = torch.randn((2, cfg.text_len, cfg.text_dim), device=dev, generator=g)
    t = torch.full((2, 3), 900.0)
    t[:, 0] = 0.0
    _lib.reset_launch_counts()
    with torch.no_grad():
        out = tdit.dit_forward(params, cfg, x, t, text, 64, ctx=ctx)
    _finish_within(120, "TI2V forward")
    counts = _lib.launch_counts()
    assert counts["ln_modulate_quant"] == 6 and counts["ln_modulate_quant_rows"] == 4
    assert counts["gate_residual"] == 6 and counts["gate_residual_rows"] == 4
    assert counts["time_embedding_rows"] == 2 and torch.isfinite(out).all()

    e, e0 = tdit.time_embedding(params, cfg, t)
    idx = torch.clamp(torch.arange(64, device=dev) // 20, max=2)
    xs = (torch.randn((2, 64, cfg.dim), device=dev, generator=g) * 0.5).bfloat16()
    c = (torch.randn((2, cfg.text_len, cfg.dim), device=dev, generator=g)).bfloat16()
    cos, sin = tdit._rope_tables_on((3, 4, 5), cfg.head_dim, dev)
    with torch.no_grad():
        frames = tdit.block_forward(params["blocks"][0], "blocks.0", ctx, xs, e0, c, cfg, cos,
                                    sin, 60, tokens_per_row=20)
        tokens = tdit.block_forward(params["blocks"][0], "blocks.0", ctx, xs, e0[:, idx], c,
                                    cfg, cos, sin, 60, tokens_per_row=1)
        head_f = tdit.head_forward(params, xs, e, cfg, ctx, tokens_per_row=20)
        head_t = tdit.head_forward(params, xs, e[:, idx], cfg, ctx, tokens_per_row=1)
    assert torch.equal(_bits(frames), _bits(tokens))
    assert torch.equal(head_f, head_t)


def test_k1_copies_operands_it_cannot_read_where_they_lie(dev, gen):
    """A shift or scale off 16 bytes, or with a row stride the kernel cannot
    take, is copied (not refused, as before the table); the bits stay."""
    from wanq_tpu_torch.ops.fused import ln_modulate_quant_cuda

    x = torch.randn((2, 40, 64), device=dev, generator=gen).bfloat16()
    mod = torch.randn((2, 64), device=dev, generator=gen)
    off = torch.zeros(2 * 64 + 1, device=dev)[1:].view(2, 64)  # 4 bytes off 16
    off.copy_(mod)
    odd = torch.zeros((2, 66), device=dev)[:, :64]  # a row stride of 66 floats
    odd.copy_(mod)
    want = ln_modulate_quant_cuda(x, mod, mod * 0.5)
    for t in (off, odd):
        got = ln_modulate_quant_cuda(x, t, t * 0.5 if t is odd else mod * 0.5)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = ln_modulate_quant_cuda(x, off, odd * 0.5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
