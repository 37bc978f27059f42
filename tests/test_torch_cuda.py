"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (a CUDA kernel has no CPU
mode) and skips without one. This file imports no JAX, so it also runs on
a machine that has only PyTorch; the repository's conftest.py imports JAX,
so run it there as

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: K1 int8 codes may differ by one on <= 0.1% of elements
(reduction order at rounding ties), scales rtol 1e-5; K2 is exact (the
int32 sums are exact and the epilogue runs in the same order); K3 within
one bf16 ulp except on <= 1e-4 of elements, where the norm's f32 sum
order flips the bf16 rounding of the normalized value by one unit; K4
within rel-L2 1e-2 and 4 bf16 ulps of max|want| (bf16 P in the PV product
and online-softmax order), with the pad tail of k/v planted so that a
missed mask moves the output by far more; ``fp_linear`` on the card
within rel-L2 1e-5 of the CPU's f32 product (a bf16-rounded output would
be ~1e-3 off).
"""

import math

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


def test_k3_kernel_matches_plain(dev, gen):
    from wanq_tpu_torch.ops.rmsnorm_rope import (
        rms_rope_heads, rms_rope_heads_plain, rms_split_heads, rms_split_heads_plain)

    b, s, n, d = 2, 100, 12, 128
    x = torch.randn((b, s, n * d), device=dev, generator=gen).bfloat16()
    w = torch.rand((n * d,), device=dev, generator=gen) + 0.5
    ang = torch.rand((s, d // 2), device=dev, generator=gen) * 6
    ca = torch.cos(ang).repeat_interleave(2, dim=1) * 0.0884
    sb = torch.sin(ang).repeat_interleave(2, dim=1) * 0.0884
    sb[:, 0::2] *= -1
    for got, want in (
        (rms_rope_heads(x, w, ca, sb, n), rms_rope_heads_plain(x, w, ca, sb, n)),
        (rms_split_heads(x, w, n), rms_split_heads_plain(x, w, n)),
    ):
        g, wv = got.float(), want.float()
        ulp = torch.exp2(torch.floor(torch.log2(wv.abs().clamp_min(1e-30))) - 7)
        beyond = ((g - wv).abs() > ulp).float().mean().item()
        assert beyond <= 1e-4 and (g - wv).abs().max().item() <= 1e-2 * wv.abs().max().item()


@pytest.mark.parametrize("sq,sk,valid", [(300, 300, 290), (257, 77, 77)])
def test_k4_kernel_matches_plain(dev, gen, sq, sk, valid):
    from wanq_tpu_torch.models.attention import _flash_cuda, _sdpa_reference

    b, n, d = 2, 3, 128
    q = torch.randn((b, sq, n, d), device=dev, generator=gen).bfloat16()
    k = torch.randn((b, sk, n, d), device=dev, generator=gen).bfloat16()
    v = torch.randn((b, sk, n * d), device=dev, generator=gen).bfloat16()
    k[:, valid:] = 0.0      # a missed mask would mix in v = 100
    v[:, valid:] = 100.0
    vh = v.view(b, sk, n, d)
    got = _flash_cuda(q.transpose(1, 2), k.transpose(1, 2), vh.transpose(1, 2), 0.0884, valid)
    want = _sdpa_reference(q, k, vh, 0.0884, valid)
    assert torch.isfinite(got.float()).all()
    g, w = got.float(), want.float()
    ulp = 2.0 ** (math.floor(math.log2(w.abs().max().item())) - 7)
    assert (g - w).abs().max().item() <= 4 * ulp
    assert ((g - w).norm() / w.norm()).item() <= 1e-2


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


def test_fp_linear_on_card_keeps_the_f32_accumulator(dev, gen):
    from wanq_tpu_torch.quant.qlinear import fp_linear

    x = torch.randn((2, 300, 1536), device=dev, generator=gen)
    p = {"w": torch.randn((1536, 640), device=dev, generator=gen).bfloat16() * 0.03,
         "b": torch.randn((640,), device=dev, generator=gen)}
    got = fp_linear(p, x)
    want = fp_linear({k: t.cpu() for k, t in p.items()}, x.cpu())
    assert got.dtype == torch.float32
    assert ((got.cpu() - want).norm() / want.norm()).item() <= 1e-5


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
    assert np.isfinite(_lib.last_build.get("seconds", 0.0))
