"""Host-side layout checks of the port's flash attention (K4).

K4 reads q, k and v through one 4-D tensor map each (TMA): dims
``(D, S, N, B)`` innermost first and the byte strides of ``(S, N, B)``.
``tensor_map_layout`` derives them from a logical [B, N, S, D] view and
refuses what the hardware cannot address (a stride that is no multiple of
16 bytes, a head dim other than a contiguous 128, a misaligned base). It is
plain Python over tensor metadata, so it is tested here on CPU tensors, on
the three operand layouts the model hands to the kernel.
"""

import pytest
import torch

from wanq_tpu_torch.models.attention import _flash_cuda, tensor_map_layout

B, N, S, D = 2, 3, 40, 128


def _heads_major():
    """q / k as K3 writes them: contiguous [B, N, S, D]."""
    return torch.zeros((B, N, S, D), dtype=torch.bfloat16)


def _v_over_gemm_output():
    """v as a head-split view over the GEMM output [B, S, N*D]."""
    return torch.zeros((B, S, N * D), dtype=torch.bfloat16).view(B, S, N, D).transpose(1, 2)


def _cross_seq_major():
    """cross-attention k / v: [B, Sk, N, D] seen heads-major."""
    return torch.zeros((B, S, N, D), dtype=torch.bfloat16).transpose(1, 2)


@pytest.mark.parametrize("make,strides", [
    (_heads_major, (D * 2, S * D * 2, N * S * D * 2)),
    (_v_over_gemm_output, (N * D * 2, D * 2, S * N * D * 2)),
    (_cross_seq_major, (N * D * 2, D * 2, S * N * D * 2)),
])
def test_tensor_map_layout_of_the_model_layouts(make, strides):
    t = make()
    assert t.shape == (B, N, S, D)
    dims, byte_strides = tensor_map_layout(t, "t")
    assert dims == (D, S, N, B)
    assert byte_strides == strides
    # what the map addresses is the element itself
    flat = t.untyped_storage()
    for b, n, s in ((0, 0, 0), (1, 2, 7), (B - 1, N - 1, S - 1)):
        off = s * byte_strides[0] + n * byte_strides[1] + b * byte_strides[2]
        assert off == t[b, n, s].data_ptr() - t.data_ptr()
        assert off + D * 2 <= flat.nbytes()


def test_tensor_map_layout_of_the_output_view():
    out = torch.empty((B, S, N, D), dtype=torch.bfloat16)
    dims, byte_strides = tensor_map_layout(out.transpose(1, 2), "out")
    assert dims == (D, S, N, B)
    assert byte_strides == (N * D * 2, D * 2, S * N * D * 2)


def test_tensor_map_layout_f32_element_size():
    t = torch.zeros((B, N, S, D), dtype=torch.float32)
    assert tensor_map_layout(t)[1] == (D * 4, S * D * 4, N * S * D * 4)


def test_tensor_map_layout_size_one_dims_take_a_row_stride():
    """A dimension of size 1 never moves; whatever stride torch reports for
    it (here 3 elements, no multiple of 16 bytes) is replaced."""
    t = torch.zeros((1, 1, S, D), dtype=torch.bfloat16).as_strided((1, 1, S, D), (3, 5, D, 1))
    dims, byte_strides = tensor_map_layout(t)
    assert dims == (D, S, 1, 1)
    assert byte_strides == (D * 2, D * 2, D * 2)


def _bad_row_pitch():
    # rows of 132 bf16 = 264 bytes: no multiple of 16
    return torch.zeros((B, N, S, 132), dtype=torch.bfloat16)[..., :D]


def _bad_head_dim():
    return torch.zeros((B, N, S, 64), dtype=torch.bfloat16)


def _strided_head_dim():
    return torch.zeros((B, N, S, 2 * D), dtype=torch.bfloat16)[..., ::2]


def _misaligned_base():
    return torch.zeros((B * N * S * D + 8,), dtype=torch.bfloat16)[4:4 + B * N * S * D].view(
        B, N, S, D)


def _broadcast_rows():
    return torch.zeros((B, N, 1, D), dtype=torch.bfloat16).expand(B, N, S, D)


def _three_dims():
    return torch.zeros((N, S, D), dtype=torch.bfloat16)


@pytest.mark.parametrize("make", [_bad_row_pitch, _bad_head_dim, _strided_head_dim,
                                  _misaligned_base, _broadcast_rows, _three_dims])
def test_tensor_map_layout_raises_on_what_tma_cannot_address(make):
    with pytest.raises(ValueError):
        tensor_map_layout(make(), "t")


def test_flash_cuda_refuses_cpu_tensors():
    """The kernel wrapper launches or raises: a CPU tensor never falls
    through to a plain version inside it."""
    t = _heads_major()
    with pytest.raises(ValueError):
        _flash_cuda(t, t, t, 1.0, S)
