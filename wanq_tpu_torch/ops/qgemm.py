"""W8A8 GEMM with the fused dequant epilogue (counterpart of
wanq_tpu/ops/qgemm.py).

    out = (A_int8 @ W_int8^T) * s_a[:, None] * s_w[None, :]
        + sum_a[:, None] * zp_w[None, :] * s_w[None, :]      (asymmetric weights)
        + bias

:func:`w8a8_linear` is kernel K2 (``csrc/w8a8_gemm.cu``) on CUDA tensors and
:func:`w8a8_linear_plain` on CPU tensors. Layout: the port stores the
weight ``w_int8`` as [C_out, C_in] (K-major, what the int8 tensor-core MMA
wants for B); the JAX package stores [C_in, C_out] and
``models.params.quant_state_from_numpy`` transposes it.
"""

from __future__ import annotations

from typing import Optional

import torch

from wanq_tpu_torch.ops import _lib


def _epilogue(acc, s_a, s_w, sum_a, zp_w, bias, out_dtype):
    out = acc.float() * (s_a[..., None] * s_w)
    if zp_w is not None:
        out = out + sum_a[..., None] * (zp_w * s_w)
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def w8a8_linear_plain(a_int8, w_int8, s_a, s_w, sum_a=None, zp_w=None,
                      bias=None, out_dtype=torch.float32) -> torch.Tensor:
    """a_int8 [..., K] @ w_int8 [N, K]^T with the dequant epilogue.
    The integer products are summed in float64, which is exact for
    K * 128 * 128 < 2**53, i.e. the same int32 accumulator the kernel and
    the JAX reference hold."""
    acc = torch.matmul(a_int8.double(), w_int8.double().t())
    return _epilogue(
        acc, s_a.float(), s_w.float(),
        None if sum_a is None else sum_a.float(),
        None if zp_w is None else zp_w.float(),
        None if bias is None else bias.float(), out_dtype)


def w8a8_linear_cuda(a_int8, w_int8, s_a, s_w, sum_a=None, zp_w=None,
                     bias=None, out_dtype=torch.float32) -> torch.Tensor:
    """Kernel K2 on CUDA tensors. Any M; K % 64 == 0 and N % 128 == 0."""
    _lib.require_cuda(a_int8, torch.int8, "a_int8")
    _lib.require_cuda(w_int8, torch.int8, "w_int8")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    lead = a_int8.shape[:-1]
    k = a_int8.shape[-1]
    n, k2 = w_int8.shape
    if k != k2 or k % 64 or n % 128:
        raise ValueError(f"w8a8 kernel needs K%64==0, N%128==0: A[..,{k}] W[{n},{k2}]")
    a2 = a_int8.reshape(-1, k).contiguous()
    m = a2.shape[0]
    w_int8 = w_int8.contiguous()

    def vec(t, size, name):
        if t is None:
            return None
        t = t.reshape(-1).float().contiguous()
        if t.numel() != size or not t.is_cuda:
            raise ValueError(f"{name}: CUDA vector of {size} expected")
        return t

    s_a, sum_a = vec(s_a, m, "s_a"), vec(sum_a, m, "sum_a")
    s_w, zp_w, bias = vec(s_w, n, "s_w"), vec(zp_w, n, "zp_w"), vec(bias, n, "bias")
    if zp_w is not None and sum_a is None:
        raise ValueError("asymmetric weights (zp_w) need sum_a")
    out = torch.empty((m, n), dtype=out_dtype, device=a2.device)
    _lib.launch(
        "w8a8_linear", "wanq_w8a8_gemm",
        a2.data_ptr(), w_int8.data_ptr(), s_a.data_ptr(), s_w.data_ptr(),
        _lib.ptr(sum_a), _lib.ptr(zp_w), _lib.ptr(bias), out.data_ptr(),
        int(out_dtype == torch.bfloat16), m, n, k,
    )
    return out.reshape(*lead, n)


def w8a8_linear(a_int8, w_int8, s_a, s_w, sum_a: Optional[torch.Tensor] = None,
                zp_w: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                out_dtype=torch.float32) -> torch.Tensor:
    """K2 dispatch: the kernel for CUDA tensors, the plain version for CPU
    tensors. a_int8 [..., K]; s_a/sum_a [...]; returns [..., N]."""
    if a_int8.is_cuda:
        return w8a8_linear_cuda(a_int8, w_int8, s_a, s_w, sum_a, zp_w, bias, out_dtype)
    return w8a8_linear_plain(a_int8, w_int8, s_a, s_w, sum_a, zp_w, bias, out_dtype)
