"""Int GEMMs with fused dequant (counterpart of wanq_tpu/ops/qgemm.py).

W8A8 and W4A8 share one epilogue:

    out = (A_int8 @ W^T) * s_a[:, None] * s_w[None, :]
        + sum_a[:, None] * zp_w[None, :] * s_w[None, :]      (asymmetric weights)
        + bias

W4A4 (Atom) scales each 128-wide K group on its own, in ascending order:

    acc += f32(A_g @ W_g^T) * (s_a[:, g, None] * s_w[g, None, :]);  out = acc + bias

Each wrapper is its kernel on CUDA tensors and its ``*_plain`` version on
CPU tensors:

* :func:`w8a8_linear` -- K2 (``csrc/w8a8_gemm.cu``), int8 weights;
* :func:`w4a8_linear` -- K8 (``csrc/w4a8_gemm.cu``), packed int4 weights;
* :func:`w4a4_linear` -- K9 (``csrc/w4a4_gemm.cu``) after a per-(token,
  group) int4 quant of the FP activation, in plain PyTorch, as the JAX
  package does in XLA outside its kernel.

Layout: the port stores int weights K-major, what the int8 tensor-core MMA
wants for B: ``w_int8`` [C_out, C_in] and packed int4 [C_out, C_in / 2]
(byte j of row n holds k = 2j in its low nibble, k = 2j + 1 in its high
one). The JAX package stores [C_in, C_out] and [C_in / 2, C_out];
``models.params.quant_state_from_numpy`` transposes both. The W4A4 weight
scales keep the JAX layout [G, C_out], whose rows K9 reads contiguously.
"""

from __future__ import annotations

from typing import Optional

import torch

from wanq_tpu_torch.ops import _lib
from wanq_tpu_torch.quant.quantizers import act_group_int4_quant, unpack_int4


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


def _vec(t, size, name):
    """A per-row / per-column operand as a contiguous CUDA f32 vector."""
    if t is None:
        return None
    t = t.reshape(-1).float().contiguous()
    if t.numel() != size or not t.is_cuda:
        raise ValueError(f"{name}: CUDA vector of {size} expected")
    return t


def _int_gemm_cuda(counter, entry, a_int8, w, k_of_w, k_mult, s_a, s_w, sum_a, zp_w,
                   bias, out_dtype):
    """The shared wrapper of K2 and K8: checks, flattens the leading dims
    of A, allocates the output and launches."""
    _lib.require_cuda(a_int8, torch.int8, "a_int8")
    _lib.require_cuda(w, torch.int8, "w")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    lead = a_int8.shape[:-1]
    k = a_int8.shape[-1]
    n = w.shape[0]
    if w.ndim != 2 or k_of_w(w.shape[1]) != k or k % k_mult or n % 128:
        raise ValueError(f"{counter} kernel needs K%{k_mult}==0, N%128==0: "
                         f"A[..,{k}] W{tuple(w.shape)}")
    a2 = a_int8.reshape(-1, k).contiguous()
    m = a2.shape[0]
    w = w.contiguous()
    s_a, sum_a = _vec(s_a, m, "s_a"), _vec(sum_a, m, "sum_a")
    s_w, zp_w, bias = _vec(s_w, n, "s_w"), _vec(zp_w, n, "zp_w"), _vec(bias, n, "bias")
    if zp_w is not None and sum_a is None:
        raise ValueError("asymmetric weights (zp_w) need sum_a")
    out = torch.empty((m, n), dtype=out_dtype, device=a2.device)
    _lib.launch(
        counter, entry,
        a2.data_ptr(), w.data_ptr(), s_a.data_ptr(), s_w.data_ptr(),
        _lib.ptr(sum_a), _lib.ptr(zp_w), _lib.ptr(bias), out.data_ptr(),
        int(out_dtype == torch.bfloat16), m, n, k,
    )
    return out.reshape(*lead, n)


def w8a8_linear_cuda(a_int8, w_int8, s_a, s_w, sum_a=None, zp_w=None,
                     bias=None, out_dtype=torch.float32) -> torch.Tensor:
    """Kernel K2 on CUDA tensors. Any M; K % 64 == 0 and N % 128 == 0."""
    return _int_gemm_cuda("w8a8_linear", "wanq_w8a8_gemm", a_int8, w_int8, lambda kw: kw, 64,
                          s_a, s_w, sum_a, zp_w, bias, out_dtype)


def w8a8_linear(a_int8, w_int8, s_a, s_w, sum_a: Optional[torch.Tensor] = None,
                zp_w: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                out_dtype=torch.float32) -> torch.Tensor:
    """K2 dispatch: the kernel for CUDA tensors, the plain version for CPU
    tensors. a_int8 [..., K]; s_a/sum_a [...]; returns [..., N]."""
    if a_int8.is_cuda:
        return w8a8_linear_cuda(a_int8, w_int8, s_a, s_w, sum_a, zp_w, bias, out_dtype)
    return w8a8_linear_plain(a_int8, w_int8, s_a, s_w, sum_a, zp_w, bias, out_dtype)


# ---------------------------------------------------------------------------
# K8: W4A8, packed int4 weights
# ---------------------------------------------------------------------------


def w4a8_linear_plain(a_int8, w_packed, s_a, s_w, sum_a=None, zp_w=None,
                      bias=None, out_dtype=torch.float32) -> torch.Tensor:
    """a_int8 [..., K] @ unpack(w_packed [N, K/2])^T with K2's epilogue:
    the weight unpacked, then K2's plain (float64, exact) product."""
    return w8a8_linear_plain(a_int8, unpack_int4(w_packed), s_a, s_w, sum_a, zp_w, bias,
                             out_dtype)


def w4a8_linear_cuda(a_int8, w_packed, s_a, s_w, sum_a=None, zp_w=None,
                     bias=None, out_dtype=torch.float32) -> torch.Tensor:
    """Kernel K8 on CUDA tensors. Any M; K % 128 == 0 and N % 128 == 0."""
    return _int_gemm_cuda("w4a8_linear", "wanq_w4a8_gemm", a_int8, w_packed,
                          lambda kw: 2 * kw, 128, s_a, s_w, sum_a, zp_w, bias, out_dtype)


def w4a8_linear(a_int8, w_packed, s_a, s_w, sum_a: Optional[torch.Tensor] = None,
                zp_w: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                out_dtype=torch.float32) -> torch.Tensor:
    """K8 dispatch: the kernel for CUDA tensors, the plain version for CPU
    tensors. a_int8 [..., K]; w_packed [N, K/2]; returns [..., N]."""
    if a_int8.is_cuda:
        return w4a8_linear_cuda(a_int8, w_packed, s_a, s_w, sum_a, zp_w, bias, out_dtype)
    return w4a8_linear_plain(a_int8, w_packed, s_a, s_w, sum_a, zp_w, bias, out_dtype)


# ---------------------------------------------------------------------------
# K9: W4A4 (Atom), int4 activations and packed int4 weights, per-group scales
# ---------------------------------------------------------------------------


def w4a4_linear_plain(a_int4, w_packed, s_a, s_w, bias=None, group: int = 128,
                      out_dtype=torch.float32) -> torch.Tensor:
    """a_int4 [M, K] (int8 containers) @ unpack(w_packed [N, K/2])^T with
    s_a [M, G], s_w [G, N]: the JAX package's loop (w4a4_linear_xla). Each
    group's integer product is summed in float64, which is exact."""
    m, k = a_int4.shape
    g = k // group
    w = unpack_int4(w_packed).double()
    a = a_int4.double()
    s_a, s_w = s_a.float(), s_w.float()
    acc = torch.zeros((m, w.shape[0]), dtype=torch.float32, device=a_int4.device)
    for i in range(g):
        ks = slice(i * group, (i + 1) * group)
        p = torch.matmul(a[:, ks], w[:, ks].t()).float()
        acc = acc + p * (s_a[:, i, None] * s_w[i][None, :])
    if bias is not None:
        acc = acc + bias.float()[None, :]
    return acc.to(out_dtype)


def w4a4_linear_cuda(a_int4, w_packed, s_a, s_w, bias=None, group: int = 128,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Kernel K9 on CUDA tensors. Any M; group 128, K % 128 == 0 and
    N % 128 == 0."""
    _lib.require_cuda(a_int4, torch.int8, "a_int4")
    _lib.require_cuda(w_packed, torch.int8, "w_packed")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    if group != 128:
        raise ValueError(f"the K9 kernel takes 128-wide groups, not {group}")
    m, k = a_int4.shape
    n = w_packed.shape[0]
    if w_packed.ndim != 2 or 2 * w_packed.shape[1] != k or k % 128 or n % 128:
        raise ValueError(f"w4a4 kernel needs K%128==0, N%128==0: A{tuple(a_int4.shape)} "
                         f"W{tuple(w_packed.shape)}")
    g = k // group
    s_a = s_a.float().contiguous()
    s_w = s_w.float().contiguous()
    _lib.require_cuda(s_a, torch.float32, "s_a")
    _lib.require_cuda(s_w, torch.float32, "s_w")
    if s_a.shape != (m, g) or s_w.shape != (g, n):
        raise ValueError(f"scales must be s_a [M, G] = {(m, g)} and s_w [G, N] = {(g, n)}, "
                         f"got {tuple(s_a.shape)} and {tuple(s_w.shape)}")
    bias = _vec(bias, n, "bias")
    a_int4, w_packed = a_int4.contiguous(), w_packed.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a_int4.device)
    _lib.launch(
        "w4a4_linear", "wanq_w4a4_gemm",
        a_int4.data_ptr(), w_packed.data_ptr(), s_a.data_ptr(), s_w.data_ptr(),
        _lib.ptr(bias), out.data_ptr(), int(out_dtype == torch.bfloat16), m, n, k,
    )
    return out


def w4a4_linear(a: torch.Tensor, w_packed, s_w, bias=None, group: int = 128,
                out_dtype=torch.float32) -> torch.Tensor:
    """Full W4A4 linear from an FP activation a [M, K]: dynamic
    per-(token, group) int4 quant (plain PyTorch, as wanq_tpu's XLA), then
    the Atom GEMM: K9 for CUDA tensors, the plain version for CPU tensors."""
    q, s_a = act_group_int4_quant(a, group)
    gemm = w4a4_linear_cuda if q.is_cuda else w4a4_linear_plain
    return gemm(q, w_packed, s_a, s_w, bias, group, out_dtype)
