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
* :func:`w8a8_linear_gelu_quant` -- K2's second mode: the same product, then
  tanh-GELU and a static-scale int8 quant with the rows' code sums in the
  GEMM's epilogue, for an ffn.0 in front of an ffn.2 with a static scale;
* :func:`w4a8_linear` -- K8 (``csrc/w4a8_gemm.cu``), packed int4 weights;
* :func:`w4a8_linear_gelu_quant` -- K8 in the same second mode, for an ffn.0
  on packed int4 weights;
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

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from wanq_tpu_torch.ops import _lib
from wanq_tpu_torch.quant.quantizers import act_group_int4_quant, unpack_int4

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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


def _int_gemm_operands(what, a_int8, w, k_of_w, k_mult, s_a, s_w, sum_a, zp_w, bias):
    """The shared checks of K2 and K8: flattens the leading dims of A and
    returns (a2 [M, K], w, s_a, s_w, sum_a, zp_w, bias, lead) ready to launch."""
    _lib.require_cuda(a_int8, torch.int8, "a_int8")
    _lib.require_cuda(w, torch.int8, "w")
    lead = a_int8.shape[:-1]
    k = a_int8.shape[-1]
    n = w.shape[0]
    if w.ndim != 2 or k_of_w(w.shape[1]) != k or k % k_mult or n % 128:
        raise ValueError(f"{what} kernel needs K%{k_mult}==0, N%128==0: "
                         f"A[..,{k}] W{tuple(w.shape)}")
    a2 = a_int8.reshape(-1, k).contiguous()
    m = a2.shape[0]
    w = w.contiguous()
    s_a, sum_a = _vec(s_a, m, "s_a"), _vec(sum_a, m, "sum_a")
    s_w, zp_w, bias = _vec(s_w, n, "s_w"), _vec(zp_w, n, "zp_w"), _vec(bias, n, "bias")
    if zp_w is not None and sum_a is None:
        raise ValueError("asymmetric weights (zp_w) need sum_a")
    return a2, w, s_a, s_w, sum_a, zp_w, bias, lead


def _check_out_dtype(out_dtype):
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")


def _check_tma_operand(t, name):
    """K2, K8 and K9 read their matrix operands through TMA tensor maps, which
    need a 16-byte aligned base (rows are multiples of 16 bytes already)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def w8a8_linear_cuda(a_int8, w_int8, s_a, s_w, sum_a=None, zp_w=None,
                     bias=None, out_dtype=torch.float32) -> torch.Tensor:
    """Kernel K2 on CUDA tensors. Any M; K % 64 == 0 and N % 128 == 0 (the
    kernel's output tile is 128 x 256 where 256 divides N, else 128 x 128)."""
    _check_out_dtype(out_dtype)
    a2, w, s_a, s_w, sum_a, zp_w, bias, lead = _int_gemm_operands(
        "w8a8_linear", a_int8, w_int8, lambda kw: kw, 64, s_a, s_w, sum_a, zp_w, bias)
    (m, k), n = a2.shape, w.shape[0]
    _check_tma_operand(a2, "a_int8")
    _check_tma_operand(w, "w_int8")
    out = torch.empty((m, n), dtype=out_dtype, device=a2.device)
    _lib.launch(
        "w8a8_linear", "wanq_w8a8_gemm",
        a2.data_ptr(), w.data_ptr(), s_a.data_ptr(), s_w.data_ptr(),
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


# ---------------------------------------------------------------------------
# The second mode of K2 and K8: the GEMM, then GELU + static int8 quant + row sum
# ---------------------------------------------------------------------------


def static_quant_outputs(q: torch.Tensor, scale2: torch.Tensor, code_sum: torch.Tensor) -> Triple:
    """(codes, per-row scale, scaled row sum) of a static-scale quant, the
    form the next int GEMM takes: the scale expanded over the rows and
    ``scale2 * f32(sum of the row's codes)``."""
    return q, scale2.expand(q.shape[:-1]).contiguous(), scale2 * code_sum.float()


def gelu_static_quant(h: torch.Tensor, scale2: torch.Tensor) -> Triple:
    """tanh-GELU of h in f32, then int8 codes at the static scale ``scale2``
    (one f32 on h's device; a true division, round half to even)."""
    scale2 = scale2.reshape(()).float()
    g = F.gelu(h.float(), approximate="tanh")
    q = torch.clamp(torch.round(g / scale2), -128, 127).to(torch.int8)
    # |sum| <= N * 128 < 2**24 for every Wan width, so the f32 sum is exact
    return static_quant_outputs(q, scale2, q.float().sum(dim=-1))


def w8a8_linear_gelu_quant_plain(a_int8, w_int8, s_a, s_w, scale2, sum_a=None, zp_w=None,
                                 bias=None) -> Triple:
    """The W8A8 linear with a bf16 output, then tanh-GELU in f32 and a
    static-scale int8 quant: the chain that wanq_tpu's ffn block runs
    between ffn.0 and an ffn.2 with a static activation scale. ``scale2`` is
    one f32 on the operands' device. Returns (q int8 [..., N], s2 f32 [...],
    sm2 f32 [...])."""
    h = w8a8_linear_plain(a_int8, w_int8, s_a, s_w, sum_a, zp_w, bias, torch.bfloat16)
    return gelu_static_quant(h, scale2)


def _gelu_quant_cuda(what, entry, k_of_w, k_mult, a_int8, w, s_a, s_w, scale2, sum_a, zp_w,
                     bias) -> Triple:
    """Launches the GELU + quant mode of K2 or K8 (``entry``; counter
    ``what``): the codes are written by the GEMM's epilogue, and the rows'
    code sums are added up in an int32 vector, zeroed here for every call."""
    a2, w, s_a, s_w, sum_a, zp_w, bias, lead = _int_gemm_operands(
        what, a_int8, w, k_of_w, k_mult, s_a, s_w, sum_a, zp_w, bias)
    (m, k), n = a2.shape, w.shape[0]
    _check_tma_operand(a2, "a_int8")
    _check_tma_operand(w, "w")
    if n >= 2 ** 17:
        raise ValueError(f"N={n}: the row sum of the codes must stay below 2**24")
    scale2 = scale2.reshape(()).float().contiguous()
    _lib.require_cuda(scale2, torch.float32, "scale2")
    q = torch.empty((m, n), dtype=torch.int8, device=a2.device)
    code_sum = torch.zeros((m,), dtype=torch.int32, device=a2.device)
    _lib.launch(
        what, entry,
        a2.data_ptr(), w.data_ptr(), s_a.data_ptr(), s_w.data_ptr(),
        _lib.ptr(sum_a), _lib.ptr(zp_w), _lib.ptr(bias), scale2.data_ptr(), q.data_ptr(),
        code_sum.data_ptr(), m, n, k,
    )
    return static_quant_outputs(q.reshape(*lead, n), scale2, code_sum.reshape(lead))


def w8a8_linear_gelu_quant_cuda(a_int8, w_int8, s_a, s_w, scale2, sum_a=None, zp_w=None,
                                bias=None) -> Triple:
    """Kernel K2 in its GELU + quant mode on CUDA tensors: the bf16
    intermediate never reaches device memory. Shapes as
    :func:`w8a8_linear_cuda`; N < 2**17 keeps the sum exact in f32."""
    return _gelu_quant_cuda("w8a8_linear_gelu_quant", "wanq_w8a8_gemm_gelu_quant",
                            lambda kw: kw, 64, a_int8, w_int8, s_a, s_w, scale2, sum_a, zp_w,
                            bias)


def w8a8_linear_gelu_quant(a_int8, w_int8, s_a, s_w, scale2,
                           sum_a: Optional[torch.Tensor] = None,
                           zp_w: Optional[torch.Tensor] = None,
                           bias: Optional[torch.Tensor] = None) -> Triple:
    """K2's GELU + quant mode, dispatched: the kernel for CUDA tensors, the
    plain chain for CPU tensors."""
    if a_int8.is_cuda:
        return w8a8_linear_gelu_quant_cuda(a_int8, w_int8, s_a, s_w, scale2, sum_a, zp_w, bias)
    return w8a8_linear_gelu_quant_plain(a_int8, w_int8, s_a, s_w, scale2, sum_a, zp_w, bias)


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
    """Kernel K8 on CUDA tensors. Any M; K % 128 == 0, K < 2**17 and
    N % 128 == 0 (the kernel's output tile is 128 x 256 where 256 divides N,
    else 128 x 128)."""
    _check_out_dtype(out_dtype)
    a2, w, s_a, s_w, sum_a, zp_w, bias, lead = _int_gemm_operands(
        "w4a8_linear", a_int8, w_packed, lambda kw: 2 * kw, 128, s_a, s_w, sum_a, zp_w, bias)
    (m, k), n = a2.shape, w.shape[0]
    _check_tma_operand(a2, "a_int8")
    _check_tma_operand(w, "w_packed")
    out = torch.empty((m, n), dtype=out_dtype, device=a2.device)
    _lib.launch(
        "w4a8_linear", "wanq_w4a8_gemm",
        a2.data_ptr(), w.data_ptr(), s_a.data_ptr(), s_w.data_ptr(),
        _lib.ptr(sum_a), _lib.ptr(zp_w), _lib.ptr(bias), out.data_ptr(),
        int(out_dtype == torch.bfloat16), m, n, k,
    )
    return out.reshape(*lead, n)


def w4a8_linear(a_int8, w_packed, s_a, s_w, sum_a: Optional[torch.Tensor] = None,
                zp_w: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                out_dtype=torch.float32) -> torch.Tensor:
    """K8 dispatch: the kernel for CUDA tensors, the plain version for CPU
    tensors. a_int8 [..., K]; w_packed [N, K/2]; returns [..., N]."""
    if a_int8.is_cuda:
        return w4a8_linear_cuda(a_int8, w_packed, s_a, s_w, sum_a, zp_w, bias, out_dtype)
    return w4a8_linear_plain(a_int8, w_packed, s_a, s_w, sum_a, zp_w, bias, out_dtype)


def w4a8_linear_gelu_quant_plain(a_int8, w_packed, s_a, s_w, scale2, sum_a=None, zp_w=None,
                                 bias=None) -> Triple:
    """The W4A8 linear with a bf16 output, then tanh-GELU in f32 and a
    static-scale int8 quant: the chain of :func:`w8a8_linear_gelu_quant_plain`
    on packed int4 weights. Returns (q int8 [..., N], s2 f32 [...], sm2 f32
    [...])."""
    h = w4a8_linear_plain(a_int8, w_packed, s_a, s_w, sum_a, zp_w, bias, torch.bfloat16)
    return gelu_static_quant(h, scale2)


def w4a8_linear_gelu_quant_cuda(a_int8, w_packed, s_a, s_w, scale2, sum_a=None, zp_w=None,
                                bias=None) -> Triple:
    """Kernel K8 in its GELU + quant mode on CUDA tensors. Shapes as
    :func:`w4a8_linear_cuda`; N < 2**17 keeps the sum exact in f32."""
    return _gelu_quant_cuda("w4a8_linear_gelu_quant", "wanq_w4a8_gemm_gelu_quant",
                            lambda kw: 2 * kw, 128, a_int8, w_packed, s_a, s_w, scale2, sum_a,
                            zp_w, bias)


def w4a8_linear_gelu_quant(a_int8, w_packed, s_a, s_w, scale2,
                           sum_a: Optional[torch.Tensor] = None,
                           zp_w: Optional[torch.Tensor] = None,
                           bias: Optional[torch.Tensor] = None) -> Triple:
    """K8's GELU + quant mode, dispatched: the kernel for CUDA tensors, the
    plain chain for CPU tensors."""
    if a_int8.is_cuda:
        return w4a8_linear_gelu_quant_cuda(a_int8, w_packed, s_a, s_w, scale2, sum_a, zp_w, bias)
    return w4a8_linear_gelu_quant_plain(a_int8, w_packed, s_a, s_w, scale2, sum_a, zp_w, bias)


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
    _check_out_dtype(out_dtype)
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
    for t, name in ((a_int4, "a_int4"), (w_packed, "w_packed"), (s_w, "s_w")):
        _check_tma_operand(t, name)
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
