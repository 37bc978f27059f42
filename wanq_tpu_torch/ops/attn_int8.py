"""Int8 flash attention (counterpart of wanq_tpu/ops/attn_int8.py): the
hardware execution of the attention quantization of an ``attn:`` section.

  QK^T   int8 q . int8 k, one scale per (batch, head, 512-token block) of q
         and of k, applied inside the f32 online softmax
  PV     the unnormalized probs p = exp(s - m) quantize to 127 levels
         against the running max of their 512-wide kv block and multiply v
         as int8 . int8; per-(batch, head, channel) v scales apply at the end

Two kernels, each with its plain PyTorch version beside it (the CPU path,
and the oracle of the tests and of ``chip_smoke.py``):

* :func:`quantize_qkv_int8` -- K10a (``csrc/quantize_qkv_int8.cu``) on CUDA
  tensors, :func:`quantize_qkv_int8_plain` on CPU tensors;
* :func:`attention_int8_cuda` -- K10 (``csrc/attention_int8.cu``);
  :func:`attention_int8_blocked` is its plain version, the TPU kernel's
  arithmetic step by step with 512-wide kv blocks, and
  :func:`attention_int8_global` the global-max form (wanq_tpu's
  ``attention_int8_xla``), a second oracle a few rounding steps away.

:func:`attention_int8` is the model-facing wrapper: q, k, v [B, S, H, D] ->
[B, S, H, D] f32. The 512-block grid is part of the function: the running
max moves once per 512 kv columns and the probs are rounded against it.

K10 reads v transposed and k-permuted, int8 [B, H, D, S]
(:func:`v_kernel_layout`); K10a writes that layout directly, so on CUDA
tensors the producer's third output is in it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from wanq_tpu_torch.models.attention import tensor_map_layout
from wanq_tpu_torch.ops import _lib
from wanq_tpu_torch.ops.fused import true_div

_NEG_INF = -1e30
_EPS = 1e-6
P_LEVELS = 127.0  # attn-map quant levels (A8 sym)
BLK = 512         # the kernels' q/k scale block and kv block

Quantized = Tuple[torch.Tensor, ...]


def _rup(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@contextlib.contextmanager
def _exact_f32_matmul():
    """f32 matmuls of int8 codes are exact per 512-block (every partial sum
    is an integer below 2**24) only in full f32: TF32 stays off inside."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# K10a: the q/k/v producer
# ---------------------------------------------------------------------------


def quantize_qkv_int8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            blk: int = BLK) -> Quantized:
    """q, k, v [B, H, S, D] -> (qi, ki, vi int8 [B, H, S_pad, D],
    s_q, s_k f32 [B, H, S_pad / blk], s_v f32 [B, H, D]). q/k: one scale
    per (b, h, blk-token block); v per (b, h, channel). S pads to blk with
    zero rows. Same math as wanq_tpu's quantize_qkv_int8."""
    b, h, s, d = q.shape
    s_pad = _rup(s, blk)
    if s_pad != s:
        q, k, v = (F.pad(t, (0, 0, 0, s_pad - s)) for t in (q, k, v))

    def per_block(x):
        xb = x.float().reshape(b, h, s_pad // blk, blk * d)
        scale = torch.clamp_min(true_div(xb.abs().amax(dim=-1), 127.0), _EPS)
        xi = torch.clamp(torch.round(xb / scale[..., None]), -127, 127).to(torch.int8)
        return xi.reshape(b, h, s_pad, d), scale

    qi, s_q = per_block(q)
    ki, s_k = per_block(k)
    vf = v.float()
    s_v = torch.clamp_min(true_div(vf.abs().amax(dim=2), 127.0), _EPS)
    vi = torch.clamp(torch.round(vf / s_v[:, :, None, :]), -127, 127).to(torch.int8)
    return qi, ki, vi, s_q, s_k, s_v


def _kperm_index(device) -> torch.Tensor:
    """Actual kv offset held at each of the 32 positions of a k-permuted
    group: position 16 (t // 2) + 4 i + 2 (t % 2) + lo holds kv
    8 t + 2 i + lo (tile t of 8 columns, thread i of the quad)."""
    pos = torch.arange(32, device=device)
    hi, rem = pos // 16, pos % 16
    i, e = rem // 4, rem % 4
    return 8 * (2 * hi + e // 2) + 2 * i + e % 2


def v_kernel_layout(vi: torch.Tensor) -> torch.Tensor:
    """vi int8 [B, H, S, D] (S a multiple of 32) -> K10's v operand
    [B, H, D, S]: transposed (the int8 wgmma reads kv-contiguous rows), and
    inside each group of 32 kv permuted the way the kernel packs its probs
    into the A fragment of the second product."""
    b, h, s, d = vi.shape
    if s % 32:
        raise ValueError(f"S={s} must be a multiple of 32")
    vt = vi.transpose(2, 3).reshape(b, h, d, s // 32, 32)
    return vt[..., _kperm_index(vi.device)].reshape(b, h, d, s).contiguous()


def v_from_kernel_layout(vt: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`v_kernel_layout`: [B, H, D, S] -> [B, H, S, D]."""
    b, h, d, s = vt.shape
    inv = torch.argsort(_kperm_index(vt.device))
    v = vt.reshape(b, h, d, s // 32, 32)[..., inv].reshape(b, h, d, s)
    return v.transpose(2, 3).contiguous()


def quantize_qkv_int8_traffic(b: int, h: int, s: int, d: int = 128) -> Tuple[int, int]:
    """(bound bytes, bytes K10a moves) for q, k, v bf16 [b, h, s, d]: the
    bound reads each input once and writes each output once; the kernel
    reads v a second time (its codes need the scale over every token) and
    writes and reads its partial maxima of v, f32 [b, h, s_pad / 512, d]."""
    s_pad = _rup(s, BLK)
    nblk = s_pad // BLK
    outputs = 3 * b * h * s_pad * d + 4 * b * h * (2 * nblk + d)
    bound = 3 * 2 * b * h * s * d + outputs
    return bound, bound + 2 * b * h * s * d + 2 * 4 * b * h * nblk * d


def quantize_qkv_int8_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Quantized:
    """Kernel K10a. q, k, v: bf16 CUDA [B, H, S, 128] views with a contiguous
    head dim, every other stride a positive multiple of 16 bytes and bases
    16-byte aligned (what its TMA tensor maps take: ``tensor_map_layout``).
    Returns (qi, ki [B, H, S_pad, 128], vt [B, H, 128, S_pad] in K10's
    layout, s_q, s_k [B, H, S_pad / 512], s_v [B, H, 128])."""
    layouts = []
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _lib.require_cuda(t, torch.bfloat16, name)
        layouts.append(tensor_map_layout(t, name)[1])
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} must agree")
    b, h, s, d = q.shape
    s_pad = _rup(s, BLK)
    dev = q.device
    qi = torch.empty((b, h, s_pad, d), dtype=torch.int8, device=dev)
    ki = torch.empty_like(qi)
    vt = torch.empty((b, h, d, s_pad), dtype=torch.int8, device=dev)
    s_q = torch.empty((b, h, s_pad // BLK), dtype=torch.float32, device=dev)
    s_k = torch.empty_like(s_q)
    s_v = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    v_part = torch.empty((b, h, s_pad // BLK, d), dtype=torch.float32, device=dev)
    _lib.launch(
        "quantize_qkv_int8", "wanq_quantize_qkv_int8",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *(st for strides in layouts for st in strides),
        qi.data_ptr(), ki.data_ptr(), vt.data_ptr(), s_q.data_ptr(), s_k.data_ptr(),
        s_v.data_ptr(), v_part.data_ptr(), b, h, s, s_pad,
    )
    return qi, ki, vt, s_q, s_k, s_v


def quantize_qkv_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      blk: int = BLK) -> Quantized:
    """K10a dispatch on [B, H, S, D] operands: the kernel for CUDA tensors
    (blk 512 only; the third output is then in K10's layout,
    :func:`v_kernel_layout`), the plain version for CPU tensors."""
    if q.is_cuda:
        if blk != BLK:
            raise ValueError(f"K10a quantizes per {BLK}-token block, not {blk}")
        return quantize_qkv_int8_cuda(q, k, v)
    return quantize_qkv_int8_plain(q, k, v, blk)


# ---------------------------------------------------------------------------
# K10: the attention
# ---------------------------------------------------------------------------


def _kv_len(k_valid_len: Optional[int], sk: int) -> int:
    return sk if k_valid_len is None else min(int(k_valid_len), sk)


def attention_int8_global(qi, ki, vi, s_q, s_k, s_v, sm_scale: float,
                          k_valid_len: Optional[int] = None) -> torch.Tensor:
    """Global-max reference (wanq_tpu's attention_int8_xla): full scores,
    one softmax max per row, probs rounded against it. [B, H, S, D] f32."""
    b, h, s, d = qi.shape
    blk_q, blk_k = s // s_q.shape[2], s // s_k.shape[2]
    with _exact_f32_matmul():
        sc = torch.matmul(qi.float(), ki.float().transpose(-1, -2))
    sq_full = s_q.repeat_interleave(blk_q, dim=2)
    sk_full = s_k.repeat_interleave(blk_k, dim=2)
    sc = sc * sq_full[:, :, :, None] * sk_full[:, :, None, :] * sm_scale
    kv_len = _kv_len(k_valid_len, s)
    if kv_len < s:
        mask = torch.arange(s, device=qi.device) < kv_len
        sc = torch.where(mask, sc, torch.full_like(sc, _NEG_INF))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    # the int32 sum over all of S can pass 2**24: f64 keeps it exact
    acc = torch.matmul(torch.round(p * P_LEVELS).double(), vi.double()).float()
    return acc / (P_LEVELS * l) * s_v[:, :, None, :]


def attention_int8_blocked(qi, ki, vi, s_q, s_k, s_v, sm_scale: float,
                           k_valid_len: Optional[int] = None,
                           q_chunk: Optional[int] = None) -> torch.Tensor:
    """Plain version of K10: the blocked algorithm of wanq_tpu's
    _flash_int8_kernel, kv block by kv block (block = Sk / s_k.shape[2],
    512 in deployment). qi, ki, vi int8 [B, H, S, D] -> [B, H, Sq, D] f32.
    ``q_chunk`` bounds the [B, H, chunk, blk] score memory at long S
    (rows are independent, so the result does not change). kv blocks wholly
    past ``k_valid_len`` are skipped: they add p = 0 and alpha = 1 exactly."""
    b, h, sq, d = qi.shape
    sk = ki.shape[2]
    nqb, nkb = s_q.shape[2], s_k.shape[2]
    if sq % nqb or sk % nkb:
        raise ValueError(f"scale blocks {nqb}/{nkb} must divide S {sq}/{sk}")
    blk_q, blk_k = sq // nqb, sk // nkb
    kv_len = _kv_len(k_valid_len, sk)
    step = q_chunk or sq
    outs = []
    with _exact_f32_matmul():
        for r0 in range(0, sq, step):
            rows = slice(r0, min(r0 + step, sq))
            qf = qi[:, :, rows].float()
            n = qf.shape[2]
            sq_rows = s_q.repeat_interleave(blk_q, dim=2)[:, :, rows, None]
            m = torch.full((b, h, n, 1), _NEG_INF, dtype=torch.float32, device=qi.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((b, h, n, d), dtype=torch.float32, device=qi.device)
            for ik in range(nkb):
                base = ik * blk_k
                if base >= kv_len:
                    break
                cols = slice(base, base + blk_k)
                s_int = torch.matmul(qf, ki[:, :, cols].float().transpose(-1, -2))
                s = s_int * (sq_rows * s_k[:, :, ik, None, None] * sm_scale)
                if base + blk_k > kv_len:
                    col = torch.arange(base, base + blk_k, device=qi.device)
                    s = torch.where(col < kv_len, s, torch.full_like(s, _NEG_INF))
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                pv = torch.matmul(torch.round(p * P_LEVELS), vi[:, :, cols].float())
                acc = acc * alpha + pv
                m = m_new
            l = torch.clamp_min(l, _EPS)
            outs.append(acc / (P_LEVELS * l) * s_v[:, :, None, :])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def attention_int8_cuda(qi, ki, vt, s_q, s_k, s_v, sm_scale: float,
                        k_valid_len: Optional[int] = None) -> torch.Tensor:
    """Kernel K10. qi, ki int8 [B, H, S, 128] and vt int8 [B, H, 128, Sk] in
    the kernel's layout, contiguous; Sq and Sk multiples of 512; s_q, s_k
    [B, H, S / 512], s_v [B, H, 128] f32. Returns f32 [B, Sq, H, 128]
    (seq-major, so merging the heads is a view)."""
    b, h, sq, d = qi.shape
    sk = ki.shape[2]
    for t, name, shape in ((qi, "qi", (b, h, sq, 128)), (ki, "ki", (b, h, sk, 128)),
                           (vt, "vt", (b, h, 128, sk))):
        _lib.require_cuda(t, torch.int8, name)
        if tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: contiguous 16-byte aligned {shape} expected, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if sq % BLK or sk % BLK:
        raise ValueError(f"K10 needs Sq and Sk multiples of {BLK}, got {sq}, {sk}")
    for t, name, shape in ((s_q, "s_q", (b, h, sq // BLK)), (s_k, "s_k", (b, h, sk // BLK)),
                           (s_v, "s_v", (b, h, 128))):
        _lib.require_cuda(t, torch.float32, name)
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: contiguous {shape} expected, got {tuple(t.shape)}")
    kv_len = _kv_len(k_valid_len, sk)
    if kv_len < 1:
        raise ValueError(f"k_valid_len {k_valid_len} leaves no kv column")
    out = torch.empty((b, sq, h, d), dtype=torch.float32, device=qi.device)
    _lib.launch(
        "attention_int8", "wanq_attention_int8",
        qi.data_ptr(), ki.data_ptr(), vt.data_ptr(), s_q.data_ptr(), s_k.data_ptr(),
        s_v.data_ptr(), out.data_ptr(), b, h, sq, sk, kv_len, float(sm_scale),
        out.stride(0), out.stride(1), out.stride(2),
    )
    return out


def attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sm_scale: Optional[float] = None, k_valid_len: Optional[int] = None,
                   blk: int = BLK) -> torch.Tensor:
    """End-to-end int8 attention: quantize q/k/v, then the attention.
    q, k, v [B, S, H, D] (model layout) -> [B, S, H, D] f32. CUDA tensors go
    through K10a and K10 (bf16, D = 128, blk 512), CPU tensors through the
    plain versions."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s_orig = q.shape[1]
    kv_len = s_orig if k_valid_len is None else k_valid_len
    quantized = quantize_qkv_int8(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), blk)
    if q.is_cuda:
        return attention_int8_cuda(*quantized, sm_scale, k_valid_len=kv_len)[:, :s_orig]
    out = attention_int8_blocked(*quantized, sm_scale, k_valid_len=kv_len)
    # seq-major memory, like the kernel's output
    return out[:, :, :s_orig].transpose(1, 2).contiguous()
