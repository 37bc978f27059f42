"""Attention (counterpart of wanq_tpu/models/attention.py).

Every entry point here is kernel K4 (``csrc/flash_attention.cu``) on CUDA
tensors and :func:`_sdpa_reference` (plain PyTorch, f32 softmax) on CPU
tensors. K4 takes its operands through strides and writes seq-major
memory, so:

* :func:`attention` -- q, k, v [B, S, N, D] -> [B, Sq, N, D];
* :func:`attention_heads_major` -- q, k, v [B, N, S, D] (any strides, e.g.
  the K3 output and a ``split_heads`` view of v), softmax scale folded
  into q -> [B, N, S, D] as a view over seq-major memory, so the head
  merge before the o-projection is free;
* :func:`cross_attention_heads_major` -- q [B, N, Sq, D], k/v seq-major
  [B, Sk, N, D] -> [B, N, Sq, D] (same seq-major view).

Masks: kv columns >= ``k_valid_len`` are masked (the pad tail); q rows past
it attend the valid prefix. The sliding temporal window is not ported yet.
K4 takes bf16 with head dim 128 (every Wan config); other inputs raise on
CUDA tensors (the ``tiny`` test config, head dim 24, runs on the CPU).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from wanq_tpu_torch.ops import _lib

_DEF_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _no_window(window) -> None:
    if window is not None:
        raise NotImplementedError(
            "temporal-window attention is not ported yet "
            "(ROADMAP Queue 1 item 6: band mask in K4)")


def _sdpa_reference(q, k, v, scale: float, k_valid_len: Optional[int],
                    window=None, q_chunk: Optional[int] = None) -> torch.Tensor:
    """Plain attention with f32 softmax. q, k, v: [B, S, N, D] (any
    strides). ``q_chunk`` splits the query rows into slices of that many
    (the result is the same; it bounds the [B, N, chunk, Sk] score
    memory at long S)."""
    _no_window(window)
    sq, sk = q.shape[1], k.shape[1]
    kf = k.float()
    mask = None
    if k_valid_len is not None and k_valid_len < sk:
        mask = torch.arange(sk, device=q.device) < k_valid_len
    outs = []
    step = q_chunk or sq
    for i in range(0, sq, step):
        scores = torch.einsum("bsnd,btnd->bnst", q[:, i:i + step].float(), kf) * scale
        if mask is not None:
            scores = scores.masked_fill(~mask, _DEF_MASK_VALUE)
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bnst,btnd->bsnd", probs.to(v.dtype), v))
    # seq-major memory, like the kernel's output
    return outs[0].contiguous() if len(outs) == 1 else torch.cat(outs, dim=1)


def _flash_cuda(q, k, v, scale: float, kv_valid: int) -> torch.Tensor:
    """K4 launch on logical [B, N, S, D] views; returns [B, Sq, N, D]."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _lib.require_cuda(t, torch.bfloat16, name)
        if t.shape[-1] != 128 or t.stride(-1) != 1:
            raise ValueError(f"{name}: K4 needs a contiguous head dim of 128, "
                             f"got shape {tuple(t.shape)} strides {t.stride()}")
        if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: strides must be multiples of 8 and the "
                             "base 16-byte aligned")
    b, n, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, n, sk, d) or v.shape != k.shape:
        raise ValueError(f"k/v shape mismatch: q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if not 1 <= kv_valid <= sk:
        raise ValueError(f"kv_valid {kv_valid} outside [1, {sk}]")
    out = torch.empty((b, sq, n, d), dtype=torch.bfloat16, device=q.device)
    _lib.launch(
        "attention", "wanq_flash_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, sq, sk,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(2), out.stride(1),
        int(kv_valid), float(scale),
    )
    return out


def _valid(k_valid_len: Optional[int], sk: int) -> int:
    return sk if k_valid_len is None else min(int(k_valid_len), sk)


def attention(q, k, v, scale: Optional[float] = None,
              k_valid_len: Optional[int] = None, window=None) -> torch.Tensor:
    """Scaled dot-product attention. q [B, Sq, N, D]; k, v [B, Sk, N, D]."""
    _no_window(window)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _flash_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           scale, _valid(k_valid_len, k.shape[1]))
    return _sdpa_reference(q, k, v, scale, k_valid_len)


def attention_heads_major(q, k, v, k_valid_len: Optional[int] = None,
                          window=None) -> torch.Tensor:
    """Self-attention on heads-major [B, N, S, D] operands, softmax scale
    pre-folded into q. Returns [B, N, S, D] over seq-major memory."""
    _no_window(window)
    if q.is_cuda:
        out = _flash_cuda(q, k, v, 1.0, _valid(k_valid_len, k.shape[2]))
    else:
        out = _sdpa_reference(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), 1.0, k_valid_len)
    return out.transpose(1, 2)


def cross_attention_heads_major(q, k, v, scale: Optional[float] = None,
                                k_valid_len: Optional[int] = None) -> torch.Tensor:
    """q heads-major [B, N, Sq, D]; k, v seq-major [B, Sk, N, D].
    Returns [B, N, Sq, D] over seq-major memory."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        out = _flash_cuda(q, k.transpose(1, 2), v.transpose(1, 2), scale,
                          _valid(k_valid_len, k.shape[1]))
    else:
        out = _sdpa_reference(q.transpose(1, 2), k, v, scale, k_valid_len)
    return out.transpose(1, 2)
