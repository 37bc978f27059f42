"""Ring (context-parallel) attention (counterpart of wanq_tpu/parallel/ring.py).

Each rank of a ring group holds one shard of the sequence: q, k, v [B, S_loc,
H, D] at global positions ``rank * S_loc ..``. The k/v shards travel round the
ring (``isend`` / ``irecv`` of the next shard are posted before the hop's
compute, so the transfer overlaps it), and every hop attends the rank's q to
the shard it holds. A hop yields an output and each row's log-sum-exp, and the
hops fold by LSE in f32: lse = log sum_i exp(lse_i), o = sum_i exp(lse_i - lse)
o_i. On the card a hop is one launch of K4's partial mode
(``models/attention.py::flash_partial``, counter ``attention_partial``); on
the CPU it is :func:`_partial_attn`, the plain online-softmax fold of
``wanq_tpu`` and the kernel's oracle.

The mask is ``temporal_band_dense_mask`` on global positions: columns past
``k_valid_len`` are masked; a q row past it (a pad row) sees every valid
column; with a uniform :class:`TemporalWindow` any other row sees the columns
within ``radius`` frames of its own. A hop whose shard holds no valid key, or
cannot meet any of the rank's rows under the window, is skipped
(:func:`hop_visits`); the rotation still runs. Unlike ``wanq_tpu``, whose
predicate ignores pad rows (they stay finite only through its finite -1e30
mask value), a rank holding pad rows visits every shard with a valid key, so
its pad rows are those of the single-device attention. Masked scores are
-inf, and an empty row keeps the exponent base 0 and weighs zero in the fold.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from wanq_tpu_torch.models.attention import TemporalWindow, flash_partial

_NEG_INF = float("-inf")


def _partial_attn(q, k, v, scale: float, m, l, acc, kv_offset: int, kv_len: int,
                  q_offset: int = 0, band: Optional[Tuple[int, int]] = None):
    """One online-softmax fold of q [B, Sq, H, D] against a k/v shard [B, Sk,
    H, D] whose global positions start at ``kv_offset``; q's start at
    ``q_offset``. ``band`` = (tokens_per_frame, radius) adds the temporal
    window on global positions. m, l [B, H, Sq, 1] and acc [B, H, Sq, D], f32,
    start at -inf, 0, 0. Returns the new (m, l, acc)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    col = torch.arange(k.shape[1], device=q.device) + kv_offset
    keep = (col < kv_len)[None, :]
    if band is not None:
        tpf, radius = band
        qpos = torch.arange(q.shape[1], device=q.device) + q_offset
        in_band = (qpos[:, None] // tpf - col[None, :] // tpf).abs() <= radius
        keep = keep & (in_band | (qpos >= kv_len)[:, None])
    s = s.masked_fill(~keep, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    base = torch.where(m_new == _NEG_INF, 0.0, m_new)  # an empty row: exp(-inf) = 0, no NaN
    alpha = torch.exp(m - base)
    p = torch.exp(s - base)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype), v)
    return m_new, l_new, acc * alpha + pv.float()


def hop_visits(q_offset: int, sq: int, kv_offset: int, sk: int, kv_len: int,
               band: Optional[Tuple[int, int]] = None) -> bool:
    """Whether the q rows [q_offset, q_offset + sq) need the k/v shard
    [kv_offset, kv_offset + sk): it holds a valid key, and without a window,
    or with q pad rows (>= kv_len, which see every valid key), always;
    otherwise when the frames of the shard's valid keys meet the rows' frames
    widened by the radius (``wanq_tpu/parallel/ring.py:133-140``)."""
    if kv_offset >= kv_len:
        return False
    if band is None or q_offset + sq > kv_len:
        return True
    tpf, radius = band
    qf0, qf1 = q_offset // tpf, (q_offset + sq - 1) // tpf
    kf0, kf1 = kv_offset // tpf, (min(kv_offset + sk, kv_len) - 1) // tpf
    return kf0 <= qf1 + radius and kf1 >= qf0 - radius


def partial_attention_plain(q, k, v, scale: float, q_offset: int, kv_offset: int,
                            kv_len: int, window: Optional[TemporalWindow] = None,
                            q_chunk: Optional[int] = None):
    """The plain version of one hop (of K4's partial mode) on any device: one
    fold of :func:`_partial_attn` from the empty state, ``q_chunk`` query rows
    at a time (the [B, H, rows, Sk] scores bound its memory). Returns (o f32
    [B, Sq, H, D], lse f32 [B, H, Sq]), 0 and -inf on rows that see no key."""
    b, sq, h, d = q.shape
    band = None if window is None else (window.tokens_per_frame, window.radius)
    outs, lses = [], []
    step = q_chunk or sq
    for i in range(0, sq, step):
        qc = q[:, i:i + step]
        n = qc.shape[1]
        m = torch.full((b, h, n, 1), _NEG_INF, device=q.device)
        l = torch.zeros((b, h, n, 1), device=q.device)
        acc = torch.zeros((b, h, n, d), device=q.device)
        m, l, acc = _partial_attn(qc, k, v, scale, m, l, acc, kv_offset, kv_len, q_offset + i,
                                  band)
        outs.append(torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0).transpose(1, 2))
        lses.append(torch.where(l > 0, m + torch.log(l), _NEG_INF)[..., 0])
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def partial_attention(q, k, v, scale: float, q_offset: int, kv_offset: int, kv_len: int,
                      window: Optional[TemporalWindow] = None):
    """One hop: q [B, Sq, H, D] against the shard k, v [B, Sk, H, D] (views
    of any strides with a contiguous head dim). Returns (o [B, Sq, H, D], lse
    f32 [B, H, Sq]); a row that sees no key of the shard has o = 0 and lse =
    -inf. CUDA tensors: K4's partial mode (o bf16); CPU tensors:
    :func:`partial_attention_plain` (o f32)."""
    if q.is_cuda:
        return flash_partial(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale,
                             q_offset, kv_offset, kv_len, window=window)
    return partial_attention_plain(q, k, v, scale, q_offset, kv_offset, kv_len, window)


def fold_partial(acc: Optional[Tuple[torch.Tensor, torch.Tensor]], o_i, lse_i):
    """Fold the hop (o_i [B, Sq, H, D], lse_i [B, H, Sq]) into the running
    (o f32, lse f32), None before the first hop: lse = log(e^lse + e^lse_i), o
    = e^(lse_old - lse) o + e^(lse_i - lse) o_i. A row whose lse is -inf on
    both sides stays (0, -inf)."""
    if acc is None:
        return o_i.float(), lse_i.float()
    o, lse = acc
    new = torch.logaddexp(lse, lse_i)
    base = torch.where(new == _NEG_INF, 0.0, new)
    w_old = torch.exp(lse - base).transpose(1, 2)[..., None]
    w_hop = torch.exp(lse_i - base).transpose(1, 2)[..., None]
    return o * w_old + o_i.float() * w_hop, new


def ring_attention(q, k, v, group=None, scale: Optional[float] = None,
                   k_valid_len: Optional[int] = None,
                   window: Optional[TemporalWindow] = None) -> torch.Tensor:
    """Attention of this rank's sequence shard q, k, v [B, S_loc, H, D] (any
    strides with a contiguous head dim) over the ring ``group`` (the ranks in
    group order hold the shards in sequence order; None: one rank). Returns
    [B, S_loc, H, D] in q's dtype. ``k_valid_len``: the global valid length;
    ``window``: a uniform TemporalWindow on global positions."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = 1 if group is None else dist.get_world_size(group)
    idx = 0 if group is None else dist.get_rank(group)
    b, s_loc, h, d = q.shape
    kv_len = n * s_loc if k_valid_len is None else min(int(k_valid_len), n * s_loc)
    band = None
    if window is not None:
        if window.head_radii is not None and len(set(window.head_radii)) > 1:
            raise NotImplementedError("per-head radii under ring attention: deploy a uniform "
                                      "window on ring meshes")
        band = (int(window.tokens_per_frame), int(window.radius))
        window = TemporalWindow(*band)
    q_off = idx * s_loc
    # the shards travel as contiguous [B, H, S_loc, D] blocks (K4 reads them as they lie)
    k_cur, v_cur = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    acc = None
    for i in range(n):
        src = (idx - i) % n
        reqs = []
        if i < n - 1:
            k_next, v_next = torch.empty_like(k_cur), torch.empty_like(v_cur)
            # k and v carry tags of their own: two messages to one peer must not
            # match each other's receive
            ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, (idx + 1) % n), group,
                              tag) for tag, t in enumerate((k_cur, v_cur))]
            ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, (idx - 1) % n), group,
                               tag) for tag, t in enumerate((k_next, v_next))]
            reqs = dist.batch_isend_irecv(ops)
        if hop_visits(q_off, s_loc, src * s_loc, s_loc, kv_len, band):
            acc = fold_partial(acc, *partial_attention(
                q, k_cur.transpose(1, 2), v_cur.transpose(1, 2), scale, q_off, src * s_loc,
                kv_len, window))
        for r in reqs:
            r.wait()
        if i < n - 1:
            k_cur, v_cur = k_next, v_next
    if acc is None:  # no valid key anywhere (k_valid_len 0)
        return torch.zeros_like(q)
    return acc[0].to(q.dtype)
