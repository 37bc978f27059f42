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
it attend the valid prefix. Self-attention also takes a sliding temporal
window (:class:`TemporalWindow`, shared or per-head radii): K4's band mode on
CUDA tensors, which visits only the kv tiles inside the band
(:func:`band_kv_tiles`), and the chunked band mask of
:func:`temporal_band_dense_mask` in the plain version. K4 reads each head's
radius, so per-head radii need neither ``wanq_tpu``'s head groups nor its
head permutes. K4 takes bf16 with head dim 128 (every Wan config); other
inputs raise on CUDA tensors (the ``tiny`` test config, head dim 24, runs on
the CPU).

Training (``attention(..., trainable=True)`` while autograd records): on
CUDA tensors a :class:`torch.autograd.Function` whose forward is K4's
residual mode (the output and each row's log-sum-exp) and whose backward is
K12 (dq) and K11 (dk, dv; skipped when k and v need no gradient) of
``csrc/flash_attention_bwd.cu`` (wgmma and TMA rings, as K4), with ``di =
sum(o * do)`` one torch reduction into the row table both read
(:func:`flash_bwd_rows`). Their plain versions are
:func:`_sdpa_lse_reference` and :func:`attention_bwd_reference`, which
work in query chunks from the LSE
(``force_reference`` runs them under the same autograd wiring on the card).
On CPU tensors autograd runs through the plain forward. The band mode has no
backward: a window under training raises.

Ring attention's backward (``parallel/ring.py``) runs K12 and K11 a hop at a
time in their accumulate mode (:func:`flash_attention_bwd_acc`, counters
``attention_bwd_dq_acc`` and ``attention_bwd_dkv_acc``): the row table comes
from the caller, made once a layer from the folded LSE and output, and the
kernels add their f32 gradients into the caller's buffers. Its plain version
is :func:`attention_bwd_reference` with ``rows``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from wanq_tpu_torch.ops import _lib

_DEF_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# the heads of K4's radius table (csrc/flash_attention.cu kMaxHeads)
_K4_MAX_HEADS = 64


@dataclasses.dataclass(frozen=True)
class TemporalWindow:
    """Sliding temporal-window self-attention: every video token attends only
    to tokens within ``radius`` latent frames of its own frame (token index //
    ``tokens_per_frame``), restricted to the valid kv prefix; pad q rows see
    the whole prefix. ``head_radii`` gives each head its own radius (from
    calibration); ``radius`` is then their maximum."""

    tokens_per_frame: int
    radius: int
    head_radii: Optional[tuple] = None

    def __post_init__(self):
        if self.head_radii is not None:
            object.__setattr__(self, "head_radii", tuple(int(r) for r in self.head_radii))
            if min(self.head_radii) < 0:
                raise ValueError(f"window radii must be >= 0, got {self.head_radii}")
            if self.radius != max(self.head_radii):
                raise ValueError("radius must be the collapsed max of head_radii")
        elif self.radius < 0:
            raise ValueError(f"window radius must be >= 0, got {self.radius}")

    def resolved_radii(self, n_heads: int) -> tuple:
        """Per-head radii, expanded to ``n_heads`` entries."""
        if self.head_radii is None:
            return (self.radius,) * n_heads
        if len(self.head_radii) != n_heads:
            raise ValueError(f"{len(self.head_radii)} radii for {n_heads} heads")
        return self.head_radii

    def density(self, n_frames: int) -> float:
        """Fraction of the dense S x S map inside the band (ignoring tile
        rounding); with per-head radii the mean over heads."""
        def one(radius: int) -> float:
            f, r = n_frames, min(radius, n_frames - 1)
            inside = sum(min(f - 1, i + r) - max(0, i - r) + 1 for i in range(f))
            return inside / (f * f)

        if self.head_radii is not None:
            return sum(one(r) for r in self.head_radii) / len(self.head_radii)
        return one(self.radius)


def _window_is_dense(window: TemporalWindow, valid: int) -> bool:
    """True when every head's radius covers every frame pair of the valid
    prefix."""
    n_frames = -(-valid // window.tokens_per_frame)
    r = min(window.head_radii) if window.head_radii else window.radius
    return r >= n_frames - 1


def _band_rows(rows: torch.Tensor, sk: int, tpf: int, radius: int, valid: int) -> torch.Tensor:
    """[len(rows), Sk] band mask of the query rows ``rows``."""
    cols = torch.arange(sk, device=rows.device)
    d = rows[:, None] // tpf - cols[None, :] // tpf
    band = (d <= radius) & (d >= -radius)
    return (band | (rows >= valid)[:, None]) & (cols < valid)[None, :]


def temporal_band_dense_mask(sq: int, sk: int, window: TemporalWindow,
                             k_valid_len: Optional[int], radius: Optional[int] = None,
                             device=None) -> torch.Tensor:
    """[Sq, Sk] bool: row q sees column kv iff kv < valid and (|q // tpf - kv //
    tpf| <= radius or q >= valid) -- ``wanq_tpu``'s band rule. ``radius``
    overrides the window's shared radius (per-head construction)."""
    valid = sk if k_valid_len is None else min(int(k_valid_len), sk)
    r = window.radius if radius is None else radius
    return _band_rows(torch.arange(sq, device=device), sk, window.tokens_per_frame, r, valid)


def band_kv_tiles(q0: int, bq: int, bkv: int, tpf: int, radius: int,
                  valid: int) -> Tuple[int, int]:
    """The kv tiles ``[j_lo, j_hi)`` that K4's band mode visits for the q tile
    ``[q0, q0 + bq)``: from the first column of its first row's band to the
    last column of its last row's, or every tile of the valid prefix if the
    q tile holds a pad row (>= valid). The host mirror of the kernel's
    ``band_tiles``."""
    if q0 + bq > valid:
        return 0, -(-valid // bkv)
    j_lo = max(0, q0 // tpf - radius) * tpf // bkv
    j_hi = -(-min(((q0 + bq - 1) // tpf + radius + 1) * tpf, valid) // bkv)
    return j_lo, j_hi


def _check_window(window) -> None:
    if window is not None and not isinstance(window, TemporalWindow):
        raise TypeError(f"window must be a TemporalWindow, got {type(window).__name__}")


def _sdpa_reference(q, k, v, scale: float, k_valid_len: Optional[int],
                    window: Optional[TemporalWindow] = None,
                    q_chunk: Optional[int] = None) -> torch.Tensor:
    """Plain attention with f32 softmax. q, k, v: [B, S, N, D] (any
    strides). ``q_chunk`` splits the query rows into slices of that many
    (the result is the same; it bounds the [B, N, chunk, Sk] score
    memory at long S). A ``window`` masks each chunk's rows with the band
    (one mask per head for per-head radii), built a chunk at a time, so no
    [Sq, Sk] mask is ever held."""
    _check_window(window)
    sq, sk = q.shape[1], k.shape[1]
    kf = k.float()
    valid = sk if k_valid_len is None else min(int(k_valid_len), sk)
    mask = None
    if window is None and valid < sk:
        mask = torch.arange(sk, device=q.device) < valid
    radii = None
    if window is not None:
        radii = window.resolved_radii(q.shape[2])
        if window.head_radii is None:
            radii = radii[:1]
    outs = []
    step = q_chunk or sq
    for i in range(0, sq, step):
        scores = torch.einsum("bsnd,btnd->bnst", q[:, i:i + step].float(), kf) * scale
        if mask is not None:
            scores = scores.masked_fill(~mask, _DEF_MASK_VALUE)
        elif radii is not None:
            rows = torch.arange(i, min(i + step, sq), device=q.device)
            band = torch.stack([_band_rows(rows, sk, window.tokens_per_frame, r, valid)
                                for r in radii])  # [1 or N, rows, Sk]
            scores = scores.masked_fill(~band, _DEF_MASK_VALUE)
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bnst,btnd->bsnd", probs.to(v.dtype), v))
    # seq-major memory, like the kernel's output
    return outs[0].contiguous() if len(outs) == 1 else torch.cat(outs, dim=1)


def _sdpa_lse_reference(q, k, v, scale: float, k_valid_len: Optional[int],
                        q_chunk: Optional[int] = None):
    """The plain version of K4's residual mode: :func:`_sdpa_reference`'s
    output (dense mask) and each row's log-sum-exp of the scaled, masked
    scores, f32 [B, N, Sq]."""
    sq, sk = q.shape[1], k.shape[1]
    kf = k.float()
    valid = _valid(k_valid_len, sk)
    outs, lses = [], []
    step = q_chunk or sq
    for i in range(0, sq, step):
        scores = torch.einsum("bsnd,btnd->bnst", q[:, i:i + step].float(), kf) * scale
        if valid < sk:
            scores[..., valid:] = _DEF_MASK_VALUE
        lses.append(torch.logsumexp(scores, dim=-1))
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bnst,btnd->bsnd", probs.to(v.dtype), v))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def attention_bwd_reference(q, k, v, o, lse, do, scale: float, k_valid_len: Optional[int],
                            q_chunk: Optional[int] = None, rows: Optional[torch.Tensor] = None):
    """The plain version of K11 and K12: (dq, dk, dv) of attention in the
    dtypes of q, k, v, from the forward's output ``o`` and log-sum-exp
    ``lse`` [B, N, Sq]; q, k, v, o, do [B, S, N, D]. In f32, a query chunk of
    ``q_chunk`` rows at a time: P = exp(scale q k^T - lse) (0 past the valid
    keys), dv = P^T do, dS = P (do v^T - di) with di = sum(o do), dq = scale
    dS k, dk = scale dS^T q. With ``rows`` (a :func:`flash_bwd_rows` table:
    the accumulate mode's input, whose lse and di may come from other keys
    than k's, as a ring hop's do) ``o`` and ``lse`` are not read, P = 2^(scale
    log2(e) q k^T - lse log2(e)) as the kernels form it, and the gradients
    stay f32."""
    sq, sk = q.shape[1], k.shape[1]
    kf, vf = k.float(), v.float()
    valid = _valid(k_valid_len, sk)
    if rows is None:
        di = (o.float() * do.float()).sum(-1).transpose(1, 2)  # [B, N, Sq]
    else:
        lse2, di = rows[:, :, 0, :sq], rows[:, :, 1, :sq]
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    step = q_chunk or sq
    for i in range(0, sq, step):
        qc, doc = q[:, i:i + step].float(), do[:, i:i + step].float()
        s = torch.einsum("bsnd,btnd->bnst", qc, kf)
        if rows is None:
            p = torch.exp(s * scale - lse[:, :, i:i + step, None])
        else:
            p = torch.exp2(s * (scale * _LOG2E) - lse2[:, :, i:i + step, None])
        if valid < sk:
            p[..., valid:] = 0.0
        dv += torch.einsum("bnst,bsnd->btnd", p, doc)
        ds = p * (torch.einsum("bsnd,btnd->bnst", doc, vf) - di[:, :, i:i + step, None])
        dqs.append(torch.einsum("bnst,btnd->bsnd", ds, kf) * scale)
        dk += torch.einsum("bnst,bsnd->btnd", ds, qc) * scale
    dq = torch.cat(dqs, dim=1)
    if rows is not None:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tensor_map_layout(t: torch.Tensor, name: str = "operand"):
    """What the 4-D tensor maps (TMA) of K4 and K10a need of a logical
    [B, N, S, D] view: ``(dims, byte_strides)`` with dims ``(D, S, N, B)``,
    innermost first, and the byte strides of ``(S, N, B)``. The view may
    have any strides (q heads-major, v over the GEMM output [B, S, N*D],
    cross k/v seq-major) as long as the head dim is 128 and contiguous,
    every other stride is a positive multiple of 16 bytes and the base is
    16-byte aligned; anything else raises. A dimension of size 1 never
    moves, so its stride is replaced by one row's bytes."""
    if t.ndim != 4 or t.shape[-1] != 128 or t.stride(-1) != 1:
        raise ValueError(f"{name}: the TMA kernels need [B, N, S, 128] with a contiguous "
                         f"head dim, got shape {tuple(t.shape)} strides {t.stride()}")
    b, n, s, d = t.shape
    row = d * t.element_size()
    strides = []
    for size, st in ((s, t.stride(2)), (n, t.stride(1)), (b, t.stride(0))):
        nbytes = row if size == 1 else st * t.element_size()
        if nbytes <= 0 or nbytes % 16 or nbytes >= 1 << 40:
            raise ValueError(f"{name}: byte strides must be positive multiples of 16, got "
                             f"shape {tuple(t.shape)} strides {t.stride()}")
        strides.append(nbytes)
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the base must be 16-byte aligned")
    return (d, s, n, b), tuple(strides)


def _flash_cuda(q, k, v, scale: float, kv_valid: int, tokens_per_frame: int = 0,
                radii: Optional[Sequence[int]] = None, lse: bool = False,
                partial: Optional[Tuple[int, int, int]] = None):
    """K4 launch on logical [B, N, S, D] views; returns [B, Sq, N, D]. With
    ``radii`` (one per head, >= 0) it runs the band mode over frames of
    ``tokens_per_frame`` tokens (counter ``attention_band``), else the dense
    mode (counter ``attention``). ``lse``: the residual mode (counter
    ``attention_lse``), which also returns each row's log-sum-exp, f32 [B, N,
    Sq]. ``partial`` = (q_offset, kv_offset, kv_len): the partial mode of one
    ring hop (counter ``attention_partial``; see :func:`flash_partial`), dense
    or banded, returning the output and the LSE with -inf on the rows that see
    no key; ``kv_valid`` must then be min(Sk, kv_len - kv_offset)."""
    layouts = []
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _lib.require_cuda(t, torch.bfloat16, name)
        layouts.append(tensor_map_layout(t, name))
    b, n, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, n, sk, d) or v.shape != k.shape:
        raise ValueError(f"k/v shape mismatch: q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if not 1 <= kv_valid <= sk:
        raise ValueError(f"kv_valid {kv_valid} outside [1, {sk}]")
    if not scale > 0:
        raise ValueError(f"scale {scale} must be positive")
    counter, table = "attention", None
    if radii is not None:
        radii = [int(r) for r in radii]
        if len(radii) != n or n > _K4_MAX_HEADS or min(radii) < 0 or tokens_per_frame < 1:
            raise ValueError(f"band mode needs one radius >= 0 for each of <= {_K4_MAX_HEADS} "
                             f"heads and tokens_per_frame >= 1, got {n} heads, radii {radii}, "
                             f"tokens_per_frame {tokens_per_frame}")
        counter, table = "attention_band", (ctypes.c_int * n)(*radii)
    offsets, lse_empty = (0, 0, int(kv_valid)), math.inf
    if partial is not None:
        offsets, lse, lse_empty, counter = tuple(int(x) for x in partial), True, -math.inf, \
            "attention_partial"
        q_off, kv_off, kv_len = offsets
        if q_off < 0 or kv_off < 0 or kv_valid != min(sk, kv_len - kv_off):
            raise ValueError(f"partial mode: offsets ({q_off}, {kv_off}) and kv_len {kv_len} "
                             f"do not give kv_valid {kv_valid} of Sk {sk}")
    elif lse:
        if table is not None:
            raise ValueError("the residual mode is dense: the band mode has no backward")
        counter = "attention_lse"
    row_lse = (torch.empty((b, n, sq), dtype=torch.float32, device=q.device) if lse
               else None)
    out = torch.empty((b, sq, n, d), dtype=torch.bfloat16, device=q.device)
    layouts.append(tensor_map_layout(out.transpose(1, 2), "out"))
    _lib.launch(
        counter, "wanq_flash_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, sq, sk,
        *(st for _, strides in layouts for st in strides),
        int(kv_valid), float(scale), int(tokens_per_frame) if table else 0, table,
        _lib.ptr(row_lse), *offsets, lse_empty,
    )
    return (out, row_lse) if lse else out


def flash_partial(q, k, v, scale: float, q_offset: int, kv_offset: int, kv_len: int,
                  window: Optional[TemporalWindow] = None):
    """K4's partial mode, one hop of ring attention on CUDA tensors: q [B, N,
    Sq, D] at global positions q_offset.., k / v [B, N, Sk, D] at kv_offset..,
    ``kv_len`` the global valid length (the mask of ``parallel/ring.py``'s
    ``_partial_attn``: columns past kv_len masked, q rows past it see every
    valid column, the others the band of ``window`` on global frames, or
    everything without one). Returns (out [B, Sq, N, D] bf16, lse [B, N, Sq]
    f32), out 0 and lse -inf on the rows that see no key of the shard. The
    shard must hold a valid key (the ring skips it otherwise)."""
    _check_window(window)
    kv_valid = min(k.shape[2], kv_len - kv_offset)
    band = {}
    if window is not None:
        band = {"tokens_per_frame": window.tokens_per_frame,
                "radii": window.resolved_radii(q.shape[1])}
    return _flash_cuda(q, k, v, scale, kv_valid, partial=(q_offset, kv_offset, kv_len), **band)


# the row table of K11 and K12 (csrc/flash_attention_bwd.cu) pads Sq to a
# multiple of the 128 rows a block owns
_BWD_ROW_PAD = 128
_LOG2E = 1.4426950408889634


def flash_bwd_rows(lse: torch.Tensor, o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """The row table K11 and K12 read: f32 [B, N, 2, Sq_pad], Sq_pad = Sq
    rounded up to 128, holding lse * log2(e) (+inf past Sq, so P = 0 on the
    pad rows) and di = sum_d o * do (0 past Sq), from ``lse`` [B, N, Sq] and
    ``o``, ``do`` [B, Sq, N, D]. di is the one plain reduction of the
    backward, as the TPU version leaves it to XLA: the products of two bf16
    values are exact in f32, summed in f32. The padding lets K11 copy a
    step's 64 rows of each in bulk and K12 read its rows with no bound."""
    b, n, sq = lse.shape
    pad = -(-sq // _BWD_ROW_PAD) * _BWD_ROW_PAD
    rows = torch.empty((b, n, 2, pad), dtype=torch.float32, device=lse.device)
    rows[:, :, 0, :sq] = lse * _LOG2E
    rows[:, :, 0, sq:] = math.inf
    rows[:, :, 1, :sq] = (o.float() * do).sum(-1).transpose(1, 2)
    rows[:, :, 1, sq:] = 0.0
    return rows


def flash_bwd_strides(q, k, v, do) -> Tuple[int, ...]:
    """The byte strides of (seq, head, batch) of q, k, v and do in turn, as
    K11's and K12's tensor maps take them, from [B, S, N, D] views; raises on
    a layout TMA cannot address (see :func:`tensor_map_layout`)."""
    return tuple(st for t, name in ((q, "q"), (k, "k"), (v, "v"), (do, "do"))
                 for st in tensor_map_layout(t.transpose(1, 2), name)[1])


def flash_attention_bwd(q, k, v, o, lse, do, scale: float, kv_valid: int, dq: bool = True,
                        dkv: bool = True):
    """K12 (dq, counter ``attention_bwd_dq``) and K11 (dk and dv, counter
    ``attention_bwd_dkv``) on [B, S, N, D] bf16 views with a contiguous head
    dim 128; ``lse`` f32 [B, N, Sq] from K4's residual mode. Returns (dq, dk,
    dv), each contiguous [B, S, N, D] bf16, or None where not asked for."""
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (do, "do")):
        _lib.require_cuda(t, torch.bfloat16, name)
    _lib.require_cuda(lse, torch.float32, "lse")
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if (k.shape != (b, sk, n, d) or v.shape != k.shape or do.shape != q.shape
            or o.shape != q.shape):
        raise ValueError(f"shape mismatch: q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} o{tuple(o.shape)} do{tuple(do.shape)}")
    if lse.shape != (b, n, sq) or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous [{b}, {n}, {sq}], got {tuple(lse.shape)}")
    if not 1 <= kv_valid <= sk:
        raise ValueError(f"kv_valid {kv_valid} outside [1, {sk}]")
    table = (ctypes.c_longlong * 12)(*flash_bwd_strides(q, k, v, do))
    rows = flash_bwd_rows(lse, o, do)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), rows.data_ptr())
    tail = (b, n, sq, sk, table, int(kv_valid), float(scale))
    grad_q = grad_k = grad_v = None
    if dq:
        grad_q = torch.empty((b, sq, n, d), dtype=torch.bfloat16, device=q.device)
        _lib.launch("attention_bwd_dq", "wanq_flash_bwd_dq", *args, grad_q.data_ptr(), *tail)
    if dkv:
        grad_k = torch.empty((b, sk, n, d), dtype=torch.bfloat16, device=q.device)
        grad_v = torch.empty_like(grad_k)
        _lib.launch("attention_bwd_dkv", "wanq_flash_bwd_dkv", *args, grad_k.data_ptr(),
                    grad_v.data_ptr(), *tail)
    return grad_q, grad_k, grad_v


def flash_attention_bwd_acc(q, k, v, do, rows, scale: float, kv_valid: int,
                            dq_acc: Optional[torch.Tensor] = None,
                            dk_acc: Optional[torch.Tensor] = None,
                            dv_acc: Optional[torch.Tensor] = None) -> None:
    """K12 and K11's accumulate mode, one hop of ring attention's backward:
    q, do [B, Sq, N, D] the rank's rows, k, v [B, Sk, N, D] the shard the hop
    holds (bf16 views with a contiguous head dim 128), ``kv_valid`` its valid
    keys, ``rows`` the :func:`flash_bwd_rows` table of q's rows from the
    folded LSE and output. Adds scale dS k into ``dq_acc`` (K12, counter
    ``attention_bwd_dq_acc``) and scale dS^T q, P^T do into ``dk_acc``,
    ``dv_acc`` (K11, counter ``attention_bwd_dkv_acc``), each f32 contiguous
    [B, S, N, D]; a None buffer skips its kernel."""
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (do, "do")):
        _lib.require_cuda(t, torch.bfloat16, name)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, n, d) or v.shape != k.shape or do.shape != q.shape:
        raise ValueError(f"shape mismatch: q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do{tuple(do.shape)}")
    pad = -(-sq // _BWD_ROW_PAD) * _BWD_ROW_PAD
    _lib.require_cuda(rows, torch.float32, "rows")
    if rows.shape != (b, n, 2, pad) or not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous [{b}, {n}, 2, {pad}], got "
                         f"{tuple(rows.shape)}")
    for t, name, s in ((dq_acc, "dq_acc", sq), (dk_acc, "dk_acc", sk), (dv_acc, "dv_acc", sk)):
        if t is not None:
            _lib.require_cuda(t, torch.float32, name)
            if t.shape != (b, s, n, d) or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous [{b}, {s}, {n}, {d}] f32")
    if (dk_acc is None) != (dv_acc is None):
        raise ValueError("dk_acc and dv_acc go together (one K11 launch)")
    if not 1 <= kv_valid <= sk:
        raise ValueError(f"kv_valid {kv_valid} outside [1, {sk}]")
    table = (ctypes.c_longlong * 12)(*flash_bwd_strides(q, k, v, do))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), rows.data_ptr())
    tail = (b, n, sq, sk, table, int(kv_valid), float(scale))
    if dq_acc is not None:
        _lib.launch("attention_bwd_dq_acc", "wanq_flash_bwd_dq_acc", *args, dq_acc.data_ptr(),
                    *tail)
    if dk_acc is not None:
        _lib.launch("attention_bwd_dkv_acc", "wanq_flash_bwd_dkv_acc", *args,
                    dk_acc.data_ptr(), dv_acc.data_ptr(), *tail)


class _FlashAttention(torch.autograd.Function):
    """Attention under autograd on the card: K4's residual mode forward, K12
    and K11 backward. q, k, v [B, S, N, D] views."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_valid):
        out, lse = _flash_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale,
                               kv_valid, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.kv_valid = scale, kv_valid
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        need = ctx.needs_input_grad
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), ctx.scale,
                                         ctx.kv_valid, dq=need[0], dkv=need[1] or need[2])
        return dq, dk, dv, None, None


# the query rows a chunk of the plain versions takes on the card
_PLAIN_Q_CHUNK = 1024


class _PlainAttention(torch.autograd.Function):
    """The kernels' plain versions under the same wiring (``force_reference``
    on the card): the chunked forward with its LSE, and
    :func:`attention_bwd_reference`, so a full-length sequence fits."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_valid):
        out, lse = _sdpa_lse_reference(q, k, v, scale, kv_valid, q_chunk=_PLAIN_Q_CHUNK)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.kv_valid = scale, kv_valid
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*attention_bwd_reference(q, k, v, out, lse, dout, ctx.scale, ctx.kv_valid,
                                         q_chunk=_PLAIN_Q_CHUNK), None, None)


def _valid(k_valid_len: Optional[int], sk: int) -> int:
    return sk if k_valid_len is None else min(int(k_valid_len), sk)


def _band_args(window: Optional[TemporalWindow], n_heads: int, valid: int):
    """K4's band arguments for ``window``: tokens_per_frame and per-head radii;
    none (the dense mode) when every head's band covers every frame pair, as
    ``wanq_tpu``'s splash then takes its dense prefix mask."""
    if window is None or _window_is_dense(window, valid):
        return {}
    return {"tokens_per_frame": window.tokens_per_frame,
            "radii": window.resolved_radii(n_heads)}


def attention(q, k, v, scale: Optional[float] = None, k_valid_len: Optional[int] = None,
              window: Optional[TemporalWindow] = None, trainable: bool = False,
              force_reference: bool = False) -> torch.Tensor:
    """Scaled dot-product attention. q [B, Sq, N, D]; k, v [B, Sk, N, D].
    ``trainable``: while autograd records and an operand needs a gradient, the
    card runs K4's residual mode here and K12 / K11 in the backward;
    ``force_reference`` runs the plain versions instead (on the card: in query
    chunks, with the plain backward from the LSE), as the kernels' oracle."""
    _check_window(window)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    valid = _valid(k_valid_len, k.shape[1])
    if q.is_cuda and trainable and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        if _band_args(window, q.shape[2], valid):
            raise NotImplementedError("the band mode has no backward: train dense, deploy "
                                      "windowed")
        fn = _PlainAttention if force_reference else _FlashAttention
        return fn.apply(q, k, v, scale, valid)
    if q.is_cuda and not force_reference:
        return _flash_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           scale, valid, **_band_args(window, q.shape[2], valid))
    return _sdpa_reference(q, k, v, scale, k_valid_len, window=window,
                           q_chunk=_PLAIN_Q_CHUNK if q.is_cuda else None)


def attention_heads_major(q, k, v, k_valid_len: Optional[int] = None,
                          window: Optional[TemporalWindow] = None) -> torch.Tensor:
    """Self-attention on heads-major [B, N, S, D] operands, softmax scale
    pre-folded into q. Returns [B, N, S, D] over seq-major memory."""
    _check_window(window)
    if q.is_cuda:
        valid = _valid(k_valid_len, k.shape[2])
        out = _flash_cuda(q, k, v, 1.0, valid, **_band_args(window, q.shape[1], valid))
    else:
        out = _sdpa_reference(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), 1.0, k_valid_len, window=window)
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
