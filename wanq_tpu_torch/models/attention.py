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


def tensor_map_layout(t: torch.Tensor, name: str = "operand"):
    """What K4's 4-D tensor map (TMA) needs of a logical [B, N, S, D] view:
    ``(dims, byte_strides)`` with dims ``(D, S, N, B)``, innermost first, and
    the byte strides of ``(S, N, B)``. The view may have any strides (q
    heads-major, v over the GEMM output [B, S, N*D], cross k/v seq-major)
    as long as the head dim is 128 and contiguous, every other stride is a
    positive multiple of 16 bytes and the base is 16-byte aligned; anything
    else raises. A dimension of size 1 never moves, so its stride is
    replaced by one row's bytes."""
    if t.ndim != 4 or t.shape[-1] != 128 or t.stride(-1) != 1:
        raise ValueError(f"{name}: K4 needs [B, N, S, 128] with a contiguous head dim, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")
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
                radii: Optional[Sequence[int]] = None) -> torch.Tensor:
    """K4 launch on logical [B, N, S, D] views; returns [B, Sq, N, D]. With
    ``radii`` (one per head, >= 0) it runs the band mode over frames of
    ``tokens_per_frame`` tokens (counter ``attention_band``), else the dense
    mode (counter ``attention``)."""
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
    out = torch.empty((b, sq, n, d), dtype=torch.bfloat16, device=q.device)
    layouts.append(tensor_map_layout(out.transpose(1, 2), "out"))
    _lib.launch(
        counter, "wanq_flash_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, sq, sk,
        *(st for _, strides in layouts for st in strides),
        int(kv_valid), float(scale), int(tokens_per_frame) if table else 0, table,
    )
    return out


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
              window: Optional[TemporalWindow] = None) -> torch.Tensor:
    """Scaled dot-product attention. q [B, Sq, N, D]; k, v [B, Sk, N, D]."""
    _check_window(window)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        valid = _valid(k_valid_len, k.shape[1])
        return _flash_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           scale, valid, **_band_args(window, q.shape[2], valid))
    return _sdpa_reference(q, k, v, scale, k_valid_len, window=window)


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
