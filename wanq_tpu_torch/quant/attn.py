"""Attention quantization, the simulation (counterpart of
wanq_tpu/quant/attn.py): q/k/v fake-quant + post-softmax attention-map
fake-quant around an explicit-BMM attention.

  q, k      dynamic per-(token, head) row quant over head_dim
  v         dynamic per-(head, channel) quant over tokens
  attn map  post-softmax quant, group in
              'row'    one scale per key column
              'block'  block decomposition with block-max deltas, optional
                       int8-quantized deltas, per-block bit masks (0 bits
                       prunes a block) and a per-head token reorder; text
                       rows/cols stay FP

The hardware execution of an ``attn:`` section is the int8 flash kernel
(``ops/attn_int8.py``); this module is what sim mode runs, and what a
``cross_attn:`` section runs in both modes. It materializes the [S, S] map,
so it is for small sequences.

Calibration helpers: pooled attention-map capture (:func:`pooled_attn_map`,
chunked) feeds the reorder tables and the choice of temporal-window radii
(:func:`select_temporal_windows`, :func:`collapse_window_radii`,
:func:`per_head_window_radii`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from wanq_tpu_torch.ops.fused import true_div
from wanq_tpu_torch.quant.quantizers import QuantizerCfg, dynamic_fake_quant, n_levels_for

_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class AttnQuantCfg:
    """Resolved from the quant YAML's attn / cross_attn sections."""

    qk: Optional[QuantizerCfg] = None
    v: Optional[QuantizerCfg] = None
    attn_map: Optional[QuantizerCfg] = None
    attn_map_group: str = "row"  # 'row' | 'block'
    n_text_tokens: int = 0
    block_size: int = 0  # tokens per block side ('block' group)
    int8_scale: bool = False

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["AttnQuantCfg"]:
        if not d:
            return None

        def qcfg(sub):
            if not sub:
                return None
            nb = sub["n_bits"]
            nb = tuple(nb) if isinstance(nb, (list, tuple)) else int(nb)
            return QuantizerCfg(n_bits=nb, sym=bool(sub.get("sym", True)))

        am = d.get("attn_map") or {}
        return cls(
            qk=qcfg(d.get("qk")),
            v=qcfg(d.get("v")),
            attn_map=qcfg(am),
            attn_map_group=am.get("group", "row"),
            n_text_tokens=int(d.get("n_text_tokens", 0)),
            block_size=int(am.get("block_size", 0)),
            int8_scale=bool(am.get("int8_scale", False)),
        )


def quantize_qk(x: torch.Tensor, cfg: QuantizerCfg) -> torch.Tensor:
    """q/k fake-quant, one scale per (b, h, token) row over head_dim."""
    shape = x.shape
    return dynamic_fake_quant(x.reshape(-1, shape[-1]), cfg).reshape(shape)


def quantize_v(v: torch.Tensor, cfg: QuantizerCfg) -> torch.Tensor:
    """v fake-quant, one scale per (b, h, channel) over tokens. v [B,H,S,D]."""
    b, h, s, d = v.shape
    vq = dynamic_fake_quant(v.transpose(2, 3).reshape(-1, s), cfg)
    return vq.reshape(b, h, d, s).transpose(2, 3)


def _fake_quant_with_delta(x: torch.Tensor, delta: torch.Tensor, n_bits: int,
                           bits_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Unsigned quant of in-[0, 1] maps with a precomputed per-element delta
    (the block max). ``bits_mask`` gives per-element bitwidths; 0 prunes."""
    delta = torch.where(delta < _EPS, torch.full_like(delta, _EPS), delta)
    if bits_mask is not None:
        n_levels = torch.pow(2.0, bits_mask.to(x.dtype)) - 1.0
        zero_mask = (n_levels != 0).to(x.dtype)
        n_levels = torch.where(n_levels == 0, torch.full_like(n_levels, 255.0), n_levels)
        step = delta / n_levels
        x_q = torch.minimum(torch.round(x / step), n_levels)
        return x_q * step * zero_mask
    nl = n_levels_for(n_bits, sym=True)
    step = true_div(delta, nl * 2 + 1)
    x_q = torch.clamp(torch.round(x / step), 0, nl * 2 + 1)
    return x_q * step


def quantize_attn_map_row(attn: torch.Tensor, cfg: QuantizerCfg) -> torch.Tensor:
    """One scale per key column. attn [B, H, Sq, Sk]."""
    b, h, sq, sk = attn.shape
    aq = dynamic_fake_quant(attn.transpose(2, 3).reshape(-1, sq), cfg)
    return aq.reshape(b, h, sk, sq).transpose(2, 3)


def quantize_attn_map_block(
    attn: torch.Tensor,
    cfg: QuantizerCfg,
    block_size: int,
    n_text_tokens: int = 0,
    int8_scale: bool = False,
    bits_mask: Optional[torch.Tensor] = None,
    perm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Blockwise attn-map quant. attn [B, H, S, S]. The image-token submap
    (text rows/cols stay FP) is tiled into block_size x block_size blocks,
    each quantized with delta = its max. ``int8_scale`` also int8-quantizes
    the per-block deltas against their per-(b, h) max. ``bits_mask``
    [n_img/bs, n_img/bs] (or broadcastable) gives per-block bitwidths
    (0 = prune). ``perm`` [H, n_img] reorders tokens per head before
    blocking and is undone after."""
    b, h, s, _ = attn.shape
    nt = n_text_tokens
    img = attn[:, :, nt:, nt:]
    n_img = s - nt
    if n_img % block_size:
        raise ValueError(f"block_size {block_size} must divide the {n_img} image tokens")
    nb = n_img // block_size

    if perm is not None:
        if tuple(perm.shape) != (h, n_img):
            raise ValueError(
                f"reorder table shape {tuple(perm.shape)} != (heads, image tokens) "
                f"({h}, {n_img}): tables are geometry-specific; regenerate for this "
                "latent size")
        perm = perm.to(device=attn.device, dtype=torch.int64)
        img = torch.take_along_dim(img, perm[None, :, :, None], dim=2)
        img = torch.take_along_dim(img, perm[None, :, None, :], dim=3)

    blocks = img.reshape(b, h, nb, block_size, nb, block_size)
    delta = blocks.amax(dim=(3, 5))  # [B, H, nb, nb]

    if int8_scale:
        dmax = delta.amax(dim=(2, 3), keepdim=True)
        dmax = torch.where(dmax < _EPS, torch.full_like(dmax, _EPS), dmax)
        nl = 127
        step = true_div(dmax, nl * 2 + 1)
        delta = torch.clamp(torch.round(delta / step), 0, nl * 2 + 1) * step

    delta_full = delta.repeat_interleave(block_size, dim=2).repeat_interleave(block_size, dim=3)
    bm_full = None
    if bits_mask is not None:
        bm = torch.as_tensor(bits_mask, device=attn.device).expand(nb, nb)
        bm_full = bm.repeat_interleave(block_size, dim=0).repeat_interleave(block_size, dim=1)
        bm_full = bm_full.expand(img.shape)

    img_q = _fake_quant_with_delta(img, delta_full, cfg.active_bits, bm_full)

    if perm is not None:
        inv = torch.argsort(perm, dim=1)
        img_q = torch.take_along_dim(img_q, inv[None, :, :, None], dim=2)
        img_q = torch.take_along_dim(img_q, inv[None, :, None, :], dim=3)

    out = attn.clone()
    out[:, :, nt:, nt:] = img_q
    return out


def generate_reorder_tables(attn_maps: Dict[str, Any], pool: int = 1,
                            iters: int = 8) -> Dict[str, np.ndarray]:
    """Calibration-driven per-head token reorder tables (host numpy).

    ``attn_maps``: {layer: [H, Sp, Sp]} pooled post-softmax maps. For each
    head, tokens are ordered by their coordinate along the map's dominant
    singular vector (power iteration), so rows with similar attention
    profiles land adjacently, which tightens the per-block deltas of the
    blockwise quantizer. Returns {layer: perm [H, Sp * pool]} int32 for
    :func:`quantize_attn_map_block` / ``QuantCtx.attn_perms``."""
    out = {}
    for layer, maps in attn_maps.items():
        maps = np.asarray(maps, dtype=np.float64)
        h, sp, _ = maps.shape
        perms = np.empty((h, sp * pool), dtype=np.int32)
        for i in range(h):
            a = maps[i]
            v = np.ones(sp) / math.sqrt(sp)
            for _ in range(iters):
                v = a.T @ (a @ v)
                nrm = np.linalg.norm(v)
                if nrm < 1e-30:
                    break
                v = v / nrm
            order = np.argsort(a @ v, kind="stable")
            # pooled order back to token granularity (tokens inside a pool
            # window keep their relative order)
            tok = (order[:, None] * pool + np.arange(pool)[None, :]).reshape(-1)
            perms[i] = tok.astype(np.int32)
        out[layer] = perms
    return out


def pooled_attn_map(q: torch.Tensor, k: torch.Tensor, pool: int,
                    scale: Optional[float] = None, k_valid_len: Optional[int] = None,
                    chunk: int = 1024, reduce: str = "max") -> torch.Tensor:
    """Pooled post-softmax attention map for calibration. q, k: [B, S, N, D]
    (post-rope). Returns [N, S // pool, S // pool]: over batch and each pool x
    pool cell, the max (``reduce='max'``, the reference's 2D max-pool; feeds
    reorder tables) or the mean (``'mean'``, mass-preserving; what
    :func:`select_temporal_windows` needs). Computed a q chunk at a time, the
    chunk halved until its f32 score block [B, N, chunk, S] fits in ~1.5 GB,
    so the [S, S] map never materializes. The operands are rounded to bf16
    (q after the scale) and their products summed in f32; the softmax is f32."""
    if reduce not in ("max", "mean"):
        raise ValueError(f"reduce must be 'max' or 'mean', got {reduce!r}")
    b, s, n, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if s % pool:
        raise ValueError(f"pool {pool} must divide the sequence length {s}")
    while chunk > pool and b * n * chunk * s * 4 > 1.5e9:
        chunk //= 2
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    chunk = max(chunk, pool)
    if chunk % pool:
        raise ValueError(f"pool {pool} must divide the q chunk {chunk}")
    qh = q.transpose(1, 2).to(torch.bfloat16)                  # [B, N, S, D]
    kt = k.transpose(1, 2).to(torch.bfloat16).float().transpose(-1, -2)
    kv_mask = None
    if k_valid_len is not None and k_valid_len < s:
        kv_mask = torch.arange(s, device=q.device) < k_valid_len
    pooled = []
    for c0 in range(0, s, chunk):
        qc = (qh[:, :, c0:c0 + chunk].float() * scale).to(torch.bfloat16).float()
        scores = torch.matmul(qc, kt)                            # [B, N, chunk, S] f32
        if kv_mask is not None:
            scores = scores.masked_fill(~kv_mask, torch.finfo(torch.float32).min)
        pb = torch.softmax(scores, dim=-1).reshape(b, n, chunk // pool, pool, s // pool, pool)
        pooled.append(pb.mean(dim=(0, 3, 5)) if reduce == "mean" else pb.amax(dim=(0, 3, 5)))
    return torch.cat(pooled, dim=1)


def select_temporal_windows(attn_maps: Dict[str, Any], tokens_per_frame: int, pool: int,
                            threshold: float = 0.95,
                            valid_len: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Calibration-driven sliding-window radii (host numpy). ``attn_maps``:
    {layer: [H, Sp, Sp]} MEAN-pooled post-softmax maps. For each head, the
    smallest radius r (latent frames) such that the attention mass within
    |frame(q) - frame(k)| <= r is at least ``threshold`` of the total.
    Returns {layer: [H] int32 radii}."""
    out = {}
    for layer, maps in attn_maps.items():
        maps = np.asarray(maps, dtype=np.float64)
        h, sp, _ = maps.shape
        # frame of each pooled cell (its centre); cells past the valid prefix
        # carry ~zero mass (masked softmax)
        frames = (np.arange(sp) * pool + pool // 2) // tokens_per_frame
        n_frames = int(frames[-1]) + 1
        if valid_len is not None:
            n_frames = min(n_frames, -(-valid_len // tokens_per_frame))
        dist = np.abs(frames[:, None] - frames[None, :])
        radii = np.empty(h, dtype=np.int32)
        for i in range(h):
            total = maps[i].sum()
            if total <= 0:
                radii[i] = n_frames - 1
                continue
            for r in range(n_frames):
                if maps[i][dist <= r].sum() / total >= threshold:
                    radii[i] = r
                    break
            else:
                radii[i] = n_frames - 1
        out[layer] = radii
    return out


def collapse_window_radii(windows: Dict[str, Any]) -> int:
    """One deployable radius for every layer and head: the max, so no head
    loses more mass than its own threshold."""
    return int(max(int(np.max(r)) for r in windows.values()))


def per_head_window_radii(windows: Dict[str, Any]) -> np.ndarray:
    """One radius per head, the max over layers: [H]. K4 reads a radius per
    head, so cheap heads stop paying the global max. Pass ``tuple(...)`` as
    ``QuantCtx.attn_window`` or comma-joined to ``--attn_window``."""
    return np.max(np.stack([np.asarray(r, dtype=int) for r in windows.values()], axis=0),
                  axis=0)


def quantized_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    acfg: AttnQuantCfg,
    scale: Optional[float] = None,
    bits_mask: Optional[torch.Tensor] = None,
    perm: Optional[torch.Tensor] = None,
    k_valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Explicit-BMM attention with q/k/v + attn-map fake-quant (the
    simulation; the int8 flash kernel is the hardware path). q, k, v
    [B, S, N, D] -> [B, S, N, D] in v's dtype. Products take the operands
    in their dtype and sum in f32, as the JAX package's einsums do."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    if acfg.qk is not None:
        qh = quantize_qk(qh, acfg.qk)
        kh = quantize_qk(kh, acfg.qk)
    if acfg.v is not None:
        vh = quantize_v(vh, acfg.v)

    attn = torch.matmul((qh * scale).float(), kh.float().transpose(-1, -2))
    if k_valid_len is not None and k_valid_len < k.shape[1]:
        kv_mask = torch.arange(k.shape[1], device=q.device) < k_valid_len
        attn = attn.masked_fill(~kv_mask, torch.finfo(torch.float32).min)
    attn = torch.softmax(attn, dim=-1)

    if acfg.attn_map is not None:
        if acfg.attn_map_group == "row":
            attn = quantize_attn_map_row(attn, acfg.attn_map)
        elif acfg.attn_map_group == "block":
            attn = quantize_attn_map_block(
                attn, acfg.attn_map, acfg.block_size, acfg.n_text_tokens,
                acfg.int8_scale, bits_mask, perm)
        else:
            raise ValueError(acfg.attn_map_group)

    out = torch.matmul(attn.to(vh.dtype).float(), vh.float()).to(vh.dtype)
    return out.transpose(1, 2)
