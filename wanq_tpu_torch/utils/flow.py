"""Optical-flow score, the motion-amount metric (counterpart of
wanq_tpu/utils/flow.py).

The score is the mean optical-flow magnitude between consecutive frames.
The reference measures it with RAFT, a pretrained net; here, as in
wanq_tpu, a classical pyramidal Horn–Schunck estimator computes it with no
weights: grey frames, downscaled to at most ``max_side`` pixels, 3 pyramid
levels of 40 iterations, the magnitude rescaled to the input's pixels. It
ranks motion between an FP set and a quantized set; its values are not
RAFT's. Where a pyramid level has an odd side, the coarser level's flow is
edge-extended by a row or column; wanq_tpu raises there (480 x 832 frames,
which it handles, never meet the case).

wanq_tpu runs one frame pair at a time in numpy (float64 where its
derivative kernels promote). Here every frame pair of every video is one
batch of float32 tensors on ``device`` (the card unless the caller asks
for the CPU): the pairs are independent, so a level's 40 iterations are 40
batched steps. The two agree to ~1e-6 relative, not to the bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from wanq_tpu_torch.utils.metrics import as_tensor


def _to_gray(frames: torch.Tensor) -> torch.Tensor:
    """[P, H, W, 3] or [P, H, W] float32 -> [P, H, W] luminance in [0, 1]:
    a frame whose max exceeds 1.5 is taken as 0..255 and divided (per frame)."""
    big = frames.flatten(1).amax(dim=1) > 1.5
    f = torch.where(big.view(-1, *([1] * (frames.ndim - 1))), frames / 255.0, frames)
    if f.ndim == 4:
        f = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    return f


def _downsample(img: torch.Tensor) -> torch.Tensor:
    h2, w2 = img.shape[-2] // 2 * 2, img.shape[-1] // 2 * 2
    x = img[..., :h2, :w2]
    return 0.25 * (x[..., 0::2, 0::2] + x[..., 1::2, 0::2] + x[..., 0::2, 1::2]
                   + x[..., 1::2, 1::2])


def _upsample2(f: torch.Tensor, shape) -> torch.Tensor:
    """Each value to a 2x2 block, cut or edge-extended to ``shape``: a level
    with an odd side is one row or column larger than twice the coarser
    one (wanq_tpu only cuts, so its flow_score raises on such frames)."""
    out = f.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    out = out[..., : shape[0], : shape[1]]
    short = (0, shape[1] - out.shape[-1], 0, shape[0] - out.shape[-2])
    return _edge_pad(out, short) if any(short) else out


def _edge_pad(img: torch.Tensor, pads) -> torch.Tensor:
    """Edge-replicating pad of the last two axes (F.pad's order)."""
    return F.pad(img[:, None], pads, mode="replicate")[:, 0]


def _gradients(i1: torch.Tensor, i2: torch.Tensor):
    """Horn–Schunck derivatives: 2x2 forward differences averaged over the
    two frames, the bottom and right edges replicated."""

    def quads(img):
        p = _edge_pad(img, (0, 1, 0, 1))
        return p[:, :-1, :-1], p[:, :-1, 1:], p[:, 1:, :-1], p[:, 1:, 1:]

    a00, a01, a10, a11 = quads(i1)
    b00, b01, b10, b11 = quads(i2)
    ix = 0.25 * (-a00 + a01 - a10 + a11) + 0.25 * (-b00 + b01 - b10 + b11)
    iy = 0.25 * (-a00 - a01 + a10 + a11) + 0.25 * (-b00 - b01 + b10 + b11)
    d00, d01, d10, d11 = quads(i2 - i1)
    return ix, iy, 0.25 * (d00 + d01 + d10 + d11)


def _avg(f: torch.Tensor) -> torch.Tensor:
    """Horn–Schunck neighbourhood average (the cross 1/6, the corners 1/12)."""
    p = _edge_pad(f, (1, 1, 1, 1))
    return ((p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2] + p[:, 1:-1, 2:]) / 6.0
            + (p[:, :-2, :-2] + p[:, :-2, 2:] + p[:, 2:, :-2] + p[:, 2:, 2:]) / 12.0)


def _warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``img`` at (x + u, y + v), clamped to the frame."""
    p, h, w = img.shape
    yy = torch.arange(h, device=img.device, dtype=img.dtype)[:, None]
    xx = torch.arange(w, device=img.device, dtype=img.dtype)[None, :]
    xs = (xx + u).clamp(0, w - 1)
    ys = (yy + v).clamp(0, h - 1)
    x0, y0 = xs.floor().long(), ys.floor().long()
    x1, y1 = (x0 + 1).clamp_max(w - 1), (y0 + 1).clamp_max(h - 1)
    fx, fy = xs - x0, ys - y0
    flat = img.reshape(p, h * w)

    def at(y, x):
        return flat.gather(1, (y * w + x).reshape(p, -1)).reshape(p, h, w)

    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x1) * fx * (1 - fy)
            + at(y1, x0) * (1 - fx) * fy + at(y1, x1) * fx * fy)


def horn_schunck(i1: torch.Tensor, i2: torch.Tensor, alpha: float = 1.0, iters: int = 40,
                 u0=None, v0=None):
    """One Horn–Schunck level on a batch of frame pairs [P, H, W], from the
    flow (u0, v0) of the coarser level (i2 warped by it). Returns (u, v) in
    pixels."""
    u = torch.zeros_like(i1) if u0 is None else u0
    v = torch.zeros_like(i1) if v0 is None else v0
    i2w = _warp(i2, u, v) if u0 is not None else i2
    ix, iy, it = _gradients(i1, i2w)
    du, dv = torch.zeros_like(u), torch.zeros_like(v)
    denom = alpha**2 + ix**2 + iy**2
    for _ in range(iters):
        ubar, vbar = _avg(du), _avg(dv)
        t = (ix * ubar + iy * vbar + it) / denom
        du = ubar - ix * t
        dv = vbar - iy * t
    return u + du, v + dv


def pyramidal_flow(f1: torch.Tensor, f2: torch.Tensor, levels: int = 3, alpha: float = 1.0,
                   iters: int = 40):
    """Coarse-to-fine Horn–Schunck between frame batches [P, H, W(, 3)]."""
    pyr1, pyr2 = [_to_gray(f1)], [_to_gray(f2)]
    for _ in range(levels - 1):
        if min(pyr1[-1].shape[-2:]) < 16:
            break
        pyr1.append(_downsample(pyr1[-1]))
        pyr2.append(_downsample(pyr2[-1]))
    u = v = None
    for a, b in zip(reversed(pyr1), reversed(pyr2)):
        if u is not None:
            u = 2.0 * _upsample2(u, a.shape[-2:])
            v = 2.0 * _upsample2(v, a.shape[-2:])
        u, v = horn_schunck(a, b, alpha=alpha, iters=iters, u0=u, v0=v)
    return u, v


@torch.no_grad()
def flow_score(videos, max_side: int = 128, device="cuda") -> float:
    """Mean flow magnitude over all consecutive frame pairs of all videos
    ([N, T, H, W, C] or [N, C, T, H, W], C in (1, 3)); frames are
    downscaled by 2 until max(H, W) <= max_side and the magnitude is
    rescaled to the input's pixels."""
    videos = as_tensor(videos)
    if videos.ndim != 5:
        raise ValueError(f"flow_score needs videos [N, T, H, W, C], got {tuple(videos.shape)}")
    if videos.shape[-1] not in (1, 3):  # N, C, T, H, W -> N, T, H, W, C
        videos = videos.permute(0, 2, 3, 4, 1)
    grays, scale = [], 1.0
    for vid in videos:  # one video at a time on the device
        g = _to_gray(vid.to(device, torch.float32))
        scale = 1.0
        while max(g.shape[-2:]) > max_side:
            g = _downsample(g)
            scale *= 2.0
        grays.append(g)
    if not grays or grays[0].shape[0] < 2:
        return 0.0
    g = torch.stack(grays)  # [N, T, h, w]
    a = g[:, :-1].reshape(-1, *g.shape[-2:])
    b = g[:, 1:].reshape(-1, *g.shape[-2:])
    u, v = pyramidal_flow(a, b)
    mags = scale * torch.sqrt(u**2 + v**2).mean(dim=(1, 2)).double()
    return float(np.mean(mags.cpu().numpy()))
