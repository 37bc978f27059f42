"""FVD (Fréchet Video Distance) and the FP-vs-quant FPFVD harness
(counterpart of wanq_tpu/utils/fvd.py).

FPFVD is the FVD between the FP outputs and the quantized outputs of the
same prompts and seeds. The standard metric rides a pretrained I3D net;
none ships here, so the feature extractor is pluggable:

* default: :class:`I3DLikeFeatures`, a seeded random-projection 3D conv
  net. Random-feature Fréchet distances rank distribution shifts (0 for
  identical sets, monotone in distortion) but are not comparable to
  published I3D-FVD numbers, and the report labels them
  ``fvd_random_feat``. Its weights are drawn by a ``torch.Generator``,
  wanq_tpu's by ``jax.random``: the two packages' ``fvd_random_feat`` do
  not compare unless one is handed the other's weights
  (``I3DLikeFeatures(kernels=..., head=...)``).
* any callable ``videos [N, T, H, W, 3] -> features [N, D]`` (a converted
  I3D checkpoint gives standard FVD).

The net runs in float32 on ``device`` (the card unless the caller asks for
the CPU) with TF32 off inside it, whatever the caller's setting; the
Fréchet math runs in float64 numpy on the host.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wanq_tpu_torch.utils.metrics import as_tensor, quant_fidelity_report

WIDTHS = (16, 32, 64, 128)


@contextlib.contextmanager
def full_f32():
    """f32 matmuls and convolutions stay full f32 inside (TF32 off), as
    XLA computes them; the caller's settings come back after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def frechet_distance(
    mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray, cov2: np.ndarray
) -> float:
    """Exact Fréchet distance between two Gaussians,
    |mu1 - mu2|^2 + tr(C1 + C2 - 2 (C1 C2)^1/2), with tr((C1 C2)^1/2) from
    the symmetric form C1^1/2 C2 C1^1/2 (eigendecompositions only)."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    cov1 = np.asarray(cov1, np.float64)
    cov2 = np.asarray(cov2, np.float64)
    diff = float(np.sum((mu1 - mu2) ** 2))
    w1, v1 = np.linalg.eigh(cov1)
    w1 = np.clip(w1, 0.0, None)
    s1 = (v1 * np.sqrt(w1)[None, :]) @ v1.T
    m = s1 @ cov2 @ s1
    wm = np.linalg.eigvalsh((m + m.T) / 2.0)
    wm = np.clip(wm, 0.0, None)
    tr_sqrt = float(np.sum(np.sqrt(wm)))
    return diff + float(np.trace(cov1) + np.trace(cov2)) - 2.0 * tr_sqrt


# ---------------------------------------------------------------------------
# feature extractors
# ---------------------------------------------------------------------------


def random_conv_weights(ndim: int, feat_dim: int, seed: int
                        ) -> Tuple[List[np.ndarray], np.ndarray]:
    """The random feature nets' weights in wanq_tpu's layout: one kernel a
    stage, [3]*ndim + [c_in, c_out], normal / sqrt(fan_in), and the head
    [128, feat_dim], normal / sqrt(128); drawn on the host by a
    ``torch.Generator`` seeded with ``seed``, so the card and the CPU
    compute from the same net."""
    gen = torch.Generator().manual_seed(seed)
    kernels, c_in = [], 3
    for c_out in WIDTHS:
        fan = c_in * 3**ndim
        w = torch.randn((3,) * ndim + (c_in, c_out), generator=gen) / math.sqrt(fan)
        kernels.append(w.numpy())
        c_in = c_out
    head = torch.randn((c_in, feat_dim), generator=gen) / math.sqrt(c_in)
    return kernels, head.numpy()


def same_pads(sizes: Sequence[int], stride: int = 2, k: int = 3) -> Tuple[int, ...]:
    """XLA's SAME padding for a stride-2 3-wide window, as F.pad's tuple
    (last axis first): out = ceil(n / 2), the total pad split with the
    smaller half low (an even side pads (0, 1), an odd one (1, 1))."""
    pads = []
    for n in reversed(sizes):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


class _RandomConvFeatures:
    """Stride-2 3-wide convolutions + tanh GELU (jax.nn.gelu's default),
    global average pool, linear head; ``ndim`` spatial axes."""

    ndim = 0

    def __init__(self, feat_dim: int = 256, seed: int = 0, device="cuda",
                 kernels: Optional[Sequence[np.ndarray]] = None,
                 head: Optional[np.ndarray] = None):
        self.feat_dim = feat_dim
        self.device = torch.device(device)
        if kernels is None:
            kernels, head = random_conv_weights(self.ndim, feat_dim, seed)
        # [k..., I, O] -> [O, I, k...]
        perm = (self.ndim + 1, self.ndim) + tuple(range(self.ndim))
        self.kernels = [torch.tensor(np.asarray(k, np.float32)).permute(perm)
                        .contiguous().to(self.device) for k in kernels]
        self.head = torch.tensor(np.asarray(head, np.float32)).to(self.device)
        self.conv = F.conv3d if self.ndim == 3 else F.conv2d

    @torch.no_grad()
    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, ..., 3] channels-last -> [N, feat_dim] float32."""
        x = x.to(self.device, torch.float32)
        x = x.permute(0, self.ndim + 1, *range(1, self.ndim + 1))
        with full_f32():
            for k in self.kernels:
                x = F.pad(x, same_pads(x.shape[2:]))
                x = F.gelu(self.conv(x, k, stride=2), approximate="tanh")
            pooled = x.mean(dim=tuple(range(2, 2 + self.ndim)))
            return pooled @ self.head

    def __call__(self, x) -> np.ndarray:
        """x [N, ..., 3] (or one sample without N) -> [N, feat_dim], one
        sample at a time through the net, which bounds the memory."""
        x = as_tensor(x)
        if x.ndim == self.ndim + 1:
            x = x[None]
        return torch.cat([self.features(x[i:i + 1]) for i in range(x.shape[0])]).cpu().numpy()


class I3DLikeFeatures(_RandomConvFeatures):
    """Seeded random-projection 3D conv feature net (I3D-shaped stages:
    four stride-2 conv3d + GELU, global average pool, linear head).
    Deterministic given ``seed``; ``kernels`` ([3, 3, 3, c_in, c_out]) and
    ``head`` ([128, feat_dim]) replace the draw, e.g. with wanq_tpu's.
    Called on videos [N, T, H, W, 3]."""

    ndim = 3


# ---------------------------------------------------------------------------
# FVD
# ---------------------------------------------------------------------------


def _stats(feats: np.ndarray, eps: float):
    mu = feats.mean(axis=0)
    d = feats - mu[None]
    n = max(feats.shape[0] - 1, 1)
    cov = (d.T @ d) / n + eps * np.eye(feats.shape[1])
    return mu, cov


def fvd(
    videos_a,
    videos_b,
    feature_fn: Optional[Callable] = None,
    eps: float = 1e-6,
    device="cuda",
) -> float:
    """FVD between two sets of videos [N, T, H, W, 3]. With the default
    random-feature extractor (on ``device``) the value is a relative
    fidelity score (0 for identical sets, monotone in distortion), not an
    I3D-FVD absolute."""
    if feature_fn is None:
        feature_fn = I3DLikeFeatures(device=device)
    fa = np.asarray(feature_fn(videos_a), np.float64)
    fb = np.asarray(feature_fn(videos_b), np.float64)
    mu_a, cov_a = _stats(fa, eps)
    mu_b, cov_b = _stats(fb, eps)
    return frechet_distance(mu_a, cov_a, mu_b, cov_b)


def fpfvd_report(
    fp_videos, quant_videos, feature_fn: Optional[Callable] = None, device="cuda"
) -> Dict[str, float]:
    """FPFVD: the FVD of the quantized outputs against the FP outputs of
    the same seeds and prompts (``fvd_random_feat`` with the random net,
    ``fvd`` with another extractor), plus the elementwise metrics."""
    rep = quant_fidelity_report(fp_videos, quant_videos, device=device)
    random_feat = feature_fn is None or isinstance(feature_fn, I3DLikeFeatures)
    key = "fvd_random_feat" if random_feat else "fvd"
    rep[key] = fvd(fp_videos, quant_videos, feature_fn=feature_fn, device=device)
    return rep


def latents_as_videos(latents) -> np.ndarray:
    """DiT latents [B, C, F, h, w] -> the feature net's video layout
    [B, F, h, g * w, 3]: the channels, zero-padded to a multiple of 3 (so
    every channel counts), fold into 3 pseudo-RGB planes of g groups tiled
    along the width."""
    z = np.asarray(latents, np.float32)
    b, c, f, h, w = z.shape
    c3 = -(-c // 3) * 3
    if c3 != c:
        z = np.concatenate([z, np.zeros((b, c3 - c, f, h, w), z.dtype)], axis=1)
    g = c3 // 3
    z = z.reshape(b, 3, g, f, h, w).transpose(0, 3, 4, 2, 5, 1)
    return z.reshape(b, f, h, g * w, 3)
