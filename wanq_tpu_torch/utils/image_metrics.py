"""Image metrics: FPFID and CLIPScore, the text-to-image side of the
evaluation (counterpart of wanq_tpu/utils/image_metrics.py).

FPFID is the FID between the FP outputs and the quantized outputs of the
same prompts and seeds. As in utils/fvd.py the feature extractor is
pluggable: the default is :class:`InceptionLikeFeatures`, a seeded random
2D conv net (a rank-preserving fidelity probe, reported as
``fid_random_feat``; its torch.Generator draw is not wanq_tpu's
jax.random one); any ``images [N, H, W, 3] -> [N, D]`` callable, such as a
converted InceptionV3, gives standard FID. CLIPScore rides the CLIP towers
of models/clip.py: ``2.5 * max(cos(image, text), 0)``. Reward models
(ImageReward, HPS, PickScore) stay external: utils/imagereward.py writes
their input layout and reads their scores back.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from wanq_tpu_torch.utils.fvd import _RandomConvFeatures, _stats, frechet_distance
from wanq_tpu_torch.utils.metrics import quant_fidelity_report


class InceptionLikeFeatures(_RandomConvFeatures):
    """Seeded random 2D conv pyramid (stride-2 stages + GELU, global
    average pool, linear head), the image analogue of
    fvd.I3DLikeFeatures; ``kernels`` ([3, 3, c_in, c_out]) and ``head``
    replace the draw. Called on images [N, H, W, 3]."""

    ndim = 2


def fid(
    images_a,
    images_b,
    feature_fn: Optional[Callable] = None,
    eps: float = 1e-6,
    device="cuda",
) -> float:
    """FID between two image sets [N, H, W, 3] (the random net on
    ``device`` unless ``feature_fn`` is given)."""
    if feature_fn is None:
        feature_fn = InceptionLikeFeatures(device=device)
    fa = np.asarray(feature_fn(images_a), np.float64)
    fb = np.asarray(feature_fn(images_b), np.float64)
    return frechet_distance(*_stats(fa, eps), *_stats(fb, eps))


def clipscore(
    images,
    text_ids,
    params,
    cfg,
    frame_chunk: int = 8,
    device="cuda",
) -> float:
    """Mean CLIPScore, 2.5 * max(cos(image, its prompt), 0), over the set.
    images [N, H, W, 3] in [-1, 1]; text_ids [N, L] (token ids: no
    tokenizer ships); ``params`` on ``device``."""
    from wanq_tpu_torch.utils.clip_metrics import clip_frame_features, text_features

    imgs = np.asarray(images, np.float32)[:, None]  # [N, 1, H, W, 3]
    f = clip_frame_features(params, cfg, imgs, frame_chunk, device=device)[:, 0]
    t = text_features(params, cfg, text_ids, device=device)
    sims = np.einsum("nd,nd->n", f, t)
    return float(np.mean(2.5 * np.clip(sims, 0.0, None)))


def fpfid_report(
    fp_images,
    quant_images,
    feature_fn: Optional[Callable] = None,
    device="cuda",
) -> Dict[str, float]:
    """FPFID: the FID of the quantized outputs against the FP outputs of
    the same prompts and seeds, plus the elementwise metrics."""
    rep = quant_fidelity_report(fp_images, quant_images, device=device)
    random_feat = feature_fn is None or isinstance(feature_fn, InceptionLikeFeatures)
    key = "fid_random_feat" if random_feat else "fid"
    rep[key] = fid(fp_images, quant_images, feature_fn=feature_fn, device=device)
    return rep
