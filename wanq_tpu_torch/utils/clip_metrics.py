"""CLIP-based video metrics: CLIPSIM, CLIP-Temp and temporal flickering
(counterpart of wanq_tpu/utils/clip_metrics.py).

CLIPSIM averages the cosine of each frame's image embedding with its
prompt's text embedding, CLIP-Temp the cosine of consecutive frames'
embeddings, and temporal flickering is (255 - mean consecutive-frame
MAE) / 255. The towers are the XLM-Roberta-CLIP of models/clip.py, the
one the i2v pipeline conditions on; with the Wan CLIP checkpoint
(``models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth``) the numbers
are standard CLIP metrics, with random weights they are rank-preserving
probes only. The image embedding is the cls token of the full 32-block
vision tower projected by ``visual.head`` and L2-normalized, as wanq_tpu
computes it (no ``visual.post_norm`` before the head).

The towers run in float32 on ``device`` (the card unless the caller asks
for the CPU; the params must live there) with TF32 off inside.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from wanq_tpu_torch.models.clip import (
    CLIP_MEAN,
    CLIP_STD,
    CLIPConfig,
    Params,
    resize_cubic,
    text_forward,
    vision_forward,
)
from wanq_tpu_torch.utils.fvd import full_f32
from wanq_tpu_torch.utils.metrics import as_tensor


def _normalize(e: torch.Tensor) -> torch.Tensor:
    return e / torch.linalg.norm(e, dim=-1, keepdim=True).clamp_min(1e-12)


def vision_embed(p: Params, cfg: CLIPConfig, imgs: torch.Tensor) -> torch.Tensor:
    """imgs [B, 3, H, W] (CLIP-normalized) -> L2-normalized [B, embed_dim]:
    the full tower's cls token through ``visual.head``."""
    h = vision_forward(p, cfg, imgs, use_31_block=False)
    return _normalize(h[:, 0].float() @ p["visual.head"].float())


def text_embed(p: Params, cfg: CLIPConfig, ids: torch.Tensor) -> torch.Tensor:
    """ids [B, L] -> L2-normalized [B, embed_dim]."""
    return _normalize(text_forward(p, cfg, ids).float())


def text_features(p: Params, cfg: CLIPConfig, text_ids, device="cuda") -> np.ndarray:
    """Token ids [N, L] -> normalized text embeddings [N, D] on the host."""
    ids = as_tensor(text_ids).to(device=device, dtype=torch.long)
    with torch.no_grad(), full_f32():
        return text_embed(p, cfg, ids).cpu().numpy()


def _preprocess_frames(frames: torch.Tensor, image_size: int) -> torch.Tensor:
    """frames [..., H, W, 3] in [-1, 1] -> [n, 3, S, S] CLIP-normalized
    (the resize and mean / std of CLIPModel.visual)."""
    h, w, c = frames.shape[-3:]
    imgs = frames.reshape(-1, h, w, c).permute(0, 3, 1, 2).float()
    imgs = resize_cubic(imgs, (image_size, image_size)) * 0.5 + 0.5
    mean = torch.tensor(CLIP_MEAN, device=imgs.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=imgs.device)[None, :, None, None]
    return (imgs - mean) / std


def clip_frame_features(
    p: Params,
    cfg: CLIPConfig,
    videos,
    frame_chunk: int = 8,
    device="cuda",
) -> np.ndarray:
    """videos [N, T, H, W, 3] in [-1, 1] -> normalized features [N, T, D]
    on the host; the frames go to ``device`` ``frame_chunk`` at a time (the
    last chunk may be shorter)."""
    videos = as_tensor(videos)
    n, t, h, w, c = videos.shape
    flat = videos.reshape(n * t, h, w, c)
    feats = []
    with torch.no_grad(), full_f32():
        for i in range(0, n * t, frame_chunk):
            blk = flat[i:i + frame_chunk].to(device, torch.float32)
            feats.append(vision_embed(p, cfg, _preprocess_frames(blk, cfg.image_size)).cpu())
    return torch.cat(feats).reshape(n, t, -1).numpy()


def clipsim(frame_feats: np.ndarray, text_feats: np.ndarray) -> float:
    """Mean over videos and frames of cos(frame, its prompt's text
    embedding). frame_feats [N, T, D], text_feats [N, D], both normalized."""
    sims = np.einsum("ntd,nd->nt", frame_feats, text_feats)
    return float(sims.mean())


def clip_temp(frame_feats: np.ndarray) -> float:
    """Mean cosine between consecutive frames' embeddings [N, T, D]."""
    if frame_feats.shape[1] < 2:
        return 1.0
    sims = np.einsum("ntd,ntd->nt", frame_feats[:, :-1], frame_feats[:, 1:])
    return float(sims.mean())


def temporal_flickering(videos) -> float:
    """(255 - mean consecutive-frame MAE) / 255 on the uint8 scale; videos
    [N, T, H, W, 3] in [-1, 1]; 1.0 for a static video."""
    v = (np.asarray(videos, np.float32) + 1.0) * 127.5
    if v.shape[1] < 2:
        return 1.0
    mae = np.abs(v[:, 1:] - v[:, :-1]).mean()
    return float((255.0 - mae) / 255.0)


def clip_fidelity_report(
    fp_videos,
    quant_videos,
    params: Params,
    cfg: CLIPConfig,
    text_ids=None,
    frame_chunk: int = 8,
    device="cuda",
) -> Dict[str, float]:
    """FP-vs-quant CLIP report: each set's CLIP-Temp and flicker, the mean
    FP-vs-quant cosine of the frames' embeddings, and, given the prompts'
    token ids [N, L], each set's CLIPSIM."""
    fp_f = clip_frame_features(params, cfg, fp_videos, frame_chunk, device=device)
    q_f = clip_frame_features(params, cfg, quant_videos, frame_chunk, device=device)
    rep: Dict[str, float] = {
        "clip_temp_fp": clip_temp(fp_f),
        "clip_temp_quant": clip_temp(q_f),
        "flicker_fp": temporal_flickering(fp_videos),
        "flicker_quant": temporal_flickering(quant_videos),
        "clip_frame_cosine_fp_vs_quant": float(np.einsum("ntd,ntd->nt", fp_f, q_f).mean()),
    }
    if text_ids is not None:
        t_f = text_features(params, cfg, text_ids, device=device)
        rep["clipsim_fp"] = clipsim(fp_f, t_f)
        rep["clipsim_quant"] = clipsim(q_f, t_f)
    return rep
