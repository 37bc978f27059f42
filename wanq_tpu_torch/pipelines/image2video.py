"""Image-to-video pipeline (counterpart of wanq_tpu/pipelines/image2video.py).

WanT2V's denoise loop with the i2v conditioning: the image, resized to the
latent grid's pixels, is VAE-encoded as the first frame of an otherwise black
video; those latents with a first-frame temporal mask form ``y`` (20 extra
input channels), and the image's CLIP ViT features ride in as ``clip_fea``
in front of the text context.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from wanq_tpu_torch.configs import WanConfig
from wanq_tpu_torch.models.clip import resize_cubic
from wanq_tpu_torch.pipelines.text2video import WanT2V


def i2v_latent_size(cfg: WanConfig, img_hw: Tuple[int, int], max_area: int) -> Tuple[int, int]:
    """The aspect-preserving latent size (lat_h, lat_w) of an image of
    ``img_hw`` pixels under ``max_area``."""
    h, w = img_hw
    ar = h / w
    lat_h = round(np.sqrt(max_area * ar) // cfg.vae_stride[1] // cfg.patch_size[1]
                  * cfg.patch_size[1])
    lat_w = round(np.sqrt(max_area / ar) // cfg.vae_stride[2] // cfg.patch_size[2]
                  * cfg.patch_size[2])
    return int(lat_h), int(lat_w)


def first_frame_mask(frame_num: int, lat_h: int, lat_w: int, t_stride: int = 4,
                     device="cuda") -> torch.Tensor:
    """[t_stride, F_lat, lat_h, lat_w] float32 mask on ``device`` (the card
    unless the caller asks for the CPU): 1 on the first frame (repeated
    t_stride times), 0 elsewhere; the reference hard-codes Wan's temporal
    stride 4."""
    msk = torch.zeros((1, frame_num, lat_h, lat_w), device=device)
    msk[:, 0] = 1.0
    msk = torch.cat([msk[:, 0:1].repeat_interleave(t_stride, dim=1), msk[:, 1:]], dim=1)
    msk = msk.reshape(1, (frame_num - 1) // t_stride + 1, t_stride, lat_h, lat_w)
    return msk.transpose(1, 2)[0]


@dataclasses.dataclass
class WanI2V(WanT2V):
    """``vae``: a models.vae.WanVAE (encodes the first frame); ``clip``: a
    models.clip.CLIPModel. Either may be left out when ``generate`` gets the
    precomputed ``y`` / ``clip_fea``."""

    vae: Optional[Any] = None
    clip: Optional[Any] = None

    def generate(
        self,
        img: torch.Tensor,
        context: torch.Tensor,
        context_null: torch.Tensor,
        max_area: int = 720 * 1280,
        frame_num: int = 81,
        shift: float = 5.0,
        sample_solver: str = "unipc",
        sampling_steps: int = 40,
        guide_scale: float = 5.0,
        seed: int = -1,
        clip_fea: Optional[torch.Tensor] = None,
        y: Optional[torch.Tensor] = None,
        ref_latents: Optional[torch.Tensor] = None,
        ref_latent_strength: float = 0.01,
        cfg_mode: str = "batched",
        cache_policy=None,
        on_step: Optional[Callable[[int, float, torch.Tensor], None]] = None,
        noise: Optional[torch.Tensor] = None,
    ):
        """img: [3, H, W] in [-1, 1]. Returns latents [1, 16, F_lat, h, w]
        (decode with ``self.vae``). ``clip_fea`` [1, 257, clip_dim] and ``y``
        ([C_y, F_lat, h, w] or with its batch dim) may be precomputed.
        ``ref_latents`` [z_dim, F_lat, h, w] (encoded reference-video latents)
        mix into the initial noise as (1 - s) * noise + s * ref, s =
        ``ref_latent_strength``. ``noise`` replaces the initial draw from
        ``seed``. The sequence is rounded to no alignment: at 832x480x81 it
        is 32760 tokens. The other arguments are WanT2V.generate's."""
        if cfg_mode not in ("batched", "sequential"):
            raise ValueError(f"unknown cfg_mode {cfg_mode!r}")
        cfg = self.config
        dev = torch.device(self.device)
        lat_h, lat_w = i2v_latent_size(cfg, tuple(img.shape[1:]), max_area)
        h, w = lat_h * cfg.vae_stride[1], lat_w * cfg.vae_stride[2]
        lat_f = (frame_num - 1) // cfg.vae_stride[0] + 1
        seq_len = lat_f * lat_h * lat_w // (cfg.patch_size[1] * cfg.patch_size[2])

        latents = self._initial_latents((1, cfg.z_dim, lat_f, lat_h, lat_w), seed, noise)
        if ref_latents is not None:
            s = float(ref_latent_strength)
            latents = (1.0 - s) * latents + s * ref_latents.to(dev, torch.float32)[None]

        img = img.to(dev, torch.float32)
        with torch.no_grad():
            if clip_fea is None:
                if self.clip is None:
                    raise ValueError("need a CLIPModel or a precomputed clip_fea")
                clip_fea = self.clip.visual(img[None, :, None])  # [1, 257, clip_dim]
            if y is None:
                if self.vae is None:
                    raise ValueError("need a WanVAE or a precomputed y")
                img_r = resize_cubic(img[None], (h, w))
                vid = torch.cat([img_r[:, :, None],
                                 torch.zeros((1, 3, frame_num - 1, h, w), device=dev)], dim=2)
                msk = first_frame_mask(frame_num, lat_h, lat_w, cfg.vae_stride[0], device=dev)
                y = torch.cat([msk, self.vae.encode(vid)[0].float()], dim=0)
        y = y.to(dev, torch.float32)
        extra = {"y": y if y.ndim == 5 else y[None], "clip_fea": clip_fea.to(dev, torch.float32)}

        sch = self._make_scheduler(sample_solver, sampling_steps, shift)
        sequential = cfg_mode == "sequential"
        ctx = self._deployed_ctx()
        context, context_null = context.to(dev), context_null.to(dev)
        with torch.no_grad():
            if cache_policy is not None and cache_policy.active:
                return self._generate_cached(cache_policy, sch, latents, ctx, context,
                                             context_null, guide_scale, seq_len, sequential,
                                             on_step, extra)
            for i, t in enumerate(sch.timesteps):
                noise_pred = self._step(latents, float(t), context, context_null, guide_scale,
                                        self._ctx_at(float(t), ctx), seq_len, sequential, extra)
                latents = sch.step(noise_pred, int(t), latents)
                if on_step is not None:
                    on_step(i, float(t), latents)
        return latents
