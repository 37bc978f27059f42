"""Wan2.2 TI2V-5B's denoise pipeline (the image-to-video mode of Wan2.2's
``wan/textimage2video.py``; text-to-video is WanT2V's loop as it stands).

WanT2V's loop, CFG and solver, with the image's latent as a conditioning
frame: latent frame 0 is set to it before the first step and after every
solver step (Wan2.2's ``(1 - mask) * z + mask * latent`` with
``masks_like(zero=True)``, written as a copy of the frame), and every forward
takes one timestep a latent frame, 0 for frame 0 and the step's t for the rest
(the pad tokens take the last frame's, the step's t, as Wan2.2 pads its
per-token timesteps with it). The solver's own state follows Wan2.2: a step
is given the held latents and returns its output, which is held again.

The conditioning latent [z_dim, 1, h, w] is the Wan2.2 VAE's encoding of the
image; that VAE is not in the repository, so callers pass a latent (the CLI
and the benchmark draw it from a seed).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from wanq_tpu_torch.pipelines.text2video import WanT2V


@dataclasses.dataclass
class WanTI2V(WanT2V):
    """``generate(..., cond_latent=z)`` runs image-to-video; without it, the
    text-to-video loop of the same model. It rides WanT2V's ``_split`` and
    ``_make_scheduler``, so calibration (``collect_calibration``), the step
    caches and sequential CFG take the same conditioning. Under a sharding
    plan the per-frame forward refuses (``models/dit.py``)."""

    _cond_latent: Optional[torch.Tensor] = dataclasses.field(default=None, init=False,
                                                             repr=False)

    def generate(self, context: torch.Tensor, context_null: torch.Tensor,
                 cond_latent: Optional[torch.Tensor] = None, size=(1280, 704),
                 frame_num: int = 121, **kw):
        """WanT2V.generate with ``cond_latent`` [z_dim, 1, h, w] (or with its
        batch dim) held as latent frame 0; the latent grid (h, w) is that of
        ``size``. Returns latents [B, z_dim, F, h, w], frame 0 the latent's."""
        if cond_latent is None:
            return super().generate(context, context_null, size=size, frame_num=frame_num, **kw)
        z = cond_latent.to(torch.device(self.device), torch.float32)
        z = z[None] if z.dim() == 4 else z
        cfg = self.config
        want = (cfg.z_dim, 1, size[1] // cfg.vae_stride[1], size[0] // cfg.vae_stride[2])
        if tuple(z.shape[1:]) != want:
            raise ValueError(f"cond_latent: [z_dim, 1, h, w] = {want} expected for size "
                             f"{size}, got {tuple(z.shape)}")
        if (frame_num - 1) // cfg.vae_stride[0] + 1 < 2:
            raise ValueError("image-to-video needs a latent frame after the held one "
                             f"(frame_num {frame_num})")
        self._cond_latent = z
        try:
            return super().generate(context, context_null, size=size, frame_num=frame_num, **kw)
        finally:
            self._cond_latent = None

    def _timesteps(self, latents, t: float) -> torch.Tensor:
        """One timestep a latent frame, [B, F] on the host (no wait for the
        device): 0 for the held frame 0, ``t`` for the rest."""
        if self._cond_latent is None:
            return super()._timesteps(latents, t)
        tt = torch.full((latents.shape[0], latents.shape[2] // self.config.patch_size[0]),
                        float(t), dtype=torch.float32)
        tt[:, 0] = 0.0
        return tt

    def _held(self, latents):
        """``latents`` with frame 0 set to the conditioning latent (a new
        tensor: the solver's output is left as it returned it)."""
        z = self._cond_latent
        if z is None:
            return latents
        return torch.cat([z.expand(latents.shape[0], -1, -1, -1, -1), latents[:, :, 1:]], dim=2)
