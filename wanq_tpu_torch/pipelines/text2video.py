"""Text-to-video denoise pipeline (counterpart of
wanq_tpu/pipelines/text2video.py, uncached batched-CFG subset).

The cond/uncond pair runs as one B=2 DiT forward per solver step; the
UniPC scheduler runs between steps. One class serves FP, calibration,
simulated and int8 inference through the QuantCtx mode. Step caches, the
DPM++ solver, sequential CFG and timestep schedules are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from wanq_tpu_torch.configs import WanConfig
from wanq_tpu_torch.models.dit import dit_forward
from wanq_tpu_torch.quant.qlinear import QuantCtx
from wanq_tpu_torch.solvers.unipc import FlowUniPCMultistepScheduler


def compute_target_shape(cfg: WanConfig, size: Tuple[int, int],
                         frame_num: int) -> Tuple[int, int, int, int]:
    """Latent shape (C, F, H, W)."""
    w, h = size
    return (cfg.z_dim, (frame_num - 1) // cfg.vae_stride[0] + 1,
            h // cfg.vae_stride[1], w // cfg.vae_stride[2])


def compute_seq_len(cfg: WanConfig, target_shape, sp_size: int = 1,
                    align: Optional[int] = None) -> int:
    """Token count rounded up to the sequence-parallel degree and, for long
    sequences, to 512 (the DiT pads and masks tokens past the valid length)."""
    _, f, h, w = target_shape
    tokens = (h // cfg.patch_size[1]) * (w // cfg.patch_size[2]) * f
    if align is None:
        align = 512 if tokens >= 4096 else 1
    m = math.lcm(sp_size, align)
    return int(math.ceil(tokens / m)) * m


@dataclasses.dataclass
class WanT2V:
    """Latent-space pipeline; text encoding and VAE decode are not part of
    it (the CLIs take random or precomputed text states)."""

    config: WanConfig
    params: Dict[str, Any]
    quant_ctx: Optional[QuantCtx] = None
    device: Any = "cuda"

    def _step(self, latents, t: float, context, context_null, guide_scale: float,
              ctx: Optional[QuantCtx], seq_len: int):
        """One batched CFG forward: cond + uncond as one [2B] batch."""
        b = latents.shape[0]
        x2 = torch.cat([latents, latents], dim=0)
        c2 = torch.cat([context, context_null], dim=0)
        t2 = torch.full((2 * b,), float(t), dtype=torch.float32, device=latents.device)
        out = dit_forward(self.params, self.config, x2, t2, c2, seq_len, ctx=ctx)
        cond, uncond = out[:b], out[b:]
        return uncond + guide_scale * (cond - uncond)

    def generate(
        self,
        context: torch.Tensor,
        context_null: torch.Tensor,
        size: Tuple[int, int] = (832, 480),
        frame_num: int = 81,
        shift: float = 5.0,
        sample_solver: str = "unipc",
        sampling_steps: int = 50,
        guide_scale: float = 5.0,
        seed: int = -1,
        collect_calib: bool = False,
        noise: Optional[torch.Tensor] = None,
        on_step: Optional[Callable[[int, float, torch.Tensor], None]] = None,
    ):
        """Denoise loop. context / context_null: [B, text_len, text_dim].
        Returns latents [B, C, F, h, w] (and the calibration stats
        {layer: [T, C]} when ``collect_calib``). ``noise`` replaces the
        initial draw (a torch.Generator seeded with ``seed``), e.g. with
        another implementation's draw. ``on_step(i, t, latents)`` runs after
        each solver step."""
        if sample_solver != "unipc":
            raise NotImplementedError(
                f"solver {sample_solver!r} is not ported yet (ROADMAP Queue 1 item 9)")
        cfg = self.config
        dev = torch.device(self.device)
        target_shape = compute_target_shape(cfg, size, frame_num)
        seq_len = compute_seq_len(cfg, target_shape)
        b = context.shape[0]
        if noise is None:
            seed = seed if seed >= 0 else int(np.random.randint(0, 2**31))
            gen = torch.Generator(device=dev).manual_seed(seed)
            latents = torch.randn((b, *target_shape), generator=gen, device=dev,
                                  dtype=torch.float32)
        else:
            if tuple(noise.shape) != (b, *target_shape):
                raise ValueError(f"noise {tuple(noise.shape)} != {(b, *target_shape)}")
            latents = noise.to(device=dev, dtype=torch.float32)
        context = context.to(dev)
        context_null = context_null.to(dev)

        sch = FlowUniPCMultistepScheduler(num_train_timesteps=cfg.num_train_timesteps,
                                          shift=1.0)
        sch.set_timesteps(sampling_steps, shift=shift)
        if collect_calib:
            if self.quant_ctx is None or self.quant_ctx.mode != "calib":
                raise ValueError("collect_calib needs a calib-mode quant_ctx")
            ctx = self.quant_ctx
        elif self.quant_ctx is not None and (self.quant_ctx.mode in ("sim", "int8")
                                             or self.quant_ctx.attn_window is not None):
            # an fp-mode ctx matters when it carries the temporal window
            ctx = self.quant_ctx
        else:
            ctx = None

        all_stats: Dict[str, List[np.ndarray]] = {}
        with torch.no_grad():
            for i, t in enumerate(sch.timesteps):
                noise_pred = self._step(latents, float(t), context, context_null,
                                        guide_scale, ctx, seq_len)
                if collect_calib:
                    for k, v in ctx.collect.items():
                        all_stats.setdefault(k, []).append(v.float().cpu().numpy())
                    ctx.collect.clear()
                latents = sch.step(noise_pred, int(t), latents)
                if on_step is not None:
                    on_step(i, float(t), latents)
        if collect_calib:
            return latents, {k: np.stack(v, axis=0) for k, v in all_stats.items()}
        return latents

    def collect_calibration(self, context, context_null, sampling_steps: int = 30,
                            **kw) -> Dict[str, np.ndarray]:
        """FP denoise sweep returning {layer: [T, C]} statistics, one row per
        batched CFG step."""
        if self.quant_ctx is None or self.quant_ctx.mode != "calib":
            raise ValueError("collect_calibration needs a calib-mode quant_ctx")
        _, stats = self.generate(context, context_null, sampling_steps=sampling_steps,
                                 collect_calib=True, **kw)
        return stats
