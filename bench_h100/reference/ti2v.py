"""Plain PyTorch reference of Wan2.2 TI2V-5B in image-to-video mode under a
PTQ scheme: the model of the Wan2.2 release (``wan/modules/model.py`` with
``model_type`` "ti2v") and its sampling loop (``wan/textimage2video.py``),
written out from their equations on :class:`WanReference`'s layers (the same
linears, quantizers, attention, RoPE and controls; see ``wan.py``). It imports
nothing of the program.

What differs from Wan2.1 is the timestep, which is per token, as Wan2.2
computes it: t [B, L] is 0 on the image's latent frame (frame 0) and the
step's t on every other token; the time MLP runs on every token's t in f32,
e = MLP(sinusoid(t)) [B, L, C] and e0 = time_projection(SiLU(e)) [B, L, 6, C],
and each block forms modulation + e0 per token again. So the reference holds
e0 per token (4 GiB at 1280x704x121, B = 2) and computes it, and each block's
modulate and gated residual updates, in blocks of tokens, so that the
transients fit on the card beside it. There are no pad tokens here (the
reference runs the valid tokens only), so Wan2.2's pads at t do not arise.

The loop holds latent frame 0 to the conditioning latent before the first
step and after every solver step; the solver is given the held latents and
its own state is Wan2.2's (:func:`replay_held`)."""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F

from .unipc import _update, sigmas_and_timesteps
from .wan import BF16, WanReference, _layer_norm, _rms_norm

# tokens a block of the per-token arithmetic
CHUNK = 4096


def frame_timesteps(batch: int, frames: int, tokens_per_frame: int, t: float,
                    device) -> torch.Tensor:
    """Wan2.2's per-token timesteps of image-to-video: [B, L], 0 on frame 0's
    tokens, ``t`` elsewhere (f32)."""
    tt = torch.full((batch, frames * tokens_per_frame), float(t), device=device)
    tt[:, :tokens_per_frame] = 0.0
    return tt


class TI2VReference(WanReference):
    """The reference model over a weight tree (``bench_h100/draw.py``'s
    layout) with per-token timesteps."""

    def time_embedding_tokens(self, t: torch.Tensor):
        """e [B, L, C] and e0 [B, L, 6, C] of per-token timesteps t [B, L]
        (f32; the sinusoid in f64, as the release computes it), in blocks of
        tokens."""
        b, n = t.shape
        d = self.cfg["dim"]
        e = torch.empty((b, n, d), device=t.device)
        e0 = torch.empty((b, n, 6, d), device=t.device)
        for a in range(0, n, CHUNK):
            rows = t[:, a:a + CHUNK].reshape(-1)
            eb, e0b = self.time_embedding(rows)
            e[:, a:a + CHUNK] = eb.reshape(b, -1, d)
            e0[:, a:a + CHUNK] = e0b.reshape(b, -1, 6, d)
        return e, e0

    def _modulated(self, x, mod, e0, j_shift: int, j_scale: int) -> torch.Tensor:
        """LN(x) * (1 + s[j_scale]) + s[j_shift], s = mod + e0 per token, bf16."""
        out = torch.empty(x.shape, dtype=BF16, device=x.device)
        eps = self.cfg["eps"]
        for a in range(0, x.shape[1], CHUNK):
            s = mod + e0[:, a:a + CHUNK]
            out[:, a:a + CHUNK] = (_layer_norm(x[:, a:a + CHUNK], eps) * (1 + s[:, :, j_scale])
                                   + s[:, :, j_shift]).to(BF16)
        return out

    def _gated(self, x, y, mod, e0, j: int) -> torch.Tensor:
        """x + y * s[j], s = mod + e0 per token, in the residual dtype."""
        out = torch.empty(x.shape, dtype=self.res_dtype, device=x.device)
        for a in range(0, x.shape[1], CHUNK):
            s = mod[:, j] + e0[:, a:a + CHUNK, j]
            out[:, a:a + CHUNK] = (x[:, a:a + CHUNK].float() + y[:, a:a + CHUNK] * s).to(
                self.res_dtype)
        return out

    def block(self, i: int, x: torch.Tensor, e0: torch.Tensor, ctx: torch.Tensor, grid):
        """One block with e0 [B, L, 6, C] per token: ``WanReference.block``'s
        equations with the modulation of each token."""
        p, cfg, eps = self.p["blocks"][i], self.cfg, self.cfg["eps"]
        n, hd = cfg["num_heads"], self.head_dim
        name = f"blocks.{i}"
        mod = p["modulation"].float()
        b, L, _ = x.shape

        h = self._modulated(x, mod, e0, 0, 1)
        sa = p["self_attn"]
        q = _rms_norm(self.linear(f"{name}.self_attn.q", sa["q"], h).to(BF16), sa["norm_q"], eps)
        k = _rms_norm(self.linear(f"{name}.self_attn.k", sa["k"], h).to(BF16), sa["norm_k"], eps)
        v = self.linear(f"{name}.self_attn.v", sa["v"], h).to(BF16)
        q = self.rope(q.to(BF16).reshape(b, L, n, hd), grid)
        k = self.rope(k.to(BF16).reshape(b, L, n, hd), grid)
        y = self.attention(q, k, v.reshape(b, L, n, hd), self.band)
        y = self.linear(f"{name}.self_attn.o", sa["o"], y)
        x = self._gated(x, y, mod, e0, 2)

        ca = p["cross_attn"]
        h = _layer_norm(x, eps, p["norm3"]["w"], p["norm3"]["b"]).to(BF16)
        q = _rms_norm(self.linear(f"{name}.cross_attn.q", ca["q"], h).to(BF16), ca["norm_q"], eps)
        k = _rms_norm(self.linear(f"{name}.cross_attn.k", ca["k"], ctx).to(BF16),
                      ca["norm_k"], eps)
        v = self.linear(f"{name}.cross_attn.v", ca["v"], ctx).to(BF16)
        y = self.attention(q.to(BF16).reshape(b, L, n, hd), k.to(BF16).reshape(b, -1, n, hd),
                           v.reshape(b, -1, n, hd))
        y = self.linear(f"{name}.cross_attn.o", ca["o"], y)
        x = (x.float() + y).to(self.res_dtype)

        h = self._modulated(x, mod, e0, 3, 4)
        h = F.gelu(self.linear(f"{name}.ffn.0", p["ffn"]["0"], h), approximate="tanh").to(BF16)
        y = self.linear(f"{name}.ffn.2", p["ffn"]["2"], h)
        return self._gated(x, y, mod, e0, 5)

    def forward(self, latents: torch.Tensor, t: float, context: torch.Tensor,
                image: bool = True) -> torch.Tensor:
        """latents [B, C, F, H, W] f32 (frame 0 the image's latent when
        ``image``), t the step's timestep, context [B, text_len, text_dim] ->
        the velocity [B, C_out, F, H, W] f32. ``image``: frame 0's tokens at
        t = 0 (image-to-video); else every token at t."""
        cfg, p = self.cfg, self.p
        pt, ph, pw = cfg["patch_size"]
        b, c, f, hh, ww = latents.shape
        grid = (f // pt, hh // ph, ww // pw)
        x = latents.to(BF16).reshape(b, c, grid[0], pt, grid[1], ph, grid[2], pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, math.prod(grid), c * pt * ph * pw)
        x = self.linear("patch_embedding", p["patch_embedding"], x).to(self.res_dtype)
        tpf = grid[1] * grid[2]
        tt = frame_timesteps(b, grid[0], tpf, t, latents.device)
        if not image:
            tt.fill_(float(t))
        e, e0 = self.time_embedding_tokens(tt)
        ctx = F.gelu(self.linear("text_embedding.0", p["text_embedding"]["0"],
                                 context.to(BF16)), approximate="tanh").to(BF16)
        ctx = self.linear("text_embedding.2", p["text_embedding"]["2"], ctx).to(BF16)
        self.band = None if self.collect is not None else self._band(grid)
        for i in range(cfg["num_layers"]):
            x = self.block(i, x, e0, ctx, grid)
        del e0
        head_mod = p["head"]["modulation"].float()  # [1, 2, C]
        h = torch.empty(x.shape, dtype=BF16, device=x.device)
        for a in range(0, x.shape[1], CHUNK):
            m = head_mod + e[:, a:a + CHUNK, None, :]  # [B, chunk, 2, C]
            h[:, a:a + CHUNK] = (_layer_norm(x[:, a:a + CHUNK], cfg["eps"]) * (1 + m[:, :, 1])
                                 + m[:, :, 0]).to(BF16)
        out = self.linear("head.head", p["head"]["head"], h)
        co = cfg["out_dim"]
        out = out.reshape(b, *grid, pt, ph, pw, co)
        out = torch.einsum("bfhwpqrc->bcfphqwr", out)
        return out.reshape(b, co, grid[0] * pt, grid[1] * ph, grid[2] * pw)


def held(latents: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """``latents`` [B, C, F, H, W] with frame 0 set to ``cond`` [C, 1, H, W]."""
    out = latents.clone()
    out[:, :, :1] = cond.to(out.dtype)
    return out


def replay_held(x0: torch.Tensor, velocities: Sequence[torch.Tensor], steps: int,
                shift: float, hold: Callable[[torch.Tensor], torch.Tensor], order: int = 2,
                dtype=torch.float32) -> List[torch.Tensor]:
    """``unipc.replay`` with frame 0 held, as Wan2.2's image-to-video loop
    drives the solver: the first sample is ``hold(x0)``; each step's data
    prediction is taken from the held sample it is given, its corrector and
    predictor run on the solver's own (unheld) state, and its output is held
    before the next step. Returns the held latents after each step."""
    sig, _ = sigmas_and_timesteps(steps, shift)
    x = hold(x0.to(dtype))
    hist: List[torch.Tensor] = []
    last = None
    last_order = 1
    out = []
    for i, v in enumerate(velocities):
        m = (x - float(sig[i]) * v.to(dtype)).to(dtype)
        if i > 0:
            x = _update(last, hist, sig, i - 1, i, last_order, m_new=m).to(dtype)
        hist = (hist + [m])[-order:]
        this = min(order, steps - i, i + 1)
        last = x
        x = hold(_update(x, hist, sig, i, i + 1, this).to(dtype))
        last_order = this
        out.append(x)
    return out
