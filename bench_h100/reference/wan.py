"""Plain PyTorch reference of the Wan2.1 T2V DiT under a PTQ scheme: the
model of the Wan2.1 release (``wan/modules/model.py``) written out from its
equations, with the scheme's quantizers (``scheme.py``) at the linears it
names. It imports nothing of the program and takes nothing the program made:
it quantizes the weights itself, and the static activation scales come from
its own calibration forward (:meth:`WanReference.calibrate`).

Precision is the configuration's: products of bf16 operands summed in f32,
norms, modulation, softmax and the time embedding in f32 (TF32 off), the
residual stream stored in ``residual_dtype``. An int8 x int4/int8 product is
computed on its integer codes, which bf16 holds exactly, so the f32 sums are
the integer sums. Attention is ``scaled_dot_product_attention`` over the
valid tokens only (no padding). ``control`` computes one precision below the
configuration's, as a faster program might: ``"fp8"``, every bf16 operand of
attention and of the FP linears through float8 e4m3 (a scale per row of an
activation, per output channel of a weight); ``"a4"``, the quantized
linears' activations at 4 bits instead of 8.

Every tensor lives on the device of the weights; one block's activations at
a time."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .scheme import SitePolicy, policies

BF16 = torch.bfloat16
FP8_MAX = 448.0
# the controls that take attention's operands through float8
FP8_CONTROLS = ("fp8", "bf16_adapters")


def set_full_f32() -> None:
    """f32 products stay f32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N], bf16 operands, f32 sums and result."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _fp8_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale per slice along ``dim``."""
    xf = x.float()
    s = (xf.abs().amax(dim=dim, keepdim=True) / FP8_MAX).clamp_min(1e-12)
    return ((xf / s).to(torch.float8_e4m3fn).float() * s).to(BF16)


def _layer_norm(x: torch.Tensor, eps: float, w=None, b=None) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), eps=eps)
    return y if w is None else y * w + b


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * w


def _int_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Integer codes xq [M, K] and wq [N, K] (f32 holding integers) -> their
    integer product [M, N] in f32."""
    return _mm(xq.to(BF16), wq.t().to(BF16))


def quantize_weight(w: torch.Tensor, bits: int, sym: bool):
    """Per-output-channel quantizer of w [K, N]: (codes [N, K], delta [N], zp [N]),
    w ~ (codes + zp) * delta. Asymmetric: 2**bits levels over [min(w, 0),
    max(w, 0)], zp = round(min / delta) + 2**(bits - 1); symmetric:
    2**(bits - 1) - 1 levels each side of 0, zp = 0."""
    wf = w.float().t()
    if sym:
        nl = 2 ** (bits - 1) - 1
        delta = (wf.abs().amax(1) / nl).clamp_min(1e-6)
        zp = torch.zeros_like(delta)
    else:
        nl = 2 ** bits
        hi = wf.amax(1).clamp_min(0.0)
        lo = wf.amin(1).clamp_max(0.0)
        delta = ((hi - lo) / (nl - 1)).clamp_min(1e-8)
        zp = torch.round(lo / delta) + nl / 2
    q = (torch.round(wf / delta[:, None]) - zp[:, None]).clamp(-2 ** (bits - 1),
                                                               2 ** (bits - 1) - 1)
    return q, delta, zp


def quantize_act(x: torch.Tensor, bits: int, scale: Optional[torch.Tensor] = None):
    """Symmetric activation quantizer of x [M, K]: per row from its absmax, or
    with the per-tensor ``scale``. Returns (codes [M, K] f32, scale [M, 1])."""
    xf = x.float()
    nl = 2 ** (bits - 1) - 1
    if scale is None:
        s = (xf.abs().amax(1, keepdim=True) / nl).clamp_min(1e-6)
    else:
        s = scale.reshape(1, 1).expand(xf.shape[0], 1)
    return (torch.round(xf / s)).clamp(-nl - 1, nl), s


class WanReference:
    """The reference model over a weight tree (see ``bench_h100/draw.py``)."""

    def __init__(self, params: Dict, cfg: Dict, scheme: dict, control: Optional[str] = None,
                 window=None):
        self.p, self.cfg, self.control = params, cfg, control
        # self-attention banded to +-r latent frames: an int r, or one r a
        # head (negative: dense for that head); None is dense
        self.window, self.band = window, None
        self.fp8 = control in FP8_CONTROLS
        self.policy = policies(scheme, cfg["num_layers"])
        self.static: Dict[str, torch.Tensor] = {}
        self.collect: Optional[Dict[str, Tuple[float, float]]] = None
        self.res_dtype = getattr(torch, cfg.get("residual_dtype", "float32"))
        self.head_dim = cfg["dim"] // cfg["num_heads"]

    # -- operands -------------------------------------------------------------
    def _act16(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8_rows(x, -1) if self.fp8 else x.to(BF16)

    def _w16(self, w: torch.Tensor) -> torch.Tensor:
        return _fp8_rows(w, 0) if self.fp8 else w.to(BF16)

    def linear(self, name: str, lp: Dict, x: torch.Tensor) -> torch.Tensor:
        """x [..., K] -> f32 [..., N]: FP (bf16 operands) or the scheme's
        quantizers, with calibration's min/max of the input collected."""
        lead, k = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k)
        pol: SitePolicy = self.policy.get(name, SitePolicy(quantized=False))
        if self.collect is not None and pol.quantized and pol.static:
            xf = x2.float()
            hi, lo = float(xf.max()), float(xf.min())
            old = self.collect.get(name)
            self.collect[name] = (hi, lo) if old is None else (max(old[0], hi), min(old[1], lo))
        if self.collect is not None or not pol.quantized:
            y = _mm(self._act16(x2), self._w16(lp["w"]))
        else:
            wq, dw, zw = quantize_weight(lp["w"], pol.w_bits, pol.w_sym)
            xq, sx = quantize_act(x2, self._a_bits(pol),
                                  self.static.get(name) if pol.static else None)
            acc = _int_product(xq, wq) + xq.sum(1, keepdim=True) * zw[None, :]
            y = sx * (acc * dw[None, :])
        return (y + lp["b"].float()).reshape(*lead, -1)

    def _a_bits(self, pol: SitePolicy) -> int:
        return 4 if self.control == "a4" else pol.a_bits

    # -- model ----------------------------------------------------------------
    def time_embedding(self, t: torch.Tensor):
        """e [B, dim], e0 [B, 6, dim] of the timesteps t [B] (f32; the
        sinusoid in f64, as the release computes it)."""
        half = self.cfg["freq_dim"] // 2
        pos = t.double()
        freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float64,
                                                 device=t.device) / half)
        s = torch.outer(pos, freqs)
        emb = torch.cat([torch.cos(s), torch.sin(s)], dim=1).float()
        p = self.p

        def lin32(lp, x):
            return x @ lp["w"].float() + lp["b"].float()

        e = lin32(p["time_embedding"]["2"], F.silu(lin32(p["time_embedding"]["0"], emb)))
        e0 = lin32(p["time_projection"]["1"], F.silu(e))
        return e, e0.reshape(t.shape[0], 6, self.cfg["dim"])

    def rope(self, x: torch.Tensor, grid) -> torch.Tensor:
        """3-axis RoPE of x [B, S, H, D] over the (F, H, W) grid, the release's
        complex rotation of adjacent pairs in f64, bf16 out."""
        d = self.head_dim
        f, h, w = grid
        c = d // 2
        parts = (c - 2 * (c // 3), c // 3, c // 3)

        def ang(n, m):  # [n, m] angles of m frequencies over 2m dims
            inv = 1.0 / torch.pow(10000.0, torch.arange(0, 2 * m, 2, dtype=torch.float64,
                                                        device=x.device) / (2 * m))
            return torch.outer(torch.arange(n, dtype=torch.float64, device=x.device), inv)

        a = torch.cat([ang(f, parts[0])[:, None, None, :].expand(f, h, w, -1),
                       ang(h, parts[1])[None, :, None, :].expand(f, h, w, -1),
                       ang(w, parts[2])[None, None, :, :].expand(f, h, w, -1)], dim=-1)
        rot = torch.polar(torch.ones_like(a), a).reshape(f * h * w, 1, c)
        out = torch.empty_like(x, dtype=BF16)
        for i in range(x.shape[0]):
            xc = torch.view_as_complex(x[i].double().reshape(*x.shape[1:3], c, 2).contiguous())
            out[i] = torch.view_as_real(xc * rot).reshape(*x.shape[1:]).to(BF16)
        return out

    def attention(self, q, k, v, band=None) -> torch.Tensor:
        """q [B, Sq, H, D], k / v [B, Sk, H, D] (bf16) -> [B, Sq, H*D] bf16.
        ``band`` (tokens a frame, one radius a head): each query frame sees
        the key frames within its head's radius."""
        q, k, v = (self._act16(t).transpose(1, 2) for t in (q, k, v))
        if band is None:
            o = F.scaled_dot_product_attention(q, k, v)
        else:
            tpf, radii = band
            o = torch.empty_like(q)
            for r in sorted(set(radii)):
                hs = [i for i, ri in enumerate(radii) if ri == r]
                for f0 in range(0, q.shape[2], tpf):
                    lo, hi = max(f0 - r * tpf, 0), f0 + (r + 1) * tpf
                    o[:, hs, f0:f0 + tpf] = F.scaled_dot_product_attention(
                        q[:, hs, f0:f0 + tpf], k[:, hs, lo:hi], v[:, hs, lo:hi])
        return o.transpose(1, 2).reshape(q.shape[0], q.shape[2], -1)

    def _band(self, grid):
        """(tokens a frame, one radius a head) of ``self.window`` on the latent
        grid; None where every head sees every frame."""
        if self.window is None:
            return None
        n = self.cfg["num_heads"]
        radii = list(self.window) if isinstance(self.window, (list, tuple)) \
            else [int(self.window)] * n
        if len(radii) != n:
            raise ValueError(f"{len(radii)} window radii for {n} heads")
        radii = [grid[0] if r < 0 else int(r) for r in radii]
        if min(radii) >= grid[0] - 1:
            return None
        return grid[1] * grid[2], radii

    def block(self, i: int, x: torch.Tensor, e0: torch.Tensor, ctx: torch.Tensor, grid):
        p, cfg, eps = self.p["blocks"][i], self.cfg, self.cfg["eps"]
        n, hd = cfg["num_heads"], self.head_dim
        name = f"blocks.{i}"
        m = p["modulation"] + e0
        s = [m[:, j][:, None, :] for j in range(6)]
        b, L, _ = x.shape

        h = (_layer_norm(x, eps) * (1 + s[1]) + s[0]).to(BF16)
        sa = p["self_attn"]
        q = _rms_norm(self.linear(f"{name}.self_attn.q", sa["q"], h).to(BF16), sa["norm_q"], eps)
        k = _rms_norm(self.linear(f"{name}.self_attn.k", sa["k"], h).to(BF16), sa["norm_k"], eps)
        v = self.linear(f"{name}.self_attn.v", sa["v"], h).to(BF16)
        q = self.rope(q.to(BF16).reshape(b, L, n, hd), grid)
        k = self.rope(k.to(BF16).reshape(b, L, n, hd), grid)
        y = self.attention(q, k, v.reshape(b, L, n, hd), self.band)
        y = self.linear(f"{name}.self_attn.o", sa["o"], y)
        x = (x.float() + y * s[2]).to(self.res_dtype)

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

        h = (_layer_norm(x, eps) * (1 + s[4]) + s[3]).to(BF16)
        h = F.gelu(self.linear(f"{name}.ffn.0", p["ffn"]["0"], h), approximate="tanh").to(BF16)
        y = self.linear(f"{name}.ffn.2", p["ffn"]["2"], h)
        return (x.float() + y * s[5]).to(self.res_dtype)

    def forward(self, latents: torch.Tensor, t: float, context: torch.Tensor) -> torch.Tensor:
        """latents [B, C, F, H, W] f32, t a timestep, context [B, text_len,
        text_dim] -> the velocity [B, C_out, F, H, W] f32."""
        cfg, p = self.cfg, self.p
        pt, ph, pw = cfg["patch_size"]
        b, c, f, hh, ww = latents.shape
        grid = (f // pt, hh // ph, ww // pw)
        x = latents.to(BF16).reshape(b, c, grid[0], pt, grid[1], ph, grid[2], pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, math.prod(grid), c * pt * ph * pw)
        x = self.linear("patch_embedding", p["patch_embedding"], x).to(self.res_dtype)
        tt = torch.full((1,), float(t), device=latents.device)
        e, e0 = self.time_embedding(tt)
        e, e0 = e.expand(b, -1), e0.expand(b, -1, -1)
        ctx = F.gelu(self.linear("text_embedding.0", p["text_embedding"]["0"],
                                 context.to(BF16)), approximate="tanh").to(BF16)
        ctx = self.linear("text_embedding.2", p["text_embedding"]["2"], ctx).to(BF16)
        # calibration runs dense, as the program's does
        self.band = None if self.collect is not None else self._band(grid)
        for i in range(cfg["num_layers"]):
            x = self.block(i, x, e0, ctx, grid)
        m = p["head"]["modulation"] + e[:, None, :]
        h = (_layer_norm(x, cfg["eps"]) * (1 + m[:, 1:2]) + m[:, 0:1]).to(BF16)
        out = self.linear("head.head", p["head"]["head"], h)
        co = cfg["out_dim"]
        out = out.reshape(b, *grid, pt, ph, pw, co)
        out = torch.einsum("bfhwpqrc->bcfphqwr", out)
        return out.reshape(b, co, grid[0] * pt, grid[1] * ph, grid[2] * pw)

    def pair(self, latents, t, context, context_null):
        """The CFG pair of one step, (conditional, unconditional) velocity, as
        one batch of two."""
        both = self.forward(torch.cat([latents, latents]), t,
                            torch.cat([context, context_null]))
        return both[:1], both[1:]

    @torch.no_grad()
    def calibrate(self, latents, t, context, context_null) -> None:
        """One FP forward of the CFG pair; each static site's per-tensor scale
        = max(|max(x, 0)|, |min(x, 0)|) / (2**(bits - 1) - 1) of its input."""
        self.collect = {}
        try:
            self.forward(torch.cat([latents, latents]), t, torch.cat([context, context_null]))
        finally:
            seen, self.collect = self.collect, None
        for name, (hi, lo) in seen.items():
            nl = 2 ** (self._a_bits(self.policy[name]) - 1) - 1
            amax = max(abs(max(hi, 0.0)), abs(min(lo, 0.0)))
            self.static[name] = torch.tensor(max(amax / nl, 1e-6), dtype=torch.float32,
                                             device=latents.device)


def guided(cond: torch.Tensor, uncond: torch.Tensor, guide_scale: float) -> torch.Tensor:
    """Classifier-free guidance: uncond + g (cond - uncond), in f32."""
    cond, uncond = cond.float(), uncond.float()
    return uncond + guide_scale * (cond - uncond)
