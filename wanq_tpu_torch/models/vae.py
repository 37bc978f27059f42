"""Wan2.1 3D causal VAE in PyTorch (counterpart of wanq_tpu/models/vae.py).

The reference streams decode one latent frame at a time through per-conv
feature caches (the last 2 input frames of every temporal-causal conv).
Here a :class:`CacheCtx` carries them from chunk to chunk in a Python loop:

  * every temporal-causal conv keeps cache[k] = its last 2 input frames,
    none on the first chunk (zero history, the reference's causal
    zero-padding); cache' = cat(cache, x)[:, :, -2:];
  * the temporal up/halve convs of Resample skip chunk 0 (the reference's
    'Rep' marker).

Params are a flat {torch_key: tensor} dict, as the reference's state dict.
The convs are ``torch.nn.functional.conv3d`` / ``conv2d`` in NCDHW layout;
their compute dtype follows the stored weight. The per-frame spatial
attention is a plain f32 product, f32 softmax and f32 product over
operands in the compute dtype, as wanq_tpu computes it outside any Pallas
kernel. No module here holds a kernel of the port.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CACHE_T = 2

# per-channel latent normalization (the published Wan2.1 VAE constants)
LATENT_MEAN = [
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
]
LATENT_STD = [
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temperal_downsample: Tuple[bool, ...] = (False, True, True)

    @property
    def temperal_upsample(self):
        return tuple(reversed(self.temperal_downsample))


WAN_VAE_CFG = VAEConfig()


def tiny_vae_config(**overrides) -> VAEConfig:
    base = dict(dim=16, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                temperal_downsample=(True,))
    base.update(overrides)
    return VAEConfig(**base)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

Params = Dict[str, torch.Tensor]
Cache = List[Optional[torch.Tensor]]


def _conv(fn, p: Params, key: str, x: torch.Tensor, stride, padding) -> torch.Tensor:
    """``fn`` (conv2d / conv3d) in the stored weight's dtype; ``padding`` is
    one (lo, hi) pair per spatial dim. The symmetric part goes to the conv,
    the rest to an explicit F.pad. The bias is added in f32 and the sum cast
    back to the weight's dtype. A bf16 conv rounds its f32 sum to bf16
    before that add (wanq_tpu adds the bias to the f32 sum)."""
    w = p[f"{key}.weight"]
    x = x.to(w.dtype)
    sym = [min(lo, hi) for lo, hi in padding]
    extra = []
    for (lo, hi), s in zip(reversed(padding), reversed(sym)):
        extra += [lo - s, hi - s]
    if any(extra):
        x = F.pad(x, extra)
    y = fn(x, w, None, stride, sym)
    b = p.get(f"{key}.bias")
    if b is None:
        return y
    shape = (1, -1) + (1,) * (y.dim() - 2)
    return (y.float() + b.float().view(shape)).to(w.dtype)


def conv3d(p: Params, key: str, x: torch.Tensor, stride=(1, 1, 1), padding=None):
    """torch-layout Conv3d. x: [B,C,T,H,W]; weight: [O,I,kt,kh,kw]."""
    return _conv(F.conv3d, p, key, x, stride, padding or [(0, 0)] * 3)


def conv2d(p: Params, key: str, x: torch.Tensor, stride=(1, 1), padding=((0, 0), (0, 0))):
    """torch-layout Conv2d on [B,C,H,W]."""
    return _conv(F.conv2d, p, key, x, stride, list(padding))


class CacheCtx:
    """The feature caches of one chunk: ``caches`` from the chunk before
    (None: no streaming, full causal padding), ``new`` for the next."""

    def __init__(self, caches: Optional[Cache], chunk0: bool):
        self.caches = caches
        self.chunk0 = chunk0
        self.idx = 0
        self.new: Cache = []

    def pull(self) -> Optional[torch.Tensor]:
        if self.caches is None:
            return None
        c = self.caches[self.idx]
        self.idx += 1
        return c

    def push(self, c: Optional[torch.Tensor]):
        self.new.append(c)


def causal_conv3d(p: Params, key: str, x: torch.Tensor, cc: CacheCtx,
                  stride=(1, 1, 1), space_pad: int = 1, time_pad: int = 2):
    """CausalConv3d: front-only temporal padding of ``time_pad`` frames,
    replaced by the streaming cache when there is one."""
    sp = [(space_pad, space_pad)] * 2
    if time_pad == 0:
        return conv3d(p, key, x, stride, [(0, 0)] + sp)
    cache = cc.pull()
    if cache is None:
        y = conv3d(p, key, x, stride, [(time_pad, 0)] + sp)
        if cc.caches is not None:
            # the last 2 frames of the zero-extended input stream
            ext = torch.cat([x.new_zeros((*x.shape[:2], time_pad, *x.shape[3:])), x], dim=2)
            cc.push(ext[:, :, -CACHE_T:])
        return y
    xin = torch.cat([cache, x], dim=2)
    y = conv3d(p, key, xin, stride, [(0, 0)] + sp)
    cc.push(xin[:, :, -CACHE_T:])
    return y


def rms_norm_image(p: Params, key: str, x: torch.Tensor, images: bool):
    """RMS_norm over the channel dim (F.normalize x sqrt(C) x gamma), stats
    in f32, the result in the stream's dtype."""
    g = p[f"{key}.gamma"].float()
    c = x.shape[1]
    xf = x.float()
    n = xf * torch.rsqrt(torch.clamp(xf.square().sum(dim=1, keepdim=True), min=1e-24))
    shape = (1, c) + (1,) * (x.dim() - 2)
    return (n * (c ** 0.5) * g.reshape(shape)).to(x.dtype)


def residual_block(p: Params, key: str, x: torch.Tensor, cc: CacheCtx):
    in_dim = x.shape[1]
    out_dim = p[f"{key}.residual.2.weight"].shape[0]
    h = conv3d(p, f"{key}.shortcut", x) if in_dim != out_dim else x
    y = F.silu(rms_norm_image(p, f"{key}.residual.0", x, images=False))
    y = causal_conv3d(p, f"{key}.residual.2", y, cc)
    y = F.silu(rms_norm_image(p, f"{key}.residual.3", y, images=False))
    y = causal_conv3d(p, f"{key}.residual.6", y, cc)
    return y + h


# above this many tokens the full [hw, hw] f32 logits of a frame dominate
# the decode chunk's memory (720p latent: 90*160 = 14400 -> 829 MB), so the
# softmax runs over blocks of query rows instead; 480p (60*104 = 6240 ->
# 156 MB) stays one-shot
_ATTN_BLOCKWISE_MIN_HW = 8192
_ATTN_Q_BLOCK = 1800


def _spatial_attention(q, k, v, scale):
    """softmax(q k^T * scale) v for [bt, hw, c] operands: both products in
    f32 over the operands' values, the softmax in f32, the probabilities
    rounded to v's dtype, the result in v's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    attn = torch.softmax(logits * scale, dim=-1)
    return torch.matmul(attn.to(v.dtype).float(), v.float()).to(v.dtype)


def attention_block(p: Params, key: str, x: torch.Tensor):
    """Single-head per-frame spatial attention. Above
    ``_ATTN_BLOCKWISE_MIN_HW`` tokens the query rows run in blocks of
    ``_ATTN_Q_BLOCK``: the softmax is per row, so blocking is exact."""
    b, c, t, h, w = x.shape
    ident = x
    xf = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
    xn = rms_norm_image(p, f"{key}.norm", xf, images=True)
    qkv = conv2d(p, f"{key}.to_qkv", xn)  # [bt, 3c, h, w]
    qkv = qkv.reshape(b * t, 3 * c, h * w).transpose(1, 2)  # [bt, hw, 3c]
    q, k, v = qkv.chunk(3, dim=-1)
    scale = 1.0 / np.sqrt(c)
    hw = h * w
    if hw < _ATTN_BLOCKWISE_MIN_HW:
        y = _spatial_attention(q, k, v, scale)
    else:
        y = torch.cat([_spatial_attention(q[:, i:i + _ATTN_Q_BLOCK], k, v, scale)
                       for i in range(0, hw, _ATTN_Q_BLOCK)], dim=1)
    y = y.transpose(1, 2).reshape(b * t, c, h, w)
    y = conv2d(p, f"{key}.proj", y)
    y = y.reshape(b, t, c, h, w).permute(0, 2, 1, 3, 4)
    return y + ident


def resample(p: Params, key: str, x: torch.Tensor, mode: str, cc: CacheCtx):
    b, c, t, h, w = x.shape
    if mode == "upsample3d" and not cc.chunk0:
        cache = cc.pull()
        if cache is None:  # zero history
            cache = x.new_zeros((b, c, CACHE_T, h, w))
        xin = torch.cat([cache, x], dim=2)
        y = conv3d(p, f"{key}.time_conv", xin)
        cc.push(xin[:, :, -CACHE_T:])
        # the 2c channels interleave into 2x time
        x = y.reshape(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * t, h, w)
        t = 2 * t
    elif mode == "upsample3d" and cc.chunk0:
        # the 'Rep' chunk: the time conv is skipped, its cache stays empty
        if cc.caches is not None:
            cc.pull()
            cc.push(None)

    if mode in ("upsample2d", "upsample3d"):
        xf = x.permute(0, 2, 1, 3, 4).reshape(b * t, x.shape[1], h, w)
        xf = xf.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)  # nearest 2x
        xf = conv2d(p, f"{key}.resample.1", xf, padding=((1, 1), (1, 1)))
        x = xf.reshape(b, t, xf.shape[1], 2 * h, 2 * w).permute(0, 2, 1, 3, 4)
    elif mode in ("downsample2d", "downsample3d"):
        xf = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
        xf = conv2d(p, f"{key}.resample.1", xf, stride=(2, 2), padding=((0, 1), (0, 1)))
        x = xf.reshape(b, t, c, h // 2, w // 2).permute(0, 2, 1, 3, 4)

    if mode == "downsample3d":
        if cc.caches is not None:
            cache = cc.pull()
            if cache is None or cc.chunk0:
                cc.push(x[:, :, -1:])  # chunk 0: the time conv is skipped
            else:
                xin = torch.cat([cache, x], dim=2)
                x = conv3d(p, f"{key}.time_conv", xin, stride=(2, 1, 1))
                cc.push(xin[:, :, -1:])
        else:
            # no streaming: frame 0 passes through, and the stride-2 window
            # over the whole stream gives the chunked conv's positions
            x = torch.cat([x[:, :, :1], conv3d(p, f"{key}.time_conv", x, stride=(2, 1, 1))],
                          dim=2)
    return x


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------


def _encoder_layers(cfg: VAEConfig):
    """(kind, key) in Encoder3d's module order."""
    layers = []
    scale = 1.0
    li = 0
    for i in range(len(cfg.dim_mult)):
        for _ in range(cfg.num_res_blocks):
            layers.append(("res", f"encoder.downsamples.{li}")); li += 1
            if scale in cfg.attn_scales:
                layers.append(("attn", f"encoder.downsamples.{li}")); li += 1
        if i != len(cfg.dim_mult) - 1:
            mode = "downsample3d" if cfg.temperal_downsample[i] else "downsample2d"
            layers.append((mode, f"encoder.downsamples.{li}")); li += 1
            scale /= 2.0
    return layers


def _decoder_layers(cfg: VAEConfig):
    layers = []
    scale = 1.0 / 2 ** (len(cfg.dim_mult) - 2)
    li = 0
    for i in range(len(cfg.dim_mult)):
        for _ in range(cfg.num_res_blocks + 1):
            layers.append(("res", f"decoder.upsamples.{li}")); li += 1
            if scale in cfg.attn_scales:
                layers.append(("attn", f"decoder.upsamples.{li}")); li += 1
        if i != len(cfg.dim_mult) - 1:
            mode = "upsample3d" if cfg.temperal_upsample[i] else "upsample2d"
            layers.append((mode, f"decoder.upsamples.{li}")); li += 1
            scale *= 2.0
    return layers


def _run_layers(p: Params, layers, x: torch.Tensor, cc: CacheCtx):
    for kind, key in layers:
        if kind == "res":
            x = residual_block(p, key, x, cc)
        elif kind == "attn":
            x = attention_block(p, key, x)
        else:
            x = resample(p, key, x, kind, cc)
    return x


def _middle(p: Params, part: str, x: torch.Tensor, cc: CacheCtx):
    x = residual_block(p, f"{part}.middle.0", x, cc)
    x = attention_block(p, f"{part}.middle.1", x)
    return residual_block(p, f"{part}.middle.2", x, cc)


def _head(p: Params, part: str, x: torch.Tensor, cc: CacheCtx):
    x = F.silu(rms_norm_image(p, f"{part}.head.0", x, images=False))
    return causal_conv3d(p, f"{part}.head.2", x, cc)


def encoder_forward(p: Params, cfg: VAEConfig, x: torch.Tensor, cc: CacheCtx):
    """Encoder3d. x: [B,3,T,H,W] -> [B,2z,t,h,w]."""
    x = causal_conv3d(p, "encoder.conv1", x, cc)
    x = _run_layers(p, _encoder_layers(cfg), x, cc)
    return _head(p, "encoder", _middle(p, "encoder", x, cc), cc)


def decoder_forward(p: Params, cfg: VAEConfig, x: torch.Tensor, cc: CacheCtx):
    """Decoder3d. x: [B,z,t,h,w] -> [B,3,T,H,W]."""
    x = _middle(p, "decoder", causal_conv3d(p, "decoder.conv1", x, cc), cc)
    return _head(p, "decoder", _run_layers(p, _decoder_layers(cfg), x, cc), cc)


class WanVAE:
    """The reference's WanVAE: chunked streaming encode / decode with the
    feature caches carried from chunk to chunk.

    ``compute_dtype`` is the reference's WanVAE(dtype=...): float32 is the
    reference default; bfloat16 casts every weight but the norm gammas
    (they only enter the f32 stats) and keeps the stream bf16 between
    layers. The decoded video is float32 in [-1, 1] either way. The weights
    live on ``device``, the card unless the caller asks for the CPU."""

    def __init__(self, cfg: VAEConfig = WAN_VAE_CFG, params: Optional[Params] = None,
                 vae_pth: Optional[str] = None, seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        if params is None:
            params = (load_vae_checkpoint(vae_pth, device=device) if vae_pth
                      else init_vae_params(cfg, seed, device=device))
        self.params = {k: v.to(self.device, v.dtype if k.endswith(".gamma") else compute_dtype)
                       for k, v in params.items()}
        z = cfg.z_dim
        if z == 16:
            self.mean = torch.tensor(LATENT_MEAN, dtype=torch.float32, device=self.device)
            self.std = torch.tensor(LATENT_STD, dtype=torch.float32, device=self.device)
        else:
            self.mean = torch.zeros(z, device=self.device)
            self.std = torch.ones(z, device=self.device)

    def _run_chunks(self, forward, x: torch.Tensor, starts, lens) -> torch.Tensor:
        """Run ``forward(params, chunk, cc)`` over the time chunks, carrying
        the caches; the chunks' outputs concatenated in time."""
        caches: Cache = [None] * 64
        outs = []
        for ci, (s, n) in enumerate(zip(starts, lens)):
            cc = CacheCtx(caches, chunk0=ci == 0)
            outs.append(forward(self.params, x[:, :, s:s + n], cc))
            caches = cc.new
        return torch.cat(outs, dim=2)

    def _norm(self, v: torch.Tensor) -> torch.Tensor:
        return v[None, :, None, None, None]

    @torch.no_grad()
    def encode(self, videos: torch.Tensor) -> torch.Tensor:
        """[B,3,T,H,W] -> normalized latents [B,z,t,h,w] (f32): chunks of
        1, 4, 4, ... frames."""
        videos = videos.to(self.device)
        t = videos.shape[2]
        n_iter = 1 + (t - 1) // 4
        starts = [0] + [1 + 4 * (i - 1) for i in range(1, n_iter)]
        lens = [1] + [4] * (n_iter - 1)
        out = self._run_chunks(lambda p, ch, cc: encoder_forward(p, self.cfg, ch, cc),
                               videos, starts, lens)
        mu = conv3d(self.params, "conv1", out).chunk(2, dim=1)[0]
        return (mu - self._norm(self.mean)) / self._norm(self.std)

    @torch.no_grad()
    def decode(self, zs: torch.Tensor) -> torch.Tensor:
        """Normalized latents [B,z,t,h,w] -> video [B,3,T,H,W], float32 in
        [-1, 1]: one latent frame per chunk."""
        z = zs.to(self.device, torch.float32) * self._norm(self.std) + self._norm(self.mean)
        x = conv3d(self.params, "conv2", z)
        t = x.shape[2]
        out = self._run_chunks(lambda p, ch, cc: decoder_forward(p, self.cfg, ch, cc),
                               x, list(range(t)), [1] * t)
        return out.float().clamp_(-1.0, 1.0)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def load_vae_checkpoint(path: str, dtype=torch.float32, device="cuda") -> Params:
    """Wan2.1_VAE.pth (a torch state dict) -> flat param dict, keys kept."""
    sd = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    return {k: v.to(device=device, dtype=dtype) for k, v in sd.items()}


def init_vae_params(cfg: VAEConfig, seed: int = 0, device="cuda") -> Params:
    """Random init with the reference module tree's shapes, drawn from
    ``np.random.default_rng(seed)`` in wanq_tpu's order (both packages make
    the same weights from one seed)."""
    rng = np.random.default_rng(seed)
    p: Params = {}

    def put(key, a):
        p[key] = torch.from_numpy(a.astype(np.float32)).to(device)

    def conv(key, ci, co, k):
        b = 1.0 / np.sqrt(ci * int(np.prod(k)))
        put(f"{key}.weight", rng.uniform(-b, b, (co, ci, *k)))
        put(f"{key}.bias", rng.uniform(-b, b, co))

    def gamma(key, c, images):
        put(f"{key}.gamma", np.ones((c, 1, 1) if images else (c, 1, 1, 1)))

    def res(key, ci, co):
        gamma(f"{key}.residual.0", ci, images=False)
        conv(f"{key}.residual.2", ci, co, (3, 3, 3))
        gamma(f"{key}.residual.3", co, images=False)
        conv(f"{key}.residual.6", co, co, (3, 3, 3))
        if ci != co:
            conv(f"{key}.shortcut", ci, co, (1, 1, 1))

    def attn(key, c):
        gamma(f"{key}.norm", c, images=True)
        conv(f"{key}.to_qkv", c, 3 * c, (1, 1))
        conv(f"{key}.proj", c, c, (1, 1))

    def middle(part, c):
        res(f"{part}.middle.0", c, c)
        attn(f"{part}.middle.1", c)
        res(f"{part}.middle.2", c, c)

    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    conv("encoder.conv1", 3, dims[0], (3, 3, 3))
    li = 0
    scale = 1.0
    for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(cfg.num_res_blocks):
            res(f"encoder.downsamples.{li}", ci, co); li += 1
            if scale in cfg.attn_scales:
                attn(f"encoder.downsamples.{li}", co); li += 1
            ci = co
        if i != len(cfg.dim_mult) - 1:
            conv(f"encoder.downsamples.{li}.resample.1", co, co, (3, 3))
            if cfg.temperal_downsample[i]:
                conv(f"encoder.downsamples.{li}.time_conv", co, co, (3, 1, 1))
            li += 1
            scale /= 2
    middle("encoder", dims[-1])
    gamma("encoder.head.0", dims[-1], images=False)
    conv("encoder.head.2", dims[-1], 2 * cfg.z_dim, (3, 3, 3))
    conv("conv1", 2 * cfg.z_dim, 2 * cfg.z_dim, (1, 1, 1))
    conv("conv2", cfg.z_dim, cfg.z_dim, (1, 1, 1))
    ddims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    conv("decoder.conv1", cfg.z_dim, ddims[0], (3, 3, 3))
    middle("decoder", ddims[0])
    li = 0
    scale = 1.0 / 2 ** (len(cfg.dim_mult) - 2)
    for i, (ci, co) in enumerate(zip(ddims[:-1], ddims[1:])):
        if i in (1, 2, 3):
            ci = ci // 2
        for _ in range(cfg.num_res_blocks + 1):
            res(f"decoder.upsamples.{li}", ci, co); li += 1
            if scale in cfg.attn_scales:
                attn(f"decoder.upsamples.{li}", co); li += 1
            ci = co
        if i != len(cfg.dim_mult) - 1:
            conv(f"decoder.upsamples.{li}.resample.1", co, co // 2, (3, 3))
            if cfg.temperal_upsample[i]:
                conv(f"decoder.upsamples.{li}.time_conv", co, 2 * co, (3, 1, 1))
            li += 1
            scale *= 2
    gamma("decoder.head.0", ddims[-1], images=False)
    conv("decoder.head.2", ddims[-1], 3, (3, 3, 3))
    return p


def decode_latents(ckpt_dir: str, wan_cfg, latents: torch.Tensor, device="cuda",
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pipeline hook: VAE-decode latents with the VAE of a Wan checkpoint
    dir (``wan_cfg.vae_checkpoint``)."""
    vae = WanVAE(vae_pth=os.path.join(ckpt_dir, wan_cfg.vae_checkpoint),
                 compute_dtype=compute_dtype, device=device)
    return vae.decode(latents)
