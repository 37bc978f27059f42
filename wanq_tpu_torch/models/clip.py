"""XLM-Roberta-CLIP, the i2v image encoder (counterpart of
wanq_tpu/models/clip.py).

Params are a flat {state-dict key: tensor} dict, as in the reference
checkpoint ``models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth``. The
i2v pipeline reads :meth:`CLIPModel.visual`: the ViT-H/14 tower up to its
second-to-last block (``use_31_block``) gives [B, 257, 1280] features. Both
towers run in float32, as in the JAX package; on the card the f32 matmuls
and convolutions stay full f32 only with TF32 off (the CLIs turn it off).
Attention is plain matmuls and a softmax: the JAX package has no kernel of
its own here.

:func:`resize_cubic` is ``jax.image.resize(..., method="cubic")``: Keys'
cubic kernel (a = -0.5), widened by the scale when downsampling
(antialiasing), as a weight matrix per axis. PyTorch's
``interpolate(mode="bicubic")`` is another function (a = -0.75, no
antialiasing, other edges).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    # the reference's clip_xlm_roberta_vit_h_14
    embed_dim: int = 1024
    image_size: int = 224
    patch_size: int = 14
    vision_dim: int = 1280
    vision_mlp_ratio: int = 4
    vision_heads: int = 16
    vision_layers: int = 32
    activation: str = "gelu"
    vocab_size: int = 250002
    max_text_len: int = 514
    pad_id: int = 1
    text_dim: int = 1024
    text_heads: int = 16
    text_layers: int = 24
    norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


CLIP_XLM_ROBERTA_VIT_H_14 = CLIPConfig()


def tiny_clip_config(**overrides) -> CLIPConfig:
    base = dict(embed_dim=16, image_size=28, patch_size=14, vision_dim=32,
                vision_heads=4, vision_layers=2, vocab_size=64,
                max_text_len=16, text_dim=32, text_heads=4, text_layers=2)
    base.update(overrides)
    return CLIPConfig(**base)


# ---------------------------------------------------------------------------
# the cubic resize of jax.image.resize
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def cubic_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of one axis: jax.image's
    ``compute_weight_mat`` with the Keys cubic kernel and antialiasing, in
    its float32 arithmetic."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_cubic(x: torch.Tensor, size) -> torch.Tensor:
    """x [..., H, W] (float) -> [..., h, w], ``size`` = (h, w): the function
    of ``jax.image.resize(x, (..., h, w), method="cubic")``. An axis whose
    size does not change is left as it is, as jax.image does."""
    h, w = (int(s) for s in size)
    if x.shape[-2] != h:
        wh = torch.from_numpy(cubic_resize_weights(x.shape[-2], h)).to(x.device, x.dtype)
        x = torch.matmul(wh.t(), x)
    if x.shape[-1] != w:
        ww = torch.from_numpy(cubic_resize_weights(x.shape[-1], w)).to(x.device, x.dtype)
        x = torch.matmul(x, ww)
    return x


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------


def _ln(p: Params, key: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y * p[f"{key}.weight"].float() + p[f"{key}.bias"].float()


def _lin(p: Params, key: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    """x @ W^T (+ b); the towers run in float32."""
    y = torch.matmul(x.float(), p[f"{key}.weight"].float().t())
    if bias and f"{key}.bias" in p:
        y = y + p[f"{key}.bias"].float()
    return y.to(x.dtype)


def _mha(q, k, v, num_heads: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    b, sq, c = q.shape
    d = c // num_heads
    qh = q.reshape(b, sq, num_heads, d).transpose(1, 2)
    kh = k.reshape(b, -1, num_heads, d).transpose(1, 2)
    vh = v.reshape(b, -1, num_heads, d).transpose(1, 2)
    scores = torch.matmul(qh, kh.transpose(-1, -2)).float() / math.sqrt(d)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2).reshape(b, sq, c)


def vision_forward(p: Params, cfg: CLIPConfig, x: torch.Tensor,
                   use_31_block: bool = False) -> torch.Tensor:
    """x: [B, 3, H, W] normalized images -> tokens [B, 1 + P, vision_dim]."""
    b = x.shape[0]
    ps = cfg.patch_size
    tok = F.conv2d(x.float(), p["visual.patch_embedding.weight"].float(),
                   p.get("visual.patch_embedding.bias"), stride=ps)
    tok = tok.reshape(b, cfg.vision_dim, -1).transpose(1, 2)
    cls = p["visual.cls_embedding"].float().expand(b, 1, cfg.vision_dim)
    h = torch.cat([cls, tok], dim=1) + p["visual.pos_embedding"].float()
    h = _ln(p, "visual.pre_norm", h, cfg.norm_eps)
    for i in range(cfg.vision_layers - (1 if use_31_block else 0)):
        key = f"visual.transformer.{i}"
        qkv = _lin(p, f"{key}.attn.to_qkv", _ln(p, f"{key}.norm1", h, cfg.norm_eps))
        q, k, v = qkv.reshape(b, qkv.shape[1], 3, cfg.vision_dim).unbind(2)
        h = h + _lin(p, f"{key}.attn.proj", _mha(q, k, v, cfg.vision_heads))
        m = _lin(p, f"{key}.mlp.0", _ln(p, f"{key}.norm2", h, cfg.norm_eps))
        m = F.gelu(m.float()).to(m.dtype)
        h = h + _lin(p, f"{key}.mlp.2", m)
    return h


def text_forward(p: Params, cfg: CLIPConfig, ids: torch.Tensor) -> torch.Tensor:
    """ids: [B, L] token ids -> pooled and projected [B, embed_dim]."""
    mask = (ids != cfg.pad_id).long()
    pos_ids = cfg.pad_id + torch.cumsum(mask, dim=1) * mask
    x = (p["textual.token_embedding.weight"][ids]
         + p["textual.type_embedding.weight"][torch.zeros_like(ids)]
         + p["textual.pos_embedding.weight"][pos_ids]).float()
    x = _ln(p, "textual.norm", x, 1e-5)  # post-norm: the norm comes before the blocks
    attn_mask = torch.where(mask[:, None, None, :] > 0, 0.0, torch.finfo(torch.float32).min)
    for i in range(cfg.text_layers):
        key = f"textual.blocks.{i}"
        q, k, v = (_lin(p, f"{key}.attn.{leaf}", x) for leaf in ("q", "k", "v"))
        a = _mha(q, k, v, cfg.text_heads, mask=attn_mask)
        x = _ln(p, f"{key}.norm1", x + _lin(p, f"{key}.attn.o", a), 1e-5)
        m = F.gelu(_lin(p, f"{key}.ffn.0", x).float())
        x = _ln(p, f"{key}.norm2", x + _lin(p, f"{key}.ffn.2", m.to(x.dtype)), 1e-5)
    # mean over the tokens that are not padding
    mf = mask[:, :, None].float()
    pooled = (x * mf).sum(dim=1) / mf.sum(dim=1)
    h = F.gelu(_lin(p, "textual.head.0", pooled, bias=False).float())
    return _lin(p, "textual.head.2", h.to(pooled.dtype), bias=False)


class CLIPModel:
    """The reference's CLIPModel: the first frames of videos -> the
    use_31_block ViT features of the i2v conditioning. The weights come from
    ``params``, a ``.pth`` state dict (``checkpoint_path``; the visual keys
    are all ``visual`` reads), or :func:`init_clip_params`; they live on
    ``device`` in float32, the card unless the caller asks for the CPU."""

    def __init__(self, cfg: CLIPConfig = CLIP_XLM_ROBERTA_VIT_H_14,
                 params: Optional[Params] = None, checkpoint_path: Optional[str] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if params is None:
            params = (load_clip_checkpoint(checkpoint_path, device=device) if checkpoint_path
                      else init_clip_params(cfg, device=device))
        self.params = {k: v.to(self.device, torch.float32) for k, v in params.items()}

    @torch.no_grad()
    def visual(self, videos: torch.Tensor) -> torch.Tensor:
        """videos: [B, 3, T, H, W] in [-1, 1] -> [B*T, 257, vision_dim]."""
        b, c, t, h, w = videos.shape
        imgs = videos.to(self.device, torch.float32).transpose(1, 2).reshape(b * t, c, h, w)
        imgs = resize_cubic(imgs, (self.cfg.image_size, self.cfg.image_size))
        imgs = imgs * 0.5 + 0.5
        mean = torch.tensor(CLIP_MEAN, device=self.device)[None, :, None, None]
        std = torch.tensor(CLIP_STD, device=self.device)[None, :, None, None]
        return vision_forward(self.params, self.cfg, (imgs - mean) / std, use_31_block=True)


def load_clip_checkpoint(path: str, device="cuda") -> Params:
    """A CLIP ``.pth`` state dict -> {key: float32 tensor on ``device``}."""
    sd = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    return {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}


def _clip_tree(cfg: CLIPConfig, lin, normal, device) -> Params:
    """The state dict's tensors, drawn by ``lin(key, c_in, c_out, bias)``
    (uniform +-1/sqrt(c_in)) and ``normal(shape, std)`` in wanq_tpu's order."""
    p: Params = {}

    def linear(key, ci, co, bias=True):
        w, b = lin(ci, co, bias)
        p[f"{key}.weight"] = w
        if bias:
            p[f"{key}.bias"] = b

    def ln(key, c):
        p[f"{key}.weight"] = torch.ones((c,), device=device)
        p[f"{key}.bias"] = torch.zeros((c,), device=device)

    vd, gain = cfg.vision_dim, 1.0 / math.sqrt(cfg.vision_dim)
    p["visual.patch_embedding.weight"] = normal((vd, 3, cfg.patch_size, cfg.patch_size), 0.02)
    p["visual.cls_embedding"] = normal((1, 1, vd), gain)
    p["visual.pos_embedding"] = normal((1, cfg.num_patches + 1, vd), gain)
    ln("visual.pre_norm", vd)
    for i in range(cfg.vision_layers):
        key = f"visual.transformer.{i}"
        ln(f"{key}.norm1", vd)
        linear(f"{key}.attn.to_qkv", vd, 3 * vd)
        linear(f"{key}.attn.proj", vd, vd)
        ln(f"{key}.norm2", vd)
        linear(f"{key}.mlp.0", vd, vd * cfg.vision_mlp_ratio)
        linear(f"{key}.mlp.2", vd * cfg.vision_mlp_ratio, vd)
    ln("visual.post_norm", vd)
    p["visual.head"] = normal((vd, cfg.embed_dim), gain)

    td = cfg.text_dim
    p["textual.token_embedding.weight"] = normal((cfg.vocab_size, td), 0.02)
    p["textual.type_embedding.weight"] = normal((1, td), 0.02)
    p["textual.pos_embedding.weight"] = normal((cfg.max_text_len, td), 0.02)
    ln("textual.norm", td)
    for i in range(cfg.text_layers):
        key = f"textual.blocks.{i}"
        for leaf in ("q", "k", "v", "o"):
            linear(f"{key}.attn.{leaf}", td, td)
        ln(f"{key}.norm1", td)
        linear(f"{key}.ffn.0", td, 4 * td)
        linear(f"{key}.ffn.2", 4 * td, td)
        ln(f"{key}.norm2", td)
    mid = (td + cfg.embed_dim) // 2
    linear("textual.head.0", td, mid, bias=False)
    linear("textual.head.2", mid, cfg.embed_dim, bias=False)
    return p


def init_clip_params(cfg: CLIPConfig, seed: int = 0, device="cuda") -> Params:
    """Random init from ``np.random.default_rng(seed)`` in wanq_tpu's draw
    order (both packages make the same weights from one seed), the shapes of
    the reference state dict. The full text tower's 250002 x 1024 embedding
    makes this a slow host draw at full size: on the card use
    :func:`init_clip_params_on_device`."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    def lin(ci, co, bias):
        bound = 1.0 / math.sqrt(ci)
        w = t(rng.uniform(-bound, bound, (co, ci)))
        return w, (t(rng.uniform(-bound, bound, co)) if bias else None)

    return _clip_tree(cfg, lin, lambda shape, std: t(rng.standard_normal(shape) * std), device)


def init_clip_params_on_device(cfg: CLIPConfig, seed: int = 0, device="cuda") -> Params:
    """Random init drawn on ``device`` by a ``torch.Generator`` seeded with
    ``seed``: :func:`init_clip_params`' tree and schemes, not its bits."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def lin(ci, co, bias):
        bound = 1.0 / math.sqrt(ci)
        w = torch.empty((co, ci), device=device).uniform_(-bound, bound, generator=gen)
        b = (torch.empty((co,), device=device).uniform_(-bound, bound, generator=gen)
             if bias else None)
        return w, b

    def normal(shape, std):
        return torch.empty(shape, device=device).normal_(0.0, std, generator=gen)

    return _clip_tree(cfg, lin, normal, device)
