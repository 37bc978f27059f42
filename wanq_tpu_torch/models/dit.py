"""Wan2.1 DiT backbone in PyTorch (counterpart of wanq_tpu/models/dit.py).

Params are a plain dict tree whose paths mirror the reference module names
("blocks.0.self_attn.q", ...), with linear weights ``w`` [C_in, C_out] as
in the JAX package. The residual stream, norms, modulation and time
embeddings run in float32 (the residual is stored in ``cfg.res_dtype``);
matmuls run in the param dtype. Blocks run as a Python loop.

Fused paths, taken on every device when ``head_dim == 128`` (the JAX
package takes them on the TPU only; on the CPU the port's kernel wrappers
run their plain versions, so the tests check the fused structure against
JAX's unfused chain):

* int8 q/k/v: one LN+modulate+int8 producer (K1) feeds three int8 GEMMs
  (K2); cross-attention q rides the norm3 producer (K1 -> K2); the FFN
  runs K1 -> GEMM (bf16) -> GELU + quant -> GEMM, the GEMMs K2 for int8
  weights and K8 for packed int4 ones, the GELU + quant dynamic (K7) or
  static: in the epilogue of the ffn.0 GEMM itself for int8 weights (K2's
  second mode, no bf16 intermediate), elementwise behind K8.
* q/k: RMSNorm -> RoPE -> heads-major (K3), cross q RMSNorm -> heads (K3),
  attention (K4) reading v through strides and writing seq-major memory,
  and the o-projection reading that memory as [B, S, N*D], a view: FP, or
  ``qlinear``'s int routes (K7 -> K2 for int8 o, K9 for W4A4 o).

Sites whose policy is not fusable (W4A4: 4-bit activations; every site in
sim mode) take the unfused chain through ``qlinear`` (K9 for W4A4).

I2V (``model_type == "i2v"``): ``dit_forward`` takes ``y`` (concatenated to
the latents on channels) and ``clip_fea`` (an FP MLP puts its 257 tokens in
front of the text context); cross-attention's one q attends the text and the
image tokens with their own k/v, two K4 launches whose bf16 outputs add.

Map capture (``QuantCtx.attn_map_pool``: calibration, or
``WanT2V.capture_attn_maps`` on a deployed ctx) runs self-attention's plain
chain and collects the pooled post-softmax map of the unscaled q.

Temporal window (``QuantCtx.attn_window``): ``dit_forward`` resolves it
against the latent grid; the plain self-attention paths then run K4's band
mode (``models/attention.py``). Calibration runs dense, and a window does not
compose with attention quantization.

Attention quantization (a quant YAML's ``attn:`` / ``cross_attn:``
sections): under ``attn:`` self-attention leaves K4. In int8 mode q and k
still go through K3, with unscaled tables (the int8 attention applies the
softmax scale itself), into the int8 flash attention (K10a -> K10,
``ops/attn_int8.py``), which takes K3's heads-major output as
[B, S, N, D] views. Sim mode runs plain RMSNorm + RoPE into the simulated
quantizers (``quant/attn.py``, with the layer's reorder table), and so does
calibration (it collects [B, S, N, D] absmaxes and pooled maps). Under
``cross_attn:`` cross-attention runs the simulated quantizers in both modes.

The rope tables, padded to the sequence with the identity and, for K4's q,
scaled by the softmax scale, are built once per ``dit_forward``
(:func:`self_attn_tables`) and shared by every block.

Training (``dit_forward(training=True)``, as ``wanq_tpu``'s): an int8 ctx
becomes ``trainable`` (the differentiable dequant route of ``qlinear``); the
fused producers (K1, K3, the GELU + quant modes) stay off, so every site takes
``qlinear`` and the q/k chain is plain PyTorch; self- and cross-attention run
``attention(..., trainable=True)``: K4's residual mode with K12 / K11 in the
backward on the card (a no-grad forward, such as a distillation teacher's,
stays on the plain K4 launch). A temporal window or an int8 ``attn:`` section
has no backward and raises. ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from wanq_tpu_torch.configs import WanConfig
from wanq_tpu_torch.models.attention import (
    TemporalWindow,
    attention,
    attention_heads_major,
    cross_attention_heads_major,
)
from wanq_tpu_torch.models.rope import (
    pad_tables,
    rope_apply_interleaved,
    rope_tables_interleaved,
)
from wanq_tpu_torch.ops.fused import (
    ln_modulate_quant,
    ln_modulate_quant_static,
)
from wanq_tpu_torch.ops.attn_int8 import attention_int8
from wanq_tpu_torch.ops.rmsnorm_rope import (
    merge_heads,
    rms_rope_heads,
    rms_split_heads,
    split_heads,
)
from wanq_tpu_torch.quant.attn import pooled_attn_map, quantized_attention
from wanq_tpu_torch.quant.qlinear import (
    QuantCtx,
    ffn0_gelu_quant_from_prequant,
    fp_linear,
    int8_fusable,
    int8_static_fusable,
    qlinear,
    resolves_fp,
    w8a8_from_prequant,
)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, eps: float, w=None, b=None) -> torch.Tensor:
    """fp32 LayerNorm, optional affine."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.float() + b.float()
    return y


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 RMSNorm with gain; the output keeps x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def sinusoidal_embedding_1d(dim: int, t: torch.Tensor) -> torch.Tensor:
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32, device=t.device) / half)
    sinusoid = torch.outer(t.float(), freqs)
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _param_tree(cfg: WanConfig, lin, modulation, device) -> Params:
    """The DiT's parameter tree, its weights drawn by ``lin(c_in, c_out,
    scheme)`` and ``modulation(n)`` in wanq_tpu's order."""
    d = cfg.dim

    def ones():
        return torch.ones((d,), device=device)

    params: Params = {
        "patch_embedding": lin(int(np.prod(cfg.patch_size)) * cfg.in_dim, d),
        "text_embedding": {"0": lin(cfg.text_dim, d, "normal02"),
                           "2": lin(d, d, "normal02")},
        "time_embedding": {"0": lin(cfg.freq_dim, d, "normal02"),
                           "2": lin(d, d, "normal02")},
        "time_projection": {"1": lin(d, d * 6)},
        "head": {
            "head": lin(d, int(np.prod(cfg.patch_size)) * cfg.out_dim, "zeros"),
            "modulation": modulation(2),
        },
        "blocks": [],
    }
    if cfg.model_type == "i2v":
        # the CLIP-feature MLP: LN -> Linear -> GELU -> Linear -> LN
        c = cfg.clip_dim
        params["img_emb"] = {"proj": {
            "0": {"w": torch.ones((c,), device=device), "b": torch.zeros((c,), device=device)},
            "1": lin(c, c),
            "3": lin(c, d),
            "4": {"w": ones(), "b": torch.zeros((d,), device=device)},
        }}
    for _ in range(cfg.num_layers):
        block = {
            "self_attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                          "norm_q": ones(), "norm_k": ones()},
            "cross_attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                           "norm_q": ones(), "norm_k": ones()},
            "norm3": ({"w": ones(), "b": torch.zeros((d,), device=device)}
                      if cfg.cross_attn_norm else None),
            "ffn": {"0": lin(d, cfg.ffn_dim), "2": lin(cfg.ffn_dim, d)},
            "modulation": modulation(6),
        }
        if cfg.model_type == "i2v":
            # drawn after the block's other weights, as wanq_tpu draws them
            block["cross_attn"].update(k_img=lin(d, d), v_img=lin(d, d), norm_k_img=ones())
        params["blocks"].append(block)
    return params


def init_params(cfg: WanConfig, seed: int = 0, device="cuda") -> Params:
    """Random init drawn from ``np.random.default_rng(seed)`` on the host in
    the same order as wanq_tpu's init_params, so both packages make the
    same weights from the same seed. The tensors land on ``device``, the
    card unless the caller asks for the CPU."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a).to(device=device, dtype=dt)

    def lin(c_in, c_out, scheme="xavier"):
        if scheme == "xavier":
            bound = math.sqrt(6.0 / (c_in + c_out))
            w = rng.uniform(-bound, bound, (c_in, c_out)).astype(np.float32)
        elif scheme == "normal02":
            w = (rng.standard_normal((c_in, c_out)) * 0.02).astype(np.float32)
        elif scheme == "zeros":
            w = np.zeros((c_in, c_out), np.float32)
        else:
            raise ValueError(scheme)
        return {"w": t(w, cfg.dtype), "b": torch.zeros((c_out,), device=device)}

    def modulation(n):
        return t((rng.standard_normal((1, n, cfg.dim)) / math.sqrt(cfg.dim)).astype(np.float32))

    return _param_tree(cfg, lin, modulation, device)


# the f32 elements init_params_on_device draws at once
_DRAW_BLOCK = 1 << 24


def init_params_on_device(cfg: WanConfig, seed: int = 0, device="cuda") -> Params:
    """Random init drawn on ``device`` by a ``torch.Generator`` seeded with
    ``seed`` (counterpart of wanq_tpu's init_params_on_device): no host copy
    of the weights, so T2V-14B (28.6 GB of bf16) draws in seconds. The
    schemes and the tree are :func:`init_params`' (xavier-uniform, normal x
    0.02, zeros for ``head.head``, modulation N(0, 1) / sqrt(dim)); the bits
    are not, as torch cannot reproduce numpy's or jax.random's streams. Each
    weight is drawn in f32 blocks of rows of at most ``_DRAW_BLOCK``
    elements, each cast to ``cfg.dtype`` at once, so the peak is the model
    plus one such block (64 MB)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def lin(c_in, c_out, scheme="xavier"):
        w = torch.zeros((c_in, c_out), dtype=cfg.dtype, device=device)
        if scheme not in ("xavier", "normal02", "zeros"):
            raise ValueError(scheme)
        rows = max(1, _DRAW_BLOCK // c_out)
        for r in range(0, c_in if scheme != "zeros" else 0, rows):
            block = torch.empty((min(rows, c_in - r), c_out), device=device)
            if scheme == "xavier":
                bound = math.sqrt(6.0 / (c_in + c_out))
                block.uniform_(-bound, bound, generator=gen)
            else:
                block.normal_(0.0, 0.02, generator=gen)
            w[r:r + rows] = block
        return {"w": w, "b": torch.zeros((c_out,), device=device)}

    def modulation(n):
        return torch.randn((1, n, cfg.dim), generator=gen, device=device) / math.sqrt(cfg.dim)

    return _param_tree(cfg, lin, modulation, device)


def linear_layer_names(cfg: WanConfig) -> List[str]:
    """Every quantizable linear path, in reference naming."""
    names = ["text_embedding.0", "text_embedding.2", "time_embedding.0",
             "time_embedding.2", "time_projection.1", "head.head"]
    for i in range(cfg.num_layers):
        for mod in ("self_attn", "cross_attn"):
            for leaf in ("q", "k", "v", "o"):
                names.append(f"blocks.{i}.{mod}.{leaf}")
        if cfg.model_type == "i2v":
            names += [f"blocks.{i}.cross_attn.k_img", f"blocks.{i}.cross_attn.v_img"]
        names.append(f"blocks.{i}.ffn.0")
        names.append(f"blocks.{i}.ffn.2")
    return names


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _rope_tables_on(grid: Tuple[int, int, int], head_dim: int, device: torch.device):
    ca, sb = rope_tables_interleaved(grid, head_dim)
    return (torch.from_numpy(np.array(ca)).to(device),
            torch.from_numpy(np.array(sb)).to(device))


class SelfAttnTables(NamedTuple):
    """K3's rope tables [S, D] for one forward: padded to S with the identity
    (ca = 1, sb = 0), and the same scaled by the softmax scale for K4's q."""

    ca: torch.Tensor
    sb: torch.Tensor
    ca_q: torch.Tensor
    sb_q: torch.Tensor


def self_attn_tables(cos: torch.Tensor, sin: torch.Tensor, valid_len: int, seq_len: int,
                     head_dim: int) -> SelfAttnTables:
    ca, sb = pad_tables(cos, sin, valid_len, seq_len)
    q_scale = 1.0 / math.sqrt(head_dim)
    return SelfAttnTables(ca, sb, ca * q_scale, sb * q_scale)


def patchify(x: torch.Tensor, patch_size: Tuple[int, int, int]) -> torch.Tensor:
    """[B, C, F, H, W] -> [B, L, C*pt*ph*pw] (Conv3d stride == kernel)."""
    b, c, f, h, w = x.shape
    pt, ph, pw = patch_size
    x = x.reshape(b, c, f // pt, pt, h // ph, ph, w // pw, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw)


def unpatchify(x: torch.Tensor, grid: Tuple[int, int, int],
               patch_size: Tuple[int, int, int], out_dim: int) -> torch.Tensor:
    """[B, L, pt*ph*pw*C] -> [B, C, F, H, W]."""
    b = x.shape[0]
    f, h, w = grid
    pt, ph, pw = patch_size
    x = x[:, : f * h * w].reshape(b, f, h, w, pt, ph, pw, out_dim)
    x = torch.einsum("bfhwpqrc->bcfphqwr", x)
    return x.reshape(b, out_dim, f * pt, h * ph, w * pw)


def _o_proj_heads_major(po: Params, y: torch.Tensor, dtype) -> torch.Tensor:
    """FP o-projection of the attention output y [B, N, S, D]. K4 writes y
    seq-major, so the [B, S, N*D] operand is a view, not a merge pass."""
    return fp_linear(po, merge_heads(y), dtype)


def _self_attention(p: Params, name: str, ctx: Optional[QuantCtx],
                    x: Optional[torch.Tensor], cfg: WanConfig, cos: torch.Tensor,
                    sin: torch.Tensor, valid_len: int, dtype,
                    prequant=None, tables: Optional[SelfAttnTables] = None,
                    training: bool = False) -> torch.Tensor:
    """Self-attention sublayer. ``prequant``: (q8, scale, sum) from the
    fused LN+modulate+quant producer, shared by the q/k/v GEMMs; ``tables``:
    K3's tables for this sequence (built here when not given); ``training``:
    the plain q/k chain into the differentiable attention."""
    n, hd = cfg.num_heads, cfg.head_dim
    if prequant is not None:
        q8, s_a, ssum = prequant
        b, s = q8.shape[0], q8.shape[1]
        q = w8a8_from_prequant(ctx, f"{name}.q", p["q"], q8, s_a, ssum, out_dtype=torch.bfloat16)
        k = w8a8_from_prequant(ctx, f"{name}.k", p["k"], q8, s_a, ssum, out_dtype=torch.bfloat16)
        v = w8a8_from_prequant(ctx, f"{name}.v", p["v"], q8, s_a, ssum, out_dtype=torch.bfloat16)
    else:
        b, s, _ = x.shape
        q = qlinear(ctx, f"{name}.q", p["q"], x, dtype).to(dtype)
        k = qlinear(ctx, f"{name}.k", p["k"], x, dtype).to(dtype)
        v = qlinear(ctx, f"{name}.v", p["v"], x, dtype).to(dtype)
    calib = ctx is not None and ctx.mode == "calib"
    # the pooled-map capture (calibration, or WanT2V.capture_attn_maps on a
    # deployed ctx) reads q and k unscaled on the plain chain
    capture = ctx is not None and bool(ctx.attn_map_pool)
    attn_quant = ctx is not None and ctx.attn is not None and ctx.mode in ("int8", "sim")
    # on the plain-attention path the softmax scale folds into q's tables;
    # the quant, calib and capture paths apply their own
    plain_attn = not (attn_quant or calib or capture)
    q_scale = 1.0 / math.sqrt(hd) if plain_attn else 1.0
    # the temporal window, resolved by dit_forward (None = dense); calibration
    # runs dense and attention quant refuses it there
    window = ctx.attn_window if ctx is not None and plain_attn else None

    int8_attn = attn_quant and ctx.mode == "int8"
    if training and int8_attn:
        raise NotImplementedError("the int8 attention (an attn: section in int8 mode) has no "
                                  "backward; train without it or in sim mode")
    if (cfg.qk_norm and hd == 128 and not capture and not training
            and (plain_attn or int8_attn)):
        if tables is None:
            tables = self_attn_tables(cos, sin, valid_len, s, hd)
        if int8_attn:
            # K3 with unscaled tables (K10 applies the softmax scale), then
            # K10a + K10 on [B, S, N, D] views of its heads-major output; the
            # f32 [B, S, N, D] output merges as a view
            qh = rms_rope_heads(q, p["norm_q"], tables.ca, tables.sb, num_heads=n,
                                eps=cfg.eps, out_dtype=q.dtype)
            kh = rms_rope_heads(k, p["norm_k"], tables.ca, tables.sb, num_heads=n,
                                eps=cfg.eps, out_dtype=k.dtype)
            y = attention_int8(qh.transpose(1, 2), kh.transpose(1, 2),
                               v.reshape(b, s, n, hd).to(dtype), k_valid_len=valid_len)
            return qlinear(ctx, f"{name}.o", p["o"], y.reshape(b, s, n * hd), dtype)
        qh = rms_rope_heads(q, p["norm_q"], tables.ca_q, tables.sb_q,
                            num_heads=n, eps=cfg.eps, out_dtype=dtype)
        kh = rms_rope_heads(k, p["norm_k"], tables.ca, tables.sb, num_heads=n, eps=cfg.eps,
                            out_dtype=dtype)
        y = attention_heads_major(qh, kh, split_heads(v.to(dtype), n), k_valid_len=valid_len,
                                  window=window)
        if resolves_fp(ctx, f"{name}.o"):
            return _o_proj_heads_major(p["o"], y, dtype)
        # int o over the merged row, a view of K4's seq-major output: the
        # int8 route's per-token quant (K7) is what wanq_tpu's
        # o_proj_heads_major_int8 computes; W4A4 quantizes per group (K9)
        return qlinear(ctx, f"{name}.o", p["o"], merge_heads(y), dtype)

    if cfg.qk_norm:
        q = rms_norm(q, p["norm_q"], cfg.eps)
        k = rms_norm(k, p["norm_k"], cfg.eps)
    q = q.reshape(b, s, n, hd)
    k = k.reshape(b, s, n, hd)
    v = v.reshape(b, s, n, hd).to(dtype)
    q = rope_apply_interleaved(q, cos, sin, valid_len, scale=q_scale).to(dtype)
    k = rope_apply_interleaved(k, cos, sin, valid_len).to(dtype)
    if calib:
        # per-(head, dim) absmax of the attention inputs
        for tag, tensor in (("q", q), ("k", k), ("v", v)):
            ctx.collect[f"{name}.attn_{tag}"] = tensor.float().abs().amax(dim=(0, 1))
    if capture:
        # pooled post-softmax map (reorder tables, window radii) of the
        # unscaled q: pooled_attn_map applies the softmax scale once
        ctx.collect[f"{name}.attn_map"] = pooled_attn_map(
            q, k, ctx.attn_map_pool, k_valid_len=valid_len, reduce=ctx.attn_map_reduce)
    if int8_attn:
        # K10a + K10 (q/k per 512-token block, v per channel, 127-level
        # probs) behind the plain chain: no qk_norm, or a head dim K3 lacks
        y = attention_int8(q, k, v, k_valid_len=valid_len)
    elif attn_quant:
        y = quantized_attention(q, k, v, ctx.attn, k_valid_len=valid_len,
                                perm=ctx.attn_perms.get(name))
    else:
        y = attention(q, k, v, scale=1.0 if plain_attn else None, k_valid_len=valid_len,
                      window=window, trainable=training)
    return qlinear(ctx, f"{name}.o", p["o"], y.reshape(b, s, n * hd), dtype)


# the CLIP tokens in front of an i2v model's text context
CLIP_TOKENS = 257


def _cross_attention(p: Params, name: str, ctx: Optional[QuantCtx],
                     x: Optional[torch.Tensor], context: torch.Tensor, cfg: WanConfig,
                     dtype, prequant=None, training: bool = False) -> torch.Tensor:
    """Cross-attention sublayer. ``prequant``: (q8, scale, sum) of the
    norm3 output from the fused producer, feeding the int8 q GEMM. For i2v
    the context is [the 257 CLIP tokens; the text tokens]: one q attends
    each part with its own k/v (``k_img`` / ``v_img`` for the image, its k
    through ``norm_k_img`` whether or not ``qk_norm`` is set), and the two
    bf16 outputs add before the o projection."""
    n, hd = cfg.num_heads, cfg.head_dim
    i2v = cfg.model_type == "i2v"
    if i2v:
        context_img, context = context[:, :CLIP_TOKENS], context[:, CLIP_TOKENS:]
    if prequant is not None:
        q8, s_a, ssum = prequant
        b = q8.shape[0]
        q = w8a8_from_prequant(ctx, f"{name}.q", p["q"], q8, s_a, ssum, out_dtype=dtype)
    else:
        b = x.shape[0]
        q = qlinear(ctx, f"{name}.q", p["q"], x, dtype).to(dtype)
    k = qlinear(ctx, f"{name}.k", p["k"], context, dtype).to(dtype)
    v = qlinear(ctx, f"{name}.v", p["v"], context, dtype).to(dtype)
    if cfg.qk_norm:
        k = rms_norm(k, p["norm_k"], cfg.eps)
    k = k.reshape(b, -1, n, hd).to(dtype)
    v = v.reshape(b, -1, n, hd).to(dtype)
    if i2v:
        # the norm takes the f32 projection, as wanq_tpu's does
        k_img = rms_norm(qlinear(ctx, f"{name}.k_img", p["k_img"], context_img, dtype),
                         p["norm_k_img"], cfg.eps).reshape(b, -1, n, hd).to(dtype)
        v_img = qlinear(ctx, f"{name}.v_img", p["v_img"], context_img,
                        dtype).reshape(b, -1, n, hd).to(dtype)
    # a cross_attn section runs the simulated quantizers in int8 mode too:
    # the int8 kernel is for the long self-attention
    quant_attn = (ctx is not None and ctx.cross_attn is not None
                  and ctx.mode in ("sim", "int8"))

    if hd == 128 and not quant_attn and not training:
        qh = (rms_split_heads(q, p["norm_q"], n, eps=cfg.eps, out_dtype=dtype)
              if cfg.qk_norm else split_heads(q.to(dtype), n))
        y = cross_attention_heads_major(qh, k, v)
        if i2v:
            # one K3 q, two K4 launches; both outputs seq-major, so the sum
            # is too and the o projection reads it as a view
            y = y + cross_attention_heads_major(qh, k_img, v_img)
        if resolves_fp(ctx, f"{name}.o"):
            return _o_proj_heads_major(p["o"], y, dtype)
        return qlinear(ctx, f"{name}.o", p["o"], merge_heads(y), dtype)

    if cfg.qk_norm:
        q = rms_norm(q, p["norm_q"], cfg.eps)
    q = q.reshape(b, -1, n, hd).to(dtype)
    y = (quantized_attention(q, k, v, ctx.cross_attn) if quant_attn
         else attention(q, k, v, trainable=training))
    if i2v:
        y = y + attention(q, k_img, v_img, trainable=training)
    return qlinear(ctx, f"{name}.o", p["o"], y.reshape(b, -1, n * hd), dtype)


def block_forward(p: Params, name: str, ctx: Optional[QuantCtx], x: torch.Tensor,
                  e: torch.Tensor, context: torch.Tensor, cfg: WanConfig,
                  cos: torch.Tensor, sin: torch.Tensor, valid_len: int,
                  tables: Optional[SelfAttnTables] = None, training: bool = False
                  ) -> torch.Tensor:
    """One transformer block. x [B, L, C] in the residual dtype; ``tables``:
    the forward's K3 tables (built by the self-attention when not given);
    ``training``: no fused producer, the differentiable attention."""
    dtype = cfg.dtype
    ee = p["modulation"].float() + e.float()
    e0, e1, e2, e3, e4, e5 = [ee[:, i] for i in range(6)]

    qkv_sites = [f"{name}.self_attn.{leaf}" for leaf in ("q", "k", "v")]
    cq_site = f"{name}.cross_attn.q"
    ffn_sites = [f"{name}.ffn.0", f"{name}.ffn.2"]
    # the fused producers have no backward: training takes qlinear at every site
    fused = None if training else ctx
    static_qkv = all(int8_static_fusable(fused, st) for st in qkv_sites)
    cq_static = cfg.cross_attn_norm and int8_static_fusable(fused, cq_site)
    if static_qkv:
        # static-scale producer: plain PyTorch (its kernel is not ported;
        # the W8A8 speed config keeps q/k/v dynamic)
        prequant = ln_modulate_quant_static(
            x, e0, e1, ctx.state[qkv_sites[0]]["delta_a"], eps=cfg.eps)
        y = _self_attention(p["self_attn"], f"{name}.self_attn", ctx, None, cfg,
                            cos, sin, valid_len, dtype, prequant=prequant, tables=tables)
    elif int8_fusable(fused, qkv_sites):
        prequant = ln_modulate_quant(x, e0, e1, eps=cfg.eps)
        y = _self_attention(p["self_attn"], f"{name}.self_attn", ctx, None, cfg,
                            cos, sin, valid_len, dtype, prequant=prequant, tables=tables)
    else:
        xn1 = layer_norm(x, cfg.eps) * (1.0 + e1[:, None, :]) + e0[:, None, :]
        y = _self_attention(p["self_attn"], f"{name}.self_attn", ctx, xn1.to(dtype), cfg,
                            cos, sin, valid_len, dtype, tables=tables, training=training)
    x = (x.float() + y.float() * e2[:, None, :]).to(x.dtype)

    if cq_static or (cfg.cross_attn_norm and int8_fusable(fused, [cq_site])):
        # the affine norm3 maps onto the modulate producer: scale = w - 1, shift = b
        w3 = p["norm3"]["w"].float()
        b3 = p["norm3"]["b"].float()
        bsz = x.shape[0]
        shift3 = b3[None, :].expand(bsz, -1)
        scale3 = (w3 - 1.0)[None, :].expand(bsz, -1)
        if cq_static:
            cq_prequant = ln_modulate_quant_static(
                x, shift3, scale3, ctx.state[cq_site]["delta_a"], eps=cfg.eps)
        else:
            cq_prequant = ln_modulate_quant(x, shift3, scale3, eps=cfg.eps)
        y = _cross_attention(p["cross_attn"], f"{name}.cross_attn", ctx, None, context,
                             cfg, dtype, prequant=cq_prequant)
    else:
        xn3 = (layer_norm(x, cfg.eps, p["norm3"]["w"], p["norm3"]["b"])
               if cfg.cross_attn_norm else x)
        y = _cross_attention(p["cross_attn"], f"{name}.cross_attn", ctx, xn3.to(dtype),
                             context, cfg, dtype, training=training)
    x = (x.float() + y.float()).to(x.dtype)

    if int8_fusable(fused, [ffn_sites[0]], allow_mask=True) and (
            int8_static_fusable(fused, ffn_sites[1])
            or int8_fusable(fused, [ffn_sites[1]], allow_mask=True)):
        h8, s_a, ssum = ln_modulate_quant(
            x, e3, e4, eps=cfg.eps, channel_scale=ctx.state[ffn_sites[0]].get("channel_mask"))
        h8b, s2, sm2 = ffn0_gelu_quant_from_prequant(
            ctx, ffn_sites[0], ffn_sites[1], p["ffn"]["0"], h8, s_a, ssum)
        y = w8a8_from_prequant(ctx, ffn_sites[1], p["ffn"]["2"], h8b, s2, sm2)
    else:
        xn2 = layer_norm(x, cfg.eps) * (1.0 + e4[:, None, :]) + e3[:, None, :]
        h = qlinear(ctx, f"{name}.ffn.0", p["ffn"]["0"], xn2.to(dtype), dtype)
        h = gelu_tanh(h).to(dtype)
        y = qlinear(ctx, f"{name}.ffn.2", p["ffn"]["2"], h, dtype)
    return (x.float() + y.float() * e5[:, None, :]).to(x.dtype)


def head_forward(p: Params, x: torch.Tensor, e: torch.Tensor, cfg: WanConfig,
                 ctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """Output head. e [B, C] time embedding."""
    ee = p["head"]["modulation"].float() + e[:, None, :]
    e0, e1 = ee[:, 0], ee[:, 1]
    xn = layer_norm(x, cfg.eps) * (1.0 + e1[:, None, :]) + e0[:, None, :]
    return qlinear(ctx, "head.head", p["head"]["head"], xn.to(cfg.dtype))


def resolve_window(aw, grid: Tuple[int, int, int], num_heads: int) -> Optional[TemporalWindow]:
    """``QuantCtx.attn_window`` against the latent grid (F, H, W): an int
    radius, a per-head tuple (a negative entry is dense for that head: it
    becomes F, which covers every frame pair; uniform radii collapse to the
    scalar form) or a ready TemporalWindow. None (dense) when every head's
    band covers every frame pair, or for a negative scalar."""
    tpf = grid[1] * grid[2]
    if isinstance(aw, TemporalWindow):
        win = aw
    elif isinstance(aw, (tuple, list)):
        radii = tuple(int(r) for r in aw)
        if len(radii) != num_heads:
            raise ValueError(f"{len(radii)} window radii for {num_heads} heads")
        radii = tuple(grid[0] if r < 0 else r for r in radii)
        if len(set(radii)) == 1:
            win = TemporalWindow(tokens_per_frame=tpf, radius=radii[0])
        else:
            win = TemporalWindow(tokens_per_frame=tpf, radius=max(radii), head_radii=radii)
    else:
        if int(aw) < 0:
            return None
        win = TemporalWindow(tokens_per_frame=tpf, radius=int(aw))
    min_r = min(win.head_radii) if win.head_radii else win.radius
    return None if min_r >= grid[0] - 1 else win


TIME_LAYERS = ("time_embedding.0", "time_embedding.2", "time_projection.1")


def time_embedding(params: Params, cfg: WanConfig, t: torch.Tensor,
                   ctx: Optional[QuantCtx] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The time embedding e [B, C] and the blocks' modulation e0 [B, 6, C]
    of the timesteps t [B]. Where its three linears run FP (every shipped
    config), each row runs on its own, so a row's embedding does not depend
    on the batch it rides in: cuBLAS sums a one-row product in another order
    than a two-row one (~5e-7 relative), and the bf16 residual turns that
    into one-ulp flips in every block, ~6e-3 apart at the output of T2V-1.3B,
    which would set a sequential-CFG forward apart from its row of the
    batched pair."""
    if t.shape[0] > 1 and all(resolves_fp(ctx, name) for name in TIME_LAYERS):
        rows = [time_embedding(params, cfg, t[i:i + 1], ctx) for i in range(t.shape[0])]
        return torch.cat([r[0] for r in rows]), torch.cat([r[1] for r in rows])
    e = sinusoidal_embedding_1d(cfg.freq_dim, t)
    e = qlinear(ctx, "time_embedding.0", params["time_embedding"]["0"], e[:, None, :],
                torch.float32)
    e = F.silu(e)
    e = qlinear(ctx, "time_embedding.2", params["time_embedding"]["2"], e,
                torch.float32)[:, 0]
    e0 = qlinear(ctx, "time_projection.1", params["time_projection"]["1"],
                 F.silu(e)[:, None, :], torch.float32)
    return e, e0.reshape(t.shape[0], 6, cfg.dim)


def img_embedding(params: Params, clip_fea: torch.Tensor, dtype) -> torch.Tensor:
    """The i2v CLIP-feature MLP [B, 257, clip_dim] -> [B, 257, dim]: LN ->
    Linear -> exact GELU -> Linear -> LN, always FP."""
    ip = params["img_emb"]["proj"]
    ci = layer_norm(clip_fea, 1e-5, ip["0"]["w"], ip["0"]["b"]).to(dtype)
    ci = qlinear(None, "img_emb.proj.1", ip["1"], ci, dtype)
    ci = F.gelu(ci).to(dtype)
    ci = qlinear(None, "img_emb.proj.3", ip["3"], ci, dtype)
    return layer_norm(ci, 1e-5, ip["4"]["w"], ip["4"]["b"]).to(dtype)


def dit_forward(params: Params, cfg: WanConfig, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor, seq_len: int, ctx: Optional[QuantCtx] = None,
                clip_fea: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None, remat: bool = False,
                training: bool = False) -> torch.Tensor:
    """Denoising forward. x [B, C_in, F, H, W]; t [B]; context [B, text_len,
    text_dim]. An i2v model also takes ``y`` [B, C_y, F, H, W] (the
    first-frame mask and its VAE latents, concatenated to x on channels) and
    ``clip_fea`` [B, 257, clip_dim] (CLIP features, embedded in front of the
    text context). Returns [B, C_out, F, H, W] float32. ``training``: the
    differentiable routes (an int8 ctx trains as ``trainable``); ``remat``:
    each block is recomputed in the backward instead of keeping its
    activations."""
    if (cfg.model_type == "i2v") != (clip_fea is not None):
        raise ValueError(f"clip_fea is for i2v models only and needed there "
                         f"(model_type {cfg.model_type!r})")
    if training and ctx is not None and ctx.mode == "int8" and not ctx.trainable:
        ctx = dataclasses.replace(ctx, trainable=True)
    if y is not None:
        x = torch.cat([x, y.to(x.dtype)], dim=1)
    dtype = cfg.dtype
    grid = (x.shape[2] // cfg.patch_size[0], x.shape[3] // cfg.patch_size[1],
            x.shape[4] // cfg.patch_size[2])
    if ctx is not None and ctx.attn_window is not None:
        win = resolve_window(ctx.attn_window, grid, cfg.num_heads)
        if win is not None and training:
            raise NotImplementedError("attn_window is inference-only: K4's band mode has no "
                                      "backward (train dense, deploy windowed)")
        if win is not None and ctx.attn is not None and ctx.mode in ("sim", "int8"):
            raise NotImplementedError(
                "attn_window does not compose with attention-map quantization: the "
                "sim materializes the full map and the int8 kernel is dense; window "
                "the plain/int8-GEMM deployment instead (drop the attn: section)")
        # calibration and map capture run dense (window selection needs the
        # full map's mass); collect stays the caller's dict
        dense_pass = ctx.mode == "calib" or bool(ctx.attn_map_pool)
        ctx = dataclasses.replace(ctx, attn_window=None if dense_pass else win,
                                  collect=ctx.collect)
    tokens = patchify(x, cfg.patch_size)
    xq = qlinear(None, "patch_embedding", params["patch_embedding"], tokens.to(dtype), dtype)
    valid_len = xq.shape[1]
    if valid_len > seq_len:
        raise ValueError(f"{valid_len} tokens exceed seq_len {seq_len}")
    if valid_len < seq_len:
        xq = F.pad(xq, (0, 0, 0, seq_len - valid_len))

    e, e0 = time_embedding(params, cfg, t, ctx)

    c = qlinear(ctx, "text_embedding.0", params["text_embedding"]["0"], context.to(dtype), dtype)
    c = gelu_tanh(c).to(dtype)
    c = qlinear(ctx, "text_embedding.2", params["text_embedding"]["2"], c, dtype).to(dtype)
    if clip_fea is not None:
        c = torch.cat([img_embedding(params, clip_fea, dtype), c], dim=1)

    cos, sin = _rope_tables_on(grid, cfg.head_dim, x.device)
    tables = self_attn_tables(cos, sin, valid_len, seq_len, cfg.head_dim)

    xf = xq.to(cfg.res_dtype)
    for i in range(cfg.num_layers):
        args = (params["blocks"][i], f"blocks.{i}", ctx, xf, e0, c, cfg, cos, sin, valid_len)
        kw = {"tables": tables, "training": training}
        if remat:
            # no random draw in a block, so no RNG state to keep for the recompute
            xf = torch.utils.checkpoint.checkpoint(block_forward, *args, use_reentrant=False,
                                                   preserve_rng_state=False, **kw)
        else:
            xf = block_forward(*args, **kw)
    out = head_forward(params, xf, e, cfg, ctx)
    return unpatchify(out.float(), grid, cfg.patch_size, cfg.out_dim)
