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

Temporal window (``QuantCtx.attn_window``): ``dit_forward`` resolves it
against the latent grid; the plain self-attention paths then run K4's band
mode (``models/attention.py``). Calibration runs dense, and a window does not
compose with attention quantization.

Attention quantization (a quant YAML's ``attn:`` / ``cross_attn:``
sections): under ``attn:`` self-attention leaves the fused q/k path (the
softmax scale is not folded into q's rope tables, K3 is skipped) and runs
plain RMSNorm + RoPE, then the int8 flash attention in int8 mode (K10a ->
K10, ``ops/attn_int8.py``) or the simulated quantizers in sim mode
(``quant/attn.py``, with the layer's reorder table). Under ``cross_attn:``
cross-attention runs the simulated quantizers in both modes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def init_params(cfg: WanConfig, seed: int = 0, device="cuda") -> Params:
    """Random init drawn from ``np.random.default_rng(seed)`` on the host in
    the same order as wanq_tpu's init_params, so both packages make the
    same weights from the same seed. The tensors land on ``device``, the
    card unless the caller asks for the CPU."""
    dtype = cfg.dtype
    d = cfg.dim
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
        return {"w": t(w, dtype), "b": torch.zeros((c_out,), device=device)}

    def modulation(n):
        return t((rng.standard_normal((1, n, d)) / math.sqrt(d)).astype(np.float32))

    def ones():
        return torch.ones((d,), device=device)

    if cfg.model_type != "t2v":
        raise NotImplementedError("i2v is not ported yet (ROADMAP Queue 1 item 9)")
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
    for _ in range(cfg.num_layers):
        params["blocks"].append({
            "self_attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                          "norm_q": ones(), "norm_k": ones()},
            "cross_attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                           "norm_q": ones(), "norm_k": ones()},
            "norm3": ({"w": ones(), "b": torch.zeros((d,), device=device)}
                      if cfg.cross_attn_norm else None),
            "ffn": {"0": lin(d, cfg.ffn_dim), "2": lin(cfg.ffn_dim, d)},
            "modulation": modulation(6),
        })
    return params


def linear_layer_names(cfg: WanConfig) -> List[str]:
    """Every quantizable linear path, in reference naming."""
    names = ["text_embedding.0", "text_embedding.2", "time_embedding.0",
             "time_embedding.2", "time_projection.1", "head.head"]
    for i in range(cfg.num_layers):
        for mod in ("self_attn", "cross_attn"):
            for leaf in ("q", "k", "v", "o"):
                names.append(f"blocks.{i}.{mod}.{leaf}")
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
                    prequant=None) -> torch.Tensor:
    """Self-attention sublayer. ``prequant``: (q8, scale, sum) from the
    fused LN+modulate+quant producer, shared by the q/k/v GEMMs."""
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
    attn_quant = ctx is not None and ctx.attn is not None and ctx.mode in ("int8", "sim")
    # on the plain-attention path the softmax scale folds into q's tables;
    # the quant and calib paths apply their own
    plain_attn = not (attn_quant or calib)
    q_scale = 1.0 / math.sqrt(hd) if plain_attn else 1.0
    # the temporal window, resolved by dit_forward (None = dense); calibration
    # runs dense and attention quant refuses it there
    window = ctx.attn_window if ctx is not None and plain_attn else None

    if cfg.qk_norm and plain_attn and hd == 128:
        ca, sb = pad_tables(cos, sin, valid_len, s)
        qh = rms_rope_heads(q, p["norm_q"], ca * q_scale, sb * q_scale,
                            num_heads=n, eps=cfg.eps, out_dtype=dtype)
        kh = rms_rope_heads(k, p["norm_k"], ca, sb, num_heads=n, eps=cfg.eps,
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
        if ctx.attn_map_pool:
            # pooled post-softmax map: reorder tables, window radii
            ctx.collect[f"{name}.attn_map"] = pooled_attn_map(
                q, k, ctx.attn_map_pool, k_valid_len=valid_len, reduce=ctx.attn_map_reduce)
    if attn_quant and ctx.mode == "int8":
        # hardware path: K10a + K10 (q/k per 512-token block, v per channel,
        # 127-level probs); the f32 [B, S, N, D] output merges as a view
        y = attention_int8(q, k, v, k_valid_len=valid_len)
    elif attn_quant:
        y = quantized_attention(q, k, v, ctx.attn, k_valid_len=valid_len,
                                perm=ctx.attn_perms.get(name))
    else:
        y = attention(q, k, v, scale=1.0 if plain_attn else None, k_valid_len=valid_len,
                      window=window)
    return qlinear(ctx, f"{name}.o", p["o"], y.reshape(b, s, n * hd), dtype)


def _cross_attention(p: Params, name: str, ctx: Optional[QuantCtx],
                     x: Optional[torch.Tensor], context: torch.Tensor, cfg: WanConfig,
                     dtype, prequant=None) -> torch.Tensor:
    """Cross-attention sublayer (t2v). ``prequant``: (q8, scale, sum) of
    the norm3 output from the fused producer, feeding the int8 q GEMM."""
    n, hd = cfg.num_heads, cfg.head_dim
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
    # a cross_attn section runs the simulated quantizers in int8 mode too:
    # the int8 kernel is for the long self-attention
    quant_attn = (ctx is not None and ctx.cross_attn is not None
                  and ctx.mode in ("sim", "int8"))

    if hd == 128 and not quant_attn:
        qh = (rms_split_heads(q, p["norm_q"], n, eps=cfg.eps, out_dtype=dtype)
              if cfg.qk_norm else split_heads(q.to(dtype), n))
        y = cross_attention_heads_major(qh, k, v)
        if resolves_fp(ctx, f"{name}.o"):
            return _o_proj_heads_major(p["o"], y, dtype)
        return qlinear(ctx, f"{name}.o", p["o"], merge_heads(y), dtype)

    if cfg.qk_norm:
        q = rms_norm(q, p["norm_q"], cfg.eps)
    q = q.reshape(b, -1, n, hd).to(dtype)
    y = quantized_attention(q, k, v, ctx.cross_attn) if quant_attn else attention(q, k, v)
    return qlinear(ctx, f"{name}.o", p["o"], y.reshape(b, -1, n * hd), dtype)


def block_forward(p: Params, name: str, ctx: Optional[QuantCtx], x: torch.Tensor,
                  e: torch.Tensor, context: torch.Tensor, cfg: WanConfig,
                  cos: torch.Tensor, sin: torch.Tensor, valid_len: int) -> torch.Tensor:
    """One transformer block. x [B, L, C] in the residual dtype."""
    dtype = cfg.dtype
    ee = p["modulation"].float() + e.float()
    e0, e1, e2, e3, e4, e5 = [ee[:, i] for i in range(6)]

    qkv_sites = [f"{name}.self_attn.{leaf}" for leaf in ("q", "k", "v")]
    cq_site = f"{name}.cross_attn.q"
    static_qkv = all(int8_static_fusable(ctx, st) for st in qkv_sites)
    cq_static = cfg.cross_attn_norm and int8_static_fusable(ctx, cq_site)
    if static_qkv:
        # static-scale producer: plain PyTorch (its kernel is not ported;
        # the W8A8 speed config keeps q/k/v dynamic)
        prequant = ln_modulate_quant_static(
            x, e0, e1, ctx.state[qkv_sites[0]]["delta_a"], eps=cfg.eps)
        y = _self_attention(p["self_attn"], f"{name}.self_attn", ctx, None, cfg,
                            cos, sin, valid_len, dtype, prequant=prequant)
    elif int8_fusable(ctx, qkv_sites):
        prequant = ln_modulate_quant(x, e0, e1, eps=cfg.eps)
        y = _self_attention(p["self_attn"], f"{name}.self_attn", ctx, None, cfg,
                            cos, sin, valid_len, dtype, prequant=prequant)
    else:
        xn1 = layer_norm(x, cfg.eps) * (1.0 + e1[:, None, :]) + e0[:, None, :]
        y = _self_attention(p["self_attn"], f"{name}.self_attn", ctx, xn1.to(dtype), cfg,
                            cos, sin, valid_len, dtype)
    x = (x.float() + y.float() * e2[:, None, :]).to(x.dtype)

    if cq_static or (cfg.cross_attn_norm and int8_fusable(ctx, [cq_site])):
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
                             context, cfg, dtype)
    x = (x.float() + y.float()).to(x.dtype)

    ffn_sites = [f"{name}.ffn.0", f"{name}.ffn.2"]
    if int8_fusable(ctx, [ffn_sites[0]], allow_mask=True) and (
            int8_static_fusable(ctx, ffn_sites[1])
            or int8_fusable(ctx, [ffn_sites[1]], allow_mask=True)):
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


def dit_forward(params: Params, cfg: WanConfig, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor, seq_len: int,
                ctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """Denoising forward. x [B, C_in, F, H, W]; t [B]; context [B, text_len,
    text_dim]. Returns [B, C_out, F, H, W] float32."""
    if cfg.model_type != "t2v":
        raise NotImplementedError("i2v is not ported yet (ROADMAP Queue 1 item 9)")
    dtype = cfg.dtype
    b = x.shape[0]
    grid = (x.shape[2] // cfg.patch_size[0], x.shape[3] // cfg.patch_size[1],
            x.shape[4] // cfg.patch_size[2])
    if ctx is not None and ctx.attn_window is not None:
        win = resolve_window(ctx.attn_window, grid, cfg.num_heads)
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

    e = sinusoidal_embedding_1d(cfg.freq_dim, t)
    e = qlinear(ctx, "time_embedding.0", params["time_embedding"]["0"], e[:, None, :],
                torch.float32)
    e = F.silu(e)
    e = qlinear(ctx, "time_embedding.2", params["time_embedding"]["2"], e,
                torch.float32)[:, 0]
    e0 = qlinear(ctx, "time_projection.1", params["time_projection"]["1"],
                 F.silu(e)[:, None, :], torch.float32)
    e0 = e0.reshape(b, 6, cfg.dim)

    c = qlinear(ctx, "text_embedding.0", params["text_embedding"]["0"], context.to(dtype), dtype)
    c = gelu_tanh(c).to(dtype)
    c = qlinear(ctx, "text_embedding.2", params["text_embedding"]["2"], c, dtype).to(dtype)

    cos, sin = _rope_tables_on(grid, cfg.head_dim, x.device)

    xf = xq.to(cfg.res_dtype)
    for i in range(cfg.num_layers):
        xf = block_forward(params["blocks"][i], f"blocks.{i}", ctx, xf, e0, c, cfg,
                           cos, sin, valid_len)
    out = head_forward(params, xf, e, cfg, ctx)
    return unpatchify(out.float(), grid, cfg.patch_size, cfg.out_dim)
