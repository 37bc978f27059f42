"""umT5 text encoder in PyTorch (counterpart of wanq_tpu/models/t5.py).

The reference's T5: T5LayerNorm (RMS, no mean subtraction), unscaled
attention with an additive relative-position bias, a gated-GELU FFN,
per-layer relative embeddings (umT5: shared_pos=False), the encoder,
decoder and full-model assemblies, and the T5EncoderModel wrapper.

Params are nested dicts with the reference's module names (token_embedding,
blocks.N.{norm1, attn.{q,k,v,o}, pos_embedding.embedding, norm2,
ffn.{gate.0, fc1, fc2}}, norm) and linear ``w`` [C_in, C_out], as in
wanq_tpu. Every linear multiplies in f32 over operands rounded to the
param dtype (wanq_tpu's ``jnp.dot(..., preferred_element_type=f32)``): the
products of bf16 values are exact in f32, so only the sum order differs.
Dropout is off (inference only). No module here holds a kernel of the port.

Under ``--t5_fsdp`` (a ShardingPlan, ``parallel/sharding.py``) each rank
stores the encoder as ``wanq_tpu``'s ``shard_t5_params`` places it over
``fsdp``: linear weights split on their output dim, gathered a block at a
time at use; the token embedding split on its vocab, looked up where it lies
and summed over the fsdp group (one rank holds each id, so the sum is exact).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24  # encoder layers
    decoder_layers: int = 24
    num_buckets: int = 32
    shared_pos: bool = False
    param_dtype: str = "bfloat16"

    @property
    def head_dim(self):
        return self.dim_attn // self.num_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


UMT5_XXL = T5Config()


def tiny_t5_config(**overrides) -> T5Config:
    base = dict(vocab_size=128, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                num_layers=2, num_buckets=8, param_dtype="float32")
    base.update(overrides)
    return T5Config(**base)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def t5_layer_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm without mean subtraction."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (w.float() * y).to(x.dtype)


def t5_gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh GELU."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf ** 3)))
    return y.to(x.dtype)


def relative_position_bucket(rel_pos: np.ndarray, num_buckets: int, bidirectional: bool,
                             max_dist: int = 128) -> np.ndarray:
    """The reference's T5RelativeEmbedding._relative_position_bucket, on the
    host (the tables are built once per sequence length)."""
    if bidirectional:
        nb = num_buckets // 2
        rel_buckets = (rel_pos > 0).astype(np.int64) * nb
        rel_pos = np.abs(rel_pos)
    else:
        nb = num_buckets
        rel_buckets = np.zeros_like(rel_pos)
        rel_pos = -np.minimum(rel_pos, 0)
    max_exact = nb // 2
    # entries below max_exact take the exact branch, so clamping the log's
    # argument to >= 1 changes no selected value and keeps log(0) out
    safe = np.maximum(rel_pos, 1).astype(np.float64)
    rel_large = max_exact + (np.log(safe / max_exact) / math.log(max_dist / max_exact)
                             * (nb - max_exact)).astype(np.int64)
    rel_large = np.minimum(rel_large, nb - 1)
    return rel_buckets + np.where(rel_pos < max_exact, rel_pos, rel_large)


def rel_pos_bias(emb: torch.Tensor, lq: int, lk: int, num_buckets: int,
                 bidirectional: bool) -> torch.Tensor:
    """[1, N, Lq, Lk] additive bias (f32)."""
    rel = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    buckets = torch.from_numpy(relative_position_bucket(rel, num_buckets, bidirectional))
    bias = emb[buckets.to(emb.device)]  # [Lq, Lk, N]
    return bias.permute(2, 0, 1)[None].float()


def _dot(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x @ w in f32 over operands rounded to ``dtype``."""
    return torch.matmul(x.to(dtype).float(), w.to(dtype).float())


def _attention(p: Params, cfg: T5Config, x, context=None, mask=None, pos_bias=None):
    """Unscaled T5 attention with an additive bias."""
    context = x if context is None else context
    b = x.shape[0]
    n, c = cfg.num_heads, cfg.head_dim
    dtype = cfg.dtype
    q = _dot(x, p["q"]["w"], dtype).reshape(b, -1, n, c)
    k = _dot(context, p["k"]["w"], dtype).reshape(b, -1, n, c)
    v = _dot(context, p["v"]["w"], dtype).reshape(b, -1, n, c)
    attn = torch.einsum("binc,bjnc->bnij", q, k)
    if pos_bias is not None:
        attn = attn + pos_bias
    if mask is not None:
        m = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None, :, :]
        attn = attn.masked_fill(m == 0, torch.finfo(torch.float32).min)
    attn = torch.softmax(attn, dim=-1)
    y = torch.einsum("bnij,bjnc->binc", attn.to(dtype), v.to(dtype))
    return _dot(y.reshape(b, -1, n * c), p["o"]["w"], dtype)


def _ffn(p: Params, cfg: T5Config, x):
    """Gated-GELU FFN."""
    dtype = cfg.dtype
    gate = t5_gelu(_dot(x, p["gate"]["0"]["w"], dtype))
    h = (_dot(x, p["fc1"]["w"], dtype) * gate).to(dtype)
    return _dot(h, p["fc2"]["w"], dtype)


def decoder_forward(params: Params, cfg: T5Config, ids: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    encoder_states: Optional[torch.Tensor] = None,
                    encoder_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T5Decoder: causal self-attention with the unidirectional bias,
    cross-attention over the encoder states, gated-GELU FFN. ids: [B, S] ->
    [B, S, dim]. No Wan pipeline runs it (the DiT reads encoder states)."""
    s = ids.shape[1]
    x = params["token_embedding"][ids].float()
    causal = torch.tril(torch.ones((s, s), device=x.device))[None]
    m3 = causal if mask is None else causal * mask.float()[:, None, :]
    for i in range(cfg.decoder_layers):
        bp = params["blocks"][i]
        emb = (params["pos_embedding"] if cfg.shared_pos else bp["pos_embedding"])["embedding"]
        bias = rel_pos_bias(emb, s, s, cfg.num_buckets, False)
        h = t5_layer_norm(x, bp["norm1"]["w"])
        x = x + _attention(bp["self_attn"], cfg, h, mask=m3, pos_bias=bias)
        h = t5_layer_norm(x, bp["norm2"]["w"])
        x = x + _attention(bp["cross_attn"], cfg, h, context=encoder_states, mask=encoder_mask)
        h = t5_layer_norm(x, bp["norm3"]["w"])
        x = x + _ffn(bp["ffn"], cfg, h)
    return t5_layer_norm(x, params["norm"]["w"]).float()


def _sharded_embedding(emb, ids: torch.Tensor, plan) -> torch.Tensor:
    """The rows ``ids`` of a token embedding stored split on its vocab over
    the plan's fsdp group (a sharding.Shard), in f32: each rank looks up the
    ids it holds, zeros elsewhere, and the group sums."""
    import torch.distributed as dist

    rows = emb.local.shape[0]
    lo = plan.mesh.index("fsdp") * rows
    mine = (ids >= lo) & (ids < lo + rows)
    x = emb.local[(ids - lo).clamp(0, rows - 1)].float() * mine[..., None]
    group = plan.mesh.group("fsdp")
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def encoder_forward(params: Params, cfg: T5Config, ids: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, plan=None) -> torch.Tensor:
    """T5Encoder. ids: [B, L] -> [B, L, dim] (f32). ``plan``: the params are
    this rank's storage of ``parallel.sharding.shard_t5_params``."""
    emb = params["token_embedding"]
    if plan is None or torch.is_tensor(emb):  # a vocab fsdp does not divide: replicated
        x = emb[ids].float()
    else:
        x = _sharded_embedding(emb, ids, plan)
        params = dict(plan.gather_weights(
            {k: v for k, v in params.items() if k not in ("blocks", "token_embedding")},
            slot="t5_top"), blocks=params["blocks"])
    lq = ids.shape[1]
    for i in range(cfg.num_layers):
        bp = params["blocks"][i]
        if plan is not None:
            bp = plan.gather_weights(bp, slot="t5")
        emb = (params["pos_embedding"] if cfg.shared_pos else bp["pos_embedding"])["embedding"]
        bias = rel_pos_bias(emb, lq, lq, cfg.num_buckets, True)
        h = t5_layer_norm(x, bp["norm1"]["w"])
        x = x + _attention(bp["attn"], cfg, h, mask=mask, pos_bias=bias)
        h = t5_layer_norm(x, bp["norm2"]["w"])
        x = x + _ffn(bp["ffn"], cfg, h)
    return t5_layer_norm(x, params["norm"]["w"]).float()


def t5_model_forward(params: Params, cfg: T5Config, encoder_ids: torch.Tensor,
                     encoder_mask: Optional[torch.Tensor], decoder_ids: torch.Tensor,
                     decoder_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T5Model: encode, decode, vocab head. Returns logits [B, S_dec, vocab]."""
    def view(part):
        return {"token_embedding": params["token_embedding"],
                "blocks": params[part]["blocks"], "norm": params[part]["norm"]}

    enc = encoder_forward(view("encoder"), cfg, encoder_ids, encoder_mask)
    dec = decoder_forward(view("decoder"), cfg, decoder_ids, decoder_mask,
                          encoder_states=enc, encoder_mask=encoder_mask)
    return _dot(dec, params["head"]["w"], cfg.dtype)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _param_tree(cfg: T5Config, lin, pos, token_embedding, device, encoder_only=True,
                head=None) -> Params:
    """The encoder's (or the full model's) tree, its weights drawn by
    ``lin(c_in, c_out, std)``, ``pos()`` and ``token_embedding()`` in
    wanq_tpu's order."""
    def ones():
        return {"w": torch.ones((cfg.dim,), device=device)}

    def attn():
        return {"q": lin(cfg.dim, cfg.dim_attn, (cfg.dim * cfg.dim_attn) ** -0.5),
                "k": lin(cfg.dim, cfg.dim_attn, cfg.dim ** -0.5),
                "v": lin(cfg.dim, cfg.dim_attn, cfg.dim ** -0.5),
                "o": lin(cfg.dim_attn, cfg.dim, (cfg.num_heads * cfg.head_dim) ** -0.5)}

    def block():
        return {"norm1": ones(), "attn": attn(), "norm2": ones(),
                "ffn": {"gate": {"0": lin(cfg.dim, cfg.dim_ffn, cfg.dim ** -0.5)},
                        "fc1": lin(cfg.dim, cfg.dim_ffn, cfg.dim ** -0.5),
                        "fc2": lin(cfg.dim_ffn, cfg.dim, cfg.dim_ffn ** -0.5)},
                "pos_embedding": {"embedding": pos()}}

    def dec_block():
        b = block()
        return {"norm1": b["norm1"], "self_attn": b["attn"], "norm2": ones(),
                "cross_attn": attn(), "norm3": b["norm2"], "ffn": b["ffn"],
                "pos_embedding": {"embedding": pos()}}

    emb = token_embedding()
    if encoder_only:
        return {"token_embedding": emb, "blocks": [block() for _ in range(cfg.num_layers)],
                "norm": ones()}
    return {"token_embedding": emb,
            "encoder": {"blocks": [block() for _ in range(cfg.num_layers)], "norm": ones()},
            "decoder": {"blocks": [dec_block() for _ in range(cfg.decoder_layers)],
                        "norm": ones()},
            "head": head()}


def init_t5_params(cfg: T5Config, seed: int = 0, encoder_only: bool = True,
                   device="cuda") -> Params:
    """Random init (the reference's init_weights) drawn on the host from
    ``np.random.default_rng(seed)`` in wanq_tpu's order, so both packages
    make the same weights from one seed."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)

    def lin(c_in, c_out, std):
        return {"w": t(rng.standard_normal((c_in, c_out)) * std, cfg.dtype)}

    def pos():
        return t(rng.standard_normal((cfg.num_buckets, cfg.num_heads))
                 * (2 * cfg.num_buckets * cfg.num_heads) ** -0.5)

    return _param_tree(
        cfg, lin, pos, lambda: t(rng.standard_normal((cfg.vocab_size, cfg.dim)), cfg.dtype),
        device, encoder_only,
        head=lambda: {"w": t(rng.standard_normal((cfg.dim, cfg.vocab_size)) * cfg.dim ** -0.5,
                             cfg.dtype)})


# the f32 elements init_t5_params_on_device draws at once
_DRAW_BLOCK = 1 << 24


def init_t5_params_on_device(cfg: T5Config, seed: int = 0, device="cuda") -> Params:
    """Encoder-only random init drawn on ``device`` by a ``torch.Generator``
    seeded with ``seed``: the structure and stds of :func:`init_t5_params`,
    not its bits, and no host copy (umT5-XXL's 5.68 B parameters are 11.4 GB
    in bf16). Each weight is drawn in f32 blocks of rows of at most
    ``_DRAW_BLOCK`` elements, each cast to the param dtype at once."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(rows, cols, std, dtype):
        w = torch.empty((rows, cols), dtype=dtype, device=device)
        step = max(1, _DRAW_BLOCK // cols)
        for r in range(0, rows, step):
            block = torch.empty((min(step, rows - r), cols), device=device)
            w[r:r + step] = block.normal_(0.0, std, generator=gen)
        return w

    return _param_tree(
        cfg, lambda c_in, c_out, std: {"w": normal(c_in, c_out, std, cfg.dtype)},
        lambda: normal(cfg.num_buckets, cfg.num_heads,
                       (2 * cfg.num_buckets * cfg.num_heads) ** -0.5, torch.float32),
        lambda: normal(cfg.vocab_size, cfg.dim, 1.0, cfg.dtype), device)


def convert_t5_state_dict(sd: Dict[str, torch.Tensor], dtype=torch.bfloat16,
                          device="cuda", plan=None) -> Params:
    """The reference's models_t5_umt5-xxl-enc-bf16.pth state dict -> params,
    one tensor at a time onto ``device``: linear weights transposed to
    [C_in, C_out] in ``dtype``, norms and relative embeddings f32. Under
    ``plan`` (--t5_fsdp) each tensor is cut to this rank's fsdp slice
    (``parallel.sharding.t5_leaf_sharding``) where ``sd`` lies (the host, for
    the mmap'd checkpoint) and only the slice moves to ``device``; the slices
    are packed as ``shard_t5_params`` packs them."""
    params: Params = {"blocks": []}
    if plan is not None:
        from wanq_tpu_torch.parallel.sharding import pack_t5_params, slice_leaf, t5_leaf_sharding

        index = plan.mesh.index("fsdp")

    def put(v, dt, transpose=False, leaf="w"):  # leaf: its name in the param tree
        v = v.t() if transpose else v  # a view: nothing is copied yet
        if plan is not None:
            v = slice_leaf(v, t5_leaf_sharding(plan.mesh, leaf, v.dim(), tuple(v.shape)), index)
            if not torch.is_tensor(v):  # a Shard: this rank's slice alone moves
                v.local = v.local.to(device=device, dtype=dt)
                return v
        return v.to(device=device, dtype=dt).contiguous()

    def block(i):
        while len(params["blocks"]) <= i:
            params["blocks"].append({})
        return params["blocks"][i]

    for key, val in sd.items():
        m = re.match(r"blocks\.(\d+)\.(.+)", key)
        if key == "token_embedding.weight":
            params["token_embedding"] = put(val, dtype, leaf="token_embedding")
        elif key == "norm.weight":
            params["norm"] = {"w": put(val, torch.float32)}
        elif key == "pos_embedding.embedding.weight":
            params["pos_embedding"] = {"embedding": put(val, torch.float32, leaf="embedding")}
        elif m:
            blk, sub = block(int(m.group(1))), m.group(2)
            if sub in ("norm1.weight", "norm2.weight"):
                blk[sub.split(".")[0]] = {"w": put(val, torch.float32)}
            elif sub.startswith("attn."):
                blk.setdefault("attn", {})[sub.split(".")[1]] = {"w": put(val, dtype, True)}
            elif sub == "pos_embedding.embedding.weight":
                blk["pos_embedding"] = {"embedding": put(val, torch.float32,
                                                         leaf="embedding")}
            elif sub == "ffn.gate.0.weight":
                blk.setdefault("ffn", {}).setdefault("gate", {})["0"] = {
                    "w": put(val, dtype, True)}
            elif sub in ("ffn.fc1.weight", "ffn.fc2.weight"):
                blk.setdefault("ffn", {})[sub.split(".")[1]] = {"w": put(val, dtype, True)}
            else:
                raise KeyError(f"unexpected T5 key {key}")
        else:
            raise KeyError(f"unexpected T5 key {key}")
    return params if plan is None else pack_t5_params(params)


class T5EncoderModel:
    """The reference's T5EncoderModel: tokenize, encode, zero the padding.
    Returns [B, text_len, dim] float32 (the reference trims each sample to
    its length and the DiT pads it again: the same states).

    The tokenizer is built on the first call with text; ``encode_ids``
    takes token ids and their mask directly. The weights live on
    ``device``, the card unless the caller asks for the CPU."""

    def __init__(self, text_len: int, checkpoint_path: Optional[str] = None,
                 tokenizer_path: str = "google/umt5-xxl", cfg: T5Config = UMT5_XXL,
                 seed: int = 0, device="cuda", params: Optional[Params] = None,
                 plan=None):
        self.text_len = text_len
        self.cfg = cfg
        self.device = torch.device(device)
        self.tokenizer_path = tokenizer_path
        self.tokenizer = None
        self.plan = plan
        if params is None and checkpoint_path:
            # under plan each rank's slices are cut on the host as they are read
            sd = torch.load(checkpoint_path, map_location="cpu", mmap=True, weights_only=True)
            params = convert_t5_state_dict(sd, dtype=cfg.dtype, device=self.device, plan=plan)
        else:
            if params is None:
                params = init_t5_params(cfg, seed=seed, device=self.device)
            if plan is not None:
                from wanq_tpu_torch.parallel.sharding import shard_t5_params

                params = shard_t5_params(params, plan)
        self.params = params

    @torch.no_grad()
    def encode_ids(self, ids, mask) -> torch.Tensor:
        """ids, mask: [B, L] -> states [B, L, dim] (f32), zero where mask is 0."""
        ids = torch.as_tensor(np.asarray(ids), device=self.device).long()
        mask = torch.as_tensor(np.asarray(mask), device=self.device)
        context = encoder_forward(self.params, self.cfg, ids, mask, plan=self.plan)
        return context * mask[:, :, None].to(context.dtype)

    def __call__(self, texts) -> torch.Tensor:
        if self.tokenizer is None:
            from wanq_tpu_torch.models.tokenizers import HuggingfaceTokenizer

            self.tokenizer = HuggingfaceTokenizer(name=self.tokenizer_path,
                                                  seq_len=self.text_len, clean="whitespace")
        ids, mask = self.tokenizer(texts, return_mask=True, add_special_tokens=True)
        return self.encode_ids(ids, mask)


def encode_prompts(ckpt_dir: str, wan_cfg, prompts, neg_prompts, on_cpu: bool = False,
                   device="cuda", plan=None):
    """CLI hook: T5-encode the positive and negative prompts with the
    encoder of a Wan checkpoint dir. Returns two [B, text_len, dim] numpy
    arrays. ``on_cpu`` (the reference's --t5_cpu) keeps the encoder on the
    host; either way it is freed before returning, so the DiT gets the
    card's memory back. ``plan`` (--t5_fsdp): the encoder is stored over its
    fsdp ranks (every rank of the plan calls this)."""
    enc = T5EncoderModel(wan_cfg.text_len,
                         checkpoint_path=os.path.join(ckpt_dir, wan_cfg.t5_checkpoint),
                         tokenizer_path=wan_cfg.t5_tokenizer,
                         device="cpu" if on_cpu else device, plan=plan)
    out = enc(prompts).cpu().numpy(), enc(neg_prompts).cpu().numpy()
    del enc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out
