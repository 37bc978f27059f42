"""K3 (RMSNorm + RoPE + heads) and K7 (GELU + int8 quant + row sums) of the
port against wanq_tpu on the CPU, on the same numpy inputs, and the int8
attention path's route through K3.

On CPU tensors every kernel wrapper runs its plain PyTorch version; the CUDA
kernels are held against those on the card (tests/test_torch_cuda.py).

Tolerances. The int8-attention self-attention sublayer: K3's q and k equal
wanq_tpu's ``rope_apply_interleaved(rms_norm(.))`` chain on the same input
bit for bit (the same f32 steps, rounded to bf16 after the norm and after
the rope); the sublayer's output within atol 4/127 of wanq_tpu's
(``tests/test_torch_attn.py``'s limit between the blocked and the global-max
int8 attention; at S = 40 both are one 512-block, and the q/k/v projections
sum in another order, which flips a bf16 rounding now and then). K3's plain
version within one bf16 ulp of the Pallas kernel in interpret mode (the f32
sum of squares runs in another order). K7's plain version: codes within one
unit on <= 0.1% of elements (XLA's and PyTorch's tanh may differ in the last
bit), scales rtol 1e-6, sums rtol 1e-6 on rows whose codes agree. The
hoisted rope tables: the forward equal to the per-block tables bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.models import dit as jdit
from wanq_tpu.models import rope as jrope
from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.ops import fused as jfused
from wanq_tpu.ops import rmsnorm_rope as jrr
from wanq_tpu.quant import attn as jattn
from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.ops import fused as tfused
from wanq_tpu_torch.ops import rmsnorm_rope as trr
from wanq_tpu_torch.quant import attn as tattn
from wanq_tpu_torch.quant.qlinear import QuantCtx

SMALL = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
             freq_dim=64, param_dtype="bfloat16", residual_dtype="bfloat16")
SECTION = {"qk": {"n_bits": 8, "sym": True}, "v": {"n_bits": 8, "sym": True},
           "attn_map": {"n_bits": 8, "sym": True, "group": "row"}}
GRID, S, VALID = (2, 3, 6), 40, 36  # 36 tokens padded to 40


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_one_bf16_ulp(got: np.ndarray, want: np.ndarray) -> bool:
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    return bool(np.all(np.abs(got - want) <= np.exp2(np.floor(np.log2(mag)) - 7)))


def _sublayer(rng):
    """Block 0's self-attention parameters of the small config (head dim 128)
    in both packages, its input [2, 40, 256] bf16 and the rope tables."""
    cfg_t, cfg_j = tiny_config(**SMALL), jax_tiny_config(**SMALL)
    pt = tdit.init_params(cfg_t, 3, device="cpu")["blocks"][0]["self_attn"]
    pt["norm_q"] = torch.from_numpy(rng.uniform(0.5, 1.5, 256).astype(np.float32))
    pt["norm_k"] = torch.from_numpy(rng.uniform(0.5, 1.5, 256).astype(np.float32))

    def to_jax(t):
        return {k: to_jax(v) for k, v in t.items()} if isinstance(t, dict) else \
            jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                                  else jnp.float32)

    pj = to_jax(pt)
    x = torch.from_numpy(rng.normal(size=(2, S, 256)).astype(np.float32)).bfloat16()
    ca, sb = jrope.rope_tables_interleaved(GRID, 128)
    return cfg_t, cfg_j, pt, pj, x, (torch.from_numpy(np.array(ca)), torch.from_numpy(np.array(sb)))


def test_int8_attention_self_attention_runs_k3_and_matches_jax(rng, monkeypatch):
    """Under an attn section in int8 mode the port's self-attention runs K3
    (its plain version here) on q and k: each equals wanq_tpu's unfused
    rms_norm -> rope_apply_interleaved chain on the same input bit for bit,
    attention_int8 gets [B, S, N, D] views of K3's outputs, and the sublayer
    matches wanq_tpu's _self_attention."""
    cfg_t, cfg_j, pt, pj, x, (cos, sin) = _sublayer(rng)
    tctx = QuantCtx(mode="int8", attn=tattn.AttnQuantCfg.from_dict(SECTION))
    jctx = JaxQuantCtx(mode="int8", attn=jattn.AttnQuantCfg.from_dict(SECTION))
    k3, attn_in = [], []
    real_k3, real_attn = tdit.rms_rope_heads, tdit.attention_int8

    def k3_rec(xx, w, ca, sb, **kw):
        k3.append((xx, w, real_k3(xx, w, ca, sb, **kw)))
        return k3[-1][2]

    def attn_rec(q, k, v, **kw):
        attn_in.append((q, k))
        return real_attn(q, k, v, **kw)

    monkeypatch.setattr(tdit, "rms_rope_heads", k3_rec)
    monkeypatch.setattr(tdit, "attention_int8", attn_rec)
    got = tdit._self_attention(pt, "blocks.0.self_attn", tctx, x, cfg_t, cos, sin, VALID,
                               torch.bfloat16)
    assert len(k3) == 2 and len(attn_in) == 1
    for (xx, w, out), seen in zip(k3, attn_in[0]):
        assert out.shape == (2, 2, S, 128) and seen.shape == (2, S, 2, 128)
        assert seen.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()
        chain = jrope.rope_apply_interleaved(
            jdit.rms_norm(jnp.asarray(xx.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(w.numpy()), cfg_j.eps).reshape(2, S, 2, 128),
            jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()), VALID).astype(jnp.bfloat16)
        np.testing.assert_array_equal(_np(seen), _np(chain))

    want = jdit._self_attention(pj, "blocks.0.self_attn", jctx,
                                jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), cfg_j,
                                jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()), VALID,
                                jnp.bfloat16)
    assert got.shape == (2, S, 256) and np.abs(_np(want)).max() > 0.1
    np.testing.assert_allclose(_np(got), _np(want), atol=4 / 127)


@pytest.mark.parametrize("mode", ["int8", "calib", "fp"])
def test_self_attention_k3_calls_and_their_tables(rng, monkeypatch, mode):
    """int8 mode with an attn section calls K3 for q and k with the same
    unscaled tables (max |ca| 1, identity past the valid tokens); calibration
    keeps the plain chain and never calls it; the plain-attention path (fp)
    calls it with q's tables scaled by 1/sqrt(128) and k's unscaled."""
    cfg_t, _, pt, _, x, (cos, sin) = _sublayer(rng)
    ctx = {"int8": QuantCtx(mode="int8", attn=tattn.AttnQuantCfg.from_dict(SECTION)),
           "calib": QuantCtx(mode="calib"), "fp": None}[mode]
    tables = []
    real_k3 = tdit.rms_rope_heads

    def k3_rec(xx, w, ca, sb, **kw):
        tables.append((ca, sb))
        return real_k3(xx, w, ca, sb, **kw)

    monkeypatch.setattr(tdit, "rms_rope_heads", k3_rec)
    tdit._self_attention(pt, "blocks.0.self_attn", ctx, x, cfg_t, cos, sin, VALID,
                         torch.bfloat16)
    if mode == "calib":
        assert tables == []
        return
    assert len(tables) == 2
    (ca_q, sb_q), (ca_k, sb_k) = tables
    assert torch.equal(ca_k[VALID:], torch.ones_like(ca_k[VALID:])) and not sb_k[VALID:].any()
    assert torch.equal(ca_k[:VALID], cos) and torch.equal(sb_k[:VALID], sin)
    q_scale = 1.0 if mode == "int8" else 1.0 / np.sqrt(128)
    assert ca_q.abs().max().item() == pytest.approx(q_scale, rel=1e-7)
    assert torch.equal(ca_q, ca_k * q_scale) and torch.equal(sb_q, sb_k * q_scale)


@pytest.mark.parametrize("rope", [True, False], ids=["rope", "split"])
def test_k3_plain_at_the_14b_width_matches_pallas_interpret(rng, rope):
    """C = 5120 (T2V-14B: 40 heads x 128): the plain version of K3 against
    wanq_tpu's Pallas kernel in interpret mode, q-scaled tables with the
    identity tail."""
    b, s, n, d, valid = 2, 16, 40, 128, 12
    x = rng.normal(size=(b, s, n * d)).astype(np.float32) * 2.0
    w = rng.uniform(0.5, 1.5, size=(n * d,)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    if rope:
        ca, sb = jrope.rope_tables_interleaved((1, 3, 4), d)
        pad = np.ones((s - valid, d), np.float32)
        ca = np.concatenate([ca, pad]) * np.float32(0.088388)
        sb = np.concatenate([sb, 0 * pad]) * np.float32(0.088388)
        got = trr.rms_rope_heads(tx, torch.from_numpy(w), torch.from_numpy(ca),
                                 torch.from_numpy(sb), num_heads=n)
        want = jrr.rms_rope_heads(jx, jnp.asarray(w), jnp.asarray(ca), jnp.asarray(sb),
                                  num_heads=n, interpret=True)
    else:
        got = trr.rms_split_heads(tx, torch.from_numpy(w), n)
        want = jrr.rms_split_heads(jx, jnp.asarray(w), n, interpret=True)
    assert got.shape == (b, n, s, d) and got.dtype == torch.bfloat16
    assert _within_one_bf16_ulp(_np(got), _np(want))


@pytest.mark.parametrize("with_cs", [False, True], ids=["nocs", "cs"])
@pytest.mark.parametrize("gelu", [False, True], ids=["plain", "gelu"])
@pytest.mark.parametrize("c", [5120, 13824])
def test_k7_plain_at_the_14b_widths_matches_jax(rng, c, gelu, with_cs):
    """K7's plain version at the T2V-14B dim and ffn width, bf16 input as on
    the paths, with and without GELU and a SmoothQuant channel scale, against
    wanq_tpu's quant_sum_xla / gelu_quant_sum_xla."""
    x = rng.normal(size=(24, c)).astype(np.float32) * 2.0 + 0.2
    x[3] = 0.0  # an all-zero row: scale 1e-6, codes 0
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    cs = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32) if with_cs else None
    got = tfused.quant_sum(tx, gelu=gelu, channel_scale=None if cs is None else torch.from_numpy(cs))
    xla = jfused.gelu_quant_sum_xla if gelu else jfused.quant_sum_xla
    want = xla(jx, None if cs is None else jnp.asarray(cs))
    diff = np.abs(got[0].numpy().astype(int) - np.asarray(want[0]).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    same = diff.max(axis=-1) == 0
    assert same.sum() >= 20
    np.testing.assert_allclose(got[2].numpy()[same], np.asarray(want[2])[same], rtol=1e-6)
    assert got[1][3].item() == np.float32(1e-6) and not got[0][3].any()


@pytest.mark.parametrize("yaml_attn", [False, True], ids=["fp", "int8_attn"])
def test_dit_forward_builds_the_rope_tables_once_and_is_unchanged(rng, monkeypatch, yaml_attn):
    """dit_forward pads the tables (and scales q's) once and hands them to
    every block: one pad_tables call a forward, and the output equal bit for
    bit to blocks that build their own tables, as each block did before."""
    cfg = tiny_config(**SMALL)
    p = tdit.init_params(cfg, 3, device="cpu")
    p["head"]["head"]["w"] = torch.from_numpy(
        rng.normal(size=(256, 64)).astype(np.float32) * 0.02).bfloat16()
    x = torch.from_numpy(rng.normal(size=(2, 16, 3, 8, 10)).astype(np.float32))
    t = torch.tensor([999.0, 500.0])
    c = torch.from_numpy(rng.normal(size=(2, 32, 64)).astype(np.float32))
    ctx = QuantCtx(mode="int8", attn=tattn.AttnQuantCfg.from_dict(SECTION)) if yaml_attn else None
    pads = []
    real_pad, real_block = tdit.pad_tables, tdit.block_forward

    def pad_rec(*a):
        pads.append(a)
        return real_pad(*a)

    monkeypatch.setattr(tdit, "pad_tables", pad_rec)
    hoisted = tdit.dit_forward(p, cfg, x, t, c, 64, ctx=ctx)
    assert len(pads) == 1

    def block_own_tables(*a, tables=None, **kw):
        return real_block(*a, **kw)

    monkeypatch.setattr(tdit, "block_forward", block_own_tables)
    per_block = tdit.dit_forward(p, cfg, x, t, c, 64, ctx=ctx)
    assert len(pads) == 2 + cfg.num_layers
    assert torch.isfinite(hoisted).all() and torch.equal(hoisted, per_block)
