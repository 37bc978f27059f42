"""The port's Wan VAE (wanq_tpu_torch/models/vae.py) against wanq_tpu's on
the CPU, on the same weights from one ``init_vae_params`` seed.

Tolerances: float32 decode (3 latent frames: the temporal caches and the
skipped chunk-0 time conv) and encode (chunks of 1, 4, 4 frames) rel-L2
<= 1e-5; ``compute_dtype=bfloat16`` PSNR >= 40 dB against wanq_tpu's bf16
path (a bf16 conv here rounds its sum to bf16 before the f32 bias add,
wanq_tpu adds the bias to the f32 sum); the full-width ``WAN_VAE_CFG`` at
32x32x9 rel-L2 <= 1e-4; the row-blockwise spatial attention against the
one-shot one rel-L2 <= 1e-6 (the softmax is per row: only the products'
blocking differs).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.models import vae as jvae
from wanq_tpu_torch.configs import WAN_CONFIGS
from wanq_tpu_torch.models import vae as tvae

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for the port's CPU ops: the test runs share the
    host's cores among several worker processes, and one torch thread per
    core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _psnr(want, got) -> float:
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    span = want.max() - want.min()
    return float(20 * np.log10(span / np.sqrt(np.mean((want - got) ** 2))))


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.fixture(scope="module")
def tiny():
    cfg_j, cfg_t = jvae.tiny_vae_config(), tvae.tiny_vae_config()
    return cfg_j, jvae.init_vae_params(cfg_j, seed=1), cfg_t, tvae.init_vae_params(
        cfg_t, seed=1, device="cpu")


@pytest.mark.parametrize("cfg_kw", [{}, {"dim": 8, "dim_mult": (1, 2, 4, 4),
                                         "num_res_blocks": 2, "z_dim": 16,
                                         "temperal_downsample": (False, True, True)}],
                         ids=["tiny", "wan_structure_dim8"])
def test_init_vae_params_equal_jax(cfg_kw):
    cfg_j, cfg_t = jvae.tiny_vae_config(**cfg_kw), tvae.tiny_vae_config(**cfg_kw)
    pj, pt = jvae.init_vae_params(cfg_j, seed=3), tvae.init_vae_params(cfg_t, 3, device="cpu")
    assert sorted(pj) == sorted(pt)
    for k in pj:
        assert pt[k].dtype == torch.float32 and pt[k].device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(pj[k]), pt[k].numpy(), err_msg=k)


def test_decode_f32_matches_jax(tiny, rng):
    cfg_j, pj, cfg_t, pt = tiny
    z = rng.normal(size=(1, cfg_t.z_dim, 3, 8, 8)).astype(np.float32)
    want = np.asarray(jvae.WanVAE(cfg_j, params=pj).decode(jnp.asarray(z)))
    got = tvae.WanVAE(cfg_t, params=pt, device="cpu").decode(torch.from_numpy(z))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, 3, 5, 16, 16)
    assert float(got.abs().max()) <= 1.0
    assert _rel(want, got.numpy()) <= 1e-5


def test_encode_f32_matches_jax(tiny, rng):
    cfg_j, pj, cfg_t, pt = tiny
    x = rng.normal(size=(1, 3, 9, 16, 16)).astype(np.float32)
    want = np.asarray(jvae.WanVAE(cfg_j, params=pj).encode(jnp.asarray(x)))
    got = tvae.WanVAE(cfg_t, params=pt, device="cpu").encode(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (1, cfg_t.z_dim, 5, 8, 8)
    assert _rel(want, got.numpy()) <= 1e-5


def test_encoder_without_caches_equals_streaming(tiny, rng):
    """``CacheCtx(None)``: one pass over the whole clip, full causal padding
    and the stride-2 time conv over the stream, gives the streaming
    encoder's states (chunks of 1, 4 frames)."""
    _, _, cfg_t, pt = tiny
    x = torch.from_numpy(rng.normal(size=(1, 3, 5, 16, 16)).astype(np.float32))
    whole = tvae.encoder_forward(pt, cfg_t, x, tvae.CacheCtx(None, False))
    vae = tvae.WanVAE(cfg_t, params=pt, device="cpu")
    streamed = vae._run_chunks(lambda p, ch, cc: tvae.encoder_forward(p, cfg_t, ch, cc),
                               x, [0, 1], [1, 4])
    assert whole.shape == streamed.shape == (1, 2 * cfg_t.z_dim, 3, 8, 8)
    assert _rel(streamed.numpy(), whole.numpy()) <= 1e-5


@pytest.mark.parametrize("op", ["decode", "encode"])
def test_bf16_compute_dtype_close_to_jax(tiny, rng, op):
    cfg_j, pj, cfg_t, pt = tiny
    vj = jvae.WanVAE(cfg_j, params=pj, compute_dtype=jnp.bfloat16)
    vt = tvae.WanVAE(cfg_t, params=pt, compute_dtype=torch.bfloat16, device="cpu")
    assert all((v.dtype == torch.float32) == k.endswith(".gamma") for k, v in vt.params.items())
    if op == "decode":
        inp = rng.normal(size=(1, cfg_t.z_dim, 3, 8, 8)).astype(np.float32)
    else:
        inp = rng.normal(size=(1, 3, 5, 16, 16)).astype(np.float32)
    want = np.asarray(getattr(vj, op)(jnp.asarray(inp)))
    got = getattr(vt, op)(torch.from_numpy(inp))
    assert got.dtype == torch.float32
    assert _psnr(want, got.numpy()) >= 40.0


def test_wan_vae_cfg_structure_matches_jax(rng):
    """The full-width WAN_VAE_CFG (dim 96, z 16, strides 4x8x8) at 32x32x9:
    9 frames -> 3 latent frames of 4x4 -> 9 frames again."""
    cfg_j, cfg_t = jvae.WAN_VAE_CFG, tvae.WAN_VAE_CFG
    pj = jvae.init_vae_params(cfg_j, seed=1)
    vj = jvae.WanVAE(cfg_j, params=pj)
    vt = tvae.WanVAE(cfg_t, seed=1, device="cpu")
    x = (rng.normal(size=(1, 3, 9, 32, 32)) * 0.1).astype(np.float32)
    zj = np.array(vj.encode(jnp.asarray(x)))
    zt = vt.encode(torch.from_numpy(x))
    assert tuple(zt.shape) == zj.shape == (1, 16, 3, 4, 4)
    assert _rel(zj, zt.numpy()) <= 1e-4
    yj = np.asarray(vj.decode(jnp.asarray(zj)))
    yt = vt.decode(torch.from_numpy(zj))
    assert tuple(yt.shape) == yj.shape == (1, 3, 9, 32, 32)
    assert _rel(yj, yt.numpy()) <= 1e-4


def test_blockwise_attention_equals_one_shot(tiny, rng, monkeypatch):
    """The 720p memory path (query rows in blocks past 8192 tokens): forced
    here with a low threshold and a block that does not divide hw (35 tokens,
    blocks of 16), against the one-shot port and wanq_tpu's one-shot."""
    cfg_j, pj, _, pt = tiny
    key = sorted({k.rsplit(".", 2)[0] for k in pt
                  if ".to_qkv.weight" in k and k.startswith("decoder")})[0]
    c = pt[f"{key}.to_qkv.weight"].shape[1]
    x = rng.normal(size=(1, c, 2, 5, 7)).astype(np.float32)
    one_shot = tvae.attention_block(pt, key, torch.from_numpy(x))
    want = np.asarray(jvae.attention_block(pj, key, jnp.asarray(x)))
    monkeypatch.setattr(tvae, "_ATTN_BLOCKWISE_MIN_HW", 1)
    monkeypatch.setattr(tvae, "_ATTN_Q_BLOCK", 16)
    blocked = tvae.attention_block(pt, key, torch.from_numpy(x))
    assert _rel(one_shot.numpy(), blocked.numpy()) <= 1e-6
    assert _rel(want, blocked.numpy()) <= 1e-5


def test_load_vae_checkpoint_and_decode_latents(tiny, rng, tmp_path):
    """A test-written Wan2.1_VAE.pth loads key for key; ``decode_latents``
    (the pipeline hook) decodes with it as WanVAE does with the params."""
    _, _, cfg_t, pt = tiny
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    _chip_smoke().write_vae_checkpoint(pt, str(ckpt / "Wan2.1_VAE.pth"))
    loaded = tvae.load_vae_checkpoint(str(ckpt / "Wan2.1_VAE.pth"), device="cpu")
    assert sorted(loaded) == sorted(pt)
    assert all(torch.equal(loaded[k], pt[k]) for k in pt)
    # decode_latents builds WAN_VAE_CFG's structure: a dim-8 VAE of that
    # structure (the channel widths follow the weights)
    wan = tvae.VAEConfig(dim=8)
    _chip_smoke().write_vae_checkpoint(tvae.init_vae_params(wan, 2, device="cpu"),
                                       str(ckpt / "Wan2.1_VAE.pth"))
    z = torch.from_numpy(rng.normal(size=(1, 16, 2, 4, 4)).astype(np.float32))
    got = tvae.decode_latents(str(ckpt), WAN_CONFIGS["t2v-1.3B"], z, device="cpu")
    want = tvae.WanVAE(wan, seed=2, device="cpu").decode(z)
    assert tuple(got.shape) == (1, 3, 5, 32, 32)
    assert torch.equal(got, want)
