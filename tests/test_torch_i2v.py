"""The port's image-to-video path against wanq_tpu on the CPU.

Both packages draw the same weights from one seed (the i2v leaves
``img_emb`` and each block's ``k_img`` / ``v_img`` / ``norm_k_img``
included, held bit for bit). Two sizes: ``tiny`` with model_type i2v
(head_dim 24: the unfused chain) and a small config with head_dim 128 (dim
256, 2 heads, 2 layers), where the port takes its fused cross-attention
route (one K3 q into two K4 launches, text and image, added in bf16) on the
kernels' plain versions while JAX runs its unfused chain. Tolerances:

* ``dit_forward`` FP float32 rel-L2 <= 1e-4 (JAX runs head.head with bf16
  operands, see tests/test_torch_slice.py; the blocks agree to ~1e-7); sim
  and int8 in bf16 from one JAX quant state (converted) under
  ``wan_w4a8_mixed.yaml``, ``wan_w4a4.yaml`` (k_img and v_img quantized: K9
  on the 2 x 257 image rows) and a W8A8 dict that quantizes k_img / v_img
  (K7 -> K2): rel-L2 <= 1e-2 and cosine >= 0.9999 (W4A4 against JAX's eager
  forward, as tests/test_torch_slice.py explains). One-unit flips of the
  int codes between the packages' bf16 roundings set that distance: the
  same forward without the image branch reads 1.0e-3 - 2.2e-3, the i2v one
  2.5e-3 - 4.8e-3 (its 257 more context tokens);
* ``WanI2V.generate`` from JAX's initial noise (``noise=``), guidance 2 (see
  tests/test_torch_step_cache.py): latents rel-L2 <= 1e-4 with precomputed
  conditioning (UniPC and DPM++), with a tiny VAE and CLIP, cached, and
  with ``ref_latents``; sequential CFG against batched <= 1e-5;
* ``cli.generate --task i2v-14B`` on a ``tiny`` override (a test-written
  checkpoint dir with a VAE and a CLIP ``.pth``, an image file read with
  imageio) against wanq_tpu's CLI: latents rel-L2 <= 1e-4.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu import configs as jconfigs
from wanq_tpu.cli import generate as jgen_cli
from wanq_tpu.models import clip as jclip
from wanq_tpu.models import dit as jdit
from wanq_tpu.models import vae as jvae
from wanq_tpu.pipelines import image2video as ji2v
from wanq_tpu.pipelines import text2video as jt2v
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu.quant.ptq import prepare_quant_state as jax_prepare
from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
from wanq_tpu_torch import configs as tconfigs
from wanq_tpu_torch.cli import fp_generate, generate, get_calib_data, quant_generate
from wanq_tpu_torch.models import clip as tclip
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models import vae as tvae
from wanq_tpu_torch.models.params import quant_state_from_numpy
from wanq_tpu_torch.pipelines import image2video as ti2v
from wanq_tpu_torch.pipelines import text2video as tt2v
from wanq_tpu_torch.quant.qlinear import QuantCtx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W4A8_MIXED = os.path.join(ROOT, "quant_configs", "wan_w4a8_mixed.yaml")
W4A4 = os.path.join(ROOT, "quant_configs", "wan_w4a4.yaml")
# W8A8 at every block linear, the image k/v included
W8A8_IMG = {"remain_fp_regex": r"text_embedding|time_embedding|time_projection|head\.head",
            "weight": {"n_bits": 8, "sym": False}, "act": {"n_bits": 8, "sym": True}}
I2V = dict(model_type="i2v", in_dim=36, clip_dim=32)
SMALL = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
             freq_dim=64, **I2V)
BF16 = dict(param_dtype="bfloat16", residual_dtype="bfloat16")
GEN_KW = dict(max_area=32 * 32, frame_num=5, sampling_steps=4, guide_scale=2.0)
SEED = 3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def _flat(tree, prefix=""):
    """{dotted path: array} of a params tree of either package."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree.float() if isinstance(tree, torch.Tensor) else tree,
                                      np.float32)
    return out


def _models(seed, **kw):
    """The same i2v weights in both packages, head.head redrawn (the
    reference zero-inits it)."""
    cfg_j, cfg_t = jconfigs.tiny_config(**kw), tconfigs.tiny_config(**kw)
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(seed))
    pt = tdit.init_params(cfg_t, seed, device="cpu")
    hw = (np.random.default_rng(seed + 100).normal(size=(cfg_t.dim, 64)) * 0.02).astype(
        np.float32)
    pj["head"]["head"]["w"] = jnp.asarray(hw, dtype=cfg_j.dtype)
    pt["head"]["head"]["w"] = torch.from_numpy(hw).to(cfg_t.dtype)
    return cfg_j, pj, cfg_t, pt


def _fwd_inputs(cfg, rng, grid=(3, 8, 10)):
    f, h, w = grid
    x = rng.normal(size=(2, 16, f, h, w)).astype(np.float32)
    y = rng.normal(size=(2, cfg.in_dim - 16, f, h, w)).astype(np.float32)
    clip_fea = rng.normal(size=(2, 257, cfg.clip_dim)).astype(np.float32)
    t = np.asarray([999.0, 500.0], np.float32)
    ctx = rng.normal(size=(2, cfg.text_len, cfg.text_dim)).astype(np.float32)
    return x, y, clip_fea, t, ctx


def _both_forwards(cfg_j, pj, cfg_t, pt, inputs, seq, jctx=None, tctx=None, eager=False):
    x, y, cf, t, ctx = inputs

    def fwd(p, q, a, b, c, yy, ff):
        return jdit.dit_forward(p, cfg_j, a, b, c, seq, ctx=q, clip_fea=ff, y=yy)

    if eager:
        with jax.disable_jit():
            want = np.asarray(fwd(pj, jctx, *(jnp.asarray(v) for v in (x, t, ctx, y, cf))))
    else:
        want = np.asarray(jax.jit(fwd)(pj, jctx, x, t, ctx, y, cf))
    got = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(ctx), seq, ctx=tctx,
                           clip_fea=torch.from_numpy(cf), y=torch.from_numpy(y)).numpy()
    return want, got


# ---------------------------------------------------------------------------
# helpers, params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frame_num,lat_h,lat_w", [(81, 4, 6), (5, 2, 2), (17, 3, 5)])
def test_first_frame_mask_matches_jax_and_the_reference(frame_num, lat_h, lat_w):
    got = ti2v.first_frame_mask(frame_num, lat_h, lat_w).numpy()
    np.testing.assert_array_equal(got, np.asarray(ji2v.first_frame_mask(frame_num, lat_h, lat_w)))
    # the reference's construction (wan/image2video.py)
    msk = torch.ones(1, frame_num, lat_h, lat_w)
    msk[:, 1:] = 0
    msk = torch.cat([torch.repeat_interleave(msk[:, 0:1], repeats=4, dim=1), msk[:, 1:]], dim=1)
    msk = msk.view(1, msk.shape[1] // 4, 4, lat_h, lat_w)
    np.testing.assert_array_equal(got, msk.transpose(1, 2)[0].numpy())
    assert got.shape == (4, (frame_num - 1) // 4 + 1, lat_h, lat_w)


@pytest.mark.parametrize("img_hw,size", [((480, 832), "832*480"), ((480, 832), "480*832"),
                                         ((720, 1280), "1280*720"), ((333, 517), "832*480"),
                                         ((32, 32), None)])
def test_i2v_latent_size_matches_jax(img_hw, size):
    area = tconfigs.MAX_AREA_CONFIGS[size] if size else 32 * 32
    if size:
        assert area == jconfigs.MAX_AREA_CONFIGS[size]
    for cfg_j, cfg_t in ((jconfigs.WAN_CONFIGS["i2v-14B"], tconfigs.WAN_CONFIGS["i2v-14B"]),
                         (jconfigs.tiny_config(**I2V), tconfigs.tiny_config(**I2V))):
        got = ti2v.i2v_latent_size(cfg_t, img_hw, area)
        assert got == ji2v.i2v_latent_size(cfg_j, img_hw, area)
    if img_hw == (480, 832) and size == "832*480":
        # sqrt(832 * 480 * 480 / 832) is 479.99999999999994 in float64, so the
        # floor division gives 58 latent rows, not 60: 21 x 29 x 52 = 31668
        # tokens at 81 frames (no 512 alignment)
        assert got == (58, 104)


def test_init_params_i2v_matches_jax_host_draw():
    cfg_j, cfg_t = jconfigs.tiny_config(**I2V), tconfigs.tiny_config(**I2V)
    want = _flat(jdit.init_params(cfg_j, jax.random.PRNGKey(5)))
    got = _flat(tdit.init_params(cfg_t, 5, device="cpu"))
    assert set(got) == set(want)
    assert {"img_emb.proj.1.w", "img_emb.proj.3.w", "img_emb.proj.4.b",
            "blocks.1.cross_attn.k_img.w", "blocks.1.cross_attn.norm_k_img"} <= set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tdit.linear_layer_names(cfg_t) == jdit.linear_layer_names(cfg_j)


def test_init_params_on_device_i2v_covers_the_new_leaves():
    cfg = tconfigs.tiny_config(**I2V)
    host = tdit.init_params(cfg, 0, device="cpu")
    a = tdit.init_params_on_device(cfg, 0, device="cpu")
    b = tdit.init_params_on_device(cfg, 0, device="cpu")
    fa, fb, fh = _flat(a), _flat(b), _flat(host)
    assert set(fa) == set(fh)
    for k in fh:
        assert fa[k].shape == fh[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert a["blocks"][0]["cross_attn"]["k_img"]["w"].dtype == cfg.dtype
    k_img = fa["blocks.0.cross_attn.k_img.w"]
    bound = np.sqrt(6.0 / (2 * cfg.dim))
    assert np.abs(k_img).max() <= bound and np.std(k_img) == pytest.approx(
        bound / np.sqrt(3), rel=0.1)
    np.testing.assert_array_equal(fa["blocks.1.cross_attn.norm_k_img"], np.ones(cfg.dim))
    np.testing.assert_array_equal(fa["img_emb.proj.0.w"], np.ones(cfg.clip_dim))


# ---------------------------------------------------------------------------
# dit_forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["tiny", "small"])
def test_i2v_dit_forward_fp32_matches_jax(size, rng):
    kw = I2V if size == "tiny" else SMALL
    cfg_j, pj, cfg_t, pt = _models(SEED, **kw)
    inputs = _fwd_inputs(cfg_t, rng)
    want, got = _both_forwards(cfg_j, pj, cfg_t, pt, inputs, 64)
    assert got.shape == want.shape == inputs[0].shape
    assert _rel(want, got) <= 1e-4


def test_i2v_forward_needs_clip_fea_and_t2v_refuses_it(rng):
    _, _, cfg_t, pt = _models(SEED, **I2V)
    x, y, cf, t, ctx = (torch.from_numpy(v) for v in _fwd_inputs(cfg_t, rng))
    with pytest.raises(ValueError, match="clip_fea"):
        tdit.dit_forward(pt, cfg_t, x, t, ctx, 64, y=y)
    cfg2 = tconfigs.tiny_config()
    p2 = tdit.init_params(cfg2, 0, device="cpu")
    with pytest.raises(ValueError, match="clip_fea"):
        tdit.dit_forward(p2, cfg2, x, t, ctx, 64, clip_fea=cf)


@pytest.mark.parametrize("mode", ["sim", "int8"])
@pytest.mark.parametrize("qcfg", ["w4a8_mixed", "w4a4", "w8a8_img"])
def test_i2v_dit_forward_quant_matches_jax(mode, qcfg, rng):
    cfg_j, pj, cfg_t, pt = _models(SEED, **SMALL, **BF16)
    inputs = _fwd_inputs(cfg_t, rng)
    qc = (JaxQuantConfig.from_dict(W8A8_IMG) if qcfg == "w8a8_img"
          else JaxQuantConfig.from_yaml({"w4a8_mixed": W4A8_MIXED, "w4a4": W4A4}[qcfg]))
    pol, st, rot = jax_prepare(pj, jdit.linear_layer_names(cfg_j), qc, targets=mode)
    assert pol["blocks.0.cross_attn.k_img"].is_quantized == (qcfg != "w4a8_mixed")
    jctx = JaxQuantCtx(mode=mode, policies=pol, state=st, rotations=rot)
    tctx = QuantCtx(mode=mode, policies=pol, state=quant_state_from_numpy(
        jax.tree.map(np.asarray, st), device="cpu"))
    want, got = _both_forwards(cfg_j, pj, cfg_t, pt, inputs, 64, jctx, tctx,
                               eager=qcfg == "w4a4")
    assert np.isfinite(got).all()
    assert _rel(want, got) <= 1e-2 and _cos(want, got) >= 0.9999


# ---------------------------------------------------------------------------
# WanI2V.generate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_i2v():
    cfg_j, pj, cfg_t, pt = _models(0, **I2V)
    rng = np.random.default_rng(11)
    img = rng.uniform(-1, 1, size=(3, 32, 32)).astype(np.float32)
    c, cn = (rng.normal(size=(1, cfg_t.text_len, cfg_t.text_dim)).astype(np.float32)
             for _ in range(2))
    lat_h, lat_w = ti2v.i2v_latent_size(cfg_t, (32, 32), 32 * 32)
    clip_fea = rng.normal(size=(1, 257, cfg_t.clip_dim)).astype(np.float32)
    y = rng.normal(size=(20, 2, lat_h, lat_w)).astype(np.float32)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(SEED), (1, 16, 2, lat_h, lat_w),
                                       jnp.float32))
    return cfg_j, pj, cfg_t, pt, img, c, cn, clip_fea, y, noise


def _gen_both(setup, jpipe_kw=None, tpipe_kw=None, **kw):
    cfg_j, pj, cfg_t, pt, img, c, cn, clip_fea, y, noise = setup
    cond = {} if kw.pop("no_cond", False) else {"clip_fea": clip_fea, "y": y}
    jkw = {**GEN_KW, **kw, **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                              for k, v in cond.items()}}
    want = np.asarray(ji2v.WanI2V(cfg_j, pj, **(jpipe_kw or {})).generate(
        jnp.asarray(img), jnp.asarray(c), jnp.asarray(cn), seed=SEED,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in jkw.items()}))
    tpipe = ti2v.WanI2V(cfg_t, pt, device="cpu", **(tpipe_kw or {}))
    tkw = {**GEN_KW, **kw, **cond}
    got = tpipe.generate(torch.from_numpy(img), torch.from_numpy(c), torch.from_numpy(cn),
                         noise=torch.from_numpy(noise),
                         **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                            for k, v in tkw.items()}).numpy()
    return want, got, tpipe


@pytest.mark.parametrize("solver", ["unipc", "dpm++"])
def test_generate_with_precomputed_conditioning_matches_jax(tiny_i2v, solver):
    want, got, _ = _gen_both(tiny_i2v, sample_solver=solver)
    assert got.shape == want.shape == (1, 16, 2, 4, 4)
    assert np.isfinite(got).all() and _rel(want, got) <= 1e-4


def test_generate_sequential_matches_batched(tiny_i2v):
    want, got, _ = _gen_both(tiny_i2v, cfg_mode="sequential")
    assert _rel(want, got) <= 1e-4
    _, batched, _ = _gen_both(tiny_i2v)
    assert _rel(batched, got) <= 1e-5


def test_generate_cached_matches_jax(tiny_i2v):
    kw = dict(cfg_interval=2, reuse_interval=2, warmup=1, tail=1)
    want, got, tpipe = _gen_both(tiny_i2v, sampling_steps=6,
                                 cache_policy=tt2v.StepCachePolicy(**kw))
    jpipe = ji2v.WanI2V(tiny_i2v[0], tiny_i2v[1])
    setup = tiny_i2v
    jpipe.generate(jnp.asarray(setup[4]), jnp.asarray(setup[5]), jnp.asarray(setup[6]),
                   seed=SEED, clip_fea=jnp.asarray(setup[7]), y=jnp.asarray(setup[8]),
                   **{**GEN_KW, "sampling_steps": 6}, cache_policy=jt2v.StepCachePolicy(**kw))
    assert tpipe.last_cache_stats == jpipe.last_cache_stats
    assert tpipe.last_cache_stats["reuse"] > 0 and tpipe.last_cache_stats["cond"] > 0
    assert _rel(want, got) <= 1e-4


def test_generate_with_ref_latents_matches_jax(tiny_i2v):
    ref = np.random.default_rng(12).normal(size=(16, 2, 4, 4)).astype(np.float32)
    _, base, _ = _gen_both(tiny_i2v)
    _, same, _ = _gen_both(tiny_i2v, ref_latents=ref, ref_latent_strength=0.0)
    np.testing.assert_array_equal(same, base)
    want, got, _ = _gen_both(tiny_i2v, ref_latents=ref, ref_latent_strength=0.3)
    assert not np.allclose(got, base) and _rel(want, got) <= 1e-4


def test_generate_without_conditioning_sources_raises(tiny_i2v):
    _, _, cfg_t, pt, img, c, cn, clip_fea, y, _ = tiny_i2v
    pipe = ti2v.WanI2V(cfg_t, pt, device="cpu")
    args = (torch.from_numpy(img), torch.from_numpy(c), torch.from_numpy(cn))
    with pytest.raises(ValueError, match="CLIPModel"):
        pipe.generate(*args, y=torch.from_numpy(y), **GEN_KW)
    with pytest.raises(ValueError, match="WanVAE"):
        pipe.generate(*args, clip_fea=torch.from_numpy(clip_fea), **GEN_KW)


def test_generate_with_vae_and_clip_matches_jax():
    """The whole conditioning: the tiny VAE (z_dim 16, stride 2 in time and
    space, so a 2-channel mask and in_dim 34) encodes the resized first
    frame, a CLIP of 257 tokens (224 / 14 patches) encodes the image."""
    kw = dict(model_type="i2v", in_dim=34, clip_dim=32, vae_stride=(2, 2, 2))
    cfg_j, pj, cfg_t, pt = _models(1, **kw)
    vcfg_j, vcfg_t = jvae.tiny_vae_config(z_dim=16), tvae.tiny_vae_config(z_dim=16)
    ccfg_j = jclip.tiny_clip_config(vision_dim=32, image_size=224)
    ccfg_t = tclip.tiny_clip_config(vision_dim=32, image_size=224)
    jpipe = ji2v.WanI2V(cfg_j, pj, vae=jvae.WanVAE(vcfg_j, params=jvae.init_vae_params(vcfg_j, 1)),
                        clip=jclip.CLIPModel(ccfg_j, params=jclip.init_clip_params(ccfg_j, 2)))
    tvae_ = tvae.WanVAE(vcfg_t, params=tvae.init_vae_params(vcfg_t, 1, "cpu"), device="cpu")
    tclip_ = tclip.CLIPModel(ccfg_t, params=tclip.init_clip_params(ccfg_t, 2, "cpu"),
                             device="cpu")
    tpipe = ti2v.WanI2V(cfg_t, pt, device="cpu", vae=tvae_, clip=tclip_)
    rng = np.random.default_rng(13)
    img = rng.uniform(-1, 1, size=(3, 30, 34)).astype(np.float32)
    c, cn = (rng.normal(size=(1, cfg_t.text_len, cfg_t.text_dim)).astype(np.float32)
             for _ in range(2))
    lat_h, lat_w = ti2v.i2v_latent_size(cfg_t, (30, 34), 32 * 32)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(SEED), (1, 16, 3, lat_h, lat_w),
                                       jnp.float32))
    gkw = dict(max_area=32 * 32, frame_num=5, sampling_steps=2, guide_scale=2.0)
    want = np.asarray(jpipe.generate(jnp.asarray(img), jnp.asarray(c), jnp.asarray(cn),
                                     seed=SEED, **gkw))
    got = tpipe.generate(torch.from_numpy(img), torch.from_numpy(c), torch.from_numpy(cn),
                         noise=torch.from_numpy(noise), **gkw).numpy()
    assert got.shape == want.shape == (1, 16, 3, lat_h, lat_w)
    assert np.isfinite(got).all() and _rel(want, got) <= 1e-4


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_i2v_task(monkeypatch):
    """'i2v-14B' served by the tiny i2v config at 64*64, in both packages,
    with a 257-token CLIP of width clip_dim."""
    for mod in (jconfigs, tconfigs):
        monkeypatch.setitem(mod.WAN_CONFIGS, "i2v-14B", mod.tiny_config(
            name="i2v-14B", clip_checkpoint=mod.WAN_CONFIGS["i2v-14B"].clip_checkpoint, **I2V))
        monkeypatch.setitem(mod.SUPPORTED_SIZES, "i2v-14B", ("64*64",))
        monkeypatch.setitem(mod.MAX_AREA_CONFIGS, "64*64", 64 * 64)
    for mod in (jclip, tclip):
        monkeypatch.setattr(mod, "CLIPModel", functools.partial(
            mod.CLIPModel, mod.tiny_clip_config(vision_dim=32, image_size=224)))


def _write_ckpt(d, seed=4):
    """A checkpoint dir of the tiny i2v task: the DiT, a VAE and a CLIP .pth."""
    import sys

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    cfg = tconfigs.WAN_CONFIGS["i2v-14B"]
    params = tdit.init_params(cfg, seed, device="cpu")
    params["head"]["head"]["w"] = torch.from_numpy(
        (0.02 * np.random.default_rng(seed + 1).standard_normal((cfg.dim, 64))).astype(
            np.float32))
    chip_smoke.write_dit_checkpoint(params, cfg, str(d), shards=2)
    chip_smoke.write_vae_checkpoint(tvae.init_vae_params(tvae.VAEConfig(dim=8), 0, device="cpu"),
                                    str(d / cfg.vae_checkpoint))
    ccfg = tclip.tiny_clip_config(vision_dim=32, image_size=224)
    torch.save(tclip.init_clip_params(ccfg, 2, device="cpu"), d / cfg.clip_checkpoint)
    return cfg


def test_cli_generate_i2v_matches_jax(tiny_i2v_task, tmp_path, monkeypatch):
    import imageio

    cfg = _write_ckpt(tmp_path / "ckpt")
    rng = np.random.default_rng(14)
    imageio.imwrite(tmp_path / "in.png", rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8))
    np.savez(tmp_path / "ctx.npz", **{k: rng.normal(size=(1, cfg.text_len, cfg.text_dim)).astype(
        np.float32) for k in ("context", "context_null")})
    argv = ["--task", "i2v-14B", "--size", "64*64", "--frame_num", "5", "--sample_steps", "2",
            "--sample_guide_scale", "2", "--ckpt_dir", str(tmp_path / "ckpt"), "--context_file",
            str(tmp_path / "ctx.npz"), "--image", str(tmp_path / "in.png")]

    jax_out = {}
    orig_j = ji2v.WanI2V.generate

    def jgen(self, *a, **kw):
        jax_out["latents"] = np.asarray(orig_j(self, *a, **kw))
        return jnp.asarray(jax_out["latents"])

    monkeypatch.setattr(ji2v.WanI2V, "generate", jgen)
    try:
        jgen_cli.generate(jgen_cli.parse_args(argv + ["--save_file", str(tmp_path / "j.npz")]))
    except UnboundLocalError:
        pass  # wanq_tpu's generate stops at its first logging call past the decode

    orig_t = ti2v.WanI2V.generate

    def tgen(self, img, context, context_null, seed=-1, frame_num=81, max_area=0, **kw):
        lat_h, lat_w = ti2v.i2v_latent_size(self.config, tuple(img.shape[1:]), max_area)
        shape = (1, 16, (frame_num - 1) // 4 + 1, lat_h, lat_w)
        noise = np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
        return orig_t(self, img, context, context_null, seed=seed, frame_num=frame_num,
                      max_area=max_area, noise=torch.from_numpy(noise), **kw)

    monkeypatch.setattr(ti2v.WanI2V, "generate", tgen)
    save = generate.generate(generate.parse_args(
        argv + ["--device", "cpu", "--save_file", str(tmp_path / "t.npz")]))
    out = np.load(save)
    assert out["latents"].shape == jax_out["latents"].shape == (1, 16, 2, 8, 8)
    assert _rel(jax_out["latents"], out["latents"]) <= 1e-4
    assert out["video"].shape == (1, 3, 5, 64, 64) and np.abs(out["video"]).max() <= 1.0
    # an image passed in is the file's
    img = generate._load_image(str(tmp_path / "in.png"))
    assert img.shape == (3, 64, 64) and img.dtype == np.float32
    again = generate.generate(generate.parse_args(
        [a for a in argv if a not in ("--image", str(tmp_path / "in.png"))]
        + ["--device", "cpu", "--save_file", str(tmp_path / "t2.npz")]), image=img)
    np.testing.assert_array_equal(np.load(again)["latents"], out["latents"])


def test_cli_generate_i2v_checkpoint_free_draws_the_conditioning(tiny_i2v_task, tmp_path):
    """Without --ckpt_dir the CLIP features and VAE latents are seeded
    random draws (wanq_tpu's: np.random.default_rng(base_seed))."""
    img = np.zeros((3, 64, 64), np.float32)
    argv = ["--task", "i2v-14B", "--size", "64*64", "--frame_num", "5", "--sample_steps", "2",
            "--random_init", "--device", "cpu", "--sample_solver", "dpm++"]
    a = np.load(generate.generate(generate.parse_args(
        argv + ["--save_file", str(tmp_path / "a.npz")]), image=img))
    b = np.load(generate.generate(generate.parse_args(
        argv + ["--save_file", str(tmp_path / "b.npz")]), image=img))
    assert a["latents"].shape == (1, 16, 2, 8, 8) and "video" not in a.files
    np.testing.assert_array_equal(a["latents"], b["latents"])
    assert np.isfinite(a["latents"]).all()


def test_cli_i2v_refusals(tiny_i2v_task, tmp_path):
    base = ["--task", "i2v-14B", "--size", "64*64", "--frame_num", "5", "--random_init",
            "--device", "cpu"]
    (tmp_path / "p.txt").write_text("a fox\n")
    with pytest.raises(SystemExit, match="--prompt_file serves t2v"):
        generate.generate(generate.parse_args(base + ["--prompt_file", str(tmp_path / "p.txt")]))
    with pytest.raises(SystemExit, match="needs --image"):
        generate.generate(generate.parse_args(base))
    for cli in (fp_generate, quant_generate, get_calib_data):
        extra = ["--quant_config", W4A8_MIXED] if cli is quant_generate else []
        with pytest.raises(SystemExit, match="cli.generate --image"):
            cli.generate(cli.parse_args(base + extra))
