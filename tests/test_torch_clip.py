"""The port's CLIP (models/clip.py) against wanq_tpu's on the CPU.

Both packages draw the same weights from one seed (``init_clip_params``,
numpy in wanq_tpu's order: held key by key, bit for bit). Tolerances, all
float32: the vision tower (with and without ``use_31_block``), the text
tower and ``CLIPModel.visual`` within rel-L2 1e-5 of wanq_tpu's (the matmuls
sum in another order); ``resize_cubic``'s weights within 1e-7 of jax.image's,
and its output within 2e-5 of the largest value of
``jax.image.resize(..., "cubic")`` (float32 sums of up to 20 taps an axis in
another order: 1e-5 measured on the downsample) on a downsample (480 x 832
-> 224 x 224), an upsample, a mixed resize and equal sizes (exact there: no
axis changes). PyTorch's bicubic ``interpolate`` is shown to be another
function. The ``.pth`` loader reads a test-written state dict (float32 and
bfloat16). The card's draw (``init_clip_params_on_device``) is held by tree,
shapes, moments and determinism.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.models import clip as jclip
from wanq_tpu_torch.models import clip as tclip

CFG = dict(image_size=56, vision_layers=3)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.fixture(scope="module")
def clips():
    cfg_j = jclip.tiny_clip_config(**CFG)
    cfg_t = tclip.tiny_clip_config(**CFG)
    pj = jclip.init_clip_params(cfg_j, seed=3)
    pt = tclip.init_clip_params(cfg_t, seed=3, device="cpu")
    return cfg_j, pj, cfg_t, pt


def test_init_clip_params_matches_jax(clips):
    _, pj, _, pt = clips
    assert list(pt) == list(pj)
    for k, v in pj.items():
        assert pt[k].dtype == torch.float32 and tuple(pt[k].shape) == v.shape, k
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("use_31_block", [False, True])
def test_vision_forward_matches_jax(clips, use_31_block):
    cfg_j, pj, cfg_t, pt = clips
    x = np.random.default_rng(0).normal(size=(2, 3, 56, 56)).astype(np.float32)
    want = np.asarray(jclip.vision_forward(pj, cfg_j, jnp.asarray(x), use_31_block))
    got = tclip.vision_forward(pt, cfg_t, torch.from_numpy(x), use_31_block).numpy()
    assert got.shape == want.shape == (2, cfg_t.num_patches + 1, cfg_t.vision_dim)
    assert _rel(want, got) <= 1e-5


def test_use_31_block_stops_one_block_early(clips):
    _, _, cfg_t, pt = clips
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 3, 56, 56)).astype(np.float32))
    short = tclip.vision_forward(pt, cfg_t, x, use_31_block=True)
    cut = tclip.CLIPConfig(**{**cfg_t.__dict__, "vision_layers": cfg_t.vision_layers - 1})
    assert torch.equal(short, tclip.vision_forward(pt, cut, x))


def test_text_forward_matches_jax(clips):
    cfg_j, pj, cfg_t, pt = clips
    ids = np.random.default_rng(2).integers(2, cfg_t.vocab_size, size=(2, 12))
    ids[0, 7:] = cfg_t.pad_id  # a padded row
    want = np.asarray(jclip.text_forward(pj, cfg_j, jnp.asarray(ids)))
    got = tclip.text_forward(pt, cfg_t, torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (2, cfg_t.embed_dim)
    assert _rel(want, got) <= 1e-5


def test_clip_model_visual_matches_jax(clips):
    cfg_j, pj, cfg_t, pt = clips
    videos = np.random.default_rng(4).uniform(-1, 1, size=(1, 3, 2, 48, 83)).astype(np.float32)
    want = np.asarray(jclip.CLIPModel(cfg_j, params=pj).visual(jnp.asarray(videos)))
    got = tclip.CLIPModel(cfg_t, params=pt, device="cpu").visual(
        torch.from_numpy(videos)).numpy()
    assert got.shape == want.shape == (2, cfg_t.num_patches + 1, cfg_t.vision_dim)
    assert _rel(want, got) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pth_loader_reads_a_state_dict(clips, tmp_path, dtype):
    _, _, cfg_t, pt = clips
    path = tmp_path / "clip.pth"
    torch.save({k: v.to(dtype) for k, v in pt.items()}, path)
    model = tclip.CLIPModel(cfg_t, checkpoint_path=str(path), device="cpu")
    assert list(model.params) == list(pt)
    for k, v in pt.items():
        assert model.params[k].dtype == torch.float32
        assert torch.equal(model.params[k], v.to(dtype).float()), k
    # the visual keys alone are enough for visual()
    vis = {k: v for k, v in pt.items() if k.startswith("visual.")}
    torch.save(vis, path)
    videos = torch.rand((1, 3, 1, 40, 40)) * 2 - 1
    got = tclip.CLIPModel(cfg_t, checkpoint_path=str(path), device="cpu").visual(videos)
    assert torch.equal(got, tclip.CLIPModel(cfg_t, params=pt, device="cpu").visual(videos))


@pytest.mark.parametrize("shape,size", [
    ((1, 3, 480, 832), (224, 224)),   # CLIPModel.visual at 480p: down on both axes
    ((2, 3, 20, 24), (60, 104)),      # up
    ((1, 3, 30, 90), (45, 40)),       # up and down
    ((1, 3, 33, 17), (33, 17)),       # equal: the identity
    ((3, 28, 28), (224, 224)),        # no batch dim
], ids=["down_480p", "up", "mixed", "equal", "unbatched"])
def test_resize_cubic_matches_jax_image_resize(shape, size):
    x = np.random.default_rng(5).uniform(-1, 1, size=shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape[:-2] + size, method="cubic"))
    got = tclip.resize_cubic(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    if shape[-2:] == size:
        np.testing.assert_array_equal(got, x)
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


def test_resize_weights_match_jax():
    from jax._src.image import scale as jscale

    for n_in, n_out in ((480, 224), (832, 224), (20, 60), (7, 7)):
        want = np.asarray(jscale.compute_weight_mat(
            n_in, n_out, n_out / n_in, 0.0, jscale._fill_keys_cubic_kernel, True))
        got = tclip.cubic_resize_weights(n_in, n_out)
        assert got.dtype == np.float32 and got.shape == (n_in, n_out)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_torch_bicubic_is_another_function():
    x = np.random.default_rng(6).uniform(-1, 1, size=(1, 3, 96, 96)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3, 40, 40), method="cubic"))
    bicubic = torch.nn.functional.interpolate(torch.from_numpy(x), size=(40, 40),
                                              mode="bicubic", align_corners=False).numpy()
    assert np.abs(bicubic - want).max() > 0.05
    assert np.abs(tclip.resize_cubic(torch.from_numpy(x), (40, 40)).numpy() - want).max() < 1e-5


def test_init_on_device_draws_the_tree_with_its_schemes(clips):
    _, _, cfg_t, pt = clips
    a = tclip.init_clip_params_on_device(cfg_t, seed=9, device="cpu")
    b = tclip.init_clip_params_on_device(cfg_t, seed=9, device="cpu")
    c = tclip.init_clip_params_on_device(cfg_t, seed=10, device="cpu")
    assert list(a) == list(pt)
    for k in pt:
        assert a[k].shape == pt[k].shape and a[k].dtype == torch.float32, k
        assert torch.equal(a[k], b[k]), k
    w = a["visual.transformer.0.attn.to_qkv.weight"]
    bound = 1.0 / np.sqrt(cfg_t.vision_dim)
    assert float(w.abs().max()) <= bound and float(w.std()) == pytest.approx(
        bound / np.sqrt(3), rel=0.1)
    emb = a["textual.token_embedding.weight"]
    assert float(emb.std()) == pytest.approx(0.02, rel=0.15)
    assert not torch.equal(a["visual.pos_embedding"], c["visual.pos_embedding"])
    assert torch.equal(a["visual.pre_norm.weight"], torch.ones(cfg_t.vision_dim))
