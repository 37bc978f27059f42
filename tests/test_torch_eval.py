"""The port's evaluation (utils/metrics.py, fvd.py, image_metrics.py,
clip_metrics.py, flow.py and cli/evaluate.py) against wanq_tpu's on the
CPU, on the same numpy inputs from a seed.

Tolerances: the elementwise metrics (float64 on both sides, sums in
another order) within 1e-12 relative; ``frechet_distance`` (the same numpy
code) within 1e-9, a singular covariance included; the random feature
nets built from wanq_tpu's kernels and head: features within rel-L2 1e-5
(float32 convolutions in another order), ``fvd`` / ``fid`` within 1e-4
relative; ``latents_as_videos`` exact; ``clip_frame_features`` from the
same ``init_clip_params`` bits within 1e-5; the CLIP report and
``clipscore`` within 1e-5 absolute; ``temporal_flickering`` within 1e-6;
``flow_score`` (float32 batches against wanq_tpu's float64 numpy) within
1e-4 relative, static video exactly 0. ``cli.evaluate`` against
``wanq_tpu.cli.evaluate`` on the same npz files, with wanq_tpu's feature
weights handed to the port (``random_conv_weights`` patched) and the tiny
CLIP config standing in for ViT-H in both packages: the same keys, the
elementwise entries within 1e-9, the random-feature, CLIP and flow
entries within 1e-4.
"""

import json

import numpy as np
import pytest
import torch

from wanq_tpu.cli import evaluate as jeval
from wanq_tpu.models import clip as jclip
from wanq_tpu.utils import clip_metrics as jcm
from wanq_tpu.utils import flow as jflow
from wanq_tpu.utils import fvd as jfvd
from wanq_tpu.utils import image_metrics as jim
from wanq_tpu.utils import metrics as jmet
from wanq_tpu_torch.cli import evaluate as teval
from wanq_tpu_torch.models import clip as tclip
from wanq_tpu_torch.utils import clip_metrics as tcm
from wanq_tpu_torch.utils import flow as tflow
from wanq_tpu_torch.utils import fvd as tfvd
from wanq_tpu_torch.utils import image_metrics as tim
from wanq_tpu_torch.utils import metrics as tmet

VIDEOS = (2, 5, 32, 48, 3)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _close(want, got, rtol):
    if np.isnan(want) or np.isinf(want):
        assert (np.isnan(want) and np.isnan(got)) or want == got, (want, got)
    else:
        assert abs(got - want) <= rtol * max(abs(want), 1e-300), (want, got)


def _videos(seed=0, shape=VIDEOS, noise=0.05):
    rng = np.random.default_rng(seed)
    fp = rng.uniform(-1, 1, shape).astype(np.float32)
    return fp, (fp + noise * rng.standard_normal(shape)).astype(np.float32)


def _jax_net(ndim, feat_dim=256, seed=0):
    net = (jfvd.I3DLikeFeatures if ndim == 3 else jim.InceptionLikeFeatures)(feat_dim, seed)
    return net, [np.asarray(k) for k in net.kernels], np.asarray(net.head)


# ---------------------------------------------------------------------------
# metrics.py
# ---------------------------------------------------------------------------


def _metric_case(name):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    b = (a + 0.03 * rng.standard_normal(a.shape)).astype(np.float32)
    if name == "equal":
        b = a.copy()
    elif name == "nonfinite":
        b.flat[[3, 17]] = [np.nan, np.inf]
    elif name == "constant_fp":
        a = np.full_like(a, 0.5)
    elif name == "zero_vectors":
        a, b = np.zeros_like(a), np.zeros_like(b)
    elif name == "one_zero":
        a = np.zeros_like(a)
    return a, b


@pytest.mark.parametrize("case", ["noisy", "equal", "nonfinite", "constant_fp", "zero_vectors",
                                  "one_zero"])
def test_metrics_match_wanq_tpu(case):
    a, b = _metric_case(case)
    want = jmet.quant_fidelity_report(a, b)
    got = tmet.quant_fidelity_report(a, b, device="cpu")
    assert set(got) == set(want)
    for k in want:
        _close(float(want[k]), got[k], 1e-12)
    for fn in ("psnr", "latent_psnr", "relative_error", "cosine_similarity"):
        with np.errstate(all="ignore"):
            w = float(getattr(jmet, fn)(a, b))
            g = getattr(tmet, fn)(a, b, device="cpu")
        _close(w, g, 1e-12)
    # tensors are read as they are
    _close(float(jmet.psnr(a, b, 3.0)),
           tmet.psnr(torch.from_numpy(a), torch.from_numpy(b), 3.0, device="cpu"), 1e-12)


# ---------------------------------------------------------------------------
# fvd.py / image_metrics.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [40, 6], ids=["full_rank", "singular"])
def test_frechet_distance_matches(n):
    rng = np.random.default_rng(4)
    fa = rng.standard_normal((n, 16))
    fb = rng.standard_normal((n, 16)) * 1.3 + 0.2
    sa, sb = tfvd._stats(fa, 0.0), tfvd._stats(fb, 0.0)
    ja, jb = jfvd._stats(fa, 0.0), jfvd._stats(fb, 0.0)
    if n < 16:
        assert np.linalg.matrix_rank(sa[1]) < 16  # singular: eigh's negative noise clipped
    want = jfvd.frechet_distance(*ja, *jb)
    got = tfvd.frechet_distance(*sa, *sb)
    assert abs(got - want) <= 1e-9 * abs(want)
    # sqrt of eigenvalues at rounding level: ~1e-8 of a singular set's own trace
    assert abs(tfvd.frechet_distance(*sa, *sa)) <= 1e-6 * abs(want)


@pytest.mark.parametrize("sides", [(32, 48), (33, 47)], ids=["even", "odd"])
@pytest.mark.parametrize("ndim", [3, 2], ids=["I3DLike", "InceptionLike"])
def test_feature_nets_match_with_wanq_tpu_weights(ndim, sides):
    fp, q = _videos(1, (2, 5, *sides, 3), noise=0.2)
    if ndim == 2:
        fp, q = fp[:, 0], q[:, 0]
    jnet, kernels, head = _jax_net(ndim)
    cls = tfvd.I3DLikeFeatures if ndim == 3 else tim.InceptionLikeFeatures
    tnet = cls(device="cpu", kernels=kernels, head=head)
    assert _rel(jnet(fp), tnet(fp)) <= 1e-5
    dist = (jfvd.fvd, tfvd.fvd) if ndim == 3 else (jim.fid, tim.fid)
    want = dist[0](fp, q, feature_fn=jnet)
    got = dist[1](fp, q, feature_fn=tnet, device="cpu")
    assert want > 0 and abs(got - want) <= 1e-4 * want
    report = (jfvd.fpfvd_report, tfvd.fpfvd_report) if ndim == 3 else (jim.fpfid_report,
                                                                         tim.fpfid_report)
    jr, tr = report[0](fp, q, feature_fn=jnet), report[1](fp, q, feature_fn=tnet, device="cpu")
    assert set(jr) == set(tr)
    key = "fvd_random_feat" if ndim == 3 else "fid_random_feat"
    assert abs(tr[key] - jr[key]) <= 1e-4 * jr[key]


@pytest.mark.parametrize("trap", ["erf_gelu", "symmetric_padding"])
def test_feature_net_traps_show(trap, monkeypatch):
    """jax.nn.gelu is the tanh form and XLA pads a stride-2 SAME window low
    by total // 2: either change moves the features past 10x the 1e-5
    tolerance (erf: 2.7e-4 at this shape)."""
    fp, _ = _videos(1, (1, 5, 33, 48, 3))
    jnet, kernels, head = _jax_net(3)
    if trap == "erf_gelu":
        gelu = torch.nn.functional.gelu
        monkeypatch.setattr(tfvd.F, "gelu", lambda x, approximate="none": gelu(x))
    else:
        monkeypatch.setattr(tfvd, "same_pads", lambda sizes: (1, 1) * len(sizes))
    tnet = tfvd.I3DLikeFeatures(device="cpu", kernels=kernels, head=head)
    assert _rel(jnet(fp), tnet(fp)) > 1e-4


def test_same_pads_are_xla_same():
    assert tfvd.same_pads((81, 480, 832)) == (0, 1, 0, 1, 1, 1)
    assert tfvd.same_pads((41, 240, 416)) == (0, 1, 0, 1, 1, 1)
    assert tfvd.same_pads((6, 5)) == (1, 1, 0, 1)
    assert tfvd.same_pads((1,)) == (1, 1)
    for n in range(1, 12):  # the padded side gives XLA's ceil(n / 2) outputs
        lo, hi = tfvd.same_pads((n,))
        assert (n + lo + hi - 3) // 2 + 1 == -(-n // 2)


@pytest.mark.parametrize("c", [16, 3, 4])
def test_latents_as_videos_exact(c):
    z = np.random.default_rng(c).standard_normal((2, c, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(tfvd.latents_as_videos(z), jfvd.latents_as_videos(z))


def test_the_port_draw_is_a_fixed_rank_preserving_probe():
    fp, _ = _videos(2, (3, 5, 32, 32, 3))
    kernels, head = tfvd.random_conv_weights(3, 256, 0)
    again = tfvd.random_conv_weights(3, 256, 0)
    assert all(np.array_equal(a, b) for a, b in zip(kernels + [head], again[0] + [again[1]]))
    assert kernels[0].shape == (3, 3, 3, 3, 16) and head.shape == (128, 256)
    net = tfvd.I3DLikeFeatures(device="cpu")
    assert tfvd.fvd(fp, fp, feature_fn=net) <= 1e-9
    rng = np.random.default_rng(5)
    noise = rng.standard_normal(fp.shape).astype(np.float32)
    d = [tfvd.fvd(fp, fp + s * noise, feature_fn=net) for s in (0.05, 0.2, 0.6)]
    assert d[0] < d[1] < d[2]
    rep = tfvd.fpfvd_report(fp, fp + 0.1 * noise, device="cpu")
    assert "fvd_random_feat" in rep and "fvd" not in rep
    assert "fvd" in tfvd.fpfvd_report(fp, fp, feature_fn=lambda v: net(v), device="cpu")


def test_feature_net_keeps_the_callers_tf32_setting():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with tfvd.full_f32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# clip_metrics.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clip_pair():
    cfg_j, cfg_t = jclip.tiny_clip_config(), tclip.tiny_clip_config()
    return (cfg_j, jclip.init_clip_params(cfg_j, seed=1),
            cfg_t, tclip.init_clip_params(cfg_t, seed=1, device="cpu"))


@pytest.mark.parametrize("chunk", [4, 8, 16], ids=["ragged_tail", "wanq_default", "one_chunk"])
def test_clip_frame_features_match(clip_pair, chunk):
    cfg_j, pj, cfg_t, pt = clip_pair
    fp, _ = _videos(6)
    want = jcm.clip_frame_features(pj, cfg_j, fp, frame_chunk=chunk)
    got = tcm.clip_frame_features(pt, cfg_t, fp, frame_chunk=chunk, device="cpu")
    assert got.shape == want.shape == (2, 5, cfg_t.embed_dim)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_clip_report_and_clipscore_match(clip_pair):
    cfg_j, pj, cfg_t, pt = clip_pair
    fp, q = _videos(7, noise=0.3)
    ids = np.random.default_rng(8).integers(2, cfg_t.vocab_size, (2, 7))
    ids[1, 5:] = cfg_t.pad_id
    want = jcm.clip_fidelity_report(fp, q, pj, cfg_j, text_ids=ids)
    got = tcm.clip_fidelity_report(fp, q, pt, cfg_t, text_ids=ids, device="cpu")
    assert set(got) == set(want) and "clipsim_fp" in got
    for k in want:
        assert abs(got[k] - float(want[k])) <= 1e-5, k
    img = fp[:, 0]
    want = jim.clipscore(img, ids, pj, cfg_j)
    got = tim.clipscore(img, ids, pt, cfg_t, device="cpu")
    assert abs(got - want) <= 1e-5


@pytest.mark.parametrize("t", [5, 1])
def test_temporal_flickering_and_clip_temp_match(t):
    fp, _ = _videos(9, (2, t, 8, 8, 3))
    assert abs(tcm.temporal_flickering(fp) - jcm.temporal_flickering(fp)) <= 1e-6
    feats = np.random.default_rng(10).standard_normal((2, t, 4))
    assert tcm.clip_temp(feats) == jcm.clip_temp(feats)
    assert tcm.clipsim(feats, feats[:, 0]) == jcm.clipsim(feats, feats[:, 0])


# ---------------------------------------------------------------------------
# flow.py
# ---------------------------------------------------------------------------


def _moving(shift, frames=5, side=64, scale=1.0):
    yy, xx = np.mgrid[0:side, 0:side] / side
    base = 0.5 + 0.3 * np.sin(2 * np.pi * xx * 3) * np.cos(2 * np.pi * yy * 2)
    return scale * np.stack([np.stack([np.roll(base, shift * i, axis=1)] * 3, -1)
                             for i in range(frames)])[None].astype(np.float32)


@pytest.mark.parametrize("case", ["static", "shift1", "shift3", "two_videos_255_scale",
                                  "downscaled_channels_first", "random"])
def test_flow_score_matches(case):
    if case == "static":
        v = _moving(0)
    elif case == "shift1":
        v = _moving(1)
    elif case == "shift3":
        v = _moving(3)
    elif case == "two_videos_255_scale":
        v = np.concatenate([_moving(1, scale=255.0), _moving(2, scale=255.0)])
    elif case == "downscaled_channels_first":  # 200 px sides: one halving, scale 2
        v = np.repeat(np.repeat(_moving(2, side=100), 2, 2), 2, 3).transpose(0, 4, 1, 2, 3)
    else:
        v = _videos(11, (2, 4, 40, 56, 3))[0]
    want = jflow.flow_score(v)
    got = tflow.flow_score(v, device="cpu")
    if case == "static":
        assert want == got == 0.0
    else:
        assert want > 0 and abs(got - want) <= 1e-4 * want, (want, got)


def test_flow_score_odd_pyramid_levels_where_wanq_tpu_raises():
    """A pyramid level with an odd side (50 x 75 -> 25 x 37 -> 12 x 18):
    wanq_tpu's upsampled flow is a row and a column short and its warp
    raises; the port edge-extends it and scores the motion."""
    v = _moving(2, side=100)[:, :, :50, :75]
    with pytest.raises(ValueError, match="could not be broadcast"):
        jflow.flow_score(v)
    got = tflow.flow_score(v, device="cpu")
    assert np.isfinite(got) and got > 0.5
    up = tflow._upsample2(torch.arange(6.0).reshape(1, 2, 3), (5, 7))
    assert up.shape == (1, 5, 7) and torch.equal(up[0, 4], up[0, 3])
    assert torch.equal(up[0, :, 6], up[0, :, 5])


def test_flow_score_single_frame_and_bad_rank():
    v = _moving(1, frames=1)
    assert tflow.flow_score(v, device="cpu") == jflow.flow_score(v) == 0.0
    with pytest.raises(ValueError, match="flow_score needs videos"):
        tflow.flow_score(v[0], device="cpu")


# ---------------------------------------------------------------------------
# cli/evaluate.py
# ---------------------------------------------------------------------------

ELEMENTWISE = ("psnr_db", "rel_err", "cosine", "nonfinite_quant", "nonfinite_fp")


@pytest.fixture
def same_nets(monkeypatch):
    """The port's random nets take wanq_tpu's weights; ViT-H becomes the
    tiny CLIP config in both packages (a full tower is minutes on the CPU)."""
    monkeypatch.setattr(tfvd, "random_conv_weights",
                        lambda ndim, feat_dim, seed: _jax_net(ndim, feat_dim, seed)[1:])
    monkeypatch.setattr(jclip, "CLIP_XLM_ROBERTA_VIT_H_14", jclip.tiny_clip_config())
    monkeypatch.setattr(tclip, "CLIP_XLM_ROBERTA_VIT_H_14", tclip.tiny_clip_config())


def _npz_pair(tmp_path, kind):
    fp, q = _videos(12)
    rng = np.random.default_rng(13)
    lat = rng.standard_normal((2, 16, 3, 4, 6)).astype(np.float32)
    lat_q = (lat + 0.05 * rng.standard_normal(lat.shape)).astype(np.float32)
    pair = {
        "videos": ({"videos": fp}, {"videos": q}),
        "latents": ({"latents": lat}, {"latents": lat_q}),
        "images": ({"images": fp[:, 0]}, {"images": q[:, 0]}),
        "bare_5d_videos": ({"arr_0": fp}, {"arr_0": q}),
        "bare_5d_latents": ({"x": lat}, {"x": lat_q}),
        "bare_4d_images": ({"arr_0": fp[:, 0]}, {"arr_0": q[:, 0]}),
        # generate / fp_generate save both: evaluate scores the latents
        "generate_npz": ({"latents": lat, "video": fp.transpose(0, 4, 1, 2, 3)},
                         {"latents": lat_q, "video": q.transpose(0, 4, 1, 2, 3)}),
    }[kind]
    paths = []
    for name, arrays in zip(("fp", "q"), pair):
        np.savez(tmp_path / f"{kind}_{name}.npz", **arrays)
        paths.append(str(tmp_path / f"{kind}_{name}.npz"))
    return paths


def _compare_reports(want, got, loose=1e-4):
    assert set(got) == set(want)
    for k, w in want.items():
        _close(float(w), got[k], 1e-9 if k in ELEMENTWISE else loose)


@pytest.mark.parametrize("kind", ["videos", "latents", "images", "bare_5d_videos",
                                  "bare_5d_latents", "bare_4d_images", "generate_npz"])
def test_evaluate_matches_wanq_tpu(kind, tmp_path, same_nets, capsys):
    fp, q = _npz_pair(tmp_path, kind)
    flags = ["--fp", fp, "--quant", q, "--clip_metrics"]
    if kind not in ("images", "bare_4d_images"):
        flags.append("--flow_score")
    want = jeval.main(flags)
    got = teval.main(flags + ["--device", "cpu"])
    _compare_reports(want, got)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == got
    assert "clip_random_init" in got and ("fvd_random_feat" in got or "fid_random_feat" in got)
    if kind in ("images", "bare_4d_images"):
        assert not any(k.startswith(("clip_temp", "flicker")) for k in got)


def test_evaluate_scores_the_latents_of_a_generate_npz(tmp_path, same_nets):
    """A generate npz holds 'latents' and 'video'; 'latents' wins, as in
    wanq_tpu: the report equals the latents-only one."""
    both = _npz_pair(tmp_path, "generate_npz")
    only = _npz_pair(tmp_path, "latents")
    assert teval._load(both[0])[1] == "latents"
    assert (teval.main(["--fp", both[0], "--quant", both[1], "--device", "cpu"])
            == teval.main(["--fp", only[0], "--quant", only[1], "--device", "cpu"]))


def test_evaluate_non_default_net_matches(tmp_path, same_nets):
    fp, q = _npz_pair(tmp_path, "videos")
    flags = ["--fp", fp, "--quant", q, "--feat_dim", "64", "--seed", "3"]
    _compare_reports(jeval.main(flags), teval.main(flags + ["--device", "cpu"]))


def test_evaluate_refusals_match(tmp_path, same_nets):
    fp, q = _npz_pair(tmp_path, "images")
    flags = ["--fp", fp, "--quant", q, "--flow_score"]
    with pytest.raises(SystemExit, match="--flow_score needs videos"):
        jeval.main(flags)
    with pytest.raises(SystemExit, match="--flow_score needs videos"):
        teval.main(flags + ["--device", "cpu"])
    np.savez(tmp_path / "bad.npz", x=np.zeros((2, 3, 4)))
    with pytest.raises(SystemExit, match="expected videos"):
        teval.main(["--fp", str(tmp_path / "bad.npz"), "--quant", q, "--device", "cpu"])
    v_fp, _ = _npz_pair(tmp_path, "videos")
    with pytest.raises(SystemExit, match="--fp is videos"):
        teval.main(["--fp", v_fp, "--quant", q, "--device", "cpu"])


def test_cuda_device_without_a_card_raises(tmp_path, monkeypatch):
    """--device cuda (the default) raises where torch sees no card; nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fp, q = _npz_pair(tmp_path, "videos")
    with pytest.raises(SystemExit, match="no CUDA device"):
        teval.main(["--fp", fp, "--quant", q])
    if not torch.backends.cuda.is_built():  # a CPU build refuses the transfer itself
        v = np.zeros((1, 2, 8, 8, 3), np.float32)
        for call in (lambda: tflow.flow_score(v), lambda: tfvd.I3DLikeFeatures()(v),
                     lambda: tmet.psnr(v, v)):
            with pytest.raises((AssertionError, RuntimeError)):
                call()
