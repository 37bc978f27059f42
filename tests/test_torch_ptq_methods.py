"""SmoothQuant masks, Hadamard rotations and the quant-state artifact of the
port (wanq_tpu_torch.quant.{smooth,hadamard,ptq,synthetic}, cli.ptq,
quant_generate --quant_params) against wanq_tpu on the CPU, on the same
numpy inputs.

Tolerances, as observed and stated per test:
- the Paley bases, get_hadK and the rotations: equal (the f64 butterflies
  run the same additions; the K x K base product is exact on +-1 entries
  up to f64 rounding, which the f32 cast absorbs);
- channel_mask: rel <= 1e-6 (torch.pow and XLA's pow differ by an ulp on
  some inputs: observed 2e-7);
- PTQ state: scales and masks rel <= 1e-6; int codes equal except one-unit
  flips on <= 1e-3 of them (a mask one ulp apart moves an exact .5 tie:
  observed 1.8e-5 to 1.5e-4 under viditq, none under quarot), ``w_q`` off by
  at most one quant step where a code flipped;
- forwards: as the other bf16 tests of the port, rel-L2 <= 5e-3 in sim mode
  and <= 2e-2 in int8 mode, cosine >= 0.999.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.quant import attn as jattn
from wanq_tpu.quant import config as jconfig
from wanq_tpu.quant import hadamard as jhad
from wanq_tpu.quant import ptq as jptq
from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
from wanq_tpu.quant.qlinear import qlinear as jax_qlinear
from wanq_tpu.quant import smooth as jsmooth
from wanq_tpu.quant import synthetic as jsyn
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import quant_state_from_numpy
from wanq_tpu_torch.ops import fused as tfused
from wanq_tpu_torch.quant import config as tconfig
from wanq_tpu_torch.quant import hadamard as thad
from wanq_tpu_torch.quant import ptq as tptq
from wanq_tpu_torch.quant import qlinear as tql
from wanq_tpu_torch.quant import smooth as tsmooth
from wanq_tpu_torch.quant import synthetic as tsyn
from wanq_tpu_torch.quant.quantizers import unpack_int4

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDITQ_YAML = os.path.join(ROOT, "quant_configs", "config.yaml")
W8 = {"weight": {"n_bits": 8, "sym": False}, "act": {"n_bits": 8, "sym": True}}
FP_REGEX = r"text_embedding|time_embedding|time_projection|head\.head"
METHODS = {"smooth_quant": {"alpha": 0.5665, "layer_name_regex": ""},
           "quarot": {"layer_name_regex": ""},
           "viditq": {"alpha": 0.5665, "layer_name_regex": ""}}
SMALL = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
             freq_dim=64, param_dtype="bfloat16", residual_dtype="bfloat16")


def _method_cfg(method, weight=None, **extra):
    return dict(W8, **({"weight": weight} if weight else {}), remain_fp_regex=FP_REGEX,
                **{method: METHODS[method]}, **extra)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def _models(seed, **kw):
    """The same weights in both packages, head.head redrawn (the reference
    zero-inits it)."""
    cfg_j, cfg_t = jax_tiny_config(**kw), tiny_config(**kw)
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(seed))
    pt = tdit.init_params(cfg_t, seed, device="cpu")
    hw = (np.random.default_rng(seed + 100).normal(size=(cfg_t.dim, 64)) * 0.02).astype(
        np.float32)
    pj["head"]["head"]["w"] = jnp.asarray(hw, dtype=cfg_j.dtype)
    pt["head"]["head"]["w"] = torch.from_numpy(hw).to(cfg_t.dtype)
    return cfg_j, pj, cfg_t, pt


def _calib(names, cfg, rng):
    """Per-channel absmax stacks [2, C_in] for every block linear."""
    return {n: np.abs(rng.normal(size=(2, cfg.ffn_dim if n.endswith("ffn.2") else cfg.dim)))
            .astype(np.float32) for n in names if n.startswith("blocks.")}


def assert_state_close(got, want, flip_frac=1e-3):
    """Port state against the JAX state through the converter: same keys;
    int codes equal except one-unit flips on <= flip_frac; w_q within one
    quant step where a code flipped, on as few elements; the rest rel <= 1e-6."""
    assert sorted(got) == sorted(want)
    for name, st in got.items():
        assert sorted(st) == sorted(want[name]), name
        for key, val in st.items():
            ref = want[name][key]
            assert val.shape == ref.shape and val.dtype == ref.dtype, (name, key)
            if key in ("w_int8", "w_int4", "w_int4g"):
                a, b = ((unpack_int4(val), unpack_int4(ref)) if key != "w_int8"
                        else (val, ref))
                diff = (a.int() - b.int()).abs()
                assert diff.max() <= 1 and (diff > 0).float().mean() <= flip_frac, (name, key)
            elif key == "w_q":
                step = st["delta_w"].double()[None, :] if "delta_w" in st else None
                diff = (val.double() - ref.double()).abs()
                off = diff > 1e-6 * ref.double().abs().clamp_min(1e-6)
                assert off.float().mean() <= flip_frac, (name, key)
                if step is not None:
                    assert bool((diff <= 1.001 * step).all()), (name, key)
            else:
                np.testing.assert_allclose(val.numpy(), ref.numpy(), rtol=1e-6, atol=0,
                                           err_msg=f"{name}.{key}")


# ---------------------------------------------------------------------------
# Hadamard and SmoothQuant building blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [4, 12, 20, 60, 108, 140])
def test_paley_hadamard_matches_jax(order):
    """The base orders of the Wan widths: the same +-1 matrix, and Hadamard."""
    h = thad.paley_hadamard(order)
    np.testing.assert_array_equal(h, jhad.paley_hadamard(order))
    np.testing.assert_array_equal(h.astype(np.int64) @ h.T, order * np.eye(order, dtype=np.int64))


@pytest.mark.parametrize("n", [96, 1536, 5120, 8960, 13824, 4096])
def test_get_hadK_matches_jax(n):
    (hj, kj), (ht, kt) = jhad.get_hadK(n), thad.get_hadK(n)
    assert kt == kj and (ht is None) == (hj is None)
    if ht is not None:
        np.testing.assert_array_equal(ht, hj)


@pytest.mark.parametrize("n", [64, 96, 384])
def test_matmul_hadU_matches_jax(rng, n):
    """f64 against the JAX package's host transform (rel 1e-12, observed
    exact) and f32 against its jnp transform (rtol 1e-5, the base product's
    f32 sums in another order); norms kept."""
    x = rng.normal(size=(5, n))
    y64 = thad.matmul_hadU(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y64, jhad.matmul_hadU_np(x), rtol=1e-12, atol=1e-12)
    x32 = x.astype(np.float32)
    y32 = thad.matmul_hadU(torch.from_numpy(x32))
    assert y32.dtype == torch.float32
    np.testing.assert_allclose(y32.numpy(), np.asarray(jhad.matmul_hadU(jnp.asarray(x32))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(y64, axis=1), np.linalg.norm(x, axis=1),
                               rtol=1e-12)


@pytest.mark.parametrize("n", [96, 640, 1536])
def test_rotation_for_dim_matches_jax(n):
    """Same signs from the same seed, same matrix to the bit in f32;
    orthonormal; another seed gives another rotation."""
    q = thad.rotation_for_dim(n, seed=3, device="cpu")
    assert q.dtype == torch.float32 and q.shape == (n, n)
    np.testing.assert_array_equal(q.numpy(), jhad.rotation_for_dim(n, seed=3).astype(np.float32))
    q64 = thad.random_hadamard_matrix(n, thad.derived_rotation_seed(n, 3), device="cpu")
    np.testing.assert_allclose((q64 @ q64.T).numpy(), np.eye(n), atol=1e-10)
    assert thad.derived_rotation_seed(n, 3) == jhad.derived_rotation_seed(n, 3)
    assert not torch.equal(q, thad.rotation_for_dim(n, seed=4, device="cpu"))


@pytest.mark.parametrize("c_in", [96, 1536])
def test_rotate_weight_fwht_matches_jax(rng, c_in):
    """The f64 weight rotation equals the JAX package's host f64 one after
    the f32 cast, and Q^T W with Q = rotation_for_dim's matrix."""
    w = rng.normal(size=(c_in, 40)).astype(np.float32)
    got = thad.rotate_weight_fwht(torch.from_numpy(w), 11)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), jhad.rotate_weight_fwht(w, 11).astype(np.float32))
    q = thad.random_hadamard_matrix(c_in, 11, device="cpu")
    np.testing.assert_allclose(got.double().numpy(), (q.T @ torch.from_numpy(w).double()).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_channel_mask_matches_jax(rng):
    w = (rng.normal(size=(96, 64)) * np.exp(rng.normal(size=(96, 1)))).astype(np.float32)
    a = np.abs(rng.normal(size=96)).astype(np.float32) * 3
    a[5] = 0.0  # below the calibration floor
    a_c = tsmooth.clamp_act_absmax(torch.from_numpy(a))
    np.testing.assert_array_equal(a_c.numpy(),
                                  np.asarray(jsmooth.clamp_act_absmax(jnp.asarray(a))))
    # reduce_calib applies the same floor after the max over steps
    stack = np.stack([a * 0.5, a])
    np.testing.assert_array_equal(tptq.reduce_calib({"l": stack})["l"], a_c.numpy())
    np.testing.assert_array_equal(tptq.reduce_calib({"l": stack})["l"],
                                  jptq.reduce_calib({"l": stack})["l"])
    got = tsmooth.channel_mask(torch.from_numpy(w), a_c, 0.5665).numpy()
    want = np.asarray(jsmooth.channel_mask(jnp.asarray(w), jnp.asarray(a_c.numpy()), 0.5665))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# PTQ state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("targets", ["sim", "int8"])
@pytest.mark.parametrize("method", list(METHODS))
def test_prepare_quant_state_methods_match_jax(rng, method, targets):
    """SmoothQuant (FQ(w / mask)), QuaRot (FQ(rot(w))) and ViDiT-Q
    (FQ(rot(FQ(w / mask)))) on every block linear of the tiny model (widths
    96 and 192: base order 12), JAX's state through the converter; the
    rotations {C_in: [C_in, C_in]} equal."""
    cfg_j, cfg_t = jax_tiny_config(), tiny_config()
    names = jdit.linear_layer_names(cfg_j)
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(4))
    pt = tdit.init_params(cfg_t, 4, device="cpu")
    calib = _calib(names, cfg_t, rng)
    qd = _method_cfg(method)
    _, st_j, rot_j = jptq.prepare_quant_state(pj, names, jconfig.QuantConfig.from_dict(qd),
                                              calib=calib, targets=targets)
    pol_t, st_t, rot_t = tptq.prepare_quant_state(pt, names, tconfig.QuantConfig.from_dict(qd),
                                                  calib=calib, targets=targets)
    assert all(pol_t[n].method == method for n in st_t)
    assert_state_close(st_t, quant_state_from_numpy(jax.tree.map(np.asarray, st_j), "cpu"))
    assert sorted(rot_t) == sorted(rot_j) == ([] if method == "smooth_quant" else [96, 192])
    for d, q in rot_t.items():
        np.testing.assert_array_equal(q.numpy(), np.asarray(rot_j[d]))


def test_prepare_quant_state_config_yaml_matches_jax(rng):
    """quant_configs/config.yaml, the source's shipped config: ViDiT-Q W8A8
    on self-attention q/k/v only, seed 5, targets both."""
    cfg_j, cfg_t = jax_tiny_config(), tiny_config()
    names = jdit.linear_layer_names(cfg_j)
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(2))
    pt = tdit.init_params(cfg_t, 2, device="cpu")
    calib = _calib(names, cfg_t, rng)
    _, st_j, rot_j = jptq.prepare_quant_state(
        pj, names, jconfig.QuantConfig.from_yaml(VIDITQ_YAML), calib=calib, seed=5)
    pol, st_t, rot_t = tptq.prepare_quant_state(
        pt, names, tconfig.QuantConfig.from_yaml(VIDITQ_YAML), calib=calib, seed=5)
    assert sorted(st_t) == sorted(f"blocks.{i}.self_attn.{x}" for i in range(2) for x in "qkv")
    assert all(pol[n].method == "viditq" for n in st_t)
    assert_state_close(st_t, quant_state_from_numpy(jax.tree.map(np.asarray, st_j), "cpu"))
    np.testing.assert_array_equal(rot_t[96].numpy(), np.asarray(rot_j[96]))
    with pytest.raises(ValueError, match="no calibration data"):
        tptq.prepare_quant_state(pt, names, tconfig.QuantConfig.from_yaml(VIDITQ_YAML))


def test_unported_refusals_fire_before_the_calibration_check():
    """GPTQ and SVDQuant low-rank still raise NotImplementedError, ahead of
    the missing-calibration ValueError their YAMLs' masks would raise."""
    cfg = tiny_config()
    params = tdit.init_params(cfg, 0, device="cpu")
    names = tdit.linear_layer_names(cfg)
    for yaml in ("wan_w4a8_gptq.yaml", "wan_svdquant.yaml"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
            tptq.prepare_quant_state(params, names, tconfig.QuantConfig.from_yaml(
                os.path.join(ROOT, "quant_configs", yaml)))
    with pytest.raises(ValueError, match="static activation quant cannot combine"):
        tptq.prepare_quant_state(params, names, tconfig.QuantConfig.from_dict(_method_cfg(
            "quarot", act={"n_bits": 8, "sym": True, "static_regex": "ffn"})),
            calib={f"{n}.act_{m}": np.ones((1, 192), np.float32) for n in names
                   for m in ("max", "min")})


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------


def _w4_viditq_state(rng, package):
    """A ViDiT-Q state with packed 4-bit weights (W4A8) on the tiny model,
    from either package."""
    qd = _method_cfg("viditq", weight={"n_bits": 4, "sym": False})
    names = jdit.linear_layer_names(jax_tiny_config())
    calib = _calib(names, tiny_config(), rng)
    if package == "jax":
        pj = jdit.init_params(jax_tiny_config(), jax.random.PRNGKey(6))
        return jptq.prepare_quant_state(pj, names, jconfig.QuantConfig.from_dict(qd),
                                        calib=calib, seed=9)
    pt = tdit.init_params(tiny_config(), 6, device="cpu")
    return tptq.prepare_quant_state(pt, names, tconfig.QuantConfig.from_dict(qd), calib=calib,
                                    seed=9)


def test_save_load_round_trip_and_rebuild_rotations(rng, tmp_path):
    """The port's npz loads back equal (packed int4 included), and
    rebuild_rotations reads C_in from the K-major layout: 2 * w_int4.shape[1]
    for packed weights, w_int8.shape[1], w_q.shape[0]."""
    pol, st, rot = _w4_viditq_state(rng, "torch")
    assert "w_int4" in st["blocks.0.self_attn.q"] and st["blocks.0.ffn.2"]["w_int4"].shape == (96, 96)
    bf = torch.arange(6, dtype=torch.float32).reshape(2, 3).bfloat16()
    st["blocks.0.ffn.0"]["extra_bf16"] = bf  # a bf16 entry takes the |bf16 key
    path = str(tmp_path / "qp.npz")
    tptq.save_quant_state(path, st, seed=9)
    keys = np.load(path).files
    assert "__seed__" in keys and "blocks.0.ffn.0|extra_bf16|bf16" in keys
    back, seed = tptq.load_quant_state(path, device="cpu")
    assert seed == 9 and sorted(back) == sorted(st)
    for name in st:
        for key, val in st[name].items():
            assert torch.equal(back[name][key], val), (name, key)
    del st["blocks.0.ffn.0"]["extra_bf16"]
    rebuilt = tptq.rebuild_rotations(back, pol, seed)
    assert sorted(rebuilt) == sorted(rot) == [96, 192]
    for d in rot:
        assert torch.equal(rebuilt[d], rot[d])
    # a sim state (w_q [C_in, C_out]) and an unpacked int8 one (K-major
    # [C_out, C_in]) give the same dims
    for only in ({n: {"w_q": st["w_q"]} for n, st in back.items()},
                 {n: {"w_int8": unpack_int4(st["w_int4"])} for n, st in back.items()}):
        assert sorted(tptq.rebuild_rotations(only, pol, seed)) == [96, 192]
    with pytest.raises(KeyError, match="no deployed weight"):
        tptq.rebuild_rotations({"blocks.0.ffn.0": {"delta_w": torch.ones(3)}}, pol, 0)


def test_npz_artifacts_load_across_packages(rng, tmp_path):
    """A JAX-written npz loads in the port equal to JAX's state through the
    converter, and the port's loads in wanq_tpu equal to the port's state in
    JAX's layout; each side's rebuild_rotations gives the other's matrices."""
    pol_j, st_j, rot_j = _w4_viditq_state(rng, "jax")
    jpath = str(tmp_path / "jax.npz")
    jptq.save_quant_state(jpath, st_j, seed=9)
    got, seed = tptq.load_quant_state(jpath, device="cpu")
    want = quant_state_from_numpy(jax.tree.map(np.asarray, st_j), "cpu")
    assert seed == 9 and sorted(got) == sorted(want)
    for name in want:
        for key, val in want[name].items():
            assert torch.equal(got[name][key], val), (name, key)
    rot_t = tptq.rebuild_rotations(got, pol_j, seed)
    assert sorted(rot_t) == sorted(rot_j)
    for d in rot_j:
        np.testing.assert_array_equal(rot_t[d].numpy(), np.asarray(rot_j[d]))

    pol_t, st_t, _ = _w4_viditq_state(rng, "torch")
    tpath = str(tmp_path / "torch.npz")
    tptq.save_quant_state(tpath, st_t, seed=9)
    back, seed = jptq.load_quant_state(tpath)
    assert seed == 9 and sorted(back) == sorted(st_t)
    for name, st in st_t.items():
        for key, val in st.items():
            ref = val.t() if key in ("w_int8", "w_int4", "w_int4g") else val
            np.testing.assert_array_equal(np.asarray(back[name][key]), ref.numpy(),
                                          err_msg=f"{name}.{key}")
    rot_back = jptq.rebuild_rotations(back, pol_t, seed)
    assert sorted(rot_back) == [96, 192]


@pytest.mark.parametrize("targets", ["sim", "int8"])
def test_load_quant_state_keeps_what_the_mode_reads(rng, tmp_path, targets):
    """A targets-both artifact loaded for one mode leaves out what only the
    other mode reads (the f32 w_q under int8; codes and their export scales
    under sim) and keeps the rest equal; an artifact without the mode's
    deployed weight raises."""
    _, st, _ = _w4_viditq_state(rng, "torch")
    path = str(tmp_path / "both.npz")
    tptq.save_quant_state(path, st, seed=9)
    got, seed = tptq.load_quant_state(path, device="cpu", targets=targets)
    dropped = ({"w_int8", "w_int4", "w_int4g", "scale_w", "zp_w_int", "scale_wg"}
               if targets == "sim" else {"w_q"})
    assert seed == 9 and sorted(got) == sorted(st)
    for name in st:
        assert sorted(got[name]) == sorted(set(st[name]) - dropped), name
        for key, val in got[name].items():
            assert torch.equal(val, st[name][key]), (name, key)
    other = "int8" if targets == "sim" else "sim"
    one = str(tmp_path / "one.npz")
    tptq.save_quant_state(one, {n: {k: v for k, v in s.items() if k not in dropped}
                                for n, s in st.items()}, seed=9)
    with pytest.raises(KeyError, match=f"no deployed {other} weight"):
        tptq.load_quant_state(one, device="cpu", targets=other)
    with pytest.raises(ValueError, match="targets"):
        tptq.load_quant_state(path, device="cpu", targets="fp")


def test_strip_quantized_weights_matches_jax():
    """Every quantized layer's w becomes a [1, 1] placeholder of its dtype;
    biases, FP layers and the caller's tree stay as they were."""
    cfg = tiny_config(param_dtype="bfloat16")
    params = tdit.init_params(cfg, 0, device="cpu")
    names = tdit.linear_layer_names(cfg)
    pol = {n: tconfig.QuantConfig.from_yaml(VIDITQ_YAML).resolve(n) for n in names}
    out = tptq.strip_quantized_weights(params, pol)
    pj = jdit.init_params(jax_tiny_config(param_dtype="bfloat16"), jax.random.PRNGKey(0))
    out_j = jptq.strip_quantized_weights(pj, pol)
    for name in names:
        leaf, orig = tptq.params_get(out, name), tptq.params_get(params, name)
        leaf_j = jptq.params_get(out_j, name)
        assert tuple(leaf["w"].shape) == tuple(leaf_j["w"].shape), name
        if pol[name].is_quantized:
            assert leaf["w"].shape == (1, 1) and leaf["w"].dtype == torch.bfloat16
            assert orig["w"].shape == (96, 96)  # the input tree is untouched
            assert leaf["b"] is orig["b"]
        else:
            assert leaf["w"] is orig["w"]


def _reference_pth(path, rng):
    """A quant_params.pth in the original repository's layout: an FSDP
    prefix, a masked weight quantizer, a static and a dynamic act
    quantizer, and a rotated layer."""
    c_out, c_in = 96, 96
    d = {
        "_fsdp_wrapped_module.blocks.0.self_attn.q.w_quantizer": {
            "delta": torch.rand(c_out, 1) * 0.01 + 1e-3,
            "zero_point": torch.randint(-5, 5, (c_out, 1)).float(),
            "channel_mask": torch.rand(c_in) + 0.5},
        "blocks.0.self_attn.q.a_quantizer": {"delta": torch.rand(4, 1),
                                             "zero_point": torch.zeros(4, 1)},
        "blocks.0.ffn.2.w_quantizer": {"delta": torch.rand(c_out, 1) * 0.01 + 1e-3,
                                       "zero_point": torch.zeros(c_out, 1)},
        "blocks.0.ffn.2.a_quantizer": {"delta": torch.tensor([0.05]),
                                       "zero_point": torch.tensor([0.0])},
        "blocks.1.self_attn.k.w_quantizer": {"delta": torch.rand(c_out, 1),
                                             "zero_point": torch.zeros(c_out, 1),
                                             "rotation_matrix": None},
    }
    torch.save(d, path)
    calib = {"blocks.0.self_attn.q": torch.rand(3, c_in), "blocks.0.ffn.2": torch.rand(3, 192)}
    torch.save(calib, path + ".calib")
    return d


def test_reference_pth_importers_match_jax(rng, tmp_path):
    """load_reference_calib / load_reference_quant_params against the JAX
    package's on the same .pth; state_from_reference_params deploys the
    imported grids as JAX's does (int weights K-major) and refuses rotated
    layers; compare_scale_dicts reports as JAX's does."""
    path = str(tmp_path / "quant_params.pth")
    _reference_pth(path, rng)
    cal_t, cal_j = tptq.load_reference_calib(path + ".calib"), jptq.load_reference_calib(
        path + ".calib")
    assert sorted(cal_t) == sorted(cal_j)
    for k in cal_j:
        np.testing.assert_array_equal(cal_t[k], cal_j[k])
    imp_t, imp_j = tptq.load_reference_quant_params(path), jptq.load_reference_quant_params(path)
    assert sorted(imp_t) == sorted(imp_j) == ["blocks.0.ffn.2", "blocks.0.self_attn.q",
                                              "blocks.1.self_attn.k"]
    for layer in imp_j:
        assert sorted(imp_t[layer]) == sorted(imp_j[layer])
        for k in imp_j[layer]:
            np.testing.assert_array_equal(imp_t[layer][k], imp_j[layer][k])

    cfg = tiny_config()
    pt = tdit.init_params(cfg, 1, device="cpu")
    pj = jdit.init_params(jax_tiny_config(), jax.random.PRNGKey(1))
    qc = tconfig.QuantConfig.from_dict(dict(W8, remain_fp_regex=r"^(?!blocks\.0\.(self_attn\.q"
                                                                 r"|ffn\.2)$)",
                                            act={"n_bits": 8, "sym": True,
                                                 "static_regex": r"ffn\.2"}))
    pol = {n: qc.resolve(n) for n in tdit.linear_layer_names(cfg)}
    assert sum(p.is_quantized for p in pol.values()) == 2
    for targets in ("sim", "int8"):
        got = tptq.state_from_reference_params(pt, pol, imp_t, targets=targets)
        want = jptq.state_from_reference_params(pj, pol, imp_j, targets=targets)
        assert_state_close(got, quant_state_from_numpy(jax.tree.map(np.asarray, want), "cpu"),
                           flip_frac=0.0)
        assert ("delta_a" in got["blocks.0.ffn.2"]) and "channel_mask" in got[
            "blocks.0.self_attn.q"]
    pol["blocks.1.self_attn.k"] = pol["blocks.0.self_attn.q"]
    with pytest.raises(ValueError, match="rotation"):
        tptq.state_from_reference_params(pt, pol, imp_t)
    ours = tptq.state_from_reference_params(pt, {k: v for k, v in pol.items()
                                                 if k != "blocks.1.self_attn.k"}, imp_t)
    ours["blocks.0.ffn.2"]["delta_w"] = ours["blocks.0.ffn.2"]["delta_w"] * 1.01
    rep_t = tptq.compare_scale_dicts(ours, imp_t)
    rep_j = jptq.compare_scale_dicts(jax.tree.map(lambda t: t.numpy(), ours), imp_j)
    assert rep_t["pass"] is rep_j["pass"] is False
    assert rep_t["worst"][:2] == rep_j["worst"][:2] == ("blocks.0.ffn.2", "delta_w")
    np.testing.assert_allclose(rep_t["worst"][2], rep_j["worst"][2], rtol=1e-6)


@pytest.mark.parametrize("mode", ["sim", "int8"])
def test_reference_static_masked_site_matches_jax(rng, tmp_path, mode):
    """A reference .pth whose layer has a SmoothQuant channel_mask and a
    static (per-tensor) a_quantizer, deployed by state_from_reference_params
    in both packages: the port's qlinear quantizes x * mask with the frozen
    scale in sim and in int8 mode, as JAX's does (rel-L2 <= 2e-3: bf16
    operands in sim, f32 sums in another order in int8)."""
    c, o = 192, 96
    x = rng.normal(size=(2, 40, c)).astype(np.float32)
    x[..., 7] *= 30.0  # a hot channel, which the mask scales down
    w = rng.normal(size=(c, o)).astype(np.float32) * 0.05
    b = rng.normal(size=o).astype(np.float32)
    mask = (rng.uniform(size=c) + 0.5).astype(np.float32)
    mask[7] = 0.05
    wm = w / mask[:, None]
    delta_w = np.abs(wm).max(0) / 127.0
    xm_max = float(np.abs(x * mask).max())
    path = str(tmp_path / "quant_params.pth")
    torch.save({"blocks.0.ffn.2.w_quantizer": {"delta": torch.from_numpy(delta_w)[:, None],
                                               "zero_point": torch.zeros(o, 1),
                                               "channel_mask": torch.from_numpy(mask)},
                "blocks.0.ffn.2.a_quantizer": {"delta": torch.tensor([xm_max / 127.0]),
                                               "zero_point": torch.tensor([0.0])}}, path)
    qd = _method_cfg("smooth_quant", weight={"n_bits": 8, "sym": True},
                     act={"n_bits": 8, "sym": True, "static_regex": r"ffn\.2"})
    pol = {"blocks.0.ffn.2": tconfig.QuantConfig.from_dict(qd).resolve("blocks.0.ffn.2")}
    pol_j = {"blocks.0.ffn.2": jconfig.QuantConfig.from_dict(qd).resolve("blocks.0.ffn.2")}
    assert pol["blocks.0.ffn.2"].uses_channel_mask and not pol["blocks.0.ffn.2"].act.dynamic
    st_t = tptq.state_from_reference_params({"blocks": [{"ffn": {"2": {"w": torch.from_numpy(w)}}}]},
                                            pol, tptq.load_reference_quant_params(path),
                                            targets=mode)
    st_j = jptq.state_from_reference_params({"blocks": [{"ffn": {"2": {"w": jnp.asarray(w)}}}]},
                                            pol_j, jptq.load_reference_quant_params(path),
                                            targets=mode)
    assert {"channel_mask", "delta_a"} <= set(st_t["blocks.0.ffn.2"])
    jctx = JaxQuantCtx(mode=mode, policies=pol_j, state=st_j, rotations={})
    want = np.asarray(jax_qlinear(jctx, "blocks.0.ffn.2",
                                  {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)))
    tctx = tql.QuantCtx(mode=mode, policies=pol, state=st_t, rotations={})
    got = tql.qlinear(tctx, "blocks.0.ffn.2",
                      {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x))
    assert _rel(want, got.numpy()) <= 2e-3
    # W8A8 of the masked product stays near the FP product (observed
    # 1.9e-2); the raw input under the masked input's frozen scale clips
    # the hot channel (rel ~1.9)
    assert _rel(x @ w + b, got.numpy()) <= 5e-2


# ---------------------------------------------------------------------------
# qlinear and the forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sim", "int8"])
@pytest.mark.parametrize("method", list(METHODS))
def test_qlinear_methods_match_jax(rng, method, mode):
    """One masked / rotated linear on the same state (JAX's, converted) in
    sim and int8 mode: rel-L2 <= 2e-3 (bf16 operands in sim, int codes in
    int8; the f32 rotation product sums in another order)."""
    c, o = 192, 96
    w = rng.normal(size=(c, o)).astype(np.float32) * 0.05
    b = rng.normal(size=o).astype(np.float32)
    x = rng.normal(size=(2, 40, c)).astype(np.float32)
    x[..., 7] *= 30.0  # a hot channel
    qc_j = jconfig.QuantConfig.from_dict(_method_cfg(method))
    calib = {"blocks.0.ffn.2": np.abs(x).reshape(-1, c).max(0)[None]}
    pol, st, rot = jptq.prepare_quant_state({"blocks": [{"ffn": {"2": {"w": jnp.asarray(w)}}}]},
                                            ["blocks.0.ffn.2"], qc_j, calib=calib,
                                            targets=mode)
    jctx = JaxQuantCtx(mode=mode, policies=pol, state=st, rotations=rot)
    want = np.asarray(jax_qlinear(jctx, "blocks.0.ffn.2",
                                  {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)))
    tctx = tql.QuantCtx(mode=mode, policies=pol,
                        state=quant_state_from_numpy(jax.tree.map(np.asarray, st), "cpu"),
                        rotations={d: torch.from_numpy(np.array(r)) for d, r in rot.items()})
    got = tql.qlinear(tctx, "blocks.0.ffn.2", {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                      torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _rel(want, got.numpy()) <= 2e-3
    if method != "smooth_quant":  # a rotated site without its rotation raises
        tctx.rotations = {}
        with pytest.raises(KeyError):
            tql.qlinear(tctx, "blocks.0.ffn.2", {"w": torch.from_numpy(w)}, torch.from_numpy(x))


@pytest.mark.parametrize("mode", ["sim", "int8"])
def test_dit_forward_config_yaml_matches_jax(rng, mode):
    """The small model (head dim 128, bf16) under config.yaml, each package
    with its own PTQ from the same calibration: q/k/v take LN + modulate,
    mask, rotation, then fake-quant (sim) or K7 -> K2 (int8; their plain
    versions here). rel-L2 <= 5e-3 (sim) / 2e-2 (int8), cosine >= 0.999."""
    cfg_j, pj, cfg_t, pt = _models(3, **SMALL)
    x = rng.normal(size=(2, 16, 3, 8, 10)).astype(np.float32)
    t = np.asarray([999.0, 500.0], np.float32)
    ctx_np = rng.normal(size=(2, 32, 64)).astype(np.float32)
    cc = tql.QuantCtx(mode="calib")
    tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(ctx_np), 64, ctx=cc)
    calib = {k: v.float().numpy()[None] for k, v in cc.collect.items()}
    names = tdit.linear_layer_names(cfg_t)
    pol, st, rot = tptq.prepare_quant_state(pt, names, tconfig.QuantConfig.from_yaml(VIDITQ_YAML),
                                            calib=calib, targets=mode)
    assert sorted(rot) == [256]
    got = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(ctx_np), 64,
                           ctx=tql.QuantCtx(mode=mode, policies=pol, state=st,
                                            rotations=rot)).numpy()
    pol_j, st_j, rot_j = jptq.prepare_quant_state(
        pj, names, jconfig.QuantConfig.from_yaml(VIDITQ_YAML), calib=calib, targets=mode)
    want = np.asarray(jax.jit(lambda p, q, a, b, c: jdit.dit_forward(p, cfg_j, a, b, c, 64, ctx=q))(
        pj, JaxQuantCtx(mode=mode, policies=pol_j, state=st_j, rotations=rot_j), x, t, ctx_np))
    fp = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                          torch.from_numpy(ctx_np), 64).numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    assert _rel(want, got) <= (5e-3 if mode == "sim" else 2e-2) and _cos(want, got) >= 0.999
    assert _rel(fp, got) > 1e-4  # the quantization is really there


def test_dit_forward_smooth_quant_int8_routes_and_matches_jax(rng, monkeypatch):
    """A smooth_quant W8A8 dict config (every block linear, dynamic
    activations) in int8 mode: K1 takes ffn.0's mask as its channel_scale,
    K7 takes ffn.2's on the GELU output; self q/k/v and the masked cross q
    leave the fused producers for plain LN + qlinear, whose K7 gets the
    mask, as in JAX. rel-L2 <= 2e-2, cosine >= 0.999 against JAX on the same
    state."""
    import wanq_tpu_torch.models.dit as tdit_mod
    import wanq_tpu_torch.quant.qlinear as tql_mod

    cfg_j, pj, cfg_t, pt = _models(3, **SMALL)
    x = rng.normal(size=(2, 16, 3, 8, 10)).astype(np.float32)
    t = np.asarray([999.0, 500.0], np.float32)
    ctx_np = rng.normal(size=(2, 32, 64)).astype(np.float32)
    names = tdit.linear_layer_names(cfg_t)
    cc = tql.QuantCtx(mode="calib")
    tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(ctx_np), 64, ctx=cc)
    calib = {k: v.float().numpy()[None] for k, v in cc.collect.items()}
    qd = _method_cfg("smooth_quant")
    pol, st, rot = jptq.prepare_quant_state(pj, names, jconfig.QuantConfig.from_dict(qd),
                                            calib=calib, targets="int8")
    assert rot == {}
    tctx = tql.QuantCtx(mode="int8", policies=pol,
                        state=quant_state_from_numpy(jax.tree.map(np.asarray, st), "cpu"))
    assert tql.int8_fusable(tctx, ["blocks.0.ffn.0"], allow_mask=True)
    assert not tql.int8_fusable(tctx, ["blocks.0.cross_attn.q"])

    seen = {"k1": [], "k7": []}
    real_k1, real_k7 = tfused.ln_modulate_quant, tfused.quant_sum

    def k1(x_, shift, scale, eps=1e-6, channel_scale=None):
        seen["k1"].append(channel_scale is not None)
        return real_k1(x_, shift, scale, eps, channel_scale)

    def k7(x_, gelu=False, channel_scale=None):
        seen["k7"].append((gelu, channel_scale is not None))
        return real_k7(x_, gelu, channel_scale)

    monkeypatch.setattr(tdit_mod, "ln_modulate_quant", k1)
    monkeypatch.setattr(tql_mod, "quant_sum", k7)
    got = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(ctx_np), 64, ctx=tctx).numpy()
    # per block: K1 once (ffn.0, masked); K7 for q, k, v, o, cross q, cross
    # k/v (the text states), cross o, all masked, then ffn.2's GELU output
    assert seen["k1"] == [True] * 2
    assert seen["k7"].count((True, True)) == 2 and seen["k7"].count((False, True)) == 2 * 8
    want = np.asarray(jax.jit(lambda p, q, a, b, c: jdit.dit_forward(p, cfg_j, a, b, c, 64, ctx=q))(
        pj, JaxQuantCtx(mode="int8", policies=pol, state=st, rotations=rot), x, t, ctx_np))
    assert _rel(want, got) <= 2e-2 and _cos(want, got) >= 0.999


# ---------------------------------------------------------------------------
# the CLI chain: get_calib_data -> ptq -> quant_generate --quant_params
# ---------------------------------------------------------------------------


def _cli(tmp_path, module, args):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        return module.generate(module.parse_args(args))
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("hardware", [False, True], ids=["sim", "hardware"])
def test_cli_ptq_then_quant_generate_equals_on_the_fly(tmp_path, hardware):
    """config.yaml on the tiny task: the artifact of cli.ptq, deployed by
    quant_generate --quant_params, gives the latents of on-the-fly PTQ bit
    for bit, and so does --strip_fp. The artifact loads in wanq_tpu."""
    from wanq_tpu_torch.cli import get_calib_data, ptq, quant_generate

    common = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--random_init",
              "--quant_config", VIDITQ_YAML, "--device", "cpu"]
    calib = _cli(tmp_path, get_calib_data, common + [
        "--sample_steps", "1", "--calib_save_path", str(tmp_path / "calib.npz")])
    art = _cli(tmp_path, ptq, common + ["--calib_data", calib, "--save_path",
                                        str(tmp_path / "qp.npz")])
    st, seed = jptq.load_quant_state(art)
    assert seed == 0 and sorted(st) == [f"blocks.{i}.self_attn.{x}" for i in range(2)
                                       for x in "kqv"]
    assert {"w_q", "w_int8", "channel_mask"} <= set(st["blocks.0.self_attn.q"])
    hw = ["--hardware"] if hardware else []
    lat = {}
    for tag, extra in (("fly", ["--calib_data", calib]), ("art", ["--quant_params", art]),
                       ("strip", ["--quant_params", art, "--strip_fp"])):
        out = _cli(tmp_path, quant_generate, common + extra + hw + [
            "--sample_steps", "2", "--save_file", str(tmp_path / f"lat_{tag}.npz")])
        lat[tag] = np.load(out)["latents"]
    assert lat["fly"].shape == (1, 16, 2, 8, 8) and np.isfinite(lat["fly"]).all()
    np.testing.assert_array_equal(lat["art"], lat["fly"])
    np.testing.assert_array_equal(lat["strip"], lat["fly"])


def test_cli_ptq_suggest_window_and_reference_check(tmp_path, capsys):
    """--suggest_window reads the pooled maps of get_calib_data
    --attn_map_pool and returns JAX's radius for them (wanq_tpu's
    select_temporal_windows on the same file). --check_reference_params
    logs the parity report."""
    from wanq_tpu_torch.cli import get_calib_data, ptq

    common = ["--task", "tiny", "--size", "64*64", "--frame_num", "9", "--random_init",
              "--quant_config", VIDITQ_YAML, "--device", "cpu"]
    calib = _cli(tmp_path, get_calib_data, common + [
        "--sample_steps", "1", "--attn_map_pool", "4", "--attn_map_reduce", "mean",
        "--calib_save_path", str(tmp_path / "calib.npz")])
    art, radius = _cli(tmp_path, ptq, common + ["--calib_data", calib, "--save_path",
                                                str(tmp_path / "qp.npz"),
                                                "--suggest_window", "0.9"])
    data = dict(np.load(calib))
    maps = {k[: -len(".attn_map")]: np.asarray(v, np.float64).mean(axis=0)
            for k, v in data.items() if k.endswith(".attn_map")}
    assert len(maps) == 2
    # 9 frames -> 3 latent frames of 4 x 4 tokens
    want = jattn.collapse_window_radii(jattn.select_temporal_windows(
        maps, 16, 4, threshold=0.9, valid_len=48))
    assert radius == want and os.path.exists(art)
    assert "suggested sliding-window radius" in capsys.readouterr().out
    pth = str(tmp_path / "ref.pth")
    torch.save({"blocks.0.self_attn.q.w_quantizer": {"delta": torch.ones(96, 1),
                                                     "zero_point": torch.zeros(96, 1)}}, pth)
    _cli(tmp_path, ptq, common + ["--calib_data", calib, "--save_path", str(tmp_path / "q2.npz"),
                                  "--check_reference_params", pth])
    out = capsys.readouterr().out
    assert "scale-dict parity vs" in out and "pass(rtol=1e-3)=False" in out


def test_quant_generate_refuses_a_rotated_reference_artifact(tmp_path):
    """A reference .pth for config.yaml carries rotation slots: deploying it
    raises instead of running unrotated."""
    from wanq_tpu_torch.cli import quant_generate

    pth = str(tmp_path / "ref.pth")
    torch.save({f"blocks.{i}.self_attn.{x}.w_quantizer": {
        "delta": torch.ones(96, 1), "zero_point": torch.zeros(96, 1),
        "channel_mask": torch.ones(96), "rotation_matrix": None}
        for i in range(2) for x in "qkv"}, pth)
    with pytest.raises(ValueError, match="rotation"):
        _cli(tmp_path, quant_generate, [
            "--task", "tiny", "--size", "64*64", "--frame_num", "5", "--random_init",
            "--quant_config", VIDITQ_YAML, "--device", "cpu", "--quant_params", pth,
            "--sample_steps", "1"])


# ---------------------------------------------------------------------------
# the methods' benefit on outlier-heavy draws (tests/test_outlier_benefit.py)
# ---------------------------------------------------------------------------

C, O, M = 256, 256, 1024


def test_synthetic_draws_match_jax():
    np.testing.assert_array_equal(tsyn.outlier_channel_scales(96, 3, seed=2, spread_sigma=0.5),
                                  jsyn.outlier_channel_scales(96, 3, seed=2, spread_sigma=0.5))
    np.testing.assert_array_equal(tsyn.correlated_outlier_acts(64, 32, 2, seed=1, draw_seed=3),
                                  jsyn.correlated_outlier_acts(64, 32, 2, seed=1, draw_seed=3))
    a, b = np.arange(1.0, 5.0), np.arange(1.0, 5.0) + 0.01
    assert tsyn.sqnr_db(torch.from_numpy(b), a) == jsyn.sqnr_db(b, a)


@pytest.fixture(scope="module")
def layer_setup():
    rng = np.random.default_rng(0)
    x_cal = tsyn.correlated_outlier_acts(M, C, n_hot=4, seed=0, draw_seed=1)
    x_test = tsyn.correlated_outlier_acts(M, C, n_hot=4, seed=0, draw_seed=2)
    w = (rng.normal(size=(C, O)).astype(np.float32)
         * np.exp(rng.normal(0, 0.3, size=(C, 1))).astype(np.float32))
    calib = {"lin": np.abs(x_cal).max(0)[None, :]}
    y_fp = x_test.astype(np.float64) @ w.astype(np.float64)
    return w, calib, x_test[None], y_fp[None]


def _layer_db(layer_setup, qdict, package):
    w, calib, x_test, y_fp = layer_setup
    if package == "jax":
        pol, st, rot = jptq.prepare_quant_state({"lin": {"w": jnp.asarray(w)}}, ["lin"],
                                                jconfig.QuantConfig.from_dict(qdict),
                                                calib=calib, targets="sim")
        y = jax_qlinear(JaxQuantCtx(mode="sim", policies=pol, state=st, rotations=rot), "lin",
                        {"w": jnp.asarray(w)}, jnp.asarray(x_test), compute_dtype=jnp.float32)
        return jsyn.sqnr_db(y, y_fp)
    params = {"lin": {"w": torch.from_numpy(w)}}
    pol, st, rot = tptq.prepare_quant_state(params, ["lin"], tconfig.QuantConfig.from_dict(qdict),
                                            calib=calib, targets="sim")
    y = tql.qlinear(tql.QuantCtx(mode="sim", policies=pol, state=st, rotations=rot), "lin",
                    params["lin"], torch.from_numpy(x_test), compute_dtype=torch.float32)
    return tsyn.sqnr_db(y, y_fp)


def test_methods_recover_outlier_degradation(layer_setup):
    """(a)+(b) of the JAX test at its numbers: base W8A8 collapses under hot
    channels (< 35 dB), SmoothQuant and QuaRot each recover >= 6 dB, ViDiT-Q
    is within 1 dB of the better of the two or above it; each SQNR within
    0.01 dB of wanq_tpu's on the same draw (observed <= 2e-4)."""
    qds = {"base": W8, "sq": dict(W8, smooth_quant=METHODS["smooth_quant"]),
           "quarot": dict(W8, quarot=METHODS["quarot"]),
           "viditq": dict(W8, viditq=METHODS["viditq"])}
    db = {tag: _layer_db(layer_setup, qd, "torch") for tag, qd in qds.items()}
    assert db["base"] < 35.0, db
    assert db["sq"] > db["base"] + 6.0, db
    assert db["quarot"] > db["base"] + 6.0, db
    assert db["viditq"] > max(db["sq"], db["quarot"]) - 1.0, db
    for tag, qd in qds.items():
        assert abs(db[tag] - _layer_db(layer_setup, qd, "jax")) <= 0.01, tag


def test_base_w8a8_fine_without_outliers():
    """Control: the same base W8A8 on Gaussian activations is not degraded
    (> 37 dB)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(M, C)).astype(np.float32)
    w = rng.normal(size=(C, O)).astype(np.float32)
    params = {"lin": {"w": torch.from_numpy(w)}}
    pol, st, rot = tptq.prepare_quant_state(params, ["lin"], tconfig.QuantConfig.from_dict(W8),
                                            calib={"lin": np.abs(x).max(0)[None, :]},
                                            targets="sim")
    assert rot == {}
    y = tql.qlinear(tql.QuantCtx(mode="sim", policies=pol, state=st), "lin", params["lin"],
                    torch.from_numpy(x[None]), compute_dtype=torch.float32)
    assert tsyn.sqnr_db(y, (x.astype(np.float64) @ w.astype(np.float64))[None]) > 37.0


def test_model_level_recovery_through_layernorm():
    """(d): outliers injected at the residual-stream producers survive
    LayerNorm into every quantized input (absmax / median > 10 at q), and
    SmoothQuant and ViDiT-Q each recover >= 2 dB of base W8A8's output PSNR
    on the tiny forward; the injected weights equal JAX's."""
    cfg = tiny_config()
    params = tdit.init_params(cfg, 0, device="cpu")
    params["head"]["head"]["w"] = torch.from_numpy(
        (np.random.default_rng(123).standard_normal((cfg.dim, 64)) * 0.02).astype(np.float32))
    sc = tsyn.outlier_channel_scales(cfg.dim, n_hot=cfg.dim // 32, hot_scale=100.0, seed=5)
    params = tsyn.inject_stream_outliers(params, cfg, sc)
    pj = jsyn.inject_stream_outliers(jdit.init_params(jax_tiny_config(), jax.random.PRNGKey(0)),
                                     jax_tiny_config(), sc)
    np.testing.assert_array_equal(params["blocks"][1]["ffn"]["2"]["w"].numpy(),
                                  np.asarray(pj["blocks"][1]["ffn"]["2"]["w"]))

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, cfg.in_dim, 2, 8, 8)).astype(np.float32))
    t = torch.tensor([500.0, 500.0])
    txt = torch.from_numpy(rng.normal(size=(2, cfg.text_len, cfg.text_dim)).astype(np.float32))
    cc = tql.QuantCtx(mode="calib")
    tdit.dit_forward(params, cfg, x, t, txt, 32, ctx=cc)
    calib = {k: v.numpy()[None] for k, v in cc.collect.items()}
    am = calib["blocks.0.self_attn.q"][0]
    assert am.max() / np.median(am) > 10.0
    fp = tdit.dit_forward(params, cfg, x, t, txt, 32).double().numpy()

    def psnr(a):
        a = a.double().numpy()
        return 20 * np.log10((fp.max() - fp.min()) / np.sqrt(((a - fp) ** 2).mean()))

    names = tdit.linear_layer_names(cfg)
    db = {}
    for tag, qd in (("base", W8), ("sq", dict(W8, smooth_quant=METHODS["smooth_quant"])),
                    ("viditq", dict(W8, viditq=METHODS["viditq"]))):
        qc = tconfig.QuantConfig.from_dict(dict(qd, remain_fp_regex=FP_REGEX))
        pol, st, rot = tptq.prepare_quant_state(params, names, qc, calib=calib, targets="sim")
        db[tag] = psnr(tdit.dit_forward(params, cfg, x, t, txt, 32, ctx=tql.QuantCtx(
            mode="sim", policies=pol, state=st, rotations=rot)))
    assert db["sq"] > db["base"] + 2.0, db
    assert db["viditq"] > db["base"] + 2.0, db
