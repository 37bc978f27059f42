"""The static-ffn.2 W4A8 route and K1's plain version, on the CPU.

Under ``quant_configs/wan_w4a8_14b.yaml`` every quantized linear has packed
int4 weights and ffn.2 a static activation scale, so the ffn.0 GEMM runs in
K8's GELU + static-quant + row-sum mode (``w4a8_linear_gelu_quant``). Here its
plain version is held against the lines of ``wanq_tpu`` that compute the same
(``w4a8_linear_xla`` with a bf16 output, ``gelu_tanh`` in f32, ``round(g /
scale2)``, ``sum(codes, dtype=f32)``, ``models/dit.py``) on the same numpy
inputs; the route is held by counting which GEMM wrapper ``qlinear`` calls;
and the slice as a whole runs the ``tiny`` DiT under the YAML in both
packages.

Tolerances: the GEMM's bf16 output is equal in both packages (exact int32
sum, the same f32 epilogue). The two tanh implementations may differ in the
last bit, which can move a value across a rounding tie; on these inputs they
do not, so the codes, ``s2`` and ``sm2`` are held **equal**. The forward is
held at the W4A8 tolerance of ``tests/test_torch_w4.py`` and
``tests/test_torch_slice.py`` (rel-L2 <= 2e-3, cosine >= 0.9999). K1's plain
version against ``ln_modulate_quant_xla``: codes within one unit on <= 0.1% of
elements (the f32 reduction order may flip a rounding tie), scale rtol 1e-5,
the scaled sum rtol 1e-5 on rows whose codes agree.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.ops import fused as jfused
from wanq_tpu.ops import qgemm as jqgemm
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu.quant.ptq import prepare_quant_state as jax_prepare
from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import quant_state_from_numpy
from wanq_tpu_torch.ops import _lib
from wanq_tpu_torch.ops import fused as tfused
from wanq_tpu_torch.ops import qgemm as tqgemm
from wanq_tpu_torch.quant import QuantConfig
from wanq_tpu_torch.quant import qlinear as tqlinear
from wanq_tpu_torch.quant.qlinear import QuantCtx
from wanq_tpu_torch.quant.quantizers import pack_int4

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W4A8_STATIC = os.path.join(ROOT, "quant_configs", "wan_w4a8_14b.yaml")
W4A8_MIXED = os.path.join(ROOT, "quant_configs", "wan_w4a8_mixed.yaml")
SPEED = os.path.join(ROOT, "quant_configs", "wan_w8a8_speed.yaml")
SMALL = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
             freq_dim=64, param_dtype="bfloat16", residual_dtype="bfloat16")
# ragged M; (K, N) of ffn.0 and of the square sites at an eighth of their widths
SHAPES = [(37, 192, 1120), (130, 192, 192), (1, 128, 128)]


def _t(v):
    return None if v is None else torch.from_numpy(np.ascontiguousarray(v))


def _j(v):
    return None if v is None else jnp.asarray(v)


def _w4_operands(rng, m, k, n, asym, with_bias):
    """int8 activations and int4 weight codes [K, N] with their packed forms:
    wanq_tpu's [K/2, N] and the port's K-major [N, K/2]."""
    a = rng.integers(-128, 128, size=(m, k), dtype=np.int8)
    codes = rng.integers(-8, 8, size=(k, n), dtype=np.int8)
    wp_port = pack_int4(torch.from_numpy(np.ascontiguousarray(codes.T)))     # [N, K/2]
    wp_jax = np.ascontiguousarray(wp_port.numpy().T)                          # [K/2, N]
    s_a = rng.uniform(1e-3, 2e-2, size=(m,)).astype(np.float32)
    s_w = (rng.uniform(2e-2, 2e-1, size=(n,)) / np.sqrt(k)).astype(np.float32)
    sum_a = (s_a * a.astype(np.float32).sum(-1)).astype(np.float32) if asym else None
    zp_w = rng.integers(0, 16, size=(n,)).astype(np.float32) if asym else None
    bias = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    return a, wp_port, wp_jax, s_a, s_w, sum_a, zp_w, bias


@pytest.mark.parametrize("asym,with_bias", [(True, True), (False, False), (True, False),
                                            (False, True)],
                         ids=["asym-bias", "sym-nobias", "asym-nobias", "sym-bias"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_w4a8_gelu_quant_plain_equals_jax_chain(rng, m, k, n, asym, with_bias):
    a, wp_port, wp_jax, s_a, s_w, sum_a, zp_w, bias = _w4_operands(rng, m, k, n, asym, with_bias)
    scale2 = np.float32(0.0173)
    got = tqgemm.w4a8_linear_gelu_quant(
        _t(a[None]), wp_port, _t(s_a[None]), _t(s_w), torch.tensor(scale2),
        _t(None if sum_a is None else sum_a[None]), _t(zp_w), _t(bias))
    # wanq_tpu/models/dit.py, the ffn2_static branch of block_forward
    h = jqgemm.w4a8_linear_xla(_j(a[None]), _j(wp_jax), _j(s_a[None]), _j(s_w),
                               _j(None if sum_a is None else sum_a[None]), _j(zp_w), _j(bias),
                               out_dtype=jnp.bfloat16)
    g = jdit.gelu_tanh(h.astype(jnp.float32))
    h8b = jnp.clip(jnp.round(g / scale2), -128, 127).astype(jnp.int8)
    s2 = jnp.full(h.shape[:2], scale2, jnp.float32)
    sm2 = scale2 * jnp.sum(h8b, axis=-1, dtype=jnp.float32)

    assert got[0].dtype == torch.int8 and got[0].shape == (1, m, n)
    assert got[1].shape == got[2].shape == (1, m)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(h8b))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(s2))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(sm2))
    assert np.abs(got[0].numpy().astype(np.int32)).max() > 32  # the codes use their range
    assert _lib.launch_counts().get("w4a8_linear_gelu_quant", 0) == 0  # CPU: the plain version


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_w4a8_gelu_quant_plain_is_the_w8a8_mode_on_the_unpacked_weight(rng, m, k, n):
    """K8's mode is K2's on the unpacked codes: the same epilogue, so equal."""
    a, wp_port, _, s_a, s_w, sum_a, zp_w, bias = _w4_operands(rng, m, k, n, True, True)
    scale2 = torch.tensor(0.02)
    got = tqgemm.w4a8_linear_gelu_quant(_t(a), wp_port, _t(s_a), _t(s_w), scale2, _t(sum_a),
                                        _t(zp_w), _t(bias))
    want = tqgemm.w8a8_linear_gelu_quant(_t(a), tqgemm.unpack_int4(wp_port), _t(s_a), _t(s_w),
                                         scale2, _t(sum_a), _t(zp_w), _t(bias))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _static_ctxs(rng, yaml, seed=3):
    """The same weights, calibration and int state under ``yaml`` in both
    packages, at the small config (head dim 128)."""
    cfg_j, cfg_t = jax_tiny_config(**SMALL), tiny_config(**SMALL)
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(seed))
    pt = tdit.init_params(cfg_t, seed, device="cpu")
    hw = (np.random.default_rng(seed + 100).normal(size=(cfg_t.dim, 64)) * 0.02).astype(np.float32)
    pj["head"]["head"]["w"] = jnp.asarray(hw, dtype=cfg_j.dtype)
    pt["head"]["head"]["w"] = torch.from_numpy(hw).to(cfg_t.dtype)
    x = rng.normal(size=(2, 16, 3, 8, 10)).astype(np.float32)  # grid 3x4x5 = 60 tokens
    t = np.asarray([999.0, 500.0], np.float32)
    c = rng.normal(size=(2, 32, 64)).astype(np.float32)
    cc = QuantCtx(mode="calib", collect_minmax=True)
    tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c),
                     64, ctx=cc)
    calib = {k: v.float().numpy()[None] for k, v in cc.collect.items()}
    pol_j, st_j, rot_j = jax_prepare(pj, jdit.linear_layer_names(cfg_j),
                                     JaxQuantConfig.from_yaml(yaml), calib=calib, targets="int8")
    jctx = JaxQuantCtx(mode="int8", policies=pol_j, state=st_j, rotations=rot_j)
    tctx = QuantCtx(mode="int8", policies=pol_j,
                    state=quant_state_from_numpy(jax.tree.map(np.asarray, st_j), device="cpu"))
    return cfg_j, pj, jctx, cfg_t, pt, tctx, (x, t, c)


ROUTES = {
    # yaml -> the wrapper that ffn0_gelu_quant_from_prequant must reach, once a block
    "w4a8_static": (W4A8_STATIC, "w4a8_linear_gelu_quant"),
    "w8a8_static": (SPEED, "w8a8_linear_gelu_quant"),
    "w4a8_dynamic": (W4A8_MIXED, "quant_sum"),
}


@pytest.mark.parametrize("label", list(ROUTES))
def test_ffn0_route_by_weight_width_and_ffn2_scale(rng, monkeypatch, label):
    """``w_int4`` + a static ffn.2 goes to K8's mode, ``w_int8`` + static to
    K2's, and a dynamic ffn.2 to the GEMM with a bf16 output and K7."""
    yaml, want_fn = ROUTES[label]
    _, _, _, cfg_t, pt, tctx, (x, t, c) = _static_ctxs(rng, yaml)
    static = label != "w4a8_dynamic"
    assert tqlinear.int8_static_fusable(tctx, "blocks.0.ffn.2") == static
    assert ("w_int4" in tctx.state["blocks.0.ffn.0"]) == (label != "w8a8_static")
    if static:
        assert "delta_a" in tctx.state["blocks.0.ffn.2"]

    calls = []
    for fn in ("w4a8_linear_gelu_quant", "w8a8_linear_gelu_quant", "quant_sum"):
        real = getattr(tqlinear, fn)
        monkeypatch.setattr(
            tqlinear, fn,
            lambda *a, _fn=fn, _real=real, **k: calls.append((_fn, k.get("gelu"))) or _real(*a, **k))
    out = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(c), 64, ctx=tctx)
    assert torch.isfinite(out).all()
    gelu_calls = [fn for fn, gelu in calls if fn != "quant_sum" or gelu]
    assert gelu_calls == [want_fn] * cfg_t.num_layers


def test_dit_forward_w4a8_static_matches_jax(rng):
    """The slice as a whole: the small DiT under wan_w4a8_14b.yaml in int8
    mode with a calibrated ffn.2 ``delta_a``, against wanq_tpu's eager
    forward, at the W4A8 tolerance of tests/test_torch_slice.py."""
    cfg_j, pj, jctx, cfg_t, pt, tctx, (x, t, c) = _static_ctxs(rng, W4A8_STATIC)
    # cross k/v stay FP, every other block linear holds packed int4 weights
    assert "blocks.0.cross_attn.k" not in tctx.state
    assert all("w_int4" in st for name, st in tctx.state.items() if name.startswith("blocks."))
    with jax.disable_jit():
        want = np.asarray(jdit.dit_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(t),
                                           jnp.asarray(c), 64, ctx=jctx))
    got = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(c), 64, ctx=tctx).numpy()
    a, b = want.astype(np.float64), got.astype(np.float64)
    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
    cos = (a.ravel() @ b.ravel()) / np.linalg.norm(a) / np.linalg.norm(b)
    assert np.isfinite(got).all() and rel <= 2e-3 and cos >= 0.9999


# ---------------------------------------------------------------------------
# K1's plain version at the widths its kernel forms are built for
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channel_scale", [False, True], ids=["nocs", "cs"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 1536, 5120])
def test_k1_plain_matches_jax_at_kernel_widths(rng, c, dtype, channel_scale):
    """C = 64 (a row narrower than a warp's 16-byte loads), 1536 (one warp a
    row) and 5120 (four warps a row); B = 3 rows of 5 tokens, so the rows of a
    tile of 8 cross two batch boundaries; one row of zeros (s = 1e-6)."""
    b, n = 3, 5
    x = (rng.normal(size=(b, n, c)) * 2.0 + 0.3).astype(np.float32)
    x[1, 2] = 0.0
    shift = (rng.normal(size=(b, c)) * 0.5).astype(np.float32)
    scale = (rng.normal(size=(b, c)) * 0.5).astype(np.float32)
    shift[1] = 0.0  # with x = 0 the zero row stays zero after the modulation
    cs = rng.uniform(0.5, 2.0, size=(c,)).astype(np.float32) if channel_scale else None
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)

    got = tfused.ln_modulate_quant_plain(tx, _t(shift), _t(scale), channel_scale=_t(cs))
    want = jfused.ln_modulate_quant_xla(jx, _j(shift), _j(scale), channel_scale=_j(cs))
    diff = np.abs(got[0].numpy().astype(np.int32) - np.asarray(want[0]).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)
    same = diff.max(axis=-1) == 0
    np.testing.assert_allclose(got[2].numpy()[same], np.asarray(want[2])[same],
                               rtol=1e-5, atol=1e-6)
    assert got[1][1, 2].item() == np.float32(1e-6) and not got[0][1, 2].any()


def test_k1_wrapper_refuses_what_the_kernel_does_not_take():
    """The width limit and the CUDA-only contract of the kernel wrapper hold
    before any launch (raised on the CPU too)."""
    x = torch.zeros((1, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.ln_modulate_quant_cuda(x, torch.zeros((1, 64)), torch.zeros((1, 64)))
    assert tfused.K1_MAX_C == 6144


# ---------------------------------------------------------------------------
# the YAML's cache: section
# ---------------------------------------------------------------------------


def test_cache_section_is_kept_and_reported_as_ignored(tmp_path, capsys):
    """wan_w4a8_14b.yaml carries step-cache defaults (the adaptive policy
    fitted at 14B). QuantConfig keeps the section and quant_generate now runs
    it: the log names the policy and its action counts. Two steps under warmup
    2 / tail 2 plan all-full, so the latents equal those of the same YAML
    without the section (the name predates the port of the step cache, when
    the section was reported as ignored)."""
    import yaml as pyyaml

    from wanq_tpu_torch.cli import get_calib_data, quant_generate

    raw = pyyaml.safe_load(open(W4A8_STATIC))
    qcfg = QuantConfig.from_yaml(W4A8_STATIC)
    assert qcfg.cache == raw["cache"] and qcfg.cache["warmup"] == 2
    assert QuantConfig.from_yaml(W4A8_MIXED).cache is None
    uncached = dict(raw)
    del uncached["cache"]
    plain_yaml = str(tmp_path / "w4a8_nocache.yaml")
    with open(plain_yaml, "w") as f:
        pyyaml.safe_dump(uncached, f)

    common = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--random_init",
              "--device", "cpu"]
    calib = get_calib_data.generate(get_calib_data.parse_args(
        common + ["--quant_config", W4A8_STATIC, "--collect_minmax", "--sample_steps", "1",
                  "--calib_save_path", str(tmp_path / "calib.npz")]))
    lats = {}
    for label, yaml in (("cached", W4A8_STATIC), ("uncached", plain_yaml)):
        capsys.readouterr()
        out = quant_generate.generate(quant_generate.parse_args(
            common + ["--quant_config", yaml, "--calib_data", calib, "--hardware",
                      "--sample_steps", "2", "--save_file", str(tmp_path / f"{label}.npz")]))
        # the CLIs log to stdout
        said = capsys.readouterr().out
        assert "cache: section is ignored" not in said
        if label == "cached":
            assert "step cache: AdaptiveCachePolicy(threshold=0.5, warmup=2, tail=2" in said
            assert "step cache actions: {'full': 2, 'cond': 0, 'reuse': 0}" in said
            assert json.loads(str(np.load(out)["cache_stats"])) == {
                "full": 2, "cond": 0, "reuse": 0}
        else:
            assert "step cache: off" in said and "cache_stats" not in np.load(out)
        lats[label] = np.load(out)["latents"]
    assert np.isfinite(lats["cached"]).all()
    np.testing.assert_array_equal(lats["cached"], lats["uncached"])
