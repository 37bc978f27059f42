"""T2V-14B in the port against wanq_tpu on the CPU, without 14B weights.

The config, the sequence lengths at 480p and 720p and the per-layer
policies of both 14B YAMLs over all 40 blocks are held equal to
``wanq_tpu``'s. ``init_params_on_device`` (the draw the CLIs make on the
card) is held on the CPU by its tree, shapes and dtypes against
``init_params``, by the moments of each scheme (the mean within 4 standard
errors of 0; the variance, xavier's bound^2 / 3, normal x 0.02's 4e-4 and
the modulation's 1 / dim, within 4 sqrt(2 / n) relative, four standard
errors of a normal sample's variance, more than a uniform one's; exact
zeros and ones) and by its determinism per seed. A 2-layer model at the
14B head layout (40 heads x 128, dim 5120; ffn and text dims cut to keep
it small) runs the int8 route through the kernel wrappers' plain versions
under
``wan_w4a8_14b.yaml`` against ``wanq_tpu``'s eager forward: rel-L2 <= 1e-2,
cosine >= 0.9999, and at most a quarter of W4A8's own distance to the FP
forward. (At dim 256, tests/test_torch_w4a8_static.py holds 2e-3; the bf16
FP forwards of the two packages drift apart with the width, because the CPU
sums bf16 products in another order: 1.1e-3 at dim 256, 2.8e-3 at 5120, and
the int8 route reads 5.6e-3 there against W4A8's 3.0e-2 from FP.) The time
embedding runs row by row where FP. And the kernel launches per block that
``chip_smoke.py`` expects of each int8 path are held against the wrappers a
forward calls.
"""

import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.configs import WAN_CONFIGS as JAX_WAN_CONFIGS
from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.pipelines import text2video as jt2v
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu.quant.ptq import prepare_quant_state as jax_prepare
from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
from wanq_tpu_torch.configs import WAN_CONFIGS, tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import params_from_numpy, quant_state_from_numpy
from wanq_tpu_torch.pipelines import text2video as tt2v
from wanq_tpu_torch.quant import QuantConfig
from wanq_tpu_torch.quant import qlinear as tqlinear
from wanq_tpu_torch.quant.ptq import prepare_quant_state
from wanq_tpu_torch.quant.qlinear import QuantCtx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W4A8_14B = os.path.join(ROOT, "quant_configs", "wan_w4a8_14b.yaml")
W8A8_14B = os.path.join(ROOT, "quant_configs", "wan_w8a8_14b.yaml")
# the 14B head layout at 2 layers; ffn, text and frequency dims cut
HEADS40 = dict(dim=5120, num_heads=40, num_layers=2, ffn_dim=256, text_len=32, text_dim=64,
               freq_dim=64, param_dtype="bfloat16", residual_dtype="bfloat16")
SMALL = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
             freq_dim=64, param_dtype="bfloat16", residual_dtype="bfloat16")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


# ---------------------------------------------------------------------------
# the config and its shapes
# ---------------------------------------------------------------------------


def test_t2v_14b_config_matches_jax_field_by_field():
    got, want = WAN_CONFIGS["t2v-14B"], JAX_WAN_CONFIGS["t2v-14B"]
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
    assert (got.dim, got.ffn_dim, got.num_heads, got.head_dim, got.num_layers) == \
        (5120, 13824, 40, 128, 40)


@pytest.mark.parametrize("size,seq,valid", [((832, 480), 32768, 32760),
                                            ((1280, 720), 75776, 75600)],
                         ids=["480p", "720p"])
def test_14b_seq_len_matches_jax(size, seq, valid):
    cfg = WAN_CONFIGS["t2v-14B"]
    shape = tt2v.compute_target_shape(cfg, size, 81)
    assert shape == jt2v.compute_target_shape(JAX_WAN_CONFIGS["t2v-14B"], size, 81)
    _, f, h, w = shape
    assert f * (h // 2) * (w // 2) == valid
    assert tt2v.compute_seq_len(cfg, shape) == seq == \
        jt2v.compute_seq_len(JAX_WAN_CONFIGS["t2v-14B"], shape)


@pytest.mark.parametrize("yaml", [W4A8_14B, W8A8_14B], ids=["w4a8_14b", "w8a8_14b"])
def test_14b_yaml_policies_match_jax(yaml):
    """Every linear of T2V-14B resolves to the same policy in both packages
    (no weights needed): 4- or 8-bit asymmetric weights, dynamic 8-bit
    activations but a static ffn.2, cross-attention k/v and the embeddings
    FP."""
    names = tdit.linear_layer_names(WAN_CONFIGS["t2v-14B"])
    assert names == jdit.linear_layer_names(JAX_WAN_CONFIGS["t2v-14B"])
    assert len(names) == 6 + 40 * 10
    tq, jq = QuantConfig.from_yaml(yaml), JaxQuantConfig.from_yaml(yaml)
    bits = 4 if yaml == W4A8_14B else 8
    for name in names:
        got, want = tq.resolve(name), jq.resolve(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        fp = not name.startswith("blocks.") or name.endswith(("cross_attn.k", "cross_attn.v"))
        assert got.is_quantized != fp, name
        if got.is_quantized:
            assert got.weight.n_bits == bits and got.act.dynamic != name.endswith("ffn.2")


# ---------------------------------------------------------------------------
# init_params_on_device
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def device_draws():
    """The host draw and three device draws (seeds 5, 5, 6) on the CPU; the
    device draws in blocks of 1000 elements (a weight takes many blocks, the
    last one ragged), as the card's 14B weights take several of 2^24."""
    cfg = tiny_config(dim=256, num_heads=2, num_layers=3, ffn_dim=640, text_dim=96,
                      freq_dim=64, param_dtype="bfloat16")
    block, tdit._DRAW_BLOCK = tdit._DRAW_BLOCK, 1000
    try:
        return (cfg, tdit.init_params(cfg, 5, device="cpu"),
                *(tdit.init_params_on_device(cfg, seed, device="cpu") for seed in (5, 5, 6)))
    finally:
        tdit._DRAW_BLOCK = block


def test_init_params_on_device_tree_shapes_dtypes(device_draws):
    _, host, dev, _, _ = device_draws
    want = [(k, tuple(v.shape), v.dtype) for k, v in _leaves(host) if v is not None]
    got = [(k, tuple(v.shape), v.dtype) for k, v in _leaves(dev) if v is not None]
    assert got == want
    assert [k for k, v in _leaves(dev) if v is None] == [k for k, v in _leaves(host) if v is None]
    assert all(v.device.type == "cpu" for _, v in _leaves(dev) if v is not None)


def test_init_params_on_device_moments_per_scheme(device_draws):
    cfg, _, dev, _, _ = device_draws
    d = cfg.dim
    normal02 = {"text_embedding.0", "text_embedding.2", "time_embedding.0", "time_embedding.2"}
    seen = set()
    for name, v in _leaves(dev):
        if v is None:
            continue
        x = v.double()
        if name.endswith(".w") and x.ndim == 2:
            layer = name[:-2]
            if layer == "head.head":
                assert not x.any(), name
                seen.add("zeros")
                continue
            n = x.numel()
            if layer in normal02:
                var, seen_as = 0.02 ** 2, "normal02"
            else:
                bound = math.sqrt(6.0 / sum(x.shape))
                var, seen_as = bound ** 2 / 3, "xavier"
                assert x.abs().max() <= bound * (1 + 2 ** -8), name  # bf16 rounding
            assert abs(x.mean().item()) <= 4 * math.sqrt(var / n), name
            assert abs(x.var().item() / var - 1) <= 4 * math.sqrt(2 / n), name
            seen.add(seen_as)
        elif name.endswith("modulation"):
            assert v.dtype == torch.float32
            n = x.numel()
            assert abs(x.var().item() * d - 1) <= 4 * math.sqrt(2 / n), name
            assert abs(x.mean().item()) * math.sqrt(d) <= 4 / math.sqrt(n), name
            seen.add("modulation")
        elif name.endswith((".b",)):
            assert not x.any(), name
        else:  # norms: ones, or the norm3 bias
            assert torch.equal(x, torch.ones_like(x)) or not x.any(), name
    assert seen == {"zeros", "normal02", "xavier", "modulation"}


def test_init_params_on_device_is_deterministic_per_seed(device_draws):
    _, _, dev, again, other = device_draws
    pairs = list(zip(_leaves(dev), _leaves(again), _leaves(other)))
    assert all(a[1] is None or torch.equal(a[1], b[1]) for a, b, _ in pairs)
    drawn = [(a[1], c[1]) for a, _, c in pairs
             if a[1] is not None and a[1].std() > 0 and not a[0].endswith(("norm_q", "norm_k"))]
    assert drawn and not any(torch.equal(a, c) for a, c in drawn)


def test_load_params_on_the_cpu_keeps_the_host_draw(monkeypatch):
    """The CLIs' random init on the CPU is the numpy draw shared with
    wanq_tpu (and a numpy head.head redraw from base_seed + 1); only a CUDA
    device takes init_params_on_device (held on the card by
    tests/test_torch_cuda.py)."""
    import argparse

    from wanq_tpu_torch.cli import common

    cfg = tiny_config()
    monkeypatch.setattr(tdit, "init_params_on_device",
                        lambda *a, **k: pytest.fail("the CPU took the device draw"))
    got = common.load_params(argparse.Namespace(base_seed=3, device="cpu"), cfg)
    want = tdit.init_params(cfg, 3, device="cpu")
    want["head"]["head"]["w"] = torch.from_numpy(
        (0.02 * np.random.default_rng(4).standard_normal((96, 64))).astype(np.float32))
    for (k, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert (a is None and b is None) or torch.equal(a, b), k


def test_time_embedding_runs_row_by_row_where_fp():
    """The time MLP of a batch equals its rows' embeddings computed alone
    (it runs row by row where its linears are FP, so sequential CFG is the
    batched function bit for bit on the card too), and a calibration pass
    still sees the whole batch in one call: its statistics are the max over
    both timesteps."""
    cfg = tiny_config()
    params = tdit.init_params(cfg, 3, device="cpu")
    t = torch.tensor([999.0, 500.0])
    e, e0 = tdit.time_embedding(params, cfg, t)
    for i in range(2):
        ei, e0i = tdit.time_embedding(params, cfg, t[i:i + 1])
        assert torch.equal(e[i:i + 1], ei) and torch.equal(e0[i:i + 1], e0i)
    cc = QuantCtx(mode="calib")
    tdit.time_embedding(params, cfg, t, cc)
    sin = tdit.sinusoidal_embedding_1d(cfg.freq_dim, t)
    assert torch.equal(cc.collect["time_embedding.0"], sin.abs().amax(0))


# ---------------------------------------------------------------------------
# the 14B head layout through the int8 route
# ---------------------------------------------------------------------------


def test_40_head_model_w4a8_14b_matches_jax():
    cfg_j, cfg_t = jax_tiny_config(**HEADS40), tiny_config(**HEADS40)
    assert cfg_t.head_dim == 128 and cfg_t.num_heads == 40
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(7))
    hw = (np.random.default_rng(8).normal(size=(cfg_t.dim, 64)) * 0.02).astype(np.float32)
    pj["head"]["head"]["w"] = jnp.asarray(hw, dtype=cfg_j.dtype)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 16, 3, 8, 10)).astype(np.float32)  # 60 tokens, padded to 64
    t = np.asarray([999.0, 500.0], np.float32)
    c = rng.normal(size=(2, 32, 64)).astype(np.float32)
    cc = QuantCtx(mode="calib", collect_minmax=True)
    tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c),
                     64, ctx=cc)
    calib = {k: v.float().numpy()[None] for k, v in cc.collect.items()}
    pol_j, st_j, rot_j = jax_prepare(pj, jdit.linear_layer_names(cfg_j),
                                     JaxQuantConfig.from_yaml(W4A8_14B), calib=calib,
                                     targets="int8")
    jctx = JaxQuantCtx(mode="int8", policies=pol_j, state=st_j, rotations=rot_j)
    tctx = QuantCtx(mode="int8", policies=pol_j,
                    state=quant_state_from_numpy(jax.tree.map(np.asarray, st_j), device="cpu"))
    del st_j
    assert all("w_int4" in st for n, st in tctx.state.items() if n.startswith("blocks."))
    with jax.disable_jit():
        want, fp = (np.asarray(jdit.dit_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(t),
                                                jnp.asarray(c), 64, ctx=q)) for q in (jctx, None))
    got = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(c), 64, ctx=tctx).numpy()
    a, b = want.astype(np.float64), got.astype(np.float64)
    cos = (a.ravel() @ b.ravel()) / np.linalg.norm(a) / np.linalg.norm(b)
    assert np.isfinite(got).all() and _rel(a, b) <= 1e-2 and cos >= 0.9999
    # the packages agree far closer than W4A8 moves the output from FP
    assert _rel(a, b) <= 0.25 * _rel(fp, a)


# ---------------------------------------------------------------------------
# chip_smoke.py's per-block launch table against the routes a forward takes
# ---------------------------------------------------------------------------

# kernel dispatcher (where models/dit.py and quant/qlinear.py call it) ->
# the launch counters its CUDA route adds to
DISPATCH = {
    (tdit, "ln_modulate_quant"): ("ln_modulate_quant",),
    (tdit, "rms_rope_heads"): ("rms_rope_heads",),
    (tdit, "rms_split_heads"): ("rms_rope_heads",),
    (tdit, "attention_heads_major"): ("attention",),
    (tdit, "cross_attention_heads_major"): ("attention",),
    (tdit, "attention"): ("attention",),
    (tdit, "attention_int8"): ("quantize_qkv_int8", "attention_int8"),
    (tqlinear, "quant_sum"): ("quant_sum",),
    (tqlinear, "w8a8_linear"): ("w8a8_linear",),
    (tqlinear, "w8a8_linear_gelu_quant"): ("w8a8_linear_gelu_quant",),
    (tqlinear, "w4a8_linear"): ("w4a8_linear",),
    (tqlinear, "w4a8_linear_gelu_quant"): ("w4a8_linear_gelu_quant",),
    (tqlinear, "w4a4_linear"): ("w4a4_linear",),
}


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.mark.parametrize("label", ["w8a8", "w4a8_mixed", "w4a4", "w8a8_attn", "w4a8_static",
                                   "w8a8_14b", "w4a8_14b", "w4a8_gptq", "svdquant"])
def test_chip_smoke_launch_table_matches_the_routes(monkeypatch, label):
    """The counts ``chip_smoke.py`` asserts on the card (per block, times the
    layers and forwards) are the dispatchers a forward calls, here on the
    small config (head dim 128, so the same fused routes) in int8 mode under
    the path's YAML."""
    smoke = _chip_smoke()
    yaml, per_block = smoke.PATHS[label]
    cfg = tiny_config(**SMALL)
    params = tdit.init_params(cfg, 3, device="cpu")
    params["head"]["head"]["w"] = torch.from_numpy(
        (np.random.default_rng(4).normal(size=(cfg.dim, 64)) * 0.02).astype(np.float32)
    ).bfloat16()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 16, 3, 8, 10)).astype(np.float32))
    t = torch.tensor([999.0, 500.0])
    c = torch.from_numpy(rng.normal(size=(2, 32, 64)).astype(np.float32))
    cc = QuantCtx(mode="calib", collect_minmax=True, hessian_regex=smoke.GPTQ_REGEX)
    tdit.dit_forward(params, cfg, x, t, c, 64, ctx=cc)
    calib = {k: v.float().numpy()[None] for k, v in cc.collect.items()}
    qcfg = QuantConfig.from_yaml(os.path.join(ROOT, yaml))
    pol, st, rot = prepare_quant_state(params, tdit.linear_layer_names(cfg), qcfg, calib=calib,
                                       targets="int8")
    ctx = QuantCtx(mode="int8", policies=pol, state=st, rotations=rot, attn=qcfg.attn_cfg)
    counts = {}
    for (module, fn), counters in DISPATCH.items():
        real = getattr(module, fn)

        def counted(*a, _real=real, _counters=counters, **k):
            for name in _counters:
                counts[name] = counts.get(name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(module, fn, counted)
    out = tdit.dit_forward(params, cfg, x, t, c, 64, ctx=ctx)
    assert torch.isfinite(out).all()
    assert counts == {k: v * cfg.num_layers for k, v in per_block.items()}
