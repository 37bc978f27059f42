"""The capacity planner (quant/planner.py) and quant_generate --auto_bits_gib
in the port against wanq_tpu on the CPU.

The byte model and the class dims are held equal for T2V-1.3B, T2V-14B and
I2V-14B; the plan over a sweep of budgets, with and without measured errors,
is held equal (upgraded, base, total bytes, the config dict), and both
packages' QuantConfig resolve every linear of the plan to equal policies;
measure_class_errors agrees within 1e-6 on the same weights. The CLI: the
port's latents against wanq_tpu's from the same checkpoint, calibration and
initial noise, 2 steps: sim mode within rel-L2 1e-5 (f32 sums in another
order: 8e-8 read), the int route within 1e-2 (int8 rounding ties that the
sum order flips, grown over two steps: 1.9e-3 read; tests/test_torch_lora.py
holds its quant_generate comparison at 2e-2); a YAML's cache: section dropped
by both, and the same error text without either flag. The plan's 14B launch table that
chip_smoke.py asserts on the card is held against the routes a forward takes.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.cli import quant_generate as jqg_cli
from wanq_tpu.configs import WAN_CONFIGS as JAX_WAN_CONFIGS
from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu.quant import planner as jplanner
from wanq_tpu_torch.cli import get_calib_data, quant_generate
from wanq_tpu_torch.configs import WAN_CONFIGS, tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.pipelines import text2video as tt2v
from wanq_tpu_torch.quant import QuantConfig
from wanq_tpu_torch.quant import planner as tplanner
from wanq_tpu_torch.quant import qlinear as tqlinear
from wanq_tpu_torch.quant.ptq import prepare_quant_state
from wanq_tpu_torch.quant.qlinear import QuantCtx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W4A8_14B = os.path.join(ROOT, "quant_configs", "wan_w4a8_14b.yaml")
TASKS = ("t2v-1.3B", "t2v-14B", "i2v-14B")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


# ---------------------------------------------------------------------------
# the byte model and the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task", TASKS)
def test_class_dims_and_bytes_match_jax(task):
    cfg, jcfg = WAN_CONFIGS[task], JAX_WAN_CONFIGS[task]
    dims = tplanner.block_linear_dims(cfg)
    assert dims == jplanner.block_linear_dims(jcfg)
    assert ("cross_attn.k_img" in dims) == (task == "i2v-14B")
    for bits in (4, 8):
        assert tplanner.class_weight_bytes(cfg, bits) == jplanner.class_weight_bytes(jcfg, bits)
    if task == "t2v-14B":  # the 14B all-W4 state that the card's streamed build holds
        assert round(sum(tplanner.class_weight_bytes(cfg, 4).values()) / 2**30, 2) == 6.56


def _budgets(cfg):
    """All-W4, all-W8, and seven budgets between them (each class's own
    upgrade cost sits at a different point of the sweep)."""
    b4 = sum(tplanner.class_weight_bytes(cfg, 4).values())
    b8 = sum(tplanner.class_weight_bytes(cfg, 8).values())
    return [b4 - 1, b4] + [int(b4 + f * (b8 - b4)) for f in (0.1, 0.2, 0.35, 0.5, 0.65, 0.8,
                                                            0.95)] + [b8]


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("measured", [False, True], ids=["priority", "errors"])
def test_plan_matches_jax_over_a_budget_sweep(task, measured):
    """The plan of each budget equals wanq_tpu's field by field, and the
    config dict resolves every linear of the model to equal policies in both
    packages: the planned bitwidth on each block linear, FP on the embeddings
    and the head."""
    cfg, jcfg = WAN_CONFIGS[task], JAX_WAN_CONFIGS[task]
    errors = None
    if measured:  # a ranking unlike DEFAULT_PRIORITY
        rng = np.random.default_rng(3)
        errors = {c: (float(rng.uniform(0.05, 0.3)), float(rng.uniform(0.0, 0.02)))
                  for c in tplanner.block_linear_dims(cfg)}
    act = {"n_bits": 8, "sym": True, "static_regex": r"ffn\.2"}
    names = tdit.linear_layer_names(cfg)
    seen = set()
    for budget in _budgets(cfg):
        got = tplanner.plan_capacity_bits(cfg, budget, errors=errors, act=act)
        want = jplanner.plan_capacity_bits(jcfg, budget, errors=errors, act=act)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), budget
        assert got.report() == want.report()
        assert got.total_bytes <= budget or not got.upgraded
        seen.add(len(got.upgraded))
        tq, jq = QuantConfig.from_dict(got.config), JaxQuantConfig.from_dict(want.config)
        for name in names:
            pol, jpol = tq.resolve(name), jq.resolve(name)
            assert dataclasses.asdict(pol) == dataclasses.asdict(jpol), name
            cls = name.split(".", 2)[-1]
            assert pol.is_quantized == name.startswith("blocks."), name
            if pol.is_quantized:
                assert pol.weight.active_bits == (8 if cls in got.upgraded else 4), name
                assert pol.act.dynamic != name.endswith("ffn.2"), name
    assert min(seen) == 0 and max(seen) == len(tplanner.block_linear_dims(cfg))
    assert len(seen) >= 4  # mixed plans, not only the two ends


def test_measure_class_errors_matches_jax():
    rng = np.random.default_rng(0)
    w = {"ffn.2": rng.normal(size=(96, 48)).astype(np.float32),
         "self_attn.q": (rng.normal(size=(48, 48)) * 0.02).astype(np.float32),
         "cross_attn.o": rng.standard_t(3, size=(48, 64)).astype(np.float32)}
    for sym in (False, True):
        got = tplanner.measure_class_errors(w, sym=sym)
        want = jplanner.measure_class_errors(w, sym=sym)
        assert list(got) == list(want)
        for name, (e4, e8) in got.items():
            assert e4 > e8 > 0, name
            np.testing.assert_allclose((e4, e8), want[name], rtol=1e-6, atol=0, err_msg=name)
    # a tensor on its device gives the numpy input's numbers
    as_t = tplanner.measure_class_errors({k: torch.from_numpy(v) for k, v in w.items()})
    assert as_t == tplanner.measure_class_errors(w)


# ---------------------------------------------------------------------------
# quant_generate --auto_bits_gib
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's pipeline starts from wanq_tpu's initial noise."""
    orig = tt2v.WanT2V.generate

    def generate_(self, context, context_null, size=(832, 480), frame_num=81, seed=-1, **kw):
        shape = tt2v.compute_target_shape(self.config, size, frame_num)
        noise = np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                           (context.shape[0], *shape), jnp.float32))
        return orig(self, context, context_null, size=size, frame_num=frame_num, seed=seed,
                    noise=torch.from_numpy(noise), **kw)

    monkeypatch.setattr(tt2v.WanT2V, "generate", generate_)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A tiny checkpoint dir, text states, the port's minmax calibration of
    it (the plan's static ffn.2 scale) and a budget between all-W4 and
    all-W8: (tmp dir, the common CLI arguments, the budget's GiB)."""
    tmp = tmp_path_factory.mktemp("plan_cli")
    cfg = tiny_config()
    params = tdit.init_params(cfg, 42, device="cpu")
    params["head"]["head"]["w"] = torch.from_numpy(
        (0.02 * np.random.default_rng(43).standard_normal((cfg.dim, 64))).astype(np.float32))
    _chip_smoke().write_dit_checkpoint(params, cfg, str(tmp / "ckpt"))
    rng = np.random.default_rng(1)
    np.savez(tmp / "ctx.npz", **{k: rng.normal(size=(1, cfg.text_len, cfg.text_dim))
                                 .astype(np.float32) for k in ("context", "context_null")})
    common = ["--task", "tiny", "--size", "64*64", "--frame_num", "5",
              "--ckpt_dir", str(tmp / "ckpt"), "--context_file", str(tmp / "ctx.npz")]
    calib = str(tmp / "calib.npz")
    get_calib_data.generate(get_calib_data.parse_args(common + [
        "--device", "cpu", "--collect_minmax", "--sample_steps", "1",
        "--calib_save_path", calib]))
    b4 = sum(tplanner.class_weight_bytes(cfg, 4).values())
    b8 = sum(tplanner.class_weight_bytes(cfg, 8).values())
    gib = (b4 + 0.4 * (b8 - b4)) / 2**30
    plan = tplanner.plan_capacity_bits(cfg, int(gib * 2**30))
    assert plan.upgraded and plan.base
    return tmp, common + ["--sample_steps", "2", "--calib_data", calib], gib


@pytest.fixture
def cache_policies(monkeypatch):
    """The cache_policy each package's pipeline is handed, in call order."""
    from wanq_tpu.pipelines import text2video as jt2v

    seen = []
    for cls in (jt2v.WanT2V, tt2v.WanT2V):
        orig = cls.generate

        def generate_(self, *a, _orig=orig, **kw):
            seen.append(kw.get("cache_policy"))
            return _orig(self, *a, **kw)

        monkeypatch.setattr(cls, "generate", generate_)
    return seen


@pytest.mark.parametrize("hardware", [False, True], ids=["sim", "int8"])
def test_quant_generate_auto_bits_matches_jax(tiny_run, jax_noise, hardware, capfd):
    """--auto_bits_gib with the default act section (static ffn.2): the
    port's latents against wanq_tpu's, and the plan's report logged."""
    tmp, common, gib = tiny_run
    argv = common + ["--auto_bits_gib", repr(gib)] + (["--hardware"] if hardware else [])
    got = np.load(quant_generate.generate(quant_generate.parse_args(
        argv + ["--device", "cpu", "--save_file", str(tmp / f"t{hardware}.npz")])))
    assert "capacity plan: W8 on ['ffn.2', 'self_attn.o', 'cross_attn.o']" in "".join(
        capfd.readouterr())
    want = np.load(jqg_cli.generate(jqg_cli.parse_args(
        argv + ["--save_file", str(tmp / f"j{hardware}.npz")])))
    assert np.isfinite(got["latents"]).all() and got["latents"].shape == want["latents"].shape
    assert _rel(want["latents"], got["latents"]) <= (1e-2 if hardware else 1e-5)


def test_auto_bits_reads_only_the_yaml_act_section(tiny_run, jax_noise, cache_policies):
    """With --quant_config wan_w4a8_14b.yaml (4-bit weights, cross k/v FP, an
    adaptive cache: section) beside --auto_bits_gib, both packages take the
    YAML's act section only: the plan's bitwidths at every block linear,
    cross k/v quantized, and no step cache."""
    tmp, common, gib = tiny_run
    argv = common + ["--auto_bits_gib", repr(gib), "--quant_config", W4A8_14B, "--hardware"]
    qcfg = quant_generate.quant_config_from_args(quant_generate.parse_args(argv),
                                                 WAN_CONFIGS["tiny"])
    assert qcfg.cache is None and qcfg.raw["act"] == QuantConfig.from_yaml(W4A8_14B).raw["act"]
    assert qcfg.resolve("blocks.0.cross_attn.k").is_quantized
    got = np.load(quant_generate.generate(quant_generate.parse_args(
        argv + ["--device", "cpu", "--save_file", str(tmp / "t_yaml.npz")])))
    want = np.load(jqg_cli.generate(jqg_cli.parse_args(
        argv + ["--save_file", str(tmp / "j_yaml.npz")])))
    assert cache_policies == [None, None] and "cache_stats" not in got.files
    assert _rel(want["latents"], got["latents"]) <= 1e-2


def test_quant_generate_needs_a_config_or_a_budget(tiny_run):
    _, common, _ = tiny_run
    with pytest.raises(SystemExit) as got:
        quant_generate.generate(quant_generate.parse_args(common + ["--device", "cpu"]))
    with pytest.raises(SystemExit) as want:
        jqg_cli.generate(jqg_cli.parse_args(common))
    assert str(got.value) == str(want.value) == "need --quant_config or --auto_bits_gib"


# ---------------------------------------------------------------------------
# chip_smoke.py's plan path: its launch table
# ---------------------------------------------------------------------------

SMALL = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
             freq_dim=64, param_dtype="bfloat16", residual_dtype="bfloat16")
DISPATCH = {
    (tdit, "ln_modulate_quant"): ("ln_modulate_quant",),
    (tdit, "rms_rope_heads"): ("rms_rope_heads",),
    (tdit, "rms_split_heads"): ("rms_rope_heads",),
    (tdit, "attention_heads_major"): ("attention",),
    (tdit, "cross_attention_heads_major"): ("attention",),
    (tqlinear, "quant_sum"): ("quant_sum",),
    (tqlinear, "w8a8_linear"): ("w8a8_linear",),
    (tqlinear, "w8a8_linear_gelu_quant"): ("w8a8_linear_gelu_quant",),
    (tqlinear, "w4a8_linear"): ("w4a8_linear",),
    (tqlinear, "w4a8_linear_gelu_quant"): ("w4a8_linear_gelu_quant",),
    (tdit, "gate_residual"): ("gate_residual",),
}


def test_chip_smoke_plan_path_launch_table(monkeypatch):
    """chip_smoke.py's w4w8_plan_14b: its budget at DEPTH_14B blocks plans
    what 9.5 GiB plans at all 40 (W8 on ffn.2, both o, self v), and its
    per-block launches are the dispatchers a forward of that plan calls on
    the small config (head dim 128, so the same fused routes): K8 on the six
    W4 classes with ffn.0 in its GELU + quant mode, K2 on the four W8 ones,
    ffn.2 reading the mode's int8."""
    smoke = _chip_smoke()
    full = WAN_CONFIGS["t2v-14B"]
    cut = dataclasses.replace(full, num_layers=smoke.DEPTH_14B)
    plan = tplanner.plan_capacity_bits(cut, int(smoke.PLAN_GIB * 2**30))
    assert plan.upgraded == tplanner.plan_capacity_bits(full, int(9.5 * 2**30)).upgraded == (
        "ffn.2", "self_attn.o", "cross_attn.o", "self_attn.v")
    cfg = tiny_config(**SMALL)
    params = tdit.init_params(cfg, 3, device="cpu")
    params["head"]["head"]["w"] = torch.from_numpy(
        (np.random.default_rng(4).normal(size=(cfg.dim, 64)) * 0.02).astype(np.float32)
    ).bfloat16()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 16, 3, 8, 10)).astype(np.float32))
    t = torch.tensor([999.0, 500.0])
    c = torch.from_numpy(rng.normal(size=(2, 32, 64)).astype(np.float32))
    cc = QuantCtx(mode="calib", collect_minmax=True)
    tdit.dit_forward(params, cfg, x, t, c, 64, ctx=cc)
    calib = {k: v.float().numpy()[None] for k, v in cc.collect.items()}
    act = QuantConfig.from_yaml(W4A8_14B).raw["act"]
    qcfg = QuantConfig.from_dict(dict(plan.config, act=act))
    pol, st, rot = prepare_quant_state(params, tdit.linear_layer_names(cfg), qcfg, calib=calib,
                                       targets="int8")
    assert all(("w_int8" in st[f"blocks.0.{c}"]) == (c in plan.upgraded)
               for c in tplanner.block_linear_dims(cfg))
    ctx = QuantCtx(mode="int8", policies=pol, state=st, rotations=rot)
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
    per_block = smoke.PATHS["w4w8_plan_14b"][1]
    assert counts == {k: v * cfg.num_layers for k, v in per_block.items()}
    assert per_block["w4a8_linear"] + per_block["w4a8_linear_gelu_quant"] == 6
    assert per_block["w8a8_linear"] == 4 and "w8a8_linear_gelu_quant" not in per_block
