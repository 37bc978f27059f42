"""The port's LoRA adapters against wanq_tpu's on the CPU: the draws of
``init_lora`` / ``init_lora_from_cfg``, ``apply_lora``,
``merge_lora_into_quant_state``, the npz both ways, the training checkpoint,
an adapted model (``b != 0``) through every quantized route of the block, and
``quant_generate --lora``.

Tolerances: the draws, the npz and the merge exactly (the same numpy draws,
the same f32 products on both sides: ``apply_lora`` rel-L2 <= 1e-6); the
adapted forward in sim and int8 mode within the limits the port's other
quantized forwards are held to against ``wanq_tpu`` (rel-L2 1e-2, cosine >=
0.9999: int-code flips at rounding ties), with the adapters moving the output
by more than ten times that; ``quant_generate --lora`` within
tests/test_torch_generate.py's quantized-CLI limit, 2e-2.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.cli import quant_generate as jqg_cli
from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu.quant.ptq import prepare_quant_state as jax_prepare
from wanq_tpu.training import lora as jlora
from wanq_tpu_torch.cli import quant_generate
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import quant_state_from_numpy
from wanq_tpu_torch.pipelines import text2video as tt2v
from wanq_tpu_torch.training import lora as tlora
from wanq_tpu_torch.training.distill import DistillConfig, init_train_state

jql = importlib.import_module("wanq_tpu.quant.qlinear")
tql = importlib.import_module("wanq_tpu_torch.quant.qlinear")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W4A8_MIXED = os.path.join(ROOT, "quant_configs", "wan_w4a8_mixed.yaml")
# head dim 128: the fused producers, K3 and K4's heads-major route run
SMALL = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
             freq_dim=64)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def _models(seed=2, **kw):
    cfg_j, cfg_t = jax_tiny_config(**kw), tiny_config(**kw)
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(seed))
    pt = tdit.init_params(cfg_t, seed, device="cpu")
    hw = (np.random.default_rng(seed + 100).normal(size=(cfg_t.dim, 64)) * 0.02).astype(
        np.float32)
    pj["head"]["head"]["w"] = jnp.asarray(hw, dtype=cfg_j.dtype)
    pt["head"]["head"]["w"] = torch.from_numpy(hw).to(cfg_t.dtype)
    return cfg_j, pj, cfg_t, pt


def _with_b(lj, lt, rng, scale=0.1):
    """Both adapter sets with the same non-zero b (a trained adapter)."""
    for name in tlora.adapters(lt):
        b = (rng.normal(size=tuple(lt[name]["b"].shape)) * scale).astype(np.float32)
        lj[name]["b"], lt[name]["b"] = jnp.asarray(b), torch.from_numpy(b)


def test_init_lora_draws_match_jax():
    cfg_j, pj, cfg_t, pt = _models()
    names = jdit.linear_layer_names(cfg_j)
    assert tlora.lora_layer_names(names) == jlora.lora_layer_names(names)
    assert len(tlora.lora_layer_names(names)) == 6 * cfg_t.num_layers
    for tl, jl in ((tlora.init_lora(pt, names, rank=8, seed=3, alpha=4.0),
                    jlora.init_lora(pj, names, rank=8, seed=3, alpha=4.0)),
                   (tlora.init_lora_from_cfg(tiny_config(num_layers=3), rank=4, seed=5,
                                             device="cpu"),
                    jlora.init_lora_from_cfg(jax_tiny_config(num_layers=3), rank=4, seed=5))):
        assert list(tl) == list(jl)
        assert tlora.lora_scale(tl) == float(jl["__scale__"])
        for name, ab in tlora.adapters(tl).items():
            for leaf in "ab":
                np.testing.assert_array_equal(ab[leaf].numpy(), np.asarray(jl[name][leaf]))
    assert tlora.block_linear_dims(tiny_config(model_type="i2v")) == __import__(
        "wanq_tpu.quant.planner", fromlist=["x"]).block_linear_dims(
        jax_tiny_config(model_type="i2v"))


def test_apply_lora_matches_jax(rng):
    cfg_j, pj, cfg_t, pt = _models()
    names = jdit.linear_layer_names(cfg_j)
    lj, lt = jlora.init_lora(pj, names, rank=4, seed=1), tlora.init_lora(pt, names, rank=4,
                                                                        seed=1)
    _with_b(lj, lt, rng)
    mj, mt = jlora.apply_lora(pj, lj), tlora.apply_lora(pt, lt)
    for name in tlora.adapters(lt):
        got = jdit_get(mt, name)["w"].numpy()
        assert _rel(np.asarray(jdit_get(mj, name)["w"]), got) <= 1e-6
        assert not np.array_equal(got, jdit_get(pt, name)["w"].numpy())
    # the base tree is untouched, and unadapted leaves are shared
    assert mt["blocks"][0]["cross_attn"]["q"]["w"] is pt["blocks"][0]["cross_attn"]["q"]["w"]


def jdit_get(params, name):
    from wanq_tpu_torch.quant.ptq import params_get

    return params_get(params, name)


def test_merge_lora_into_quant_state(rng):
    cfg_j, pj, cfg_t, pt = _models()
    names = jdit.linear_layer_names(cfg_j)
    lt = tlora.init_lora(pt, names, rank=4, seed=1, alpha=8.0)
    _with_b({n: {} for n in tlora.adapters(lt)}, lt, rng)
    state = {n: {"w_int8": torch.zeros(1)} for n in tlora.adapters(lt)}
    merged = tlora.merge_lora_into_quant_state(state, lt)
    assert "lora_a" not in state[next(iter(state))]  # a copy
    for name, ab in tlora.adapters(lt).items():
        assert merged[name]["lora_a"] is ab["a"]
        assert torch.equal(merged[name]["lora_b"], ab["b"] * 2.0)
    with pytest.raises(KeyError, match="apply_lora"):
        tlora.merge_lora_into_quant_state({}, lt)


def test_lora_npz_both_directions(tmp_path, rng):
    cfg_j, pj, cfg_t, pt = _models()
    names = jdit.linear_layer_names(cfg_j)
    lj, lt = jlora.init_lora(pj, names, rank=4, seed=1, alpha=2.0), tlora.init_lora(
        pt, names, rank=4, seed=1, alpha=2.0)
    _with_b(lj, lt, rng)
    back_t = tlora.load_lora(jlora.save_lora(str(tmp_path / "j.npz"), lj), device="cpu")
    back_j = jlora.load_lora(tlora.save_lora(str(tmp_path / "t.npz"), lt))
    assert sorted(back_t) == sorted(lt) and sorted(back_j) == sorted(lj)
    assert tlora.lora_scale(back_t) == 0.5 and float(back_j["__scale__"]) == 0.5
    for name, ab in tlora.adapters(lt).items():
        for leaf in "ab":
            np.testing.assert_array_equal(back_t[name][leaf].numpy(), ab[leaf].numpy())
            np.testing.assert_array_equal(np.asarray(back_j[name][leaf]), ab[leaf].numpy())


def test_lora_checkpoint_round_trip(tmp_path, rng):
    """Adapters, the AdamW state after a step, and the config JSON; a fresh
    optimizer resumes to equal moments."""
    cfg_t = tiny_config()
    lora = tlora.init_lora_from_cfg(cfg_t, rank=4, seed=0, alpha=8.0, device="cpu")
    state, tx = init_train_state(lora, DistillConfig(learning_rate=1e-2))
    for t in tx.param_groups[0]["params"]:
        t.grad = torch.ones_like(t)
    tx.step()
    path = tlora.save_lora_checkpoint(str(tmp_path), 7, state.params, opt_state=tx)
    assert path.endswith("lora-checkpoint-7")
    fresh, tx2 = init_train_state(tlora.init_lora_from_cfg(cfg_t, rank=4, seed=9,
                                                           device="cpu"), DistillConfig())
    lora2, opt, step, cfg = tlora.resume_lora_checkpoint(path, opt_state_target=tx2,
                                                         device="cpu")
    assert step == 7 and opt is tx2
    assert cfg["lora_params"] == {"lora_rank": 4, "lora_alpha": 8.0,
                                  "target_modules": tlora.DEFAULT_TARGETS}
    for name, ab in tlora.adapters(state.params).items():
        assert torch.equal(lora2[name]["a"], ab["a"].detach())
    s1, s2 = tx.state_dict()["state"], tx2.state_dict()["state"]
    assert sorted(s1) == sorted(s2)
    for k in s1:
        assert torch.equal(s1[k]["exp_avg"], s2[k]["exp_avg"])
        assert torch.equal(s1[k]["exp_avg_sq"], s2[k]["exp_avg_sq"])
    # without a target the saved state dict comes back as it is
    assert tlora.resume_lora_checkpoint(path, device="cpu")[1]["state"].keys() == s1.keys()


@pytest.mark.parametrize("mode", ["sim", "int8"])
def test_adapted_model_matches_jax_on_every_route(rng, mode):
    """A head-dim-128 model under wan_w4a8_mixed.yaml with trained adapters on
    the default targets (self-attention q/k/v/o at W8, ffn at W4): every
    adapted site leaves the fused producers for qlinear's routes (the o
    projection after K3 / K4 included), and the forward equals wanq_tpu's;
    the adapters move it by far more than that."""
    cfg_j, pj, cfg_t, pt = _models(**SMALL, param_dtype="bfloat16",
                                   residual_dtype="bfloat16")
    names = jdit.linear_layer_names(cfg_j)
    pol, st, rot = jax_prepare(pj, names, JaxQuantConfig.from_yaml(W4A8_MIXED), targets=mode)
    st_t = quant_state_from_numpy(jax.tree.map(np.asarray, st), device="cpu")
    lj, lt = jlora.init_lora(pj, names, seed=4), tlora.init_lora(pt, names, seed=4)
    _with_b(lj, lt, rng, scale=0.05)
    x = rng.normal(size=(2, 16, 3, 8, 10)).astype(np.float32)
    t = np.asarray([999.0, 500.0], np.float32)
    c = rng.normal(size=(2, cfg_t.text_len, cfg_t.text_dim)).astype(np.float32)

    def jfwd(state):
        ctx = jql.QuantCtx(mode=mode, policies=pol, state=state, rotations=rot)
        return np.asarray(jax.jit(lambda p, a, b, d: jdit.dit_forward(
            p, cfg_j, a, b, d, 64, ctx=ctx))(pj, x, t, c))

    def tfwd(state):
        ctx = tql.QuantCtx(mode=mode, policies=pol, state=state)
        return tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                                torch.from_numpy(c), 64, ctx=ctx).numpy()

    want = jfwd(jlora.merge_lora_into_quant_state(st, lj))
    got = tfwd(tlora.merge_lora_into_quant_state(st_t, lt))
    base = tfwd(st_t)
    assert np.isfinite(got).all()
    assert _rel(want, got) <= 1e-2 and _cos(want, got) >= 0.9999
    assert _rel(base, got) >= 10 * max(_rel(want, got), 1e-2)


# ---------------------------------------------------------------------------
# quant_generate --lora
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


@pytest.mark.parametrize("hardware", [False, True], ids=["sim", "int8"])
def test_quant_generate_lora_matches_jax(tmp_path, jax_noise, hardware):
    """Both CLIs on one checkpoint dir (chip_smoke.write_dit_checkpoint) with
    wanq_tpu-written adapters (b != 0): the port's --lora as an npz and as a
    lora-checkpoint-N dir give the same latents, within 2e-2 of wanq_tpu's
    --lora and far from the run without adapters."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    cfg = tiny_config()
    params = tdit.init_params(cfg, 42, device="cpu")
    params["head"]["head"]["w"] = torch.from_numpy(
        (0.02 * np.random.default_rng(43).standard_normal((cfg.dim, 64))).astype(np.float32))
    chip_smoke.write_dit_checkpoint(params, cfg, str(tmp_path / "ckpt"))
    rng = np.random.default_rng(1)
    np.savez(tmp_path / "ctx.npz", **{k: rng.normal(size=(1, cfg.text_len, cfg.text_dim))
                                      .astype(np.float32) for k in ("context", "context_null")})
    names = tdit.linear_layer_names(cfg)
    lora = tlora.init_lora(params, names, rank=4, seed=2)
    _with_b({n: {} for n in tlora.adapters(lora)}, lora, rng, scale=0.2)
    jl = jlora.load_lora(tlora.save_lora(str(tmp_path / "l.npz"), lora))
    jlora.save_lora(str(tmp_path / "j_lora.npz"), jl)
    ckpt_dir = tlora.save_lora_checkpoint(str(tmp_path), 3, lora)
    common = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--sample_steps", "2",
              "--ckpt_dir", str(tmp_path / "ckpt"), "--context_file", str(tmp_path / "ctx.npz"),
              "--quant_config", W4A8_MIXED] + (["--hardware"] if hardware else [])

    def port(name, extra):
        return np.load(quant_generate.generate(quant_generate.parse_args(
            common + ["--device", "cpu", "--save_file", str(tmp_path / name)] + extra)))["latents"]

    got = port("t.npz", ["--lora", str(tmp_path / "j_lora.npz")])
    np.testing.assert_array_equal(port("t_dir.npz", ["--lora", ckpt_dir]), got)
    base = port("t_base.npz", [])
    want = np.load(jqg_cli.generate(jqg_cli.parse_args(
        common + ["--lora", str(tmp_path / "j_lora.npz"), "--save_file",
                  str(tmp_path / "j.npz")])))["latents"]
    assert np.isfinite(got).all() and got.shape == want.shape
    assert _rel(want, got) <= 2e-2
    assert _rel(base, got) >= 10 * max(_rel(want, got), 2e-3)
