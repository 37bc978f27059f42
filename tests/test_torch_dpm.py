"""The port's DPM++ solver against wanq_tpu's on the CPU.

The scheduler: the same model outputs (seeded numpy, float64) are fed to
both schedulers step by step over solver orders 1-3, both second-order
types, with and without ``lower_order_final``, and several step counts;
the timesteps and sigmas must be equal and every step's sample within 1e-12
relative (the same float64 host coefficients, the same tensor expressions).
On a constant-x0 flow the solver is exact (atol 1e-8). The pipeline:
``WanT2V.generate(sample_solver="dpm++")`` on the ``tiny`` DiT from
wanq_tpu's initial noise, latents within rel-L2 1e-4 of wanq_tpu's (one
forward of the two packages agrees to ~1e-7; 6 steps at guidance 2), and
the sequential-CFG run within 1e-5 of the batched one. Every CLI with
``--sample_solver`` hands it to the pipeline.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.pipelines import text2video as jt2v
from wanq_tpu.solvers import dpm as jdpm
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.pipelines import text2video as tt2v
from wanq_tpu_torch.solvers import dpm as tdpm

W4A8_MIXED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "quant_configs", "wan_w4a8_mixed.yaml")
GEN_KW = dict(size=(64, 64), frame_num=5, sampling_steps=6, guide_scale=2.0,
              sample_solver="dpm++")
SEED = 7


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.mark.parametrize("steps", [1, 3, 6, 20])
@pytest.mark.parametrize("order,solver_type,lower_order_final", [
    (1, "midpoint", True), (2, "midpoint", True), (2, "heun", True), (3, "midpoint", True),
    (3, "heun", True), (2, "midpoint", False), (3, "midpoint", False),
])
def test_scheduler_matches_jax(steps, order, solver_type, lower_order_final):
    kw = dict(solver_order=order, solver_type=solver_type, lower_order_final=lower_order_final)
    sj = jdpm.FlowDPMSolverMultistepScheduler(**kw)
    st = tdpm.FlowDPMSolverMultistepScheduler(**kw)
    sig = jdpm.get_sampling_sigmas(steps, 5.0)
    np.testing.assert_array_equal(tdpm.get_sampling_sigmas(steps, 5.0), sig)
    tj, nj = jdpm.retrieve_timesteps(sj, sigmas=sig)
    tt, nt = tdpm.retrieve_timesteps(st, sigmas=sig)
    assert nt == nj == steps
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(st.sigmas, sj.sigmas)
    rng = np.random.default_rng(steps * 10 + order)
    xj = rng.normal(size=(3, 8))
    xt = torch.from_numpy(xj.copy())
    for t in tj:
        out = rng.normal(size=(3, 8))
        xj = sj.step(out, t, xj)
        xt = st.step(torch.from_numpy(out), t, xt)
        assert _rel(xj, xt.numpy()) <= 1e-12
    assert st.step_index == sj.step_index == steps


def test_set_timesteps_by_count_matches_jax():
    for shift in (1.0, 3.0):
        sj = jdpm.FlowDPMSolverMultistepScheduler(shift=shift)
        st = tdpm.FlowDPMSolverMultistepScheduler(shift=shift)
        sj.set_timesteps(12)
        st.set_timesteps(12)
        np.testing.assert_array_equal(st.timesteps, sj.timesteps)
        np.testing.assert_array_equal(st.sigmas, sj.sigmas)


@pytest.mark.parametrize("steps", [1, 2, 5, 30])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_exact_on_constant_x0_flow(steps, order):
    rng = np.random.default_rng(steps + 100 * order)
    x0 = torch.from_numpy(rng.normal(size=(2, 8)))
    x = torch.from_numpy(rng.normal(size=(2, 8)))
    sch = tdpm.FlowDPMSolverMultistepScheduler(solver_order=order)
    timesteps, n = tdpm.retrieve_timesteps(sch, sigmas=tdpm.get_sampling_sigmas(steps, 5.0))
    assert n == steps
    for i, t in enumerate(timesteps):
        x = sch.step((x - x0) / sch.sigmas[i], t, x)
    np.testing.assert_allclose(x.numpy(), x0.numpy(), atol=1e-8)


def test_bad_solver_options_raise():
    with pytest.raises(ValueError, match="dpmsolver"):
        tdpm.FlowDPMSolverMultistepScheduler(algorithm_type="sde-dpmsolver++")
    with pytest.raises(ValueError, match="solver_type"):
        tdpm.FlowDPMSolverMultistepScheduler(solver_type="bh2")
    with pytest.raises(RuntimeError, match="set_timesteps"):
        tdpm.FlowDPMSolverMultistepScheduler().step(torch.zeros(1), 999, torch.zeros(1))


@pytest.fixture(scope="module")
def models():
    cfg_j, cfg_t = jax_tiny_config(), tiny_config()
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = tdit.init_params(cfg_t, 0, device="cpu")
    hw = (np.random.default_rng(123).standard_normal((cfg_t.dim, 64)) * 0.02).astype(np.float32)
    pj["head"]["head"]["w"] = jnp.asarray(hw)
    pt["head"]["head"]["w"] = torch.from_numpy(hw)
    rng = np.random.default_rng(1)
    c, cn = (rng.normal(size=(1, cfg_t.text_len, cfg_t.text_dim)).astype(np.float32)
             for _ in range(2))
    shape = tt2v.compute_target_shape(cfg_t, GEN_KW["size"], GEN_KW["frame_num"])
    noise = np.array(jax.random.normal(jax.random.PRNGKey(SEED), (1, *shape), jnp.float32))
    return cfg_j, pj, cfg_t, pt, c, cn, noise


def test_generate_dpm_matches_jax(models):
    cfg_j, pj, cfg_t, pt, c, cn, noise = models
    want = np.asarray(jt2v.WanT2V(cfg_j, pj).generate(jnp.asarray(c), jnp.asarray(cn),
                                                       seed=SEED, **GEN_KW))
    pipe = tt2v.WanT2V(cfg_t, pt, device="cpu")
    got = pipe.generate(torch.from_numpy(c), torch.from_numpy(cn),
                        noise=torch.from_numpy(noise), **GEN_KW).numpy()
    assert np.isfinite(got).all() and _rel(want, got) <= 1e-4
    seq = pipe.generate(torch.from_numpy(c), torch.from_numpy(cn), noise=torch.from_numpy(noise),
                        cfg_mode="sequential", **GEN_KW).numpy()
    assert _rel(got, seq) <= 1e-5


def test_unknown_solver_raises(models):
    _, _, cfg_t, pt, c, cn, _ = models
    with pytest.raises(ValueError, match="sample_solver"):
        tt2v.WanT2V(cfg_t, pt, device="cpu").generate(
            torch.from_numpy(c), torch.from_numpy(cn), **{**GEN_KW, "sample_solver": "euler"})


@pytest.mark.parametrize("solver", ["unipc", "dpm++"])
@pytest.mark.parametrize("cli_name", ["fp_generate", "generate", "quant_generate",
                                      "get_calib_data"])
def test_every_cli_runs_the_solver_it_is_given(cli_name, solver, monkeypatch, tmp_path):
    """--sample_solver reaches the pipeline in each CLI that has the flag, as
    in wanq_tpu's CLIs (the calibration sweep's too), and the run ends."""
    cli = importlib.import_module(f"wanq_tpu_torch.cli.{cli_name}")
    seen = []
    orig = tt2v.WanT2V.generate

    def generate(self, *a, **kw):
        seen.append(kw.get("sample_solver"))
        return orig(self, *a, **kw)

    monkeypatch.setattr(tt2v.WanT2V, "generate", generate)
    argv = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--sample_steps", "2",
            "--random_init", "--device", "cpu", "--sample_solver", solver]
    if cli_name in ("quant_generate", "get_calib_data"):
        argv += ["--quant_config", W4A8_MIXED]
    argv += (["--calib_save_path", str(tmp_path / "calib.npz")] if cli_name == "get_calib_data"
             else ["--save_file", str(tmp_path / "out.npz")])
    cli.generate(cli.parse_args(argv))
    assert seen == [solver]
