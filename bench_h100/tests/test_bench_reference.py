"""The plain reference against the program's CPU path (its kernels' plain
versions) on the tiny model: the DiT in FP and under each scheme, the static
scales of its own calibration, and the UniPC sampler over a whole schedule.
The test imports both; the reference imports nothing of the program."""

import numpy as np
import pytest
import torch

import draw
from jobs.denoise import wan_config
from reference.scheme import load_scheme
from reference.unipc import replay, sigmas_and_timesteps
from reference.wan import WanReference
from tiny import BENCH, CONFIG, TRAFFIC

SEED = 2**31 + 5


def inputs():
    params = draw.draw_params(CONFIG, SEED, "cpu")
    noise, text, null = draw.draw_video(CONFIG, TRAFFIC, SEED, 0, "cpu")
    return params, noise, text, null


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def program_forward(params, x, t, ctx, qctx=None):
    from wanq_tpu_torch.models.dit import dit_forward

    with torch.no_grad():
        return dit_forward(params, wan_config(CONFIG), x, torch.full((x.shape[0],), t), ctx, 32,
                           ctx=qctx)


def test_fp_forward():
    params, noise, text, null = inputs()
    x, ctx = torch.cat([noise, noise]), torch.cat([text, null])
    fp = {"remain_fp_regex": ".*", "weight": {"n_bits": 8}, "act": {"n_bits": 8}}
    with torch.no_grad():
        want = WanReference(params, CONFIG, fp).forward(x, 999.0, ctx)
    # bf16 operands and a bf16 residual, rounded in another order: ~2e-3
    assert rel(program_forward(params, x, 999.0, ctx), want) < 5e-3


@pytest.mark.parametrize("scheme", ["wan_w8a8_speed", "wan_w4a8_14b"])
def test_quantized_forward(scheme):
    from wanq_tpu_torch.models.dit import linear_layer_names
    from wanq_tpu_torch.pipelines.text2video import WanT2V
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state
    from wanq_tpu_torch.quant.qlinear import QuantCtx

    path = str(BENCH / "schemes" / f"{scheme}.yaml")
    params, noise, text, null = inputs()
    wcfg = wan_config(CONFIG)
    with torch.no_grad():
        calib = WanT2V(wcfg, params, quant_ctx=QuantCtx(mode="calib", collect_minmax=True),
                       device="cpu").collect_calibration(
            text, null, sampling_steps=1, noise=noise, size=(64, 64), frame_num=5, shift=5.0,
            sample_solver="unipc", guide_scale=5.0)
        qcfg = QuantConfig.from_yaml(path)
        pol, state, rot = prepare_quant_state(params, linear_layer_names(wcfg), qcfg, calib=calib,
                                              targets="int8")
        ref = WanReference(params, CONFIG, load_scheme(path))
        ref.calibrate(noise, 999.0, text, null)
        assert sorted(ref.static) == sorted(f"blocks.{i}.ffn.2"
                                            for i in range(CONFIG["num_layers"]))
        for name, scale in ref.static.items():
            assert float(scale) == pytest.approx(float(state[name]["delta_a"]), rel=1e-6)
        x, ctx = torch.cat([noise, noise]), torch.cat([text, null])
        got = program_forward(params, x, 624.0, ctx, QuantCtx(mode="int8", policies=pol,
                                                              state=state, rotations=rot))
        want = ref.forward(x, 624.0, ctx)
    assert rel(got, want) < 1e-2


def test_sampler_replays_the_program_scheduler():
    from wanq_tpu_torch.solvers.unipc import FlowUniPCMultistepScheduler

    sch = FlowUniPCMultistepScheduler(num_train_timesteps=1000, shift=1.0)
    sch.set_timesteps(50, shift=5.0)
    _, ts = sigmas_and_timesteps(50, 5.0)
    assert np.array_equal(np.asarray(sch.timesteps), ts)
    g = torch.Generator().manual_seed(3)
    x = x0 = torch.randn(1, 4, 2, 6, 6, generator=g)
    vs, xs = [], []
    for t in ts:
        v = torch.randn(x.shape, generator=g)
        x = sch.step(v, int(t), x)
        vs.append(v)
        xs.append(x)
    want = replay(x0, vs, 50, 5.0)
    assert max(rel(a, b) for a, b in zip(xs, want)) < 1e-6
    low = replay(x0, vs, 50, 5.0, dtype=torch.bfloat16)
    assert max(rel(a, b.float()) for a, b in zip(xs, low)) > 1e-4


@pytest.mark.parametrize("window", [0, 1, (0, -1)])
def test_banded_forward(window):
    """Self-attention banded to +-r latent frames (an int, or one r a head,
    negative dense), against the program's band (K4's band mode's plain
    version). The tiny video has two latent frames: r = 0 bands."""
    from wanq_tpu_torch.quant.qlinear import QuantCtx

    params, noise, text, null = inputs()
    x, ctx = torch.cat([noise, noise]), torch.cat([text, null])
    fp = {"remain_fp_regex": ".*", "weight": {"n_bits": 8}, "act": {"n_bits": 8}}
    with torch.no_grad():
        want = WanReference(params, CONFIG, fp, window=window).forward(x, 999.0, ctx)
        dense = WanReference(params, CONFIG, fp).forward(x, 999.0, ctx)
    got = program_forward(params, x, 999.0, ctx, QuantCtx(mode="fp", attn_window=window))
    assert rel(got, want) < 5e-3
    if window != 1:
        assert rel(want, dense) > 2e-2  # the band is seen: 10x the agreement above
