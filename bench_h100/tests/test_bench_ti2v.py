"""The ``ti2v`` job kind on a tiny stand-in of TI2V-5B on the CPU (the look
for a card skipped), judged by the cell's own limits: a sound run is
correct, each control reads above a limit, and each fault of the job kind
(``faults_ti2v.py``: the denoise faults, every token at the step's t, frame 0
not held after a step) comes out not correct. Also the cell's files, the
modulation bytes at the cell's widths, and the reference's held sampler
against the program's."""

import json

import pytest
import torch

import arith_ti2v
import draw
from faults import FAULTS, plant
from harness import run_job
from jobs import ti2v
from reference.scheme import load_scheme
from reference.ti2v import held, replay_held
from reference.unipc import sigmas_and_timesteps
from tiny import BENCH, CONFIG

CELL = "ti2v-5b.w8a8.704p121"
TINY = {**CONFIG, "name": "tiny-ti2v", "model_type": "ti2v", "in_dim": 48, "out_dim": 48,
        "z_dim": 48, "vae_stride": [4, 16, 16], "sample_fps": 24}
# 3 latent frames of 2 x 4 tokens: frame 0 held, two at the step's t
TRAFFIC = {"width": 128, "height": 64, "frames": 9}


def job(seed=2**31 + 23, steps=6):
    import run

    spec = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    spec["traffic"] = {**spec["traffic"], **TRAFFIC, "steps": steps}
    run.OUT.mkdir(exist_ok=True)
    return run.Job(spec, TINY, seed, 0.0, False, 0.0, device="cpu")


def correct(j, checks):
    return all(v <= j.spec["limits"][k] for k, v in checks.items())


def test_sound_run_is_correct():
    j = job()
    checks = run_job(j, ti2v)["checks"]
    assert checks["timestep_mismatches"] == 0 and checks["sampler_rel_l2"] < 1e-6
    assert correct(j, checks)


@pytest.mark.parametrize("control", ["fp8", "a4"])
def test_control_is_not_correct(control):
    j = job()
    state = ti2v.setup(j)
    ti2v.window(j, state)
    low = ti2v.check(j, ti2v.free(state), control=control)
    assert low["sampler_rel_l2"] <= j.spec["limits"]["sampler_rel_l2"]
    assert low["forward_rel_l2"] > j.spec["limits"]["forward_rel_l2"]


@pytest.mark.parametrize("fault", sorted(FAULTS["ti2v"]))
def test_broken_path_is_not_correct(fault, monkeypatch):
    plant("ti2v", fault, monkeypatch.setattr)
    j = job()
    assert not correct(j, run_job(j, ti2v)["checks"])


def test_the_window_counts_the_per_frame_mode(capfd):
    """Every forward of the window reads per-frame rows: the time MLP's two
    distinct timesteps a step (batched CFG), taken out of the per-block
    counts and checked a forward."""
    j = job(steps=4)
    run_job(j, ti2v)
    err = capfd.readouterr().err
    assert "launch check a forward: time_embedding_rows 2;" in err and "; equal" in err


def test_held_replay_is_the_program_loop():
    """The reference's UniPC with frame 0 held gives the latents the
    program's TI2V loop carries, on the velocities the loop was given."""
    from wanq_tpu_torch.configs import tiny_config
    from wanq_tpu_torch.models.dit import init_params
    from wanq_tpu_torch.pipelines import textimage2video
    from wanq_tpu_torch.pipelines.textimage2video import WanTI2V

    g = torch.Generator().manual_seed(5)
    cfg = tiny_config(model_type="ti2v", in_dim=48, out_dim=48, z_dim=48,
                      vae_stride=(4, 16, 16))
    pipe = WanTI2V(cfg, init_params(cfg, 0, device="cpu"), device="cpu")
    vs, xs = [], []

    def dit(params, c, x, t, *a, **k):
        vs.append(torch.randn(x.shape, generator=g))
        return vs[-1]

    noise, z = torch.randn(1, 48, 3, 4, 8, generator=g), torch.randn(48, 1, 4, 8, generator=g)
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(textimage2video.WanT2V, "_cond", lambda self, lat, t, *a, **k: dit(
            None, None, lat, t))
        pipe.generate(ctx, ctx, cond_latent=z, size=(128, 64), frame_num=9, sampling_steps=8,
                      noise=noise, cfg_mode="sequential",
                      on_step=lambda i, t, x: xs.append(x.clone()))
    velocities = [vs[2 * i + 1] + 5.0 * (vs[2 * i] - vs[2 * i + 1]) for i in range(8)]
    want = replay_held(noise, velocities, 8, 5.0, lambda x: held(x, z))
    for got, w in zip(xs, want):
        assert torch.equal(got[:, :, :1], w[:, :, :1])
        assert float((got - w).norm() / w.norm()) < 1e-6
    _, ts = sigmas_and_timesteps(8, 5.0)
    assert len(xs) == len(ts)


def test_modulate_bytes_at_the_cell():
    """K1 at [2, 27648, 3072] bf16: 2 + 1 bytes an element, 8 a row, the
    rows of 31 frames a sample; K13 8 bytes an element."""
    spec = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    cfg = json.loads((BENCH / "configs" / "ti2v-5b.json").read_text())
    calls = {c["call"]: c for c in arith_ti2v.modulate_calls(
        cfg, load_scheme(str(BENCH / "schemes" / "wan_w8a8_speed.yaml")), spec["traffic"], 2)}
    m, c = 2 * 27648, 3072
    assert arith_ti2v.latent_frames(cfg, spec["traffic"]) == 31
    assert calls["K1 self"]["bytes"] == 3 * m * c + 8 * m + 2 * 2 * 31 * c * 4
    assert calls["K1 cross"]["bytes"] == 3 * m * c + 8 * m + 2 * 2 * c * 4
    assert calls["K13 self"]["bytes"] == 8 * m * c + 2 * 31 * c * 4 + c * 4  # FP o: its bias
    assert calls["K13 cross"]["bytes"] == 8 * m * c + c * 4
    assert calls["K13 ffn"]["bytes"] == 8 * m * c + 2 * 31 * c * 4
    assert all(x["count"] == 30 for x in calls.values())
    assert sum(x["bound_s"] for x in calls.values()) * 30 * 1e3 == pytest.approx(
        30 * (3 * (3 * m * c + 8 * m) + 3 * 8 * m * c) / 3.35e9, rel=1e-3)


def test_cell_files():
    """The configuration is Wan2.2-TI2V-5B's published widths, whole; the
    cell counts the per-frame launches; the win1 cell is cell 1 banded."""
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "ti2v-5b.json").read_text())
    assert {k: cfg[k] for k in ("dim", "ffn_dim", "num_heads", "num_layers", "in_dim", "out_dim",
                                "z_dim", "freq_dim", "text_len")} == {
        "dim": 3072, "ffn_dim": 14336, "num_heads": 24, "num_layers": 30, "in_dim": 48,
        "out_dim": 48, "z_dim": 48, "freq_dim": 256, "text_len": 512}
    assert cfg["vae_stride"] == [4, 16, 16] and cfg["reduced"] == []
    spec = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    assert spec["job"] == "ti2v" and set(spec["limits"]) == {
        "forward_rel_l2", "sampler_rel_l2", "timestep_mismatches"}
    assert spec["launches_per_block"]["ln_modulate_quant_rows"] == 2
    assert spec["launches_per_block"]["gate_residual_rows"] == 2
    assert spec["launches_per_forward"] == {"time_embedding_rows": 2}
    one = json.loads((BENCH / "workloads" / "t2v-1.3b.w8a8.480p81.json").read_text())
    win1 = json.loads((BENCH / "workloads" / "t2v-1.3b.w8a8.480p81.win1.json").read_text())
    assert win1["traffic"] == {**one["traffic"], "ctx": {"attn_window": 1}}
    names = {w["name"]: w for w in bench["workloads"]}
    assert names[CELL]["config"] == "ti2v-5b" and CELL in [
        c for m in bench["per_layer"] if m["name"] == "modulate_roofline.serve"
        for c in m["workloads"]]


def test_draws_differ_by_video():
    a = ti2v.cond_latent(TINY, TRAFFIC, 7, 0, "cpu")
    assert a.shape == (48, 1, 4, 8)
    assert torch.equal(a, ti2v.cond_latent(TINY, TRAFFIC, 7, 0, "cpu"))
    assert not torch.equal(a, ti2v.cond_latent(TINY, TRAFFIC, 7, 1, "cpu"))
    noise, _, _ = draw.draw_video(TINY, TRAFFIC, 7, 0, "cpu")
    assert noise.shape == (1, 48, 3, 4, 8)
