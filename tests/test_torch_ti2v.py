"""Wan2.2 TI2V-5B on the port's normal path, on the CPU at tiny widths with
seeded weights: per-frame timesteps through the compact modulation table
(``models/dit.py``), the TI2V loop (``pipelines/textimage2video.py``) and the
``--task ti2v-5B`` CLI, held against the benchmark's plain reference
(``bench_h100/reference/ti2v.py``, loaded by path: it imports nothing of the
port) and against the per-token form Wan2.2 computes."""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.ops import _lib
from wanq_tpu_torch.pipelines.textimage2video import WanTI2V

BENCH = Path(__file__).resolve().parent.parent / "bench_h100"


def _load(name: str, path: Path, package: bool = False):
    """A benchmark module by its path, under a name of its own."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, path, submodule_search_locations=[str(path.parent)] if package else None)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_load("bench_reference", BENCH / "reference" / "__init__.py", package=True)
ref_ti2v = _load("bench_reference.ti2v", BENCH / "reference" / "ti2v.py")
ref_scheme = _load("bench_reference.scheme", BENCH / "reference" / "scheme.py")
draw = _load("bench_draw", BENCH / "draw.py")

# a Wan-shaped TI2V model small enough for the CPU: two heads of 128 (the
# fused routes), 48 latent channels, 16x spatial VAE stride
CFG = {"name": "tiny-ti2v", "dim": 256, "ffn_dim": 512, "num_heads": 2, "num_layers": 3,
       "text_len": 32, "text_dim": 256, "freq_dim": 256, "patch_size": [1, 2, 2], "in_dim": 48,
       "out_dim": 48, "z_dim": 48, "vae_stride": [4, 16, 16], "eps": 1e-6, "qk_norm": True,
       "cross_attn_norm": True, "param_dtype": "bfloat16", "residual_dtype": "bfloat16",
       "num_train_timesteps": 1000, "window_size": [-1, -1], "model_type": "ti2v"}
FP = {"remain_fp_regex": ".*", "weight": {"n_bits": 8}, "act": {"n_bits": 8}}
# 3 latent frames of 2 x 4 = 8 tokens; a sequence of 32 pads 8 tokens
FRAMES, TPF, SEQ = 3, 8, 32


def wan_cfg(cfg=CFG):
    keys = ("text_len", "text_dim", "z_dim", "in_dim", "out_dim", "dim", "ffn_dim", "freq_dim",
            "num_heads", "num_layers", "qk_norm", "cross_attn_norm", "eps",
            "num_train_timesteps", "param_dtype", "residual_dtype", "model_type")
    return tiny_config(name=cfg["name"], vae_stride=tuple(cfg["vae_stride"]),
                       patch_size=tuple(cfg["patch_size"]), **{k: cfg[k] for k in keys})


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def frame_t(t: float, b: int = 2) -> torch.Tensor:
    tt = torch.full((b, FRAMES), t)
    tt[:, 0] = 0.0
    return tt


@pytest.fixture(scope="module")
def inputs():
    params = draw.draw_params(CFG, 11, "cpu")
    g = torch.Generator().manual_seed(12)
    x = torch.randn((2, 48, FRAMES, 4, 8), generator=g)
    text = torch.randn((2, CFG["text_len"], CFG["text_dim"]), generator=g)
    return params, x, text


def test_time_tables_are_the_reference_per_token_embedding(inputs):
    """The compact tables, gathered to tokens, against the reference's
    per-token time MLP (f64 sinusoid there, f32 here): 1e-4 relative."""
    params, _, _ = inputs
    e, e0 = tdit.time_embedding(params, wan_cfg(), frame_t(871.0))
    ref = ref_ti2v.TI2VReference(params, CFG, FP)
    tok = ref_ti2v.frame_timesteps(2, FRAMES, TPF, 871.0, "cpu")
    re_, re0 = ref.time_embedding_tokens(tok)
    idx = torch.arange(FRAMES * TPF) // TPF
    assert rel(e[:, idx], re_) < 1e-4 and rel(e0[:, idx], re0) < 1e-4
    assert not torch.equal(e[:, 0], e[:, 1])  # frame 0's row is t = 0's


def test_fp_forward_against_the_reference(inputs):
    """The whole FP forward with per-frame timesteps against the reference's
    per-token one. Both round the products' bf16 operands and the bf16
    residual at the same points but sum in another order (the port's
    cuBLAS-ordered products, its rope in f32 where the reference's is f64),
    which alone puts 1.8e-3 to 2.2e-3 between them (weight seeds 5, 11, 21,
    31), as it does in text-to-video mode (1.9e-3 to 2.0e-3; the Wan2.1
    check's bound in bench_h100's tests is 5e-3): so 5e-3. Dropping the
    per-frame timestep moves the output 3.9e-2 to 4.4e-2, 20x that."""
    params, x, text = inputs
    ref = ref_ti2v.TI2VReference(params, CFG, FP)
    with torch.no_grad():
        want = ref.forward(x, 900.0, text)
        got = tdit.dit_forward(params, wan_cfg(), x, frame_t(900.0), text, SEQ)
        flat = tdit.dit_forward(params, wan_cfg(), x, torch.full((2,), 900.0), text, SEQ)
        t2v = ref.forward(x, 900.0, text, image=False)
    assert rel(got, want) < 5e-3
    assert rel(flat, t2v) < 5e-3
    assert rel(got, flat) > 10 * rel(got, want)


def _w8a8(params, cfg):
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state
    from wanq_tpu_torch.quant.qlinear import QuantCtx

    path = str(BENCH / "schemes" / "wan_w8a8_speed.yaml")
    g = torch.Generator().manual_seed(13)
    noise = torch.randn((1, 48, FRAMES, 4, 8), generator=g)
    z = torch.randn((48, 1, 4, 8), generator=g)
    text = torch.randn((1, CFG["text_len"], CFG["text_dim"]), generator=g)
    null = torch.randn((1, CFG["text_len"], CFG["text_dim"]), generator=g)
    calib = WanTI2V(cfg, params, quant_ctx=QuantCtx(mode="calib", collect_minmax=True),
                    device="cpu").collect_calibration(
        text, null, sampling_steps=1, noise=noise, cond_latent=z, size=(128, 64), frame_num=9,
        shift=5.0, sample_solver="unipc", guide_scale=5.0)
    pol, state, rot = prepare_quant_state(params, tdit.linear_layer_names(cfg),
                                          QuantConfig.from_yaml(path), calib=calib,
                                          targets="int8")
    ref = ref_ti2v.TI2VReference(params, CFG, ref_scheme.load_scheme(path))
    ref.calibrate(ref_ti2v.held(noise, z), 999.0, text, null)
    return QuantCtx(mode="int8", policies=pol, state=state, rotations=rot), ref


def test_w8a8_forward_against_the_reference(inputs):
    """W8A8 on the CPU route (the kernels' plain versions) against the
    reference under the same scheme, calibrated on the same held input. The
    reference quantizes the bf16-rounded modulated input (the release feeds
    its linears bf16), K1 the f32 value: 6.3% of block 0's q/k/v codes differ
    by one, which with the FP rounding gap puts 3.4e-3 to 3.6e-3 between the
    outputs (weight seeds 11, 21, 31); the reference with 4-bit activations
    reads 6.3e-2 to 6.6e-2. So 1e-2, the Wan2.1 check's bound."""
    params, x, text = inputs
    ctx, ref = _w8a8(params, wan_cfg())
    with torch.no_grad():
        got = tdit.dit_forward(params, wan_cfg(), x, frame_t(640.0), text, SEQ, ctx=ctx)
        want = ref.forward(x, 640.0, text)
        ref.control = "a4"
        low = ref.forward(x, 640.0, text)
    assert rel(got, want) < 1e-2 < rel(low, want)


def test_compact_table_is_the_per_token_form(inputs):
    """The per-frame table and the per-token form Wan2.2 computes (e0 a token,
    frame 0 at t = 0 and the pads at the step's t: here a table of one row a
    token) give the same f32 bits: e0, each block's output (on the fused
    W8A8 routes and on the FP plain routes) and the head."""
    params, _, _ = inputs
    cfg = wan_cfg()
    ctx, _ = _w8a8(params, cfg)
    e, e0 = tdit.time_embedding(params, cfg, frame_t(555.0))
    tok_t = torch.full((2, SEQ), 555.0)
    tok_t[:, :TPF] = 0.0
    # the per-token time MLP: one row a token, run on its own as the FP
    # time linears run each distinct row
    pe = [tdit.time_embedding(params, cfg, tok_t[b, i:i + 1]) for b in range(2)
          for i in range(SEQ)]
    pe_e = torch.cat([r[0] for r in pe]).reshape(2, SEQ, -1)
    pe_e0 = torch.cat([r[1] for r in pe]).reshape(2, SEQ, 6, -1)
    idx = torch.clamp(torch.arange(SEQ) // TPF, max=FRAMES - 1)
    assert torch.equal(e0[:, idx], pe_e0) and torch.equal(e[:, idx], pe_e)
    g = torch.Generator().manual_seed(14)
    x = (torch.randn((2, SEQ, CFG["dim"]), generator=g) * 0.5).bfloat16()
    c = torch.randn((2, CFG["text_len"], CFG["dim"]), generator=g).bfloat16()
    cos, sin = tdit._rope_tables_on((FRAMES, 2, 4), cfg.head_dim, x.device)
    with torch.no_grad():
        for qctx in (ctx, None):
            frames = tdit.block_forward(params["blocks"][0], "blocks.0", qctx, x, e0, c, cfg,
                                        cos, sin, FRAMES * TPF, tokens_per_row=TPF)
            tokens = tdit.block_forward(params["blocks"][0], "blocks.0", qctx, x, pe_e0, c, cfg,
                                        cos, sin, FRAMES * TPF, tokens_per_row=1)
            assert torch.equal(frames, tokens)
        assert torch.equal(tdit.head_forward(params, x, e, cfg, tokens_per_row=TPF),
                           tdit.head_forward(params, x, pe_e, cfg, tokens_per_row=1))


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8a8"])
def test_one_timestep_a_sample_is_todays_forward(inputs, quantized):
    """A [B] timestep is today's path; [B, 1] and a [B, F] whose frames all
    share the sample's t give its bits; so does a block given a one-row
    table in place of the [B, 6, C] modulation."""
    params, x, text = inputs
    cfg = wan_cfg()
    ctx = _w8a8(params, cfg)[0] if quantized else None
    t = torch.tensor([700.0, 300.0])
    _lib.reset_launch_counts()
    with torch.no_grad():
        base = tdit.dit_forward(params, cfg, x, t, text, SEQ, ctx=ctx)
        assert "time_embedding_rows" not in _lib.launch_counts()
        for tt in (t[:, None], t[:, None].expand(2, FRAMES).contiguous()):
            assert torch.equal(tdit.dit_forward(params, cfg, x, tt, text, SEQ, ctx=ctx), base)
        _, e0 = tdit.time_embedding(params, cfg, t)
        g = torch.Generator().manual_seed(15)
        xs = (torch.randn((2, SEQ, CFG["dim"]), generator=g) * 0.5).bfloat16()
        c = torch.randn((2, CFG["text_len"], CFG["dim"]), generator=g).bfloat16()
        cos, sin = tdit._rope_tables_on((FRAMES, 2, 4), cfg.head_dim, xs.device)
        one = tdit.block_forward(params["blocks"][1], "blocks.1", ctx, xs, e0, c, cfg, cos, sin,
                                 FRAMES * TPF)
        tab = tdit.block_forward(params["blocks"][1], "blocks.1", ctx, xs, e0[:, None], c, cfg,
                                 cos, sin, FRAMES * TPF, tokens_per_row=SEQ)
    assert torch.equal(one, tab)


def test_generate_holds_frame_zero_and_counts_two_rows_a_step(inputs):
    """Frame 0 is the conditioning latent before the first step and after
    every step, exactly; a batched CFG step runs the time MLP on its two
    distinct timesteps (0 and t), a sequential one twice; the text-to-video
    mode of the same model runs no per-frame row."""
    params, _, _ = inputs
    pipe = WanTI2V(wan_cfg(), params, device="cpu")
    g = torch.Generator().manual_seed(16)
    z = torch.randn((48, 1, 4, 8), generator=g)
    text = torch.randn((1, CFG["text_len"], CFG["text_dim"]), generator=g)
    seen, inputs_seen = [], []
    real = tdit.dit_forward

    def spy(params_, cfg_, x, t, *a, **k):
        inputs_seen.append((x[:, :, :1].clone(), t.clone()))
        return real(params_, cfg_, x, t, *a, **k)

    for mode, rows in (("batched", 2), ("sequential", 4)):
        seen.clear()
        inputs_seen.clear()
        _lib.reset_launch_counts()
        with pytest.MonkeyPatch.context() as mp:
            from wanq_tpu_torch.pipelines import text2video
            mp.setattr(text2video, "dit_forward", spy)
            out = pipe.generate(text, text, cond_latent=z, size=(128, 64), frame_num=9,
                                sampling_steps=4, seed=3, cfg_mode=mode,
                                on_step=lambda i, t, lat: seen.append(lat.clone()))
        assert _lib.launch_counts() == {"time_embedding_rows": rows * 4}
        assert len(seen) == 4 and all(torch.equal(s[0, :, 0], z[:, 0]) for s in seen)
        assert torch.equal(out[0, :, 0], z[:, 0])
        for x0, t in inputs_seen:  # every forward's input held, its timesteps per frame
            assert torch.equal(x0[:, :, 0], z[None, :, 0].expand(x0.shape[0], -1, -1, -1))
            assert t.shape == (x0.shape[0], FRAMES) and (t[:, 0] == 0).all()
            assert (t[:, 1:] == t[0, 1]).all() and float(t[0, 1]) > 0
    _lib.reset_launch_counts()
    pipe.generate(text, text, size=(128, 64), frame_num=9, sampling_steps=2, seed=3)
    assert "time_embedding_rows" not in _lib.launch_counts()


def test_plain_table_helpers_broadcast_by_rows():
    """ops/fused.py's plain table forms: each token takes its row's values
    (the last row also the tokens past the rows), the bits of a per-token
    gather."""
    from wanq_tpu_torch.ops.fused import gate_residual_plain, ln_modulate_quant_plain

    g = torch.Generator().manual_seed(17)
    x = torch.randn((2, 23, 16), generator=g).bfloat16()
    y = torch.randn((2, 23, 16), generator=g)
    tab = torch.randn((2, 4, 16), generator=g)
    idx = torch.clamp(torch.arange(23) // 5, max=3)  # rows of 5, the last row 8 tokens
    tok = tab[:, idx]
    assert torch.equal(gate_residual_plain(x, y, tab, tokens_per_row=5),
                       gate_residual_plain(x, y, tok, tokens_per_row=1))
    a = ln_modulate_quant_plain(x, tab, tab * 0.5, tokens_per_row=5)
    b = ln_modulate_quant_plain(x, tok, tok * 0.5, tokens_per_row=1)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_per_frame_refusals(inputs):
    params, x, text = inputs
    cfg = wan_cfg()
    with pytest.raises(ValueError):  # F must be the latent frames
        tdit.dit_forward(params, cfg, x, torch.zeros((2, FRAMES + 1)), text, SEQ)

    class Plan:
        dp_size = sp_size = 1

    with pytest.raises(NotImplementedError, match="sharding plan"):
        tdit.dit_forward(params, cfg, x, frame_t(5.0), text, SEQ, plan=Plan())
    from wanq_tpu_torch.training.distill import (DistillConfig, make_distill_step,
                                                 make_lora_distill_step,
                                                 make_qlora_distill_step)

    for make in (make_distill_step, make_lora_distill_step, make_qlora_distill_step):
        with pytest.raises(NotImplementedError, match="TI2V"):
            make(cfg, DistillConfig(), None)
    pipe = WanTI2V(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="cond_latent"):
        pipe.generate(text[:1], text[:1], cond_latent=torch.zeros((48, 1, 4, 4)),
                      size=(128, 64), frame_num=9, sampling_steps=1)


def _cli_args(tmp_path, *extra):
    from wanq_tpu_torch.cli.generate import parse_args

    return parse_args(["--task", "ti2v-5B", "--size", "1280*704", "--frame_num", "9",
                       "--random_init", "--device", "cpu", "--sample_steps", "2",
                       "--save_file", str(tmp_path / "ti2v.npz"), *extra])


@pytest.fixture
def tiny_ti2v_task(monkeypatch):
    """``ti2v-5B`` in the CLI's tables at the tiny widths (the CPU cannot hold
    5B), its 1280*704 size kept: a 5 x 80 x 44 latent grid."""
    from wanq_tpu_torch import configs

    small = dataclasses.replace(configs.WAN_CONFIGS["ti2v-5B"], dim=256, ffn_dim=512,
                                num_heads=2, num_layers=2, text_len=16, text_dim=64,
                                freq_dim=32)
    monkeypatch.setitem(configs.WAN_CONFIGS, "ti2v-5B", small)
    return small


def test_cli_runs_the_ti2v_task(tmp_path, tiny_ti2v_task):
    """``cli.generate --task ti2v-5B`` runs image-to-video on the seeded
    conditioning latent through the normal path: per-frame timesteps, frame
    0 held, the latents saved (no decode: the Wan2.2 VAE is not here)."""
    from wanq_tpu_torch.cli.generate import generate

    _lib.reset_launch_counts()
    path = generate(_cli_args(tmp_path, "--base_seed", "7"))
    lat = np.load(path)["latents"]
    assert lat.shape == (1, 48, 3, 44, 80) and np.isfinite(lat).all()
    z = np.random.default_rng(7).normal(size=(48, 1, 44, 80)).astype(np.float32)
    assert np.array_equal(lat[0, :, :1], z)
    assert _lib.launch_counts() == {"time_embedding_rows": 4}
    assert "video" not in np.load(path)


def test_cli_refuses_an_image_for_ti2v(tmp_path, tiny_ti2v_task):
    from wanq_tpu_torch.cli.generate import generate

    with pytest.raises(SystemExit, match="Wan2.2 VAE"):
        generate(_cli_args(tmp_path, "--image", str(tmp_path / "in.png")))


def test_calibration_and_quant_generate_run_image_to_video(tmp_path, tiny_ti2v_task):
    """The quantized deployment is built as it serves: ``get_calib_data``
    calibrates and ``quant_generate`` denoises ti2v-5B in image-to-video mode
    (per-frame timesteps, two time MLP rows a step; frame 0 held to the
    seeded conditioning latent), as ``cli.generate`` runs it."""
    from wanq_tpu_torch.cli import get_calib_data, quant_generate

    common = ["--task", "ti2v-5B", "--size", "1280*704", "--frame_num", "9", "--random_init",
              "--device", "cpu", "--sample_steps", "1", "--base_seed", "5",
              "--quant_config", str(Path(__file__).resolve().parent.parent / "quant_configs"
                                    / "wan_w8a8_speed.yaml")]
    calib = str(tmp_path / "calib.npz")
    _lib.reset_launch_counts()
    get_calib_data.generate(get_calib_data.parse_args(
        common + ["--collect_minmax", "--calib_save_path", calib]))
    assert _lib.launch_counts() == {"time_embedding_rows": 2}
    stats = np.load(calib)
    assert any(k.endswith("ffn.2.act_max") for k in stats.files)

    _lib.reset_launch_counts()
    path = quant_generate.generate(quant_generate.parse_args(
        common + ["--calib_data", calib, "--hardware", "--save_file", str(tmp_path / "q.npz")]))
    assert _lib.launch_counts() == {"time_embedding_rows": 2}
    lat = np.load(path)["latents"]
    z = np.random.default_rng(5).normal(size=(48, 1, 44, 80)).astype(np.float32)
    assert lat.shape == (1, 48, 3, 44, 80) and np.array_equal(lat[0, :, :1], z)


def test_fp_generate_runs_image_to_video(tmp_path, tiny_ti2v_task):
    """``fp_generate`` (the FP latents a quantized run is scored against)
    takes ti2v-5B in the same image-to-video mode."""
    from wanq_tpu_torch.cli import fp_generate

    _lib.reset_launch_counts()
    path = fp_generate.generate(fp_generate.parse_args(
        ["--task", "ti2v-5B", "--size", "1280*704", "--frame_num", "9", "--random_init",
         "--device", "cpu", "--sample_steps", "2", "--base_seed", "3",
         "--save_file", str(tmp_path / "fp.npz")]))
    assert _lib.launch_counts() == {"time_embedding_rows": 4}
    lat = np.load(path)["latents"]
    z = np.random.default_rng(3).normal(size=(48, 1, 44, 80)).astype(np.float32)
    assert np.array_equal(lat[0, :, :1], z)
