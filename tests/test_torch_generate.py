"""The port's whole generate chain against wanq_tpu's on the CPU: the DiT
checkpoint loader, the ``generate`` / ``fp_generate`` CLIs and the video
writer.

Both packages read one test-written checkpoint dir: the ``tiny`` DiT as
reference-layout safetensors in two shards with their index JSON
(``chip_smoke.write_dit_checkpoint``, the writer the card's smoke run uses),
and a ``Wan2.1_VAE.pth`` of ``WAN_VAE_CFG``'s structure at dim 8. The port's
initial noise is replaced by wanq_tpu's draw (jax.random), so both CLIs
denoise the same latents. Tolerances: ``dit_forward`` on the loaded params
rel-L2 <= 1e-5; FP latents and videos rel-L2 <= 1e-5; the sim and int8
runs (W8A8 from one ptq artifact) within tests/test_torch_slice.py's W8A8
limit, 2e-2.

wanq_tpu's single-prompt ``generate`` raises UnboundLocalError at its end
(``import logging`` inside the scan fallback makes ``logging`` local to the
function), after the mp4 and before the npz when it decodes; its
``--prompt_file`` loop runs to its end, so the port's ``generate`` is held
against that loop's npz.
"""

import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.cli import fp_generate as jfp_cli
from wanq_tpu.cli import generate as jgen_cli
from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.models import params as jparams
from wanq_tpu.utils import video as jvideo
from wanq_tpu_torch.cli import common, fp_generate, generate, get_calib_data, ptq
from wanq_tpu_torch import configs as tconfigs
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models import params as tparams
from wanq_tpu_torch.models import vae as tvae
from wanq_tpu_torch.pipelines import text2video as tt2v
from wanq_tpu_torch.utils import video as tvideo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEED = os.path.join(ROOT, "quant_configs", "wan_w8a8_speed.yaml")
COMMON = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--sample_steps", "2"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for the port's CPU ops: the test runs share the
    host's cores among several worker processes, and one torch thread per
    core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


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


def _tiny_params(seed=42):
    cfg = tiny_config()
    params = tdit.init_params(cfg, seed, device="cpu")
    shape = params["head"]["head"]["w"].shape
    params["head"]["head"]["w"] = torch.from_numpy(
        (0.02 * np.random.default_rng(seed + 1).standard_normal(shape)).astype(np.float32))
    return cfg, params


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A checkpoint dir, one- and two-row context files and a W8A8 ptq
    artifact of the checkpoint's weights."""
    d = tmp_path_factory.mktemp("gen")
    cfg, params = _tiny_params()
    smoke = _chip_smoke()
    smoke.write_dit_checkpoint(params, cfg, str(d / "ckpt"), shards=2)
    smoke.write_vae_checkpoint(tvae.init_vae_params(tvae.VAEConfig(dim=8), 0, device="cpu"),
                               str(d / "ckpt" / cfg.vae_checkpoint))
    rng = np.random.default_rng(1)
    ctx = {k: rng.normal(size=(2, cfg.text_len, cfg.text_dim)).astype(np.float32)
           for k in ("context", "context_null")}
    np.savez(d / "ctx2.npz", **ctx)
    np.savez(d / "ctx1.npz", **{k: v[:1] for k, v in ctx.items()})
    (d / "one.txt").write_text("a red fox\n")
    (d / "two.txt").write_text("a red fox\n\na blue whale\n")
    base = COMMON + ["--ckpt_dir", str(d / "ckpt"), "--context_file", str(d / "ctx1.npz"),
                     "--device", "cpu", "--quant_config", SPEED]
    calib = get_calib_data.generate(get_calib_data.parse_args(
        base + ["--collect_minmax", "--calib_save_path", str(d / "calib.npz")]))
    ptq.generate(ptq.parse_args(base + ["--calib_data", calib,
                                        "--save_path", str(d / "qp.npz")]))
    return d


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


def _args(d, name, ctx="ctx1.npz", extra=()):
    return COMMON + ["--ckpt_dir", str(d / "ckpt"), "--context_file", str(d / ctx),
                     "--save_file", str(d / name), *extra]


# ---------------------------------------------------------------------------
# the checkpoint loader
# ---------------------------------------------------------------------------

KEYS = {  # reference key -> shape, one per class convert_tensor tells apart
    "patch_embedding.weight": (8, 4, 1, 2, 2),
    "patch_embedding.bias": (8,),
    "blocks.3.modulation": (1, 6, 8),
    "head.modulation": (1, 2, 8),
    "blocks.0.self_attn.norm_q.weight": (8,),
    "blocks.0.cross_attn.norm_k_img.weight": (8,),
    "blocks.1.norm3.weight": (8,),
    "blocks.1.norm3.bias": (8,),
    "blocks.2.ffn.0.weight": (12, 8),
    "img_emb.proj.0.weight": (8,),
    "text_embedding.2.bias": (8,),
    "freqs": (4, 2),
    "some_buffer": (3,),
}


@pytest.mark.parametrize("key", list(KEYS))
def test_convert_tensor_matches_jax(key):
    v = np.random.default_rng(0).normal(size=KEYS[key]).astype(np.float32)
    want = jparams.convert_tensor(key, v, jnp.bfloat16)
    got = tparams.convert_tensor(key, torch.from_numpy(v), torch.bfloat16)
    if want is None:
        assert got is None
        return
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[2] == torch.bfloat16) == (want[2] == jnp.bfloat16)


def test_convert_state_dict_matches_jax():
    """A reference-layout state dict (the checkpoint writer's) converts back
    to the params it came from, as wanq_tpu's converter does."""
    cfg, params = _tiny_params()
    sd = _chip_smoke().reference_state_dict(params, cfg)
    got = tparams.convert_state_dict(sd, dtype=cfg.dtype, device="cpu")
    back = _chip_smoke().reference_state_dict(got, cfg)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    want = jax.tree.map(np.asarray, jparams.convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, dtype=jnp.float32))
    np.testing.assert_array_equal(want["patch_embedding"]["w"], got["patch_embedding"]["w"])
    np.testing.assert_array_equal(want["blocks"][1]["self_attn"]["norm_q"],
                                  got["blocks"][1]["self_attn"]["norm_q"])
    np.testing.assert_array_equal(want["blocks"][0]["ffn"]["2"]["w"],
                                  got["blocks"][0]["ffn"]["2"]["w"])


@pytest.mark.parametrize("index", [True, False], ids=["index", "no_index"])
def test_load_wan_checkpoint_forward_matches_jax(ckpt, index, tmp_path):
    """The port loads the weights it wrote, bit for bit, with or without the
    index JSON; its dit_forward on them matches wanq_tpu's forward on
    wanq_tpu's load of the same dir."""
    src = ckpt / "ckpt"
    if not index:
        src = tmp_path / "noindex"
        src.mkdir()
        for f in os.listdir(ckpt / "ckpt"):
            if f.endswith(".safetensors"):
                os.symlink(ckpt / "ckpt" / f, src / f)
    cfg, params = _tiny_params()
    got = tparams.load_wan_checkpoint(str(src), dtype=cfg.dtype, device="cpu")
    a, b = _chip_smoke().reference_state_dict(params, cfg), \
        _chip_smoke().reference_state_dict(got, cfg)
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    cfg_j = jax_tiny_config()
    pj = jparams.load_wan_checkpoint(str(ckpt / "ckpt"), dtype=cfg_j.dtype)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 16, 2, 8, 8)).astype(np.float32)
    t = np.asarray([700.0], np.float32)
    ctx = rng.normal(size=(1, cfg.text_len, cfg.text_dim)).astype(np.float32)
    want = np.asarray(jdit.dit_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(ctx), 32))
    out = tdit.dit_forward(got, cfg, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(ctx), 32)
    assert _rel(want, out.numpy()) <= 1e-5
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        tparams.load_wan_checkpoint(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_fp_generate_cli_matches_jax(ckpt, jax_noise):
    got = np.load(fp_generate.generate(fp_generate.parse_args(
        _args(ckpt, "t_fp.npz", extra=["--device", "cpu"]))))
    want = np.load(jfp_cli.generate(jfp_cli.parse_args(_args(ckpt, "j_fp.npz"))))
    assert got["latents"].shape == want["latents"].shape == (1, 16, 2, 8, 8)
    assert got["video"].shape == want["video"].shape == (1, 3, 5, 64, 64)
    assert got["video"].dtype == np.float32 and np.abs(got["video"]).max() <= 1.0
    assert _rel(want["latents"], got["latents"]) <= 1e-5
    assert _rel(want["video"], got["video"]) <= 1e-5


@pytest.mark.parametrize("mode", ["fp", "sim", "int8"])
def test_generate_cli_matches_jax(ckpt, jax_noise, mode):
    """The port's single-prompt generate against wanq_tpu's --prompt_file
    loop on one line (same context row, seed and artifact)."""
    quant = {"fp": [], "sim": ["--quant_config", SPEED, "--quant_params", str(ckpt / "qp.npz")],
             "int8": ["--quant_config", SPEED, "--quant_params", str(ckpt / "qp.npz"),
                      "--hardware"]}[mode]
    got = np.load(generate.generate(generate.parse_args(
        _args(ckpt, f"t_{mode}.npz", extra=quant + ["--device", "cpu"]))))
    saved = jgen_cli.generate(jgen_cli.parse_args(
        _args(ckpt, f"j_{mode}.npz", extra=quant + ["--prompt_file", str(ckpt / "one.txt")])))
    want = np.load(saved[0])
    limit = 1e-5 if mode == "fp" else 2e-2
    assert got["video"].shape == want["video"].shape == (1, 3, 5, 64, 64)
    assert _rel(want["latents"], got["latents"]) <= limit
    assert _rel(want["video"], got["video"]) <= limit


def test_prompt_file_serving_matches_jax(ckpt, jax_noise):
    """--prompt_file with 2 prompts: one npz per prompt (latents, prompt,
    video), each equal to wanq_tpu's."""
    extra = ["--prompt_file", str(ckpt / "two.txt")]
    got = generate.generate(generate.parse_args(
        _args(ckpt, "t_serve.npz", "ctx2.npz", extra + ["--device", "cpu"])))
    want = jgen_cli.generate(jgen_cli.parse_args(
        _args(ckpt, "j_serve.npz", "ctx2.npz", extra)))
    assert [os.path.basename(f) for f in got] == ["t_serve_p0.npz", "t_serve_p1.npz"]
    for g, w, prompt in zip(got, want, ("a red fox", "a blue whale")):
        g, w = np.load(g), np.load(w)
        assert str(g["prompt"]) == str(w["prompt"]) == prompt
        assert _rel(w["latents"], g["latents"]) <= 1e-5
        assert _rel(w["video"], g["video"]) <= 1e-5
    assert np.abs(np.load(got[0])["latents"] - np.load(got[1])["latents"]).max() > 0


def test_serving_loop_reads_the_quant_yaml_once(ckpt, monkeypatch):
    """wanq_tpu's serving loop parses the quant YAML again for every prompt
    (a known reference fault); the port reads it once, for the quant state
    and the cache: fallback alike."""
    from wanq_tpu_torch.quant import QuantConfig

    reads = []
    real = QuantConfig.from_yaml.__func__

    def counted(cls, path):
        reads.append(path)
        return real(cls, path)

    monkeypatch.setattr(QuantConfig, "from_yaml", classmethod(counted))
    out = generate.generate(generate.parse_args(_args(ckpt, "yaml_once.npz", "ctx2.npz", [
        "--device", "cpu", "--sample_steps", "1", "--quant_config", SPEED, "--quant_params",
        str(ckpt / "qp.npz"), "--hardware", "--prompt_file", str(ckpt / "two.txt")])))
    assert len(out) == 2 and reads == [SPEED]


def test_vae_dtype_t5_cpu_and_offload_flags(ckpt, monkeypatch):
    """--vae_dtype bfloat16 decodes in bf16 (a float32 video close to the
    f32 one: PSNR >= 30 dB over the [-1, 1] range), --offload_model is accepted and ignored, and --t5_cpu reaches
    encode_prompts when the states come from the checkpoint's T5."""
    extra = ["--device", "cpu", "--offload_model", "True", "--t5_cpu"]
    f32 = np.load(generate.generate(generate.parse_args(
        _args(ckpt, "f32.npz", extra=extra))))["video"]
    bf16 = np.load(generate.generate(generate.parse_args(
        _args(ckpt, "bf16.npz", extra=extra + ["--vae_dtype", "bfloat16"]))))["video"]
    psnr = 10 * np.log10(4.0 / np.mean((f32.astype(np.float64) - bf16) ** 2))  # range [-1, 1]
    assert bf16.dtype == np.float32 and not np.array_equal(f32, bf16) and psnr >= 30.0
    from wanq_tpu_torch.models import t5 as tt5

    calls = []

    def encode(ckpt_dir, cfg, prompts, negs, on_cpu=False, device="cuda"):
        calls.append((ckpt_dir, prompts, negs, on_cpu, device))
        return (np.zeros((1, cfg.text_len, cfg.text_dim), np.float32),) * 2

    monkeypatch.setattr(tt5, "encode_prompts", encode)
    args = generate.parse_args(COMMON + ["--ckpt_dir", str(ckpt / "ckpt"), "--t5_cpu",
                                         "--prompt", "a fox", "--neg_prompt", "blur",
                                         "--device", "cpu"])
    common.load_contexts(args, tiny_config())
    assert calls == [(str(ckpt / "ckpt"), ["a fox"], ["blur"], True, "cpu")]


@pytest.mark.parametrize("cli", [generate, fp_generate], ids=["generate", "fp_generate"])
@pytest.mark.parametrize("flags,item", [
    (["--task", "i2v-14B"], None),
    (["--sample_solver", "dpm++"], None),
    (["--t5_fsdp"], None),
    (["--use_prompt_extend", "--prompt", "a cat"], None),
], ids=["i2v", "dpm++", "t5_fsdp", "prompt_extend"])
def test_unported_options_raise_naming_their_item(cli, flags, item, tmp_path, monkeypatch):
    """What is not ported raises naming its ROADMAP item. i2v and DPM++
    (item 9) are ported: generate runs an i2v task (``tiny`` with
    model_type i2v standing in for i2v-14B, an image file written here,
    seeded random conditioning) and fp_generate refuses it, as wanq_tpu's
    text-to-video fp_generate cannot run it, naming cli.generate; both CLIs
    run DPM++. Prompt extension (item 11) is ported: both CLIs hand
    --prompt to the local expander (a stub here: no LM ships) on --device
    before the text states are made. --t5_fsdp (item 10) is ported: at world
    1 there is no mesh, and the latents equal the run without it."""
    import imageio

    from wanq_tpu_torch.utils import prompt_extend as tpe

    extended = []

    class Stub(tpe.PromptExpander):
        def extend(self, prompt, system_prompt, seed=-1, **kw):
            extended.append((prompt, seed))
            return tpe.PromptOutput(True, prompt + ", cinematic", seed, system_prompt)

    monkeypatch.setattr(tpe, "LocalPromptExpander",
                        lambda model_name=None, device="cuda": Stub())

    base = ["--task", "tiny", "--size", "64*64", "--random_init", "--device", "cpu",
            "--frame_num", "5", "--sample_steps", "2", "--save_file", str(tmp_path / "o.npz")]
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
            cli.generate(cli.parse_args(base + flags))
        return
    if flags[0] == "--task":
        cfg = tiny_config(name="i2v-14B", model_type="i2v", in_dim=36, clip_dim=32)
        monkeypatch.setitem(tconfigs.WAN_CONFIGS, "i2v-14B", cfg)
        monkeypatch.setitem(tconfigs.SUPPORTED_SIZES, "i2v-14B", ("64*64",))
        monkeypatch.setitem(tconfigs.MAX_AREA_CONFIGS, "64*64", 64 * 64)
        if cli is fp_generate:
            with pytest.raises(SystemExit, match="cli.generate --image"):
                cli.generate(cli.parse_args(base + flags))
            return
        imageio.imwrite(tmp_path / "in.png", np.full((64, 64, 3), 200, np.uint8))
        flags = flags + ["--image", str(tmp_path / "in.png")]
    args = cli.parse_args(base + flags)
    latents = np.load(cli.generate(args))["latents"]
    assert latents.shape == (1, 16, 2, 8, 8) and np.isfinite(latents).all()
    if "--t5_fsdp" in flags:
        plain = np.load(cli.generate(cli.parse_args(base)))["latents"]
        assert np.array_equal(latents, plain)
    if "--use_prompt_extend" in flags:
        assert extended == [("a cat", 42)] and args.prompt == "a cat, cinematic"


def test_without_imageio_the_npz_keeps_the_video(ckpt, monkeypatch, capsys):
    """Where imageio is missing (as on a machine without it), cache_video
    raises ImportError in both packages. The port's CLIs have saved the npz,
    'video' included, and log that no video file was written; wanq_tpu's
    generate would stop at that error instead."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(ImportError):
        jvideo.cache_video(np.zeros((3, 1, 4, 4), np.float32), str(ckpt / "x.mp4"))
    with pytest.raises(ImportError, match="imageio"):
        tvideo.cache_video(np.zeros((3, 1, 4, 4), np.float32), str(ckpt / "x.mp4"))
    out = generate.generate(generate.parse_args(
        _args(ckpt, "noio.npz", extra=["--device", "cpu", "--sample_steps", "1"])))
    assert np.load(out)["video"].shape == (1, 3, 5, 64, 64)
    assert not [f for f in os.listdir(ckpt) if f.startswith("noio.") and f != "noio.npz"]
    assert "no video file written" in capsys.readouterr().out


def test_missing_vae_file_saves_latents_only(ckpt, tmp_path, capsys):
    """A checkpoint dir without Wan2.1_VAE.pth: the latents alone, and a
    warning (wanq_tpu's FileNotFoundError -> warning)."""
    src = tmp_path / "novae"
    src.mkdir()
    for f in os.listdir(ckpt / "ckpt"):
        if not f.endswith(".pth"):
            os.symlink(ckpt / "ckpt" / f, src / f)
    args = fp_generate.parse_args(COMMON + [
        "--ckpt_dir", str(src), "--context_file", str(ckpt / "ctx1.npz"), "--device", "cpu",
        "--sample_steps", "1", "--save_file", str(tmp_path / "lat.npz")])
    assert sorted(np.load(fp_generate.generate(args)).files) == ["latents"]
    assert "VAE decode skipped" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the video writer
# ---------------------------------------------------------------------------


def test_to_uint8_equals_jax():
    v = np.random.default_rng(3).uniform(-1.3, 1.3, (3, 4, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(tvideo._to_uint8(v), jvideo._to_uint8(v))
    np.testing.assert_array_equal(tvideo._to_uint8(v, (0.0, 1.0)),
                                  jvideo._to_uint8(v, (0.0, 1.0)))


@pytest.mark.parametrize("channels", [3, 1])
def test_cache_video_gif_fallback_equals_jax(tmp_path, channels, caplog):
    """Without an mp4 backend imageio refuses libx264 and both packages
    write the same GIF frames instead."""
    import imageio

    v = np.random.default_rng(4).uniform(-1, 1, (1, channels, 5, 16, 16)).astype(np.float32)
    with caplog.at_level(logging.WARNING):
        got = tvideo.cache_video(v, str(tmp_path / "t.mp4"), fps=16)
        want = jvideo.cache_video(v, str(tmp_path / "j.mp4"), fps=16)
    if got.endswith(".mp4"):
        pytest.skip("this imageio has an mp4 backend: no GIF fallback to compare")
    assert got == str(tmp_path / "t.gif") and want == str(tmp_path / "j.gif")
    a, b = imageio.mimread(got), imageio.mimread(want)
    assert len(a) == len(b) == 5 and a[0].shape[:2] == (16, 16)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa, fb)
    with pytest.raises(ValueError, match="C in"):
        tvideo.cache_video(np.zeros((2, 5, 4, 4), np.float32), str(tmp_path / "bad.mp4"))


def test_cache_image_and_str2bool_equal_jax(tmp_path):
    import imageio

    img = np.random.default_rng(5).uniform(-1, 1, (1, 3, 8, 8)).astype(np.float32)
    tvideo.cache_image(img, str(tmp_path / "t.png"))
    jvideo.cache_image(img, str(tmp_path / "j.png"))
    np.testing.assert_array_equal(imageio.imread(tmp_path / "t.png"),
                                  imageio.imread(tmp_path / "j.png"))
    for v in (True, "yes", "T", "1", "n", "False", "0"):
        assert tvideo.str2bool(v) == jvideo.str2bool(v)
    with pytest.raises(ValueError):
        tvideo.str2bool("maybe")
