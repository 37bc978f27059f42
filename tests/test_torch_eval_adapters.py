"""The port's host-side evaluation and prompt modules against wanq_tpu's on
the CPU: the VBench and reward-model adapters (utils/vbench.py,
imagereward.py) and evaluate's four flags that drive them, the vision
helpers (utils/vision.py), the prompt expanders (utils/prompt_extend.py,
cli/common.py::maybe_extend_prompt) and the gradio demo's callback core
(cli/gradio_demo.py::DemoRuntime).

The exports are held to wanq_tpu's: the same file tree, the same JSON and
runner text (with the package's name and the output directory put back),
and equal decoded frames. gradio, dashscope and the expanders' model
weights are not installed: the expanders run on stubs (a stand-in
``transformers`` module, a stand-in ``dashscope``), the demo with a fake
umT5 encoder and VAE, and ``build_demo`` must refuse without gradio.
"""

import argparse
import dataclasses
import json
import logging
import os
import sys
import types

import imageio.v3 as iio
import numpy as np
import pytest
import torch

from wanq_tpu.cli import common as jcommon
from wanq_tpu.cli import evaluate as jeval
from wanq_tpu.utils import imagereward as jir
from wanq_tpu.utils import prompt_extend as jpe
from wanq_tpu.utils import vbench as jvb
from wanq_tpu.utils import vision as jvis
from wanq_tpu.utils import fvd as jfvd
from wanq_tpu.utils import image_metrics as jim
from wanq_tpu_torch import configs as tconfigs
from wanq_tpu_torch.cli import common as tcommon
from wanq_tpu_torch.cli import evaluate as teval
from wanq_tpu_torch.cli import gradio_demo
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.utils import fvd as tfvd
from wanq_tpu_torch.utils import imagereward as tir
from wanq_tpu_torch.utils import prompt_extend as tpe
from wanq_tpu_torch.utils import vbench as tvb
from wanq_tpu_torch.utils import vision as tvis


def _tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            out[os.path.relpath(path, root)] = path
    return out


def _same_text(jpath, tpath, jroot, troot):
    want = open(jpath).read().replace(os.path.abspath(jroot), "<OUT>")
    got = open(tpath).read().replace(os.path.abspath(troot), "<OUT>")
    assert got.replace("wanq_tpu_torch", "wanq_tpu") == want


def _same_exports(jroot, troot):
    jt, tt = _tree(jroot), _tree(troot)
    assert sorted(jt) == sorted(tt) and jt
    for rel in jt:
        if rel.endswith((".sh", ".txt")):
            _same_text(jt[rel], tt[rel], jroot, troot)
        elif rel.endswith(".json"):
            want = json.loads(open(jt[rel]).read().replace(os.path.abspath(jroot), "<OUT>")
                              .replace(jroot, "<OUT>"))
            got = json.loads(open(tt[rel]).read().replace(os.path.abspath(troot), "<OUT>")
                             .replace(troot, "<OUT>"))
            assert got == want
        else:  # decoded frames
            np.testing.assert_array_equal(iio.imread(tt[rel]), iio.imread(jt[rel]))


@pytest.mark.parametrize("layout,dims", [("NCTHW", None),
                                         ("NTHWC", ["scene", "background_consistency"])],
                         ids=["all_dimensions", "channels_last_subset"])
def test_export_vbench_matches(tmp_path, layout, dims):
    rng = np.random.default_rng(0)
    vids = rng.uniform(-1, 1, size=(2, 3, 4, 16, 16)).astype(np.float32)
    if layout == "NTHWC":
        vids = vids.transpose(0, 2, 3, 4, 1)
    prompts = ["a cat boxing", "a dog/surfing"]
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    jinfo = jvb.export_vbench(vids, prompts, j, fps=4, dimensions=dims)
    tinfo = tvb.export_vbench(vids, prompts, t, fps=4, dimensions=dims)
    assert os.path.relpath(tinfo, t) == os.path.relpath(jinfo, j)
    _same_exports(j, t)
    info = json.load(open(tinfo))
    assert info[1]["prompt_en"] == "a dog/surfing" and len(info[1]["video_list"]) == len(
        {tvb.DIMENSION_GROUPS[d] for d in (dims or tvb.DIMENSION_GROUPS)})


def test_export_vbench_refuses_bad_input(tmp_path):
    v = np.zeros((1, 3, 2, 8, 8), np.float32)
    with pytest.raises(ValueError, match="prompts for"):
        tvb.export_vbench(v, ["a", "b"], str(tmp_path))
    with pytest.raises(ValueError, match="unknown VBench dimensions"):
        tvb.export_vbench(v, ["a"], str(tmp_path), dimensions=["color"])
    with pytest.raises(ValueError, match="needs videos"):
        tvb.export_vbench(v[0], ["a"], str(tmp_path))


def test_ingest_vbench_results_matches(tmp_path):
    r1 = {"scene": [0.42, [{"video_path": "a.mp4", "video_results": 0.4}]],
          "background_consistency": [0.91, []]}
    r2 = {"subject_consistency": 0.88, "dynamic_degree": {"score": 0.3}}
    (tmp_path / "scene_eval_results.json").write_text(json.dumps(r1))
    (tmp_path / "subject_consistency_eval_results.json").write_text(json.dumps(r2))
    (tmp_path / "other.json").write_text("{}")
    for arg in (str(tmp_path), [str(tmp_path / "scene_eval_results.json")]):
        assert tvb.ingest_vbench_results(arg) == jvb.ingest_vbench_results(arg)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no \\*_eval_results.json"):
        tvb.ingest_vbench_results(str(tmp_path / "empty"))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_export_imagereward_matches(tmp_path, dtype):
    rng = np.random.default_rng(2)
    imgs = rng.uniform(-1, 1, size=(3, 16, 16, 3)).astype(np.float32)
    if dtype == "uint8":
        imgs = ((imgs + 1) * 127.5).astype(np.uint8)
    prompts = ["a red cube", "a blue\nsphere", " a green cone "]
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    assert jir.export_imagereward(imgs, prompts, j) == j
    assert tir.export_imagereward(imgs, prompts, t) == t
    _same_exports(j, t)
    with pytest.raises(ValueError, match="prompts for"):
        tir.export_imagereward(imgs, prompts[:2], t)


def test_ingest_imagereward_matches(tmp_path):
    path = tmp_path / "result-score.json"
    path.write_text(json.dumps({"0": 1.2, "1": -0.4, "2": 0.1}))
    assert tir.ingest_imagereward(str(path)) == jir.ingest_imagereward(str(path))
    path.write_text("{}")
    with pytest.raises(ValueError, match="no scores"):
        tir.ingest_imagereward(str(path))


@pytest.fixture
def same_nets(monkeypatch):
    def weights(ndim, feat_dim, seed):
        net = (jfvd.I3DLikeFeatures if ndim == 3 else jim.InceptionLikeFeatures)(feat_dim, seed)
        return [np.asarray(k) for k in net.kernels], np.asarray(net.head)

    monkeypatch.setattr(tfvd, "random_conv_weights", weights)


@pytest.mark.parametrize("kind", ["videos", "images"])
def test_evaluate_export_and_ingest_flags_match(tmp_path, kind, same_nets, capsys):
    """--vbench_out (with --prompts) on videos, --imagereward_out on images,
    --vbench_results and --imagereward_results on both: the same report and
    the same exported trees as wanq_tpu's evaluate."""
    rng = np.random.default_rng(3)
    shape = (2, 3, 16, 16, 3) if kind == "videos" else (2, 16, 16, 3)
    fp = rng.uniform(-1, 1, shape).astype(np.float32)
    q = (fp + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    np.savez(tmp_path / "fp.npz", **{kind: fp})
    np.savez(tmp_path / "q.npz", **{kind: q})
    (tmp_path / "prompts.txt").write_text("a cat\n\nan owl\n")
    (tmp_path / "scene_eval_results.json").write_text(
        json.dumps({"scene": [0.5, []], "vbench_custom": 0.25}))
    (tmp_path / "result-score.json").write_text(json.dumps({"0": 2.0, "1": 1.0}))
    reports = {}
    for name, main in (("j", jeval.main), ("t", teval.main)):
        out = str(tmp_path / name)
        flags = ["--fp", str(tmp_path / "fp.npz"), "--quant", str(tmp_path / "q.npz"),
                 "--prompts", str(tmp_path / "prompts.txt"), "--fps", "8",
                 "--vbench_results", str(tmp_path / "scene_eval_results.json"),
                 "--imagereward_results", str(tmp_path / "result-score.json")]
        flags += ["--vbench_out" if kind == "videos" else "--imagereward_out", out]
        reports[name] = main(flags + (["--device", "cpu"] if name == "t" else []))
    assert set(reports["t"]) == set(reports["j"])
    for k, want in reports["j"].items():
        assert abs(reports["t"][k] - float(want)) <= 1e-4 * max(abs(float(want)), 1e-12), k
    assert reports["t"]["vbench_scene"] == 0.5 and reports["t"]["vbench_custom"] == 0.25
    assert reports["t"]["reward_mean"] == 1.5
    assert reports["t"]["vbench_export" if kind == "videos" else "imagereward_export"] == 1.0
    _same_exports(str(tmp_path / "j"), str(tmp_path / "t"))
    out = capsys.readouterr().out
    assert ("VBench layout written" if kind == "videos" else "reward-scoring layout") in out


def test_evaluate_export_flags_refuse_the_wrong_kind(tmp_path):
    v = np.zeros((1, 3, 8, 8, 3), np.float32)
    np.savez(tmp_path / "v.npz", videos=v)
    np.savez(tmp_path / "i.npz", images=v[:, 0])
    base = ["--device", "cpu"]
    with pytest.raises(SystemExit, match="--vbench_out needs videos"):
        teval.main(base + ["--fp", str(tmp_path / "i.npz"), "--quant", str(tmp_path / "i.npz"),
                           "--vbench_out", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="--imagereward_out needs t2i images"):
        teval.main(base + ["--fp", str(tmp_path / "v.npz"), "--quant", str(tmp_path / "v.npz"),
                           "--imagereward_out", str(tmp_path / "o")])
    (tmp_path / "p.txt").write_text("a\nb\n")
    with pytest.raises(SystemExit, match="2 prompts for 1 videos"):
        teval.main(base + ["--fp", str(tmp_path / "v.npz"), "--quant", str(tmp_path / "v.npz"),
                           "--vbench_out", str(tmp_path / "o"), "--prompts",
                           str(tmp_path / "p.txt")])


# ---------------------------------------------------------------------------
# vision.py
# ---------------------------------------------------------------------------


def test_smart_resize_and_nframes_match():
    for h, w in [(480, 832), (720, 1280), (28, 28), (1000, 3000), (37, 53), (8000, 8000),
                 (10, 12), (4, 700)]:
        for kw in ({}, {"min_pixels": 128 * 28 * 28, "max_pixels": 768 * 28 * 28},
                   {"factor": 14}):
            assert tvis.smart_resize(h, w, **kw) == jvis.smart_resize(h, w, **kw)
    for bad in ((10, 10000), (3000, 1)):
        for mod in (jvis, tvis):
            with pytest.raises(ValueError, match="aspect"):
                mod.smart_resize(*bad)
    for ele, total, fps in [({"nframes": 17}, 100, 30), ({"fps": 2.0}, 300, 30), ({}, 81, 16),
                            ({"min_frames": 6, "max_frames": 20}, 400, 24), ({}, 5, 16)]:
        assert tvis.smart_nframes(ele, total, fps) == jvis.smart_nframes(ele, total, fps)
    for ele, total in (({"nframes": 10, "fps": 1.0}, 100), ({"nframes": 1}, 100),
                       ({"nframes": 5}, 3)):
        for mod in (jvis, tvis):
            with pytest.raises(ValueError):
                mod.smart_nframes(ele, total, 30)


def test_fetch_image_and_video_match(tmp_path):
    import base64
    import io

    from PIL import Image

    img = np.random.default_rng(0).uniform(0, 255, (100, 160, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    uri = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    cases = [{"image": img}, {"image": Image.fromarray(img)}, {"image": str(tmp_path / "a.png")},
             {"image_url": "file://" + str(tmp_path / "a.png")}, {"image": uri},
             {"image": img, "resized_height": 56, "resized_width": 84},
             {"image": img, "min_pixels": 200 * 28 * 28}, img]
    for ele in cases:
        np.testing.assert_array_equal(np.asarray(tvis.fetch_image(ele)),
                                      np.asarray(jvis.fetch_image(ele)))
    for bad in ("https://example.invalid/x.png", 3):
        for mod in (jvis, tvis):
            with pytest.raises(ValueError):
                mod.fetch_image({"image": bad})
    frames = [img[:56, :56] for _ in range(3)]
    np.testing.assert_array_equal(tvis.fetch_video({"video": frames}),
                                  jvis.fetch_video({"video": frames}))
    clip = np.stack([np.roll(img, 5 * i, axis=1) for i in range(12)])
    iio.imwrite(tmp_path / "v.gif", clip)
    ele = {"video": str(tmp_path / "v.gif"), "nframes": 6}
    got, want = tvis.fetch_video(ele), jvis.fetch_video(ele)
    assert got.shape[0] == 6
    np.testing.assert_array_equal(got, want)


def test_process_vision_info_matches():
    img = np.zeros((56, 84, 3), np.uint8)
    messages = [
        {"role": "system", "content": "sys"},
        {"role": "user", "content": [{"type": "image", "image": img},
                                     {"type": "text", "text": "hi"},
                                     {"video": [img, img]}]},
    ]
    assert tvis.extract_vision_info(messages) == jvis.extract_vision_info(messages)
    assert len(tvis.extract_vision_info([messages, messages])) == 4
    ti, tv = tvis.process_vision_info(messages)
    ji, jv = jvis.process_vision_info(messages)
    assert [im.size for im in ti] == [im.size for im in ji]
    np.testing.assert_array_equal(tv[0], jv[0])
    assert tvis.process_vision_info([{"role": "user", "content": "text"}]) == (None, None)
    with pytest.raises(ValueError, match="neither image nor video"):
        tvis.process_vision_info([{"role": "user", "content": [{"type": "video"}]}])


# ---------------------------------------------------------------------------
# prompt_extend.py and maybe_extend_prompt
# ---------------------------------------------------------------------------


def test_identity_expander_and_system_prompts_match():
    for mod in (jpe, tpe):
        out = mod.IdentityPromptExpander()("a cat", tar_lang="zh", seed=4)
        assert out.status and out.prompt == "a cat" and out.seed == 4
    for lang in ("en", "zh"):
        for vl in (False, True):
            assert (tpe.PromptExpander(is_vl=vl).decide_system_prompt(lang)
                    == jpe.PromptExpander(is_vl=vl).decide_system_prompt(lang))
    with pytest.raises(NotImplementedError):
        tpe.PromptExpander().extend("x", "sys")


class _Batch(dict):
    def __init__(self, n, log):
        super().__init__(input_ids=torch.ones((1, n), dtype=torch.long))
        self.log = log

    def __getattr__(self, k):
        return self[k]

    def to(self, device):
        self.log.append(("inputs_to", str(device)))
        return self


def _stub_transformers(log):
    """A stand-in ``transformers``: a tokenizer / processor that logs the
    chat, a model that appends three tokens, a decoder that names them."""

    class Tok:
        @classmethod
        def from_pretrained(cls, name):
            log.append(("tokenizer", name))
            return cls()

        def apply_chat_template(self, messages, tokenize, add_generation_prompt):
            log.append(("chat", [m["role"] for m in messages]))
            return "TEXT"

        def __call__(self, texts=None, text=None, images=None, videos=None,
                     return_tensors=None):
            if images is not None:
                log.append(("images", [im.size for im in images]))
            return _Batch(4, log)

        def batch_decode(self, out, skip_special_tokens):
            return [f"extended:{out.shape[1]}"]

    class Model:
        @classmethod
        def from_pretrained(cls, name, **kw):
            log.append(("model", name, kw))
            return cls()

        def to(self, device):
            log.append(("model_to", str(device)))
            return self

        def generate(self, input_ids, max_new_tokens):
            return torch.cat([input_ids, torch.zeros((1, 3), dtype=torch.long)], dim=1)

    return types.SimpleNamespace(AutoTokenizer=Tok, AutoProcessor=Tok,
                                 AutoModelForCausalLM=Model, AutoModelForVision2Seq=Model)


def test_local_expanders_run_on_a_stub_transformers(monkeypatch):
    log = []
    monkeypatch.setitem(sys.modules, "transformers", _stub_transformers(log))
    exp = tpe.LocalPromptExpander(model_name="m", device="cpu", torch_dtype="x")
    out = exp("a cat", tar_lang="en", seed=3)
    assert (out.status, out.prompt, out.seed) == (True, "extended:3", 3)
    assert out.system_prompt == tpe.LM_EN_SYS_PROMPT
    assert ("model", "m", {"torch_dtype": "x"}) in log and ("model_to", "cpu") in log
    assert ("inputs_to", "cpu") in log and ("chat", ["system", "user"]) in log
    log.clear()
    vl = tpe.LocalVLPromptExpander(model_name="vl", device="cpu")
    out = vl("a dog", image=np.zeros((56, 84, 3), np.uint8), tar_lang="zh")
    assert out.prompt == "extended:3" and out.system_prompt == tpe.VL_ZH_SYS_PROMPT
    assert ("images", [(84, 56)]) in log and ("inputs_to", "cpu") in log
    # wanq_tpu's expander on the same stub gives the same output
    jout = jpe.LocalPromptExpander(model_name="m")("a cat", tar_lang="en", seed=3)
    tout = tpe.LocalPromptExpander(model_name="m", device="cpu")("a cat", seed=3)
    assert dataclasses.astuple(jout) == dataclasses.astuple(tout)


def test_expanders_without_their_packages_raise_as_wanq_tpu(monkeypatch):
    monkeypatch.setitem(sys.modules, "dashscope", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    for name in ("DashScopePromptExpander", "LocalPromptExpander"):
        with pytest.raises(ImportError) as want:
            getattr(jpe, name)()
        with pytest.raises(ImportError) as got:
            getattr(tpe, name)()
        assert str(got.value) == str(want.value)
    with pytest.raises(ImportError, match="needs the 'dashscope' package"):
        tpe.DashScopePromptExpander()


def test_dashscope_expander_on_a_stub(monkeypatch):
    calls = []

    def call(model, messages, seed, result_format):
        calls.append((model, seed, messages[0]["role"]))
        if len(calls) < 3:
            return types.SimpleNamespace(status_code=500, __str__=lambda s: "busy")
        msg = types.SimpleNamespace(content="rich prompt")
        return types.SimpleNamespace(
            status_code=200,
            output=types.SimpleNamespace(choices=[types.SimpleNamespace(message=msg)]))

    stub = types.SimpleNamespace(Generation=types.SimpleNamespace(call=call), api_key=None)
    monkeypatch.setitem(sys.modules, "dashscope", stub)
    out = tpe.DashScopePromptExpander(api_key="k")("a cat", seed=-1)
    assert (out.status, out.prompt) == (True, "rich prompt") and stub.api_key == "k"
    assert calls[0] == ("qwen-plus", 0, "system") and len(calls) == 3
    calls.clear()
    out = tpe.DashScopePromptExpander(retry_times=2)("a cat")
    assert not out.status and out.prompt == "a cat" and len(calls) == 2


@pytest.mark.parametrize("outcome", ["extended", "failed", "off"])
def test_maybe_extend_prompt_matches(outcome, monkeypatch, caplog):
    made = []

    def expander(mod):
        class Fake(mod.PromptExpander):
            def extend(self, prompt, system_prompt, seed=-1, **kw):
                if outcome == "failed":
                    return mod.PromptOutput(False, prompt, seed, system_prompt, message="down")
                return mod.PromptOutput(True, prompt + ", cinematic", seed, system_prompt)

        def make(model_name=None, **kw):
            made.append((mod.__name__, model_name, kw))
            return Fake()
        return make

    for mod in (jpe, tpe):
        monkeypatch.setattr(mod, "LocalPromptExpander", expander(mod))
    flags = ["--prompt", "a cat", "--random_init"]
    if outcome != "off":
        flags.append("--use_prompt_extend")
    results = []
    for common in (jcommon, tcommon):
        args = common.add_common_args(argparse.ArgumentParser()).parse_args(
            flags + (["--device", "cpu"] if common is tcommon else []))
        with caplog.at_level(logging.INFO):
            results.append((common.maybe_extend_prompt(args, logging.getLogger()), args.prompt))
    assert results[0] == results[1]
    want = "a cat, cinematic" if outcome == "extended" else "a cat"
    assert results[1] == (want, want)
    if outcome == "failed":
        assert "prompt extension failed: down; using the original" in caplog.text
    if outcome != "off":
        assert made[-1] == ("wanq_tpu_torch.utils.prompt_extend", "Qwen/Qwen2.5-3B-Instruct",
                            {"device": "cpu"})


def test_load_contexts_reads_only_the_flags_it_is_given():
    """Callers such as chip_smoke.py pass load_contexts a bare Namespace
    (seed, device, context file): without --use_prompt_extend it reads no
    prompt, and draws wanq_tpu's random states."""
    bare = argparse.Namespace(base_seed=5, device="cpu", context_file=None)
    got = tcommon.load_contexts(bare, tiny_config())
    want = jcommon.load_contexts(argparse.Namespace(base_seed=5, context_file=None,
                                                    ckpt_dir=None, prompt="x"), tiny_config())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# gradio_demo.py
# ---------------------------------------------------------------------------

DEMO = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--random_init",
        "--sample_steps", "1", "--base_seed", "7", "--device", "cpu"]


class _FakeEncoder:
    """Stands in for T5EncoderModel (no umT5 checkpoint ships)."""

    def __init__(self, text_len, text_dim):
        self.text_len, self.text_dim = text_len, text_dim
        self.calls = []

    def __call__(self, prompts):
        self.calls.append(list(prompts))
        rng = np.random.default_rng(len(self.calls))
        return rng.normal(size=(len(prompts), self.text_len, self.text_dim)).astype(np.float32)


class _FakeVAE:
    """Latents [B, C, F, h, w] -> a random [B, 3, F, 8h, 8w] video."""

    def decode(self, latents):
        b, _, f, h, w = latents.shape
        rng = np.random.default_rng(0)
        return torch.from_numpy(rng.uniform(-1, 1, (b, 3, f, h * 8, w * 8)).astype(np.float32))


@pytest.fixture
def runtime():
    rt = gradio_demo.DemoRuntime(gradio_demo.parse_args(DEMO))
    rt.encoder = _FakeEncoder(rt.cfg.text_len, rt.cfg.text_dim)
    rt.vae = _FakeVAE()
    return rt


def test_demo_t2v_callback(runtime, tmp_path):
    out = str(tmp_path / "out.mp4")
    path, img, final = runtime.run("a cat", None, steps=1, guide_scale=5.0, shift=5.0, seed=11,
                                   extend=True, out_path=out)
    assert img is None and final == "a cat"  # the identity expander
    assert path in (out, out.replace(".mp4", ".gif")) and os.path.getsize(path) > 0
    assert runtime.encoder.calls == [["a cat"], [runtime.args.neg_prompt]]
    assert iio.imread(path).shape[1:3] == (64, 64)


def test_demo_t2i_branch_returns_an_image(runtime):
    runtime.is_t2i = True
    path, img, _ = runtime.run("a dog", None, steps=1, guide_scale=5.0, shift=5.0, seed=3,
                               extend=False)
    assert path is None and img.dtype == np.uint8 and img.shape == (64, 64, 3)


def test_demo_extends_with_the_chosen_expander(monkeypatch, tmp_path):
    class Upper(tpe.PromptExpander):
        def extend(self, prompt, system_prompt, seed=-1, **kw):
            return tpe.PromptOutput(True, prompt.upper(), seed, system_prompt)

    made = []
    monkeypatch.setattr(tpe, "LocalPromptExpander", lambda **kw: made.append(kw) or Upper())
    rt = gradio_demo.DemoRuntime(gradio_demo.parse_args(DEMO + ["--prompt_extend", "local"]))
    rt.encoder, rt.vae = _FakeEncoder(rt.cfg.text_len, rt.cfg.text_dim), _FakeVAE()
    _, _, final = rt.run("a fox", None, 1, 5.0, 5.0, 0, True, out_path=str(tmp_path / "o.mp4"))
    assert final == "A FOX" and made == [{"device": "cpu"}]
    assert rt.encoder.calls[0] == ["A FOX"]


def test_demo_error_paths(monkeypatch):
    class Boom(Exception):
        pass

    rt = gradio_demo.DemoRuntime(gradio_demo.parse_args(DEMO))  # no --ckpt_dir
    with pytest.raises(Boom, match="ckpt_dir"):
        rt.run("x", None, 1, 5.0, 5.0, 0, False, error_cls=Boom)
    cfg = tiny_config(name="i2v-14B", model_type="i2v", in_dim=36, clip_dim=32)
    monkeypatch.setitem(tconfigs.WAN_CONFIGS, "i2v-14B", cfg)
    args = gradio_demo.parse_args(["--task", "i2v-14B"] + DEMO[2:])
    rt = gradio_demo.DemoRuntime(args)
    assert rt.is_i2v and type(rt.pipe).__name__ == "WanI2V"
    rt.encoder = _FakeEncoder(cfg.text_len, cfg.text_dim)
    with pytest.raises(Boom, match="i2v needs an input image"):
        rt.run("x", None, 1, 5.0, 5.0, 0, False, error_cls=Boom)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        gradio_demo.DemoRuntime(gradio_demo.parse_args(DEMO[:-2]))


def test_build_demo_refuses_without_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(SystemExit, match="gradio is not installed"):
        gradio_demo.build_demo(gradio_demo.parse_args(DEMO))
