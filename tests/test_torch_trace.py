"""The port's trace spans (``wanq_tpu_torch/utils/trace.py``) on the CPU.

``WanT2V.generate`` / ``WanI2V.generate`` run the tiny DiT under
``torch.profiler.profile(activities=[CPU])``; the recorded ranges are read
back as a tree (each span under its nearest enclosing span) and held to the
shape a step has: one ``pipe.step`` a solver step, as many ``dit.forward``
under it as the step ran forwards (batched CFG 1, sequential 2, a cached
``cond`` step 1, ``reuse`` 0), ``num_layers`` ``dit.block`` a forward, and
``dit.self_attn``, ``dit.cross_attn``, ``dit.ffn`` in that order in each
block. The spans change no arithmetic: latents (FP and W8A8 on the fused
routes) and training gradients are equal bit for bit with and without a
profiler. Without one, ``span`` is the one shared no-op. Every ``span(...)``
call in the package names a constant of ``trace.py``, and each constant is
used."""

import ast
import contextlib
import os
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.pipelines import image2video as ti2v
from wanq_tpu_torch.pipelines import text2video as tt2v
from wanq_tpu_torch.quant import QuantConfig
from wanq_tpu_torch.quant.ptq import prepare_quant_state
from wanq_tpu_torch.quant.qlinear import QuantCtx
from wanq_tpu_torch.utils import trace

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "wanq_tpu_torch"
GEN_KW = dict(size=(64, 64), frame_num=5, sampling_steps=3, guide_scale=2.0)
# head dim 128: the int8 routes take the fused producers (K1, K3, K2's mode)
SMALL = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
             freq_dim=64, param_dtype="bfloat16", residual_dtype="bfloat16")
SUBLAYERS = [trace.SELF_ATTN, trace.CROSS_ATTN, trace.FFN]


def _model(**kw):
    cfg = tiny_config(**kw)
    params = tdit.init_params(cfg, 0, device="cpu")
    params["head"]["head"]["w"] = torch.from_numpy(
        (np.random.default_rng(123).normal(size=(cfg.dim, 64)) * 0.02).astype(np.float32)
    ).to(cfg.dtype)
    rng = np.random.default_rng(1)
    c, cn = (torch.from_numpy(rng.normal(size=(1, cfg.text_len, cfg.text_dim)).astype(np.float32))
             for _ in range(2))
    shape = tt2v.compute_target_shape(cfg, GEN_KW["size"], GEN_KW["frame_num"])
    noise = torch.from_numpy(rng.normal(size=(1, *shape)).astype(np.float32))
    return cfg, params, c, cn, noise


def _w8a8_ctx(cfg, params, c):
    """An int8 ctx under the W8A8 speed YAML, calibrated on one forward."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 16, 2, 8, 8)).astype(np.float32))
    cc = QuantCtx(mode="calib", collect_minmax=True)
    tdit.dit_forward(params, cfg, x, torch.tensor([999.0, 500.0]), torch.cat([c, c]), 32,
                     ctx=cc)
    calib = {k: v.float().numpy()[None] for k, v in cc.collect.items()}
    qcfg = QuantConfig.from_yaml(str(ROOT / "quant_configs" / "wan_w8a8_speed.yaml"))
    pol, st, rot = prepare_quant_state(params, tdit.linear_layer_names(cfg), qcfg, calib=calib,
                                       targets="int8")
    return QuantCtx(mode="int8", policies=pol, state=st, rotations=rot)


def _profiled(fn):
    """fn()'s result and the profile recorded around it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _tree(prof):
    """The recorded spans as nested lists: each entry (name, children), the
    roots in start order, each span under its nearest enclosing span."""
    spans = sorted((e for e in prof.events() if e.name in trace.SPAN_NAMES),
                   key=lambda e: (e.time_range.start, -e.time_range.end))
    nodes = {id(e): (e.name, []) for e in spans}
    roots = []
    for e in spans:
        p = e.cpu_parent
        while p is not None and p.name not in trace.SPAN_NAMES:
            p = p.cpu_parent
        (nodes[id(p)][1] if p is not None else roots).append(nodes[id(e)])
    return roots


def _step_shape(step):
    """A pipe.step node as [[sub-layer names of each block] of each forward]."""
    name, forwards = step
    assert name == trace.PIPE_STEP
    out = []
    for fname, blocks in forwards:
        assert fname == trace.DIT_FORWARD
        assert all(bname == trace.DIT_BLOCK for bname, _ in blocks)
        assert not any(grand for _, subs in blocks for _, grand in subs)
        out.append([[sub for sub, _ in subs] for _, subs in blocks])
    return out


def _forward(cfg, n):
    return [[SUBLAYERS] * cfg.num_layers] * n


@pytest.mark.parametrize("cfg_mode, forwards", [("batched", 1), ("sequential", 2)])
def test_each_step_nests_its_forwards_blocks_and_sublayers(cfg_mode, forwards):
    cfg, params, c, cn, noise = _model()
    pipe = tt2v.WanT2V(cfg, params, device="cpu")
    _, prof = _profiled(lambda: pipe.generate(c, cn, noise=noise, cfg_mode=cfg_mode, **GEN_KW))
    roots = _tree(prof)
    assert len(roots) == GEN_KW["sampling_steps"]
    assert [_step_shape(s) for s in roots] == [_forward(cfg, forwards)] * len(roots)


@pytest.mark.parametrize("cfg_mode, full", [("batched", 1), ("sequential", 2)])
def test_a_cached_step_holds_the_forwards_its_action_ran(cfg_mode, full):
    cfg, params, c, cn, noise = _model()
    pipe = tt2v.WanT2V(cfg, params, device="cpu")
    policy = tt2v.StepCachePolicy(cfg_interval=2, reuse_interval=2, warmup=1, tail=1)
    kw = {**GEN_KW, "sampling_steps": 8}
    _, prof = _profiled(lambda: pipe.generate(c, cn, noise=noise, cfg_mode=cfg_mode,
                                              cache_policy=policy, **kw))
    actions = policy.plan(kw["sampling_steps"])
    assert {"full", "cond", "reuse"} <= set(actions)
    per_action = {"full": full, "cond": 1, "reuse": 0}
    assert [_step_shape(s) for s in _tree(prof)] == [_forward(cfg, per_action[a])
                                                     for a in actions]


def test_the_image_to_video_loop_has_the_same_spans():
    cfg = tiny_config(model_type="i2v", in_dim=36, clip_dim=32)
    params = tdit.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(11)
    img = torch.from_numpy(rng.uniform(-1, 1, size=(3, 32, 32)).astype(np.float32))
    c, cn = (torch.from_numpy(rng.normal(size=(1, cfg.text_len, cfg.text_dim)).astype(
        np.float32)) for _ in range(2))
    lat_h, lat_w = ti2v.i2v_latent_size(cfg, (32, 32), 32 * 32)
    clip_fea = torch.from_numpy(rng.normal(size=(1, 257, cfg.clip_dim)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(20, 2, lat_h, lat_w)).astype(np.float32))
    pipe = ti2v.WanI2V(cfg, params, device="cpu")
    _, prof = _profiled(lambda: pipe.generate(img, c, cn, max_area=32 * 32, frame_num=5,
                                              sampling_steps=2, clip_fea=clip_fea, y=y,
                                              seed=3))
    assert [_step_shape(s) for s in _tree(prof)] == [_forward(cfg, 1)] * 2


@pytest.mark.parametrize("route", ["fp", "w8a8"])
def test_latents_are_the_same_bits_with_a_profiler_running(route):
    cfg, params, c, cn, noise = _model(**SMALL) if route == "w8a8" else _model()
    ctx = _w8a8_ctx(cfg, params, c) if route == "w8a8" else None
    pipe = tt2v.WanT2V(cfg, params, quant_ctx=ctx, device="cpu")
    plain = pipe.generate(c, cn, noise=noise, **GEN_KW)
    traced, prof = _profiled(lambda: pipe.generate(c, cn, noise=noise, **GEN_KW))
    assert torch.equal(plain, traced)
    assert [_step_shape(s) for s in _tree(prof)] == [_forward(cfg, 1)] * GEN_KW["sampling_steps"]


def test_training_gradients_are_the_same_bits_with_a_profiler_running():
    """Remat's recompute enters the block spans again in the backward; the
    gradients do not move."""
    cfg, params, c, _, _ = _model()
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(1, 16, 2, 8, 8)).astype(np.float32))
    leaf = params["blocks"][0]["self_attn"]["q"]["w"]

    def grad():
        w = leaf.detach().clone().requires_grad_(True)
        params["blocks"][0]["self_attn"]["q"]["w"] = w
        out = tdit.dit_forward(params, cfg, x, torch.tensor([500.0]), c, 32, remat=True,
                               training=True)
        out.square().mean().backward()
        return w.grad

    try:
        plain = grad()
        traced, prof = _profiled(grad)
    finally:
        params["blocks"][0]["self_attn"]["q"]["w"] = leaf
    assert torch.equal(plain, traced)
    names = [e.name for e in prof.events() if e.name in trace.SPAN_NAMES]
    # each block once in the forward and once in remat's recompute
    assert names.count(trace.DIT_BLOCK) == 2 * cfg.num_layers
    assert names.count(trace.DIT_FORWARD) == 1


def test_span_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    off = [trace.span(name) for name in trace.SPAN_NAMES]
    assert all(s is off[0] for s in off)
    assert isinstance(off[0], contextlib.nullcontext)
    with off[0] as entered:
        assert entered is None
    # with a profiler running the same call records a range
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = trace.span(trace.DIT_BLOCK)
        with on:
            torch.ones(4).sum()
    assert on is not off[0]
    assert [e.name for e in prof.events()].count(trace.DIT_BLOCK) == 1


def test_every_span_in_the_package_names_a_constant_of_trace_py():
    """Each ``span(...)`` call passes one of ``trace.py``'s constants (by
    name, imported from it), and every constant is used, so a trace reader
    can rely on the list."""
    constants = {k: v for k, v in vars(trace).items() if isinstance(v, str) and v in
                 trace.SPAN_NAMES}
    assert sorted(constants.values()) == sorted(trace.SPAN_NAMES)
    assert len(set(trace.SPAN_NAMES)) == 6
    used = []
    for path in PACKAGE.rglob("*.py"):
        if path.name == "trace.py":
            continue
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span":
                where = f"{os.path.relpath(path, ROOT)}:{node.lineno}"
                assert len(node.args) == 1 and isinstance(node.args[0], ast.Name), where
                assert node.args[0].id in constants, where
                used.append(node.args[0].id)
    assert set(used) == set(constants)


def test_chip_smoke_counts_no_span_annotation_as_device_work():
    """``chip_smoke.py``'s profile readers (a CFG forward, the QLoRA step)
    take their kernels from ``device_ops``: the device-side annotations of
    the spans, which cover whole forwards, are left out; kernels are kept,
    with or without the ``is_user_annotation`` attribute."""
    import sys
    import types

    from torch.autograd import DeviceType

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))

    def event(name, device, **kw):
        return types.SimpleNamespace(name=name, device_type=device, **kw)

    kernels = [event("flash_fwd_kernel", DeviceType.CUDA, is_user_annotation=False),
               event("vectorized_elementwise_kernel", DeviceType.CUDA)]
    events = [event(name, DeviceType.CUDA, is_user_annotation=True) for name in trace.SPAN_NAMES]
    events += [event(trace.DIT_FORWARD, DeviceType.CPU), kernels[0],
               event("aten::add", DeviceType.CPU), kernels[1]]
    assert chip_smoke.device_ops(events) == kernels
