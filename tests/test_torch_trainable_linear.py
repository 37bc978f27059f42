"""The trainable quantized linear of the port (QuantCtx.trainable, the QLoRA /
QAT route of ``quant/qlinear.py``) on the CPU: the straight-through
fake-quant Function (``quant/quantizers.py::fake_quant_ste``), the dequant
product and the LoRA product against the autograd chain they replaced, which
this file keeps as the reference (``_chain_qlinear``).

- W4 and W8 codes; dynamic per-token and static (``delta_a``) activations;
  with and without a SmoothQuant mask; bf16 and f32 inputs.
- Planted rows: a tied absmax (the gradient through ``torch.amax`` shared
  between them), values exactly on the codes -128 / 127 and past them (the
  clamp's maximum-then-minimum halves the gradient at a bound), a row under
  the delta eps (no gradient through it).
- The forward gives the chain's bits; the gradients to x, to the adapters
  and to a static ``delta_a`` are within rel 1e-6 of the chain's.
- The route keeps no f32 copy of its input (its saved tensors) and makes no
  f32 weight.
- A whole 2-block trainable forward and backward (remat, adapters b != 0)
  against wanq_tpu's within tests/test_torch_distill.py's QLoRA tolerances
  (the loss within rel 1e-4, the adapters' gradients within rel-L2 5e-4).
The same checks at the card's shapes are in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.models import dit as jdit
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu.quant.ptq import prepare_quant_state as jax_prepare
from wanq_tpu.quant.ptq import strip_quantized_weights as jstrip
from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
from wanq_tpu.training import lora as jlora
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import quant_state_from_numpy
from wanq_tpu_torch.quant import QuantConfig
from wanq_tpu_torch.quant.ptq import prepare_quant_state, strip_quantized_weights
from wanq_tpu_torch.quant.qlinear import QuantCtx, fp_linear, qlinear
from wanq_tpu_torch.quant.quantizers import (
    compute_quant_params,
    fake_quant,
    fake_quant_ste,
    unpack_int4,
)
from wanq_tpu_torch.training import lora as tlora

C_IN, C_OUT, ROWS = 128, 48, 40


def _chain_linear(policy, st, bias, x):
    """The trainable route as an autograd chain (the port before the
    Function): f32 fake-quant, f32 dequant, fp_linear."""
    b, n, c = x.shape
    xf = x.float()
    if not policy.act.dynamic:
        xq = fake_quant(xf, st["delta_a"], st["zp_a"], 8, True)
    else:
        d_a, zp_a = compute_quant_params(xf.reshape(b * n, c), 8, True)
        xq = fake_quant(xf.reshape(b * n, c), d_a, zp_a, 8, True).reshape(b, n, c)
    codes = unpack_int4(st["w_int4"]) if "w_int4" in st else st["w_int8"]
    w_deq = (codes.float() + st["zp_w_int"][:, None]) * st["scale_w"][:, None]
    return fp_linear({"w": w_deq.t(), "b": bias}, xq)


def _chain_qlinear(ctx, name, params, x):
    policy, st = ctx.policy(name), ctx.state[name]
    xt = x.float() * st["channel_mask"] if policy.uses_channel_mask else x
    y = _chain_linear(policy, st, params.get("b"), xt)
    return y + (x.float() @ st["lora_a"].float()) @ st["lora_b"].float()


def _planted_x(dtype, static):
    """[1, ROWS, C_IN]: Gaussian rows, and rows 0-3 planted. With a static
    delta_a of 0.125: codes exactly -128 and 127 and past both; dynamically:
    a tied absmax, an absmax of 127 / 8 (delta 1/8, codes exactly +-127),
    a row under the eps, a row of .5 ties of the rounding."""
    g = np.random.default_rng(5)
    x = g.normal(size=(ROWS, C_IN)).astype(np.float32)
    if static:
        x[0, :4] = [-16.0, 15.875, -17.0, 20.0]
        x[1, :2] = [-16.0, 15.875]
    else:
        x[0, 3], x[0, 7] = 5.0, -5.0
        x[1, 10], x[1, 11] = 15.875, -15.875
        x[2] = 1e-8
        x[3, :8] = np.arange(8) * 0.25 + 0.125
        x[3, 8] = 127 / 32
    return torch.from_numpy(x).to(dtype)[None]


def _layer(bits, static, mask):
    """(ctx, params) of one trainable layer 'lin' with an adapter (b != 0)."""
    g = np.random.default_rng(bits + 2 * static + 4 * mask)
    w = torch.from_numpy(g.normal(size=(C_IN, C_OUT)).astype(np.float32) * 0.05)
    bias = torch.from_numpy(g.normal(size=(C_OUT,)).astype(np.float32) * 0.1)
    qd = {"weight": {"n_bits": bits, "sym": False}, "act": {"n_bits": 8, "sym": True}}
    if static:
        qd["act"]["static_regex"] = "lin"
    if mask:
        qd["smooth_quant"] = {"layer_name_regex": "lin", "alpha": 0.5}
    calib = {"lin": np.abs(g.normal(size=(1, C_IN))).astype(np.float32) * 4 + 0.5,
             "lin.act_max": np.asarray([[8.0]], np.float32),
             "lin.act_min": np.asarray([[-8.0]], np.float32)}
    pol, st, rot = prepare_quant_state({"lin": {"w": w, "b": bias}}, ["lin"],
                                       QuantConfig.from_dict(qd), calib=calib, targets="int8")
    st = dict(st["lin"])
    if static:
        st["delta_a"] = torch.tensor([0.125])
    st["lora_a"] = torch.from_numpy(g.normal(size=(C_IN, 4)).astype(np.float32) * 0.1)
    st["lora_b"] = torch.from_numpy(g.normal(size=(4, C_OUT)).astype(np.float32) * 0.5)
    ctx = QuantCtx(mode="int8", policies=pol, state={"lin": st}, rotations=rot, trainable=True)
    return ctx, {"b": bias}


def _leaves_with_grad(ctx, x, static):
    """Fresh leaves (x, lora_a, lora_b[, delta_a]) requiring grad, and the ctx
    that reads them."""
    st = dict(ctx.state["lin"])
    keys = ["lora_a", "lora_b"] + (["delta_a"] if static else [])
    for k in keys:
        st[k] = st[k].detach().clone().requires_grad_()
    xl = x.detach().clone().requires_grad_()
    return [xl] + [st[k] for k in keys], dataclasses.replace(ctx, state={"lin": st})


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


# a static activation does not combine with a SmoothQuant mask (quant/ptq.py)
ROUTES = {"dynamic": (False, False), "static": (True, False), "dynamic_smoothquant": (False, True)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("bits", [4, 8], ids=["w4", "w8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_trainable_linear_matches_the_chain(bits, route, dtype):
    static, mask = ROUTES[route]
    ctx, params = _layer(bits, static, mask)
    x = _planted_x(dtype, static)
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(1, ROWS, C_OUT)).astype(
        np.float32))
    leaves_n, ctx_n = _leaves_with_grad(ctx, x, static)
    leaves_c, ctx_c = _leaves_with_grad(ctx, x, static)
    y_n = qlinear(ctx_n, "lin", params, leaves_n[0])
    y_c = _chain_qlinear(ctx_c, "lin", params, leaves_c[0])
    assert y_n.dtype == torch.float32 and torch.equal(y_n.view(torch.int32),
                                                      y_c.view(torch.int32))
    grads_n = torch.autograd.grad(y_n, leaves_n, g)
    grads_c = torch.autograd.grad(y_c, leaves_c, g)
    for name, gn, gc in zip(("x", "lora_a", "lora_b", "delta_a"), grads_n, grads_c):
        assert gn.dtype == gc.dtype and gn.shape == gc.shape, name
        assert _rel(gn, gc) <= 1e-6, (name, _rel(gn, gc))


@pytest.mark.parametrize("route", list(ROUTES))
def test_trainable_linear_in_row_chunks_matches_the_chain(route, monkeypatch):
    """Chunks of 7 rows (six, the last of 5): the forward and every gradient
    the chain's bits (elementwise passes, and row sums that do not depend on
    the chunk)."""
    from wanq_tpu_torch.quant import quantizers

    monkeypatch.setattr(quantizers, "STE_CHUNK", 7 * C_IN)
    assert len(quantizers.row_chunks(ROWS, C_IN)) == 6
    static, mask = ROUTES[route]
    ctx, params = _layer(8, static, mask)
    x = _planted_x(torch.bfloat16, static)
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(1, ROWS, C_OUT)).astype(
        np.float32))
    (leaves_n, ctx_n), (leaves_c, ctx_c) = (_leaves_with_grad(ctx, x, static) for _ in "nc")
    y_n = qlinear(ctx_n, "lin", params, leaves_n[0])
    y_c = _chain_qlinear(ctx_c, "lin", params, leaves_c[0])
    assert torch.equal(y_n.view(torch.int32), y_c.view(torch.int32))
    for gn, gc in zip(torch.autograd.grad(y_n, leaves_n, g), torch.autograd.grad(y_c, leaves_c, g)):
        assert torch.equal(gn, gc)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_fake_quant_ste_planted_gradients(static):
    """The Function's own gradients on the planted rows, element by element:
    x's through the clamp (half at -128 / 127, none past them), none through
    the eps row's delta, the tied absmax's share split evenly."""
    x = _planted_x(torch.float32, static)[0].requires_grad_()
    delta = torch.tensor([0.125], requires_grad=True) if static else None
    zp = torch.zeros(1) if static else None
    out = fake_quant_ste(x, 8, delta, zp)
    g = torch.ones_like(out)
    if static:
        gx, gd = torch.autograd.grad(out, [x, delta], g)
        np.testing.assert_array_equal(gx[0, :4].numpy(), [0.5, 0.5, 0.0, 0.0])
        np.testing.assert_array_equal(gx[1, :2].numpy(), [0.5, 0.5])
        dl = delta.detach().clone().requires_grad_()
        xl = x.detach().clone().requires_grad_()
        gxr, gdr = torch.autograd.grad(fake_quant(xl, dl, zp, 8, True), [xl, dl], g)
        assert torch.equal(gx, gxr)
        assert abs(float(gd) - float(gdr)) <= 1e-6 * abs(float(gdr))
        return
    xl = x.detach().clone().requires_grad_()
    d_a, zp_a = compute_quant_params(xl, 8, True)
    ref = fake_quant(xl, d_a, zp_a, 8, True)
    gx, = torch.autograd.grad(out, [x], g)
    gr, = torch.autograd.grad(ref, [xl], g)
    # the eps row: its straight-through part only, g * delta / delta
    assert torch.equal(gx[2], torch.ones(C_IN))
    assert _rel(gx, gr) <= 1e-6
    # the tied pair takes equal shares of the absmax's gradient, times sgn(x),
    # beside its own straight-through part (code 127: half; code -127: all)
    assert float(gx[0, 3]) - 0.5 == -(float(gx[0, 7]) - 1.0) != 0.0


@pytest.mark.parametrize("bits", [4, 8], ids=["w4", "w8"])
def test_trainable_route_keeps_no_f32_copy_of_its_input(bits):
    """The tensors a trainable W4 / W8 linear with an adapter saves for its
    backward beside the state's own: the bf16 input once (fake-quant and LoRA
    share it), the per-row delta, the rank-r product; nothing of [M, C] in
    f32, no dequantized weight."""
    ctx, params = _layer(bits, False, False)
    x = _planted_x(torch.bfloat16, False).requires_grad_()
    st = dict(ctx.state["lin"])
    st["lora_a"] = st["lora_a"].requires_grad_()
    ctx = dataclasses.replace(ctx, state={"lin": st})
    saved = {}
    state = {t.untyped_storage().data_ptr() for t in st.values()}

    def pack(t):  # the state's own tensors (the codes, scales, adapters) are not new
        if t.untyped_storage().data_ptr() not in state:
            saved.setdefault(t.untyped_storage().data_ptr(), (t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = qlinear(ctx, "lin", params, x)
    shapes = sorted(saved.values(), key=str)
    big = [s for s in shapes if int(np.prod(s[1])) >= ROWS * min(C_IN, C_OUT)]
    assert big == [(torch.bfloat16, (ROWS, C_IN))], shapes
    assert (torch.float32, (ROWS, 1)) in shapes
    seen, fn = set(), [y.grad_fn]
    while fn:
        f = fn.pop()
        if f is not None and f not in seen:
            seen.add(f)
            fn.extend(nf for nf, _ in f.next_functions)
    names = {type(f).__name__ for f in seen}
    assert {"_SymFakeQuantSTEBackward", "_DequantMmBackward", "_LoraF32Backward"} <= names
    assert not {"AmaxBackward0", "MinimumBackward0", "MaximumBackward0"} & names


def test_two_block_trainable_forward_backward_matches_jax(rng):
    """dit_forward(training=True, remat=True) through 2 blocks of the
    wan_w4a8_mixed.yaml int8 base (FP copies stripped) with rank-4 adapters
    (b != 0) in the state, the loss sum(out * r), against wanq_tpu's (run
    eagerly) from the same weights, adapters and inputs."""
    from tests.test_torch_distill import SEQ, W4A8_MIXED, _models

    cfg_j, pj, cfg_t, pt = _models(7)
    names = jdit.linear_layer_names(cfg_j)
    pol, st, rot = jax_prepare(pj, names, JaxQuantConfig.from_yaml(W4A8_MIXED), targets="int8")
    pol_t = QuantConfig.from_yaml(W4A8_MIXED).resolve_all(names)
    state_t = quant_state_from_numpy(jax.tree.map(np.asarray, st), device="cpu")
    pj, pt = jstrip(pj, pol), strip_quantized_weights(pt, pol_t)
    lj = jlora.init_lora_from_cfg(cfg_j, rank=4, seed=2, alpha=8.0)
    lt = tlora.init_lora_from_cfg(cfg_t, rank=4, seed=2, alpha=8.0, device="cpu")
    for name in tlora.adapters(lt):
        b = (rng.normal(size=tuple(lt[name]["b"].shape)) * 0.5).astype(np.float32)
        lj[name]["b"], lt[name]["b"] = jnp.asarray(b), torch.from_numpy(b)
    x = rng.normal(size=(1, 16, 3, 4, 6)).astype(np.float32)
    ctxt = rng.normal(size=(1, cfg_t.text_len, cfg_t.text_dim)).astype(np.float32)
    r = rng.normal(size=(1, 16, 3, 4, 6)).astype(np.float32)
    t = np.asarray([600.0], np.float32)

    def loss_j(lora):
        ctx = JaxQuantCtx(mode="int8", policies=pol, rotations=rot,
                          state=jlora.merge_lora_into_quant_state(st, lora))
        out = jdit.dit_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctxt),
                               SEQ, ctx=ctx, training=True, remat=True)
        return jnp.sum(out * jnp.asarray(r))

    with jax.disable_jit():
        lval, gj = jax.value_and_grad(loss_j)(lj)
    for ab in tlora.adapters(lt).values():
        for v in ab.values():
            v.requires_grad_()
    ctx = QuantCtx(mode="int8", policies=pol_t,
                   state=tlora.merge_lora_into_quant_state(state_t, lt))
    out = tdit.dit_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(ctxt), SEQ, ctx=ctx, training=True, remat=True)
    loss = (out * torch.from_numpy(r)).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(lval)) <= 1e-4 * abs(float(lval))
    num = den = 0.0
    for name, ab in tlora.adapters(lt).items():
        for leaf in "ab":
            gt, gw = ab[leaf].grad.double().numpy(), np.asarray(gj[name][leaf], np.float64)
            num += float(np.sum((gt - gw) ** 2))
            den += float(np.sum(gw ** 2))
    assert np.sqrt(num / den) <= 5e-4
