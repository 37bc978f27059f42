"""K13's plain version, its dispatch and the DiT block's residual updates
through it, on the CPU.

``gate_residual_plain`` is held bit for bit against the three expressions the
block wrote before K13 (``x + y * e2``, ``x + y``, ``x + y * e5``, each summed
in f32 and rounded to the residual's dtype), with an FP o projection's bias
added to y first as ``fp_linear`` adds it, and against wanq_tpu's
gate_residual. The dispatch takes the kernel for every card tensor and the
plain version on CPU tensors; under autograd the kernel's backward gives the
former expressions' gradients, in a training block and a remat forward too.
The FP o projection that leaves its bias to the residual update
gives the block the bits of ``qlinear``'s route, and ``block_forward`` and
``dit_forward`` give the bits of the former chain. Every comparison is exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.models import dit as jdit
from wanq_tpu.ops import fused as jfused
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu.quant.ptq import prepare_quant_state as jax_prepare
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import quant_state_from_numpy
from wanq_tpu_torch.models.rope import rope_tables_interleaved
from wanq_tpu_torch.ops import fused
from wanq_tpu_torch.quant import qlinear as tqlinear
from wanq_tpu_torch.quant.qlinear import QuantCtx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEED = os.path.join(ROOT, "quant_configs", "wan_w8a8_speed.yaml")
# head_dim 128, so the block takes its fused inference branches (K1..K4)
SMALL = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
             freq_dim=64)
BF16 = dict(param_dtype="bfloat16", residual_dtype="bfloat16")
GRID = (3, 4, 5)  # 60 tokens
SEQ = 64


def _former(x, y, gate=None, bias=None):
    """The block's updates as it wrote them before K13, y carrying the bias
    that fp_linear added."""
    if bias is not None:
        y = y + bias.float()
    if gate is None:
        return (x.float() + y.float()).to(x.dtype)
    return (x.float() + y.float() * gate[:, None, :]).to(x.dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _operands(dtype, b=2, s=37, c=48, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((b, s, c), generator=g) * 4).to(dtype)
    y = torch.randn((b, s, c), generator=g) * 3
    # signed zeros: x + y of -0 and -0 is -0, which an added +0 bias would lose
    x[0, 0, :8] = -0.0
    y[0, 0, :8] = -0.0
    # the gate as the block passes it: a column of the [B, 6, C] modulation
    mod = torch.randn((b, 6, c), generator=g)
    bias = (torch.randn((c,), generator=g) * 0.1).bfloat16()
    return x, y, mod[:, 2], bias


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("with_gate", [False, True], ids=["nogate", "gate"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_plain_is_the_blocks_former_expressions(dtype, with_gate, with_bias):
    x, y, gate, bias = _operands(dtype)
    gate = gate if with_gate else None
    bias = bias if with_bias else None
    assert not torch.equal(gate[0], gate[1]) if with_gate else True
    got = fused.gate_residual_plain(x, y, gate, bias)
    want = _former(x, y, gate, bias)
    assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))
    # through the dispatch on CPU tensors too
    assert torch.equal(_bits(fused.gate_residual(x, y, gate, bias)), _bits(want))
    if not with_gate and not with_bias:
        assert (_bits(got[0, 0, :8]) == _bits(torch.tensor(-0.0, dtype=dtype))).all()


def test_plain_matches_wanq_tpu_gate_residual():
    """wanq_tpu's gate_residual (the f32 sum XLA fuses) rounded to x's dtype,
    as the JAX block stores it."""
    for dtype in (torch.bfloat16, torch.float32):
        x, y, gate, _ = _operands(dtype, seed=2)
        xj = jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16 if dtype == torch.bfloat16
                         else jnp.float32)
        want = torch.from_numpy(np.array(jfused.gate_residual(
            xj, jnp.asarray(y.numpy()), jnp.asarray(gate.numpy())[:, None, :]))).to(dtype)
        got = fused.gate_residual_plain(x, y, gate)
        assert torch.equal(_bits(got), _bits(want))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself a CUDA one, to drive the dispatch."""

    @property
    def is_cuda(self):
        return True


def _kernel_is_plain(monkeypatch):
    """gate_residual_cuda replaced by the plain chain (the kernel's bits, as
    the card tests hold them), its calls counted."""
    calls = []
    monkeypatch.setattr(fused, "gate_residual_cuda",
                        lambda *a: calls.append(a) or fused.gate_residual_plain(
                            *(t.as_subclass(torch.Tensor) if isinstance(t, torch.Tensor)
                              else t for t in a)))
    return calls


@pytest.mark.parametrize("case", ["cpu", "card", "card_grad_y", "card_grad_x",
                                  "card_grad_gate", "card_grad_under_no_grad"])
def test_dispatch_takes_the_kernel_for_every_card_tensor(monkeypatch, case):
    x, y, gate, bias = _operands(torch.bfloat16)
    calls = _kernel_is_plain(monkeypatch)
    if case != "cpu":
        x = x.as_subclass(_OnCard)
    if case in ("card_grad_y", "card_grad_under_no_grad"):
        y.requires_grad_(True)
    if case == "card_grad_x":
        x = x.float().requires_grad_(True).as_subclass(_OnCard)
    if case == "card_grad_gate":
        gate = gate.clone().requires_grad_(True)
    if case == "card_grad_under_no_grad":
        with torch.no_grad():
            out = fused.gate_residual(x, y, gate, bias)
    else:
        out = fused.gate_residual(x, y, gate, bias)
    assert len(calls) == int(case != "cpu")
    assert (out.grad_fn is not None) == (case.startswith("card_grad_")
                                         and case != "card_grad_under_no_grad")
    assert torch.equal(_bits(out.detach().as_subclass(torch.Tensor)),
                       _bits(_former(x.detach().as_subclass(torch.Tensor), y.detach(),
                                     gate.detach(), bias)))


# (gate, bias, the operands whose gradients are asked for: x, y, g(ate), b(ias))
_BACKWARD_CASES = [(g, b, asked) for g in (False, True) for b in (False, True)
                   for asked in ("xygb", "y", "g", "xb") if (g or "g" not in asked)
                   and (b or "b" not in asked)]


@pytest.mark.parametrize("with_gate,with_bias,asked", _BACKWARD_CASES,
                         ids=[f"{'gate' if g else 'nogate'}-{'bias' if b else 'nobias'}-{a}"
                              for g, b, a in _BACKWARD_CASES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_backward_is_the_former_chains_gradients(monkeypatch, dtype, with_gate, with_bias,
                                                 asked):
    """K13's backward against autograd through the former expression: every
    gradient asked for equal bit for bit, none formed for what is not asked."""
    x, y, gate, bias = _operands(dtype, seed=4)
    gate = gate if with_gate else None
    bias = bias if with_bias else None
    up = (torch.randn(x.shape, generator=torch.Generator().manual_seed(8)) * 2).to(dtype)
    calls = _kernel_is_plain(monkeypatch)

    def run(fn):
        ins = [t.clone().requires_grad_(k in asked) if t is not None else None
               for t, k in ((x, "x"), (y, "y"), (gate, "g"), (bias, "b"))]
        fn(*ins).backward(up)
        return [None if t is None else t.grad for t in ins]

    got = run(fused._GateResidual.apply)
    assert len(calls) == 1
    want = run(_former)
    for g_got, g_want, k in zip(got, want, "xygb"):
        assert (g_got is None) == (g_want is None), k
        if g_want is not None:
            assert g_got.dtype == g_want.dtype and torch.equal(_bits(g_got), _bits(g_want)), k


def _block_inputs(cfg, seed=5):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, SEQ, cfg.dim)).astype(np.float32)).to(cfg.res_dtype)
    e = torch.from_numpy((rng.normal(size=(2, 6, cfg.dim)) * 0.1).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(2, 32, cfg.dim)).astype(np.float32)).to(cfg.dtype)
    ca, sb = (torch.from_numpy(np.array(t)) for t in rope_tables_interleaved(GRID, cfg.head_dim))
    return x, e, c, ca, sb


def _block(cfg, p, ctx, inputs, training=False):
    x, e, c, ca, sb = inputs
    return tdit.block_forward(p["blocks"][1], "blocks.1", ctx, x, e, c, cfg, ca, sb, 60,
                              training=training)


def _w8a8_ctx(cfg, p, inputs, seed=3):
    """wan_w8a8_speed.yaml's int8 state of block 1 (self o and cross o FP),
    calibrated through the port's block."""
    cc = QuantCtx(mode="calib", collect_minmax=True)
    _block(cfg, p, cc, inputs)
    calib = {k: v.float().numpy()[None] for k, v in cc.collect.items()}
    from wanq_tpu.configs import tiny_config as jax_tiny_config

    cfg_j = jax_tiny_config(**SMALL, **BF16)
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(seed))
    names = [n for n in jdit.linear_layer_names(cfg_j) if n.startswith("blocks.1.")]
    pol, st, _ = jax_prepare(pj, names, JaxQuantConfig.from_yaml(SPEED), calib=calib,
                             targets="int8")
    state = quant_state_from_numpy(jax.tree.map(np.asarray, st), device="cpu")
    return QuantCtx(mode="int8", policies=pol, state=state)


def _no_fold(ctx, name, po, y, dtype, split_bias=False):
    out = tqlinear.qlinear(ctx, name, po, y, dtype)
    return (out, None) if split_bias else out


@pytest.mark.parametrize("mode", ["fp", "w8a8"])
def test_fp_o_bias_fold_keeps_the_block_bits(monkeypatch, mode):
    cfg = tiny_config(**SMALL, **BF16)
    p = tdit.init_params(cfg, 3, device="cpu")
    for sub in ("self_attn", "cross_attn"):  # a bias that rounds visibly
        ob = p["blocks"][1][sub]["o"]
        ob["b"] = (torch.randn(ob["b"].shape, generator=torch.Generator().manual_seed(7))
                   * 0.5).to(ob["b"].dtype)
    inputs = _block_inputs(cfg)
    ctx = None if mode == "fp" else _w8a8_ctx(cfg, p, inputs)
    if ctx is not None:
        assert tqlinear.resolves_fp(ctx, "blocks.1.self_attn.o")
        assert not tqlinear.resolves_fp(ctx, "blocks.1.self_attn.q")
    seen = []
    real = tdit.gate_residual
    monkeypatch.setattr(tdit, "gate_residual",
                        lambda x, y, gate=None, bias=None: seen.append(bias is not None)
                        or real(x, y, gate, bias))
    folded = _block(cfg, p, ctx, inputs)
    # self o and cross o leave their bias to the update; the ffn has none to leave
    assert seen == [True, True, False]
    monkeypatch.setattr(tdit, "_o_proj", _no_fold)
    seen.clear()
    routed = _block(cfg, p, ctx, inputs)
    assert seen == [False, False, False]
    assert torch.equal(_bits(folded), _bits(routed))


def _former_chain(monkeypatch):
    """The block as it ran before K13: no bias apart, the former expressions."""
    monkeypatch.setattr(tdit, "_o_proj", _no_fold)
    monkeypatch.setattr(tdit, "gate_residual", _former)


@pytest.mark.parametrize("cfg_kw", [BF16, {}], ids=["bf16", "f32"])
@pytest.mark.parametrize("entry", ["block", "dit"])
def test_block_and_dit_forward_outputs_unchanged(monkeypatch, entry, cfg_kw):
    cfg = tiny_config(**SMALL, **cfg_kw)
    p = tdit.init_params(cfg, 4, device="cpu")
    p["head"]["head"]["w"] = (torch.randn(p["head"]["head"]["w"].shape,
                                          generator=torch.Generator().manual_seed(1))
                              * 0.02).to(cfg.dtype)
    rng = np.random.default_rng(9)
    if entry == "block":
        inputs = _block_inputs(cfg)
        run = lambda: _block(cfg, p, None, inputs)
    else:
        x = torch.from_numpy(rng.normal(size=(2, 16, 3, 8, 10)).astype(np.float32))
        t = torch.tensor([999.0, 500.0])
        c = torch.from_numpy(rng.normal(size=(2, 32, 64)).astype(np.float32))
        run = lambda: tdit.dit_forward(p, cfg, x, t, c, SEQ)
    got = run()
    _former_chain(monkeypatch)
    want = run()
    assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("entry", ["block", "dit_remat"])
def test_training_gradients_through_k13_unchanged(monkeypatch, entry):
    """A training forward and backward with every residual update through
    K13's autograd function (the card's route, the kernel's bits given by the
    plain chain) against the former chain: output and gradients equal bit for
    bit; a no-grad teacher's forward takes K13 too."""
    cfg = tiny_config(**SMALL, **BF16)
    p = tdit.init_params(cfg, 6, device="cpu")
    bp = p["blocks"][1]
    leaves = [bp["modulation"], bp["self_attn"]["o"]["w"], bp["self_attn"]["o"]["b"],
              bp["cross_attn"]["o"]["b"], bp["ffn"]["2"]["w"], bp["ffn"]["0"]["b"]]
    inputs = _block_inputs(cfg)
    rng = np.random.default_rng(11)
    xv = torch.from_numpy(rng.normal(size=(2, 16, 3, 8, 10)).astype(np.float32))
    t = torch.tensor([999.0, 500.0])
    c = torch.from_numpy(rng.normal(size=(2, 32, 64)).astype(np.float32))

    def forward(x=None):
        if entry == "block":
            return _block(cfg, p, None, ((inputs[0] if x is None else x),) + inputs[1:],
                          training=True)
        return tdit.dit_forward(p, cfg, xv if x is None else x, t, c, SEQ, training=True,
                                remat=True)

    def grads():
        for leaf in leaves:
            leaf.grad = None
            leaf.requires_grad_(True)
        x = (inputs[0] if entry == "block" else xv).clone().requires_grad_(True)
        out = forward(x)
        out.float().square().sum().backward()
        return [out.detach()] + [t_.grad.clone() for t_ in leaves + [x]]

    calls = _kernel_is_plain(monkeypatch)
    monkeypatch.setattr(tdit, "gate_residual", lambda x, y, gate=None, bias=None:
                        fused._GateResidual.apply(x, y, gate, bias))
    got = grads()
    per_forward = 3 * (1 if entry == "block" else cfg.num_layers)
    # the forward, and under remat each block's recompute in the backward
    assert len(calls) == per_forward * (1 if entry == "block" else 2)
    calls.clear()
    with torch.no_grad():
        teacher = forward()
    assert len(calls) == per_forward
    _former_chain(monkeypatch)
    want = grads()
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
    with torch.no_grad():
        assert torch.equal(_bits(teacher), _bits(forward()))


def _table_operands(dtype, seed=12, b=2, s=37, c=48, rows=8):
    """A per-frame gate table (a column of a [B, R, 6, C] modulation) with
    ragged rows: 8 rows of 5 tokens over 37, the last row taking 2 more."""
    x, y, _, bias = _operands(dtype, b=b, s=s, c=c, seed=seed)
    mod = torch.randn((b, rows, 6, c), generator=torch.Generator().manual_seed(seed + 1))
    return x, y, mod, bias


@pytest.mark.parametrize("asked", ["xygb", "y", "g", "xb"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_table_backward_is_the_plain_chains_gradients(monkeypatch, dtype, with_bias, asked):
    """K13 under autograd with a gate table of rows of tokens_per_row tokens
    (the card's route for per-frame timesteps) against autograd through the
    plain chain's broadcast: equal output and gradients, the gate's summed
    over each row's tokens into the modulation it is a column of."""
    if not with_bias and "b" in asked:
        asked = asked.replace("b", "")
    x, y, mod, bias = _table_operands(dtype)
    bias = bias if with_bias else None
    up = (torch.randn(x.shape, generator=torch.Generator().manual_seed(8)) * 2).to(dtype)
    # zeros upstream: a product with a negative gate is -0, which autograd's
    # sum of the table's two views turns to +0
    up[0, 3] = 0.0
    up[1, 36] = 0.0
    calls = _kernel_is_plain(monkeypatch)

    def run(fn):
        ins = [t.clone().requires_grad_(k in asked) if t is not None else None
               for t, k in ((x, "x"), (y, "y"), (mod, "g"), (bias, "b"))]
        out = fn(ins[0], ins[1], ins[2][:, :, 2], ins[3], 5)
        out.backward(up)
        return [out.detach()] + [None if t is None else t.grad for t in ins]

    got = run(fused._GateResidual.apply)
    assert len(calls) == 1 and calls[0][4] == 5
    want = run(fused.gate_residual_plain)
    for g_got, g_want, k in zip(got, want, "oxygb"):
        assert (g_got is None) == (g_want is None), k
        if g_want is not None:
            assert g_got.dtype == g_want.dtype and torch.equal(_bits(g_got), _bits(g_want)), k


def test_dispatch_takes_the_kernel_for_a_table_under_grad(monkeypatch):
    """A card tensor with a gate table that asks for gradients goes through
    K13's autograd function, not the plain chain."""
    x, y, mod, bias = _table_operands(torch.bfloat16)
    calls = _kernel_is_plain(monkeypatch)
    mod.requires_grad_(True)
    out = fused.gate_residual(x.as_subclass(_OnCard), y, mod[:, :, 2], bias, tokens_per_row=5)
    assert len(calls) == 1 and type(out.grad_fn).__name__ == "_GateResidualBackward"
    assert torch.equal(_bits(out.detach().as_subclass(torch.Tensor)),
                       _bits(fused.gate_residual_plain(x, y, mod[:, :, 2].detach(), bias,
                                                       tokens_per_row=5)))


def test_training_table_gradients_through_k13(monkeypatch):
    """A training block reading a per-frame modulation table (3 rows of 20
    tokens, 4 pad tokens on the last row) with every residual update through
    K13's autograd function, against the plain chain: output and gradients
    equal bit for bit."""
    cfg = tiny_config(**SMALL, **BF16)
    p = tdit.init_params(cfg, 6, device="cpu")
    bp = p["blocks"][1]
    x0, _, c, ca, sb = _block_inputs(cfg)
    tab = torch.randn((2, 3, 6, cfg.dim), generator=torch.Generator().manual_seed(3)) * 0.1
    leaves = [bp["modulation"], bp["self_attn"]["o"]["b"], bp["ffn"]["2"]["w"]]

    def grads():
        for leaf in leaves:
            leaf.grad = None
            leaf.requires_grad_(True)
        x, e = x0.clone().requires_grad_(True), tab.clone().requires_grad_(True)
        out = tdit.block_forward(bp, "blocks.1", None, x, e, c, cfg, ca, sb, 60,
                                 training=True, tokens_per_row=20)
        out.float().square().sum().backward()
        return [out.detach(), x.grad, e.grad] + [t_.grad.clone() for t_ in leaves]

    calls = _kernel_is_plain(monkeypatch)
    monkeypatch.setattr(tdit, "gate_residual",
                        lambda x, y, gate=None, bias=None, tokens_per_row=None:
                        fused._GateResidual.apply(x, y, gate, bias, tokens_per_row))
    got = grads()
    assert len(calls) == 3 and [a[4] for a in calls] == [20, None, 20]
    monkeypatch.setattr(tdit, "gate_residual", fused.gate_residual_plain)
    want = grads()
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
