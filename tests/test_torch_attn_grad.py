"""Gradients of the port against wanq_tpu's on the CPU: the quantizers, the
trainable int8 route of ``qlinear`` with its QLoRA adapter, attention under
``trainable`` and its plain backward from the LSE, and ``dit_forward(training=
True)`` with and without ``remat``.

The same numpy inputs go through ``jax.grad`` of the JAX function and through
torch's autograd of the port's. Tolerances, each from its cause:

* quantizers: gradients rel-L2 <= 1e-6 (f32, the same operations; the STE
  round, the split of the absmax gradient between ties and jnp.clip's split at
  a bound are what is held);
* the trainable route: outputs rel-L2 <= 1e-6 and gradients <= 1e-5 (bf16
  operands of one f32 product: both packages round the same f32 values, so
  only the f32 sum order differs);
* attention: the plain backward from the LSE within rel-L2 1e-6 of the plain
  forward's autograd (f32, two orders of the same sums) and within 1e-5 of
  ``jax.grad`` of ``_sdpa_reference``;
* ``dit_forward(training=True)`` on ``tiny`` (f32): gradients within rel-L2
  1e-4 of JAX's, and remat equal to no remat bit for bit (the same CPU
  operations run again).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.quant import ptq as jptq
from wanq_tpu.quant import quantizers as jq
from wanq_tpu.quant.config import QuantConfig as JaxQuantConfig
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import quant_state_from_numpy
from wanq_tpu_torch.quant import quantizers as tq
from wanq_tpu_torch.quant.config import QuantConfig

# the modules (the packages' __init__ files export functions of these names)
jattn = importlib.import_module("wanq_tpu.models.attention")
tattn = importlib.import_module("wanq_tpu_torch.models.attention")
jql = importlib.import_module("wanq_tpu.quant.qlinear")
tql = importlib.import_module("wanq_tpu_torch.quant.qlinear")
SITE = "blocks.0.ffn.0"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bits,sym", [(8, True), (4, True), (8, False), (4, False)])
def test_quantizer_gradients_match_jax_grad(rng, n_bits, sym):
    """d/dx sum(r * fake_quant(x, compute_quant_params(x))): the gradient
    flows through the STE round and the dynamic delta. Row 0 has a tie for its
    absmax (the gradient splits between them), row 1 is all zero (the eps
    clamp), row 2 is one-signed (the asymmetric zero bound)."""
    x = rng.normal(size=(5, 33)).astype(np.float32)
    x[0, 3], x[0, 9] = 4.0, -4.0
    x[1] = 0.0
    x[2] = np.abs(x[2])
    r = rng.normal(size=x.shape).astype(np.float32)

    def jf(v):
        d, z = jq.compute_quant_params(v, n_bits, sym)
        return jnp.sum(jnp.asarray(r) * jq.fake_quant(v, d, z, n_bits, sym))

    want_v, want_g = jax.value_and_grad(jf)(jnp.asarray(x))
    xt = _t(x, grad=True)
    d, z = tq.compute_quant_params(xt, n_bits, sym)
    got = torch.sum(_t(r) * tq.fake_quant(xt, d, z, n_bits, sym))
    got.backward()
    assert abs(got.item() - float(want_v)) <= 1e-6 * abs(float(want_v))
    assert _rel(xt.grad.numpy(), want_g) <= 1e-6


def test_round_ste_is_straight_through():
    x = torch.tensor([0.5, 1.5, -2.5, 0.49, 3.7], requires_grad=True)
    y = tq.round_ste(x)
    assert torch.equal(y.detach(), torch.round(x.detach()))
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(5))


def test_clip_bound_splits_the_gradient_as_jnp_clip():
    """A code exactly at the bound gets half the gradient in both packages."""
    x = np.asarray([[127.0, -64.0, 10.0, 200.0]], np.float32)
    d, z = jnp.ones((1, 1)), jnp.zeros((1, 1))
    want = jax.grad(lambda v: jnp.sum(jq.quantize(v, d, z, 8, True)))(jnp.asarray(x))
    xt = _t(x, grad=True)
    tq.quantize(xt, torch.ones((1, 1)), torch.zeros((1, 1)), 8, True).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert xt.grad[0, 0].item() == 0.5


# ---------------------------------------------------------------------------
# the trainable qlinear route + _maybe_lora
# ---------------------------------------------------------------------------

W8 = {"weight": {"n_bits": 8, "sym": False}, "act": {"n_bits": 8, "sym": True}}
W4 = {"weight": {"n_bits": 4, "sym": False}, "act": {"n_bits": 8, "sym": True}}


def _calib(rng, names, cfg):
    calib = {}
    for name in names:
        c_in = cfg.ffn_dim if name.endswith("ffn.2") else (
            cfg.text_dim if name == "text_embedding.0" else
            cfg.freq_dim if name == "time_embedding.0" else cfg.dim)
        calib[f"{name}.act_max"] = np.abs(rng.normal(size=(2, c_in))).astype(np.float32) * 4
        calib[f"{name}.act_min"] = -np.abs(rng.normal(size=(2, c_in))).astype(np.float32) * 3
    return calib


def _int8_state(rng, qdict, cfg_j):
    """JAX's int8 state of ``tiny`` under ``qdict`` and the port's converted
    copy; policies of both."""
    names = jdit.linear_layer_names(cfg_j)
    params = jdit.init_params(cfg_j, jax.random.PRNGKey(3))
    calib = _calib(rng, names, cfg_j) if "static_regex" in qdict["act"] else None
    pol_j, st_j, _ = jptq.prepare_quant_state(params, names, JaxQuantConfig.from_dict(qdict),
                                              calib=calib, targets="int8")
    st_np = jax.tree.map(np.asarray, st_j)
    pol_t = QuantConfig.from_dict(qdict).resolve_all(names)
    return params, pol_j, st_j, pol_t, quant_state_from_numpy(st_np, device="cpu")


@pytest.mark.parametrize("qdict", [W8, W4, {**W8, "act": {**W8["act"], "static_regex": "."}},
                                   {**W4, "act": {**W4["act"], "static_regex": "."}}],
                         ids=["w8_dynamic", "w4_dynamic", "w8_static", "w4_static"])
def test_trainable_route_and_lora_gradients_match_jax_grad(rng, qdict):
    """One site through the trainable route with a non-zero adapter: the
    output and the gradients of x, lora_a and lora_b against jax.grad."""
    cfg_j = jax_tiny_config()
    params, pol_j, st_j, pol_t, st_t = _int8_state(rng, qdict, cfg_j)
    assert ("w_int4" in st_t[SITE]) == (qdict["weight"]["n_bits"] == 4)
    x = rng.normal(size=(2, 7, cfg_j.dim)).astype(np.float32)
    a = (rng.normal(size=(cfg_j.dim, 4)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(4, cfg_j.ffn_dim)) * 0.3).astype(np.float32)
    r = rng.normal(size=(2, 7, cfg_j.ffn_dim)).astype(np.float32)
    lin_j = params["blocks"][0]["ffn"]["0"]

    def jf(xv, av, bv):
        st = dict(st_j)
        st[SITE] = {**st_j[SITE], "lora_a": av, "lora_b": bv}
        ctx = jql.QuantCtx(mode="int8", policies=pol_j, state=st, trainable=True)
        y = jql.qlinear(ctx, SITE, lin_j, xv)
        return jnp.sum(jnp.asarray(r) * y), y

    (_, y_j), g_j = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    xt, at, bt = _t(x, True), _t(a, True), _t(b, True)
    st = dict(st_t)
    st[SITE] = {**st_t[SITE], "lora_a": at, "lora_b": bt}
    ctx = tql.QuantCtx(mode="int8", policies=pol_t, state=st, trainable=True)
    lin_t = {"w": None, "b": torch.from_numpy(np.array(lin_j["b"]))}
    y_t = tql.qlinear(ctx, SITE, lin_t, xt)
    torch.sum(_t(r) * y_t).backward()
    assert _rel(y_t.detach().numpy(), y_j) <= 1e-6
    for got, want in zip((xt.grad, at.grad, bt.grad), g_j):
        assert _rel(got.numpy(), want) <= 1e-5


def test_w4a4_has_no_trainable_route(rng):
    qdict = {"weight": {"n_bits": 4, "sym": True, "group": 32},
             "act": {"n_bits": 4, "sym": True, "group": 32}}
    _, _, _, pol_t, st_t = _int8_state(rng, qdict, jax_tiny_config())
    ctx = tql.QuantCtx(mode="int8", policies=pol_t, state=st_t, trainable=True)
    with pytest.raises(NotImplementedError, match="W4A4"):
        tql.qlinear(ctx, SITE, {"b": None}, torch.zeros((1, 3, 96)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,sk,valid", [(37, 37, 30), (21, 13, None), (40, 29, 1)])
def test_trainable_attention_matches_jax_grad(rng, sq, sk, valid):
    """attention(trainable=True) on CPU tensors (autograd through the plain
    forward) against jax.grad of wanq_tpu's _sdpa_reference, kv_valid mask
    included; then attention_bwd_reference from the plain forward's LSE
    against the same autograd."""
    q = rng.normal(size=(2, sq, 3, 24)).astype(np.float32)
    k = rng.normal(size=(2, sk, 3, 24)).astype(np.float32)
    v = rng.normal(size=(2, sk, 3, 24)).astype(np.float32)
    do = rng.normal(size=(2, sq, 3, 24)).astype(np.float32)

    def jf(qv, kv, vv):
        return jnp.sum(jnp.asarray(do) * jattn._sdpa_reference(qv, kv, vv, 0.3, valid))

    g_j = jax.grad(jf, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    leaves = [_t(t, True) for t in (q, k, v)]
    out = tattn.attention(*leaves, scale=0.3, k_valid_len=valid, trainable=True)
    out.backward(_t(do))
    for i, (got, want) in enumerate(zip(leaves, g_j)):
        if valid == 1 and i < 2:
            # one visible key: P = 1, so dq and dk are 0 up to rounding in both
            assert np.abs(got.grad.numpy()).max() <= 1e-5 and np.abs(want).max() <= 1e-5
        else:
            assert _rel(got.grad.numpy(), want) <= 1e-5

    o, lse = tattn._sdpa_lse_reference(*(_t(t) for t in (q, k, v)), 0.3, valid, q_chunk=8)
    np.testing.assert_array_equal(o.numpy(), out.detach().numpy())
    s = np.einsum("bsnd,btnd->bnst", q, k).astype(np.float64) * 0.3
    if valid is not None:
        s[..., valid:] = -np.inf
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-5)
    grads = tattn.attention_bwd_reference(*(_t(t) for t in (q, k, v)), o, lse, _t(do), 0.3,
                                          valid, q_chunk=10)
    for i, (got, leaf) in enumerate(zip(grads, leaves)):
        if valid == 1 and i < 2:
            assert np.abs(got.numpy()).max() <= 1e-5
        else:
            assert _rel(got.numpy(), leaf.grad.numpy()) <= 1e-6
    if valid is not None:
        assert not grads[1][:, valid:].any() and not grads[2][:, valid:].any()


def test_trainable_attention_outside_autograd_is_the_plain_forward(rng):
    q, k, v = (_t(rng.normal(size=(1, 9, 2, 24))) for _ in range(3))
    with torch.no_grad():
        got = tattn.attention(q, k, v, k_valid_len=7, trainable=True)
    assert torch.equal(got, tattn.attention(q, k, v, k_valid_len=7))


# ---------------------------------------------------------------------------
# dit_forward(training=True), remat
# ---------------------------------------------------------------------------


def _dit_pair(seed=5):
    cfg_j, cfg_t = jax_tiny_config(), tiny_config()
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(seed))
    pt = tdit.init_params(cfg_t, seed, device="cpu")
    hw = (np.random.default_rng(seed).normal(size=(cfg_t.dim, 64)) * 0.02).astype(np.float32)
    pj["head"]["head"]["w"] = jnp.asarray(hw)
    pt["head"]["head"]["w"] = torch.from_numpy(hw)
    return cfg_j, pj, cfg_t, pt


def _dit_inputs(rng, cfg):
    x = rng.normal(size=(2, 16, 3, 4, 6)).astype(np.float32)
    t = np.asarray([700.0, 300.0], np.float32)
    c = rng.normal(size=(2, cfg.text_len, cfg.text_dim)).astype(np.float32)
    r = rng.normal(size=(2, 16, 3, 4, 6)).astype(np.float32)
    return x, t, c, r


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _torch_grads(pt, cfg, inputs, seq, **kw):
    x, t, c, r = inputs
    leaves = {k: v.requires_grad_() for k, v in _flat(pt).items()}
    out = tdit.dit_forward(pt, cfg, _t(x), _t(t), _t(c), seq, training=True, **kw)
    torch.sum(_t(r) * out).backward()
    grads = {k: v.grad.clone() for k, v in leaves.items()}
    for v in leaves.values():
        v.grad = None
        v.requires_grad_(False)
    return grads


def test_dit_training_gradients_match_jax_and_remat_is_exact(rng):
    """Every parameter's gradient of sum(r * dit_forward(training=True)) on
    tiny (f32, 2 blocks, 72 tokens padded to 80) against jax.grad; remat
    gives the same bits."""
    cfg_j, pj, cfg_t, pt = _dit_pair()
    inputs = _dit_inputs(rng, cfg_t)
    x, t, c, r = inputs

    def jf(p):
        out = jdit.dit_forward(p, cfg_j, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c), 80,
                               training=True)
        return jnp.sum(jnp.asarray(r) * out)

    g_j = _flat(jax.jit(jax.grad(jf))(pj))
    g_t = _torch_grads(pt, cfg_t, inputs, 80)
    assert sorted(g_t) == sorted(g_j)
    for name, got in g_t.items():
        want = np.asarray(g_j[name])
        if np.abs(want).max() == 0:
            assert not got.any(), name
        else:
            assert _rel(got.numpy(), want) <= 1e-4, name
    g_remat = _torch_grads(pt, cfg_t, inputs, 80, remat=True)
    for name, got in g_t.items():
        assert torch.equal(g_remat[name], got), name


def _tree_rel(got, want) -> float:
    """rel-L2 over every leaf at once."""
    num = sum(np.sum((np.asarray(g, np.float64) - np.asarray(w, np.float64)) ** 2)
              for g, w in zip(got, want))
    return float(np.sqrt(num / sum(np.sum(np.asarray(w, np.float64) ** 2) for w in want)))


def test_qlora_dit_gradients_match_jax_and_remat_is_exact(rng):
    """The adapters' gradients through a tiny int8 model under
    wan_w4a8_mixed.yaml's policies (W4 ffn, W8 self-attention, dynamic
    activations; the trainable route) with b != 0, against jax.grad run
    eagerly: rel-L2 <= 1e-4 over all adapters and <= 1e-3 for each. XLA's jit
    changes this model's arithmetic (fused divisions flip fake-quant
    roundings): jit and eager JAX read 1.5e-3 apart over all adapters and up to
    2.7e-3 on one, while the port reads 2.3e-5 from eager JAX. The softmax
    backward of the near-uniform attention of a random tiny model amplifies a
    1e-6 difference of dO about a hundredfold in block 0's q, k, v. Remat equal
    to no remat."""
    from wanq_tpu.training.lora import init_lora as jinit_lora
    from wanq_tpu.training.lora import merge_lora_into_quant_state as jmerge
    from wanq_tpu_torch.training.lora import init_lora, merge_lora_into_quant_state

    cfg_j, pj, cfg_t, pt = _dit_pair()
    import os
    yaml = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "quant_configs", "wan_w4a8_mixed.yaml")
    names = jdit.linear_layer_names(cfg_j)
    pol_j, st_j, _ = jptq.prepare_quant_state(pj, names, JaxQuantConfig.from_yaml(yaml),
                                              targets="int8")
    pol_t = QuantConfig.from_yaml(yaml).resolve_all(names)
    st_t = quant_state_from_numpy(jax.tree.map(np.asarray, st_j), device="cpu")
    lj = jinit_lora(pj, names, rank=4, seed=1)
    lt = init_lora(pt, names, rank=4, seed=1)
    for name in lt:
        if name != "__scale__":
            b = (rng.normal(size=tuple(lt[name]["b"].shape)) * 0.1).astype(np.float32)
            lj[name]["b"], lt[name]["b"] = jnp.asarray(b), torch.from_numpy(b)
    x, t, c, r = _dit_inputs(rng, cfg_t)

    def jf(lora):
        ctx = jql.QuantCtx(mode="int8", policies=pol_j, state=jmerge(st_j, lora))
        out = jdit.dit_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c), 80,
                               ctx=ctx, training=True)
        return jnp.sum(jnp.asarray(r) * out)

    with jax.disable_jit():
        g_j = jax.grad(jf)(lj)

    def grads(remat):
        leaves = {n: ab for n, ab in lt.items() if n != "__scale__"}
        for ab in leaves.values():
            for v in ab.values():
                v.grad = None
                v.requires_grad_()
        ctx = tql.QuantCtx(mode="int8", policies=pol_t, state=merge_lora_into_quant_state(
            st_t, lt))
        out = tdit.dit_forward(pt, cfg_t, _t(x), _t(t), _t(c), 80, ctx=ctx, training=True,
                               remat=remat)
        torch.sum(_t(r) * out).backward()
        return {(n, k): v.grad.clone() for n, ab in leaves.items() for k, v in ab.items()}

    g_t = grads(False)
    assert len(g_t) == 2 * 12  # q, k, v, o, ffn.0, ffn.2 in 2 blocks: a and b
    want = [np.asarray(g_j[name][leaf]) for name, leaf in g_t]
    assert _tree_rel([g.numpy() for g in g_t.values()], want) <= 1e-4
    for (name, leaf), got in g_t.items():
        assert _rel(got.numpy(), np.asarray(g_j[name][leaf])) <= 1e-3, (name, leaf)
    for key, got in grads(True).items():
        assert torch.equal(got, g_t[key]), key


def test_training_refuses_what_has_no_backward(rng):
    """A temporal window, and an int8 attn: section, under training raise."""
    cfg = tiny_config()
    pt = tdit.init_params(cfg, 0, device="cpu")
    x, t, c, _ = _dit_inputs(rng, cfg)
    ctx = tql.QuantCtx(mode="fp", attn_window=0)
    with pytest.raises(NotImplementedError, match="attn_window"):
        tdit.dit_forward(pt, cfg, _t(x), _t(t), _t(c), 80, ctx=ctx, training=True)
    # the same window runs without training
    tdit.dit_forward(pt, cfg, _t(x), _t(t), _t(c), 80, ctx=ctx)
    from wanq_tpu_torch.quant.attn import AttnQuantCfg

    ctx = tql.QuantCtx(mode="int8", attn=AttnQuantCfg())
    with pytest.raises(NotImplementedError, match="int8 attention"):
        tdit.dit_forward(pt, cfg, _t(x), _t(t), _t(c), 80, ctx=ctx, training=True)


def test_backward_kernels_refuse_cpu_tensors():
    """K12 / K11's wrapper launches or raises: CPU tensors never reach a plain
    fallback there (the CPU's gradient is autograd through the plain forward)."""
    q = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_bwd(q, q, q, q, lse, q, 1.0, 8)
