"""Training and calibration under a mesh in the port (``wanq_tpu_torch/parallel``,
``dit_forward(plan=)`` with ``training`` or a calib ctx, the step builders'
``plan=``) against ``wanq_tpu`` on the CPU.

The multi-rank tests run on the gloo harness of ``tests/test_torch_parallel.py``
(its ``ranks`` fixture: worker processes in one gloo group of the mesh's size,
up to 8 for ``make_mesh(1, 2, 2, 2)``), calling this module's task functions by
``test_torch_parallel_train:<name>``; those functions and this file's top level
import no JAX. The ``wanq_tpu`` oracle runs in the test process on one of its
8 virtual CPU devices (``wanq_tpu``'s own mesh tests hold its meshes to one
device at these tolerances: ``tests/test_lora.py:395``,
``tests/test_gptq.py:411``), from the same numpy weights and inputs.

Tolerances: the ring's gradients 2e-5 / 1e-4 (``tests/test_ring_attention.py``);
QLoRA's loss rtol 2e-4 and adapter gradients rtol 5e-3, atol 1e-6
(``tests/test_lora.py:395``; JAX's jit moves a quantized model's gradients by
~1.5e-3); every-parameter gradients 1e-4 of the tree (``tests/test_torch_distill.py``);
the Hessians rtol 2e-3, atol 2e-2 and the absmax / minmax stacks 1e-5 relative
(``tests/test_gptq.py:411``). Against the port's own planless run (a worker's
one-thread products differ from this process's in ulps): 1e-5, and 1e-4 for
a two-step sweep's stats; ``head.head``'s gradient at bf16's 1e-2 (each rank
rounds its part to bf16 before the sum).
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import _inputs, _jax_models, _plan, _rel, ranks  # noqa: F401
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import params_from_numpy, quant_state_from_numpy
from wanq_tpu_torch.parallel import shard_params
from wanq_tpu_torch.parallel import ring, sharding
from wanq_tpu_torch.quant.qlinear import QuantCtx

ME = "test_torch_parallel_train:"
# wanq_tpu's QLoRA mesh test: 8 heads of 12 (96 wide), 2 frames of 8 x 8 -> 32 tokens
QLORA_CFG = dict(num_heads=8, dim=96)
QLORA_SEQ = 32
QLORA_TARGETS = r"self_attn\.(q|v)|ffn\.0"
QLORA_QUANT = {
    "remain_fp_regex": r"text_embedding|time_embedding|time_projection|head\.head",
    "weight": {"n_bits": 8, "sym": False},
    "act": {"n_bits": 8, "sym": True},
}
QLORA_MESHES = {"dp1fsdp2sp2ring2": (1, 2, 2, 2), "ring4": (1, 1, 1, 4),
                "sp2ring2": (1, 1, 2, 2), "dp2sp2": (2, 1, 2, 1), "fsdp2sp2": (1, 2, 2, 1)}
HESS_REGEX = r"self_attn|cross_attn\.(q|o)|ffn\.0"
CALIB_KW = dict(size=(64, 64), frame_num=5, shift=5.0, sampling_steps=2, guide_scale=5.0)


def _world(dims) -> int:
    return int(np.prod(dims))


# ---------------------------------------------------------------------------
# task functions, run on every rank of a group (no JAX here)
# ---------------------------------------------------------------------------


def task_ring_grads(q, k, v, do, ring_n, k_valid_len=None):
    """The ring's autograd on this rank's sequence shard: (ring index, dq, dk,
    dv) of sum(ring_attention(q, k, v) * do)."""
    plan = _plan((1, 1, 1, ring_n))
    r = plan.mesh.coords["ring"]
    s_r = q.shape[1] // ring_n
    mine = [torch.from_numpy(a[:, r * s_r:(r + 1) * s_r]).requires_grad_() for a in (q, k, v)]
    out = plan.ring_attention(*mine, k_valid_len=k_valid_len)
    out.backward(torch.from_numpy(do[:, r * s_r:(r + 1) * s_r]))
    return r, *(t.grad.numpy() for t in mine)


def _qlora_ctx(cfg, state, plan):
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import shard_quant_state

    policies = QuantConfig.from_dict(QLORA_QUANT).resolve_all(tdit.linear_layer_names(cfg))
    st = quant_state_from_numpy(state, device="cpu")
    return QuantCtx(mode="int8", policies=policies,
                    state=st if plan is None else shard_quant_state(st, plan))


def _lora(lora_np):
    from wanq_tpu_torch.training.lora import SCALE

    out = {SCALE: torch.tensor(float(lora_np[SCALE]))}
    out.update({k: {leaf: torch.from_numpy(np.array(a)).requires_grad_() for leaf, a in ab.items()}
                for k, ab in lora_np.items() if k != SCALE})
    return out


def task_qlora_grads(params, state, lora_np, x, t, c, dims):
    """wanq_tpu's QLoRA mesh loss, mean(dit_forward(training=True)^2), with the
    adapters merged into the int8 state: (loss, {layer: (grad a, grad b)})
    after ``plan.reduce_grads``."""
    from wanq_tpu_torch.training.lora import adapters, merge_lora_into_quant_state

    plan = _plan(dims)
    cfg = tiny_config(**QLORA_CFG)
    qctx = _qlora_ctx(cfg, state, plan)
    lora = _lora(lora_np)
    ctx = QuantCtx(mode="int8", policies=qctx.policies,
                   state=merge_lora_into_quant_state(qctx.state, lora))
    out = tdit.dit_forward(shard_params(params_from_numpy(params, device="cpu"), plan), cfg,
                           *(torch.from_numpy(a) for a in (x, t, c)), QLORA_SEQ, ctx=ctx,
                           training=True, plan=plan)
    loss = torch.mean(out ** 2)
    loss.backward()
    leaves = [ab[leaf] for ab in adapters(lora).values() for leaf in ("a", "b")]
    plan.reduce_grads([t.grad for t in leaves])
    return float(loss), {k: (ab["a"].grad.numpy(), ab["b"].grad.numpy())
                         for k, ab in adapters(lora).items()}


def task_qlora_step(params, state, lora_np, batch, dims, g):
    """One make_qlora_distill_step under the mesh (remat): the loss, the
    gradients' norm and the updated adapters."""
    from wanq_tpu_torch.training import distill
    from wanq_tpu_torch.training.lora import adapters

    plan = None if dims is None else _plan(dims)
    cfg = tiny_config(**QLORA_CFG)
    dcfg = distill.DistillConfig(learning_rate=1e-3, seq_len=QLORA_SEQ, remat=True)
    state_t, tx = distill.init_train_state(_lora(lora_np), dcfg)
    params_t = params_from_numpy(params, device="cpu")
    step = distill.make_qlora_distill_step(cfg, dcfg, tx, plan=plan)
    out = step(state_t.params, state_t.ema_params, tx,
               params_t if plan is None else shard_params(params_t, plan),
               _qlora_ctx(cfg, state, plan), *(torch.from_numpy(batch[k]) for k in (
                   "x0", "noise", "t", "context", "null_context")), g)
    return float(out[3]), float(out[4]), {k: (ab["a"].detach().numpy(), ab["b"].detach().numpy())
                                          for k, ab in adapters(out[0]).items()}


def task_lora_step(params, lora_np, batch, dims, g):
    """One make_lora_distill_step (FP LoRA) under the mesh (None: planless):
    the loss, the gradients' norm and the updated adapters."""
    from wanq_tpu_torch.training import distill
    from wanq_tpu_torch.training.lora import adapters

    plan = None if dims is None else _plan(dims)
    dcfg = distill.DistillConfig(learning_rate=1e-3, seq_len=96, remat=True)
    state, tx = distill.init_train_state(_lora(lora_np), dcfg)
    base = params_from_numpy(params, device="cpu")
    step = distill.make_lora_distill_step(tiny_config(), dcfg, tx, plan=plan)
    out = step(state.params, state.ema_params, tx, base if plan is None else shard_params(
        base, plan), *(torch.from_numpy(batch[k]) for k in ("x0", "noise", "t", "context",
                                                            "null_context")), g)
    return float(out[3]), float(out[4]), {k: (ab["a"].detach().numpy(), ab["b"].detach().numpy(),
                                              ab["a"].grad.numpy(), ab["b"].grad.numpy())
                                          for k, ab in adapters(out[0]).items()}


def task_distill_grads(student, teacher, batch, dims, g, full_shard=False):
    """One make_distill_step (every parameter, no clip, lr 0: the gradients
    stay in .grad) under the mesh: the loss and each trained leaf's gradient
    as this rank holds it ({path: (stored split, gradient)})."""
    from wanq_tpu_torch.training import distill

    plan = _plan(dims, full_shard)
    cfg = tiny_config()
    dcfg = distill.DistillConfig(learning_rate=0.0, weight_decay=0.0, seq_len=80,
                                 max_grad_norm=1e9)
    stored = shard_params(params_from_numpy(student, device="cpu"), plan)
    state, tx = distill.init_train_state(stored, dcfg)
    step = distill.make_distill_step(cfg, dcfg, tx, plan=plan)
    out = step(state.params, state.ema_params, tx,
               shard_params(params_from_numpy(teacher, device="cpu"), plan),
               *(torch.from_numpy(batch[k]) for k in ("x0", "noise", "t", "context",
                                                       "null_context")), g)
    grads = {"/".join(p): (isinstance(leaf, sharding.Shard),
                           (leaf.local if isinstance(leaf, sharding.Shard) else leaf).grad.numpy())
             for p, leaf in sharding._walk(state.params)
             if isinstance(leaf, sharding.Shard) or torch.is_tensor(leaf)}
    return float(out[3]), plan.storage()[2], grads


def task_output_grads(params, x, t, c, dims):
    """The gradient of mean(dit_forward(training=True)^2) w.r.t. every (replicated)
    parameter, summed by ``plan.reduce_grads``: the gathers' backward keeps this
    rank's slice, so the sum is the planless gradient."""
    plan = _plan(dims)
    cfg = tiny_config()
    pt = params_from_numpy(params, device="cpu")
    leaves = [leaf for _, leaf in sharding._walk(pt) if torch.is_tensor(leaf)]
    for leaf in leaves:
        leaf.requires_grad_()
    out = tdit.dit_forward(pt, cfg, *(torch.from_numpy(a) for a in (x, t, c)), 96,
                           training=True, plan=plan)
    torch.mean(out ** 2).backward()
    plan.reduce_grads([leaf.grad for leaf in leaves])
    return [leaf.grad.numpy() for leaf in leaves]


def task_calibration(params, context, context_null, noise, dims, pool=0):
    """WanT2V.collect_calibration (minmax, the GPTQ Hessian regex, ``pool``'s
    map capture) under the mesh from ``noise``: the stats on every rank."""
    from wanq_tpu_torch.pipelines.text2video import WanT2V

    plan = _plan(dims)
    pipe = WanT2V(tiny_config(), shard_params(params_from_numpy(params, device="cpu"), plan),
                  quant_ctx=QuantCtx(mode="calib", collect_minmax=True, hessian_regex=HESS_REGEX,
                                     attn_map_pool=pool), device="cpu", shardings=plan)
    stats = pipe.collect_calibration(torch.from_numpy(context), torch.from_numpy(context_null),
                                     noise=torch.from_numpy(noise), **CALIB_KW)
    return {k: v.double().numpy() if torch.is_tensor(v) else v for k, v in stats.items()}


def task_capture(params, context, latents, dims):
    """WanT2V.capture_attn_maps (pool 8, mean) under the mesh."""
    from wanq_tpu_torch.pipelines.text2video import WanT2V

    plan = _plan(dims)
    pipe = WanT2V(tiny_config(), shard_params(params_from_numpy(params, device="cpu"), plan),
                  device="cpu", shardings=plan)
    return pipe.capture_attn_maps(torch.from_numpy(context), size=(64, 64), frame_num=5, pool=8,
                                  latents=torch.from_numpy(latents))


def task_calib_cli(argv):
    from wanq_tpu_torch.cli import get_calib_data

    return get_calib_data.generate(get_calib_data.parse_args(argv))


# ---------------------------------------------------------------------------
# the ring's gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qkv_do():
    rng = np.random.default_rng(1)
    return tuple(rng.normal(size=(2, 64, 4, 32)).astype(np.float32) for _ in range(4))


@pytest.mark.parametrize("ring_n,valid", [(2, None), (4, None), (4, 40)],
                         ids=["ring2", "ring4", "ring4_pad_tail"])
def test_ring_grads_match_wanq_tpu(ranks, qkv_do, ring_n, valid):
    """The ring's backward (the row table from the folded LSE, one hop
    backward per visited shard, the dk / dv accumulators travelling with
    their shards and sent home) against jax.grad through wanq_tpu's
    ring_attention on its mesh. With 40 valid keys of 64 the last rank's
    shard holds no valid key (its hop is skipped, its rotation kept) and
    its q rows are pad rows, which see every valid key."""
    import jax
    import jax.numpy as jnp

    from wanq_tpu.parallel import make_mesh as jmesh
    from wanq_tpu.parallel.ring import ring_attention as jring

    q, k, v, do = qkv_do
    mesh = jmesh(1, 1, 1, ring_n)
    loss = lambda q_, k_, v_: jnp.sum(jring(q_, k_, v_, mesh, axis="ring", k_valid_len=valid)
                                      * jnp.asarray(do))
    want = [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))]
    got = [np.zeros_like(q) for _ in range(3)]
    s_r = q.shape[1] // ring_n
    for r, *grads in ranks(ring_n).run(ME + "task_ring_grads", q=q, k=k, v=v, do=do,
                                       ring_n=ring_n, k_valid_len=valid):
        for full, part in zip(got, grads):
            full[:, r * s_r:(r + 1) * s_r] = part
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-4, err_msg=f"d{name}")
    if valid is not None:
        assert not got[1][:, valid:].any() and not got[2][:, valid:].any()


def test_hop_backward_sums_to_the_whole_backward(qkv_do):
    """hop_backward over four shards from one row table (the plain version of
    K12 / K11's accumulate mode) sums to attention_bwd_reference on the whole
    sequence; a partial last shard gives dk = dv = 0 past its valid keys."""
    from wanq_tpu_torch.models.attention import (
        _sdpa_lse_reference, attention_bwd_reference, flash_bwd_rows)

    q, k, v, do = (torch.from_numpy(a) for a in qkv_do)
    scale, valid = 0.2, 58
    o, lse = _sdpa_lse_reference(q, k, v, scale, valid)
    want = attention_bwd_reference(q, k, v, o, lse, do, scale, valid)
    rows = flash_bwd_rows(lse, o, do)
    assert rows.shape == (2, 4, 2, 128) and torch.isinf(rows[:, :, 0, 64:]).all()
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for j in (2, 0, 3, 1):
        sl = slice(16 * j, 16 * (j + 1))
        ring.hop_backward(q, k[:, sl], v[:, sl], do, rows, scale, min(16, valid - 16 * j),
                          dq, dk[:, sl], dv[:, sl])
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=2e-6, rtol=1e-5)
    assert not dk[:, valid:].any() and not dv[:, valid:].any()


# ---------------------------------------------------------------------------
# gathers, QLoRA, every-parameter training
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_models():
    cfg_j, pj, pnp = _jax_models({})
    return cfg_j, pj, pnp, _inputs({}, frames=6)


@pytest.mark.parametrize("dims", [(2, 1, 1, 1), (1, 1, 2, 1)], ids=["dp2", "sp2"])
def test_gathers_backward_gives_the_planless_gradient(ranks, tiny_models, dims):
    """The output's gathers over dp and over tokens keep this rank's slice of
    the gradient (a sum over the ranks would double it): summed over the data
    axes, every parameter's gradient equals the port's planless one."""
    _, _, pnp, (x, t, c) = tiny_models
    pt = params_from_numpy(pnp, device="cpu")
    leaves = [leaf for _, leaf in sharding._walk(pt) if torch.is_tensor(leaf)]
    assert len(leaves) > 40
    for leaf in leaves:
        leaf.requires_grad_()
    out = tdit.dit_forward(pt, tiny_config(), *(torch.from_numpy(a) for a in (x, t, c)), 96,
                           training=True)
    torch.mean(out ** 2).backward()
    want = {"/".join(p): leaf.grad.double().numpy()
            for p, leaf in sharding._walk(pt) if torch.is_tensor(leaf)}
    for got in ranks(_world(dims)).run(ME + "task_output_grads", params=pnp, x=x, t=t, c=c,
                                       dims=dims):
        for g, (path, w) in zip(got, want.items()):
            # head.head multiplies bf16 operands: each rank rounds its part of
            # the weight's gradient to bf16 before the sum (2e-3 at dp2)
            assert _rel(w, g) <= (1e-2 if path == "head/head/w" else 1e-5), path


@pytest.fixture(scope="module")
def qlora_case():
    """wanq_tpu's QLoRA mesh test's model, int8 state, adapters and inputs;
    its single-device loss and adapter gradients (jitted, as that test)."""
    import jax
    import jax.numpy as jnp

    from tests.conftest import randomize_head
    from wanq_tpu.configs import tiny_config as jax_tiny_config
    from wanq_tpu.models.dit import dit_forward, init_params, linear_layer_names
    from wanq_tpu.quant import QuantConfig
    from wanq_tpu.quant.ptq import prepare_quant_state
    from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
    from wanq_tpu.training.lora import init_lora, merge_lora_into_quant_state

    cfg = jax_tiny_config(**QLORA_CFG)
    params = randomize_head(init_params(cfg, jax.random.PRNGKey(0)))
    names = linear_layer_names(cfg)
    pol, state, rot = prepare_quant_state(params, names, QuantConfig.from_dict(QLORA_QUANT),
                                          targets="int8")
    lora = init_lora(params, names, rank=4, seed=9, targets=QLORA_TARGETS)
    for k in lora:
        if k != "__scale__":
            lora[k]["b"] = 0.05 * jnp.asarray(np.random.default_rng(4).normal(
                size=lora[k]["b"].shape).astype(np.float32))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, cfg.in_dim, 2, 8, 8)).astype(np.float32)
    t = np.asarray([500.0, 500.0], np.float32)
    c = rng.normal(size=(2, cfg.text_len, cfg.text_dim)).astype(np.float32)

    def loss(lo):
        ctx = JaxQuantCtx(mode="int8", policies=pol, rotations=rot, trainable=True,
                          state=merge_lora_into_quant_state(state, lo))
        out = dit_forward(params, cfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c),
                          QLORA_SEQ, ctx=ctx, training=True)
        return jnp.mean(out ** 2)

    l_want, g_want = jax.jit(jax.value_and_grad(loss))(lora)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return dict(params=to_np(params), state=to_np(state), lora=to_np(lora), x=x, t=t, c=c,
                loss=float(l_want), grads=to_np(g_want))


@pytest.mark.parametrize("name", list(QLORA_MESHES))
def test_qlora_grads_on_meshes_match_wanq_tpu(ranks, qlora_case, name):
    """QLoRA under each mesh (8 ranks for wanq_tpu's own make_mesh(1, 2, 2,
    2)): the int8 base stored over fsdp, the Ulysses all-to-all, the ring's
    backward hops, the dp split; every rank's loss and summed adapter
    gradients against wanq_tpu's, and equal on every rank bit for bit."""
    case, dims = qlora_case, QLORA_MESHES[name]
    outs = ranks(_world(dims)).run(ME + "task_qlora_grads", params=case["params"],
                                   state=case["state"], lora_np=case["lora"], x=case["x"],
                                   t=case["t"], c=case["c"], dims=dims)
    for loss, grads in outs:
        np.testing.assert_allclose(loss, case["loss"], rtol=2e-4)
        assert sorted(grads) == sorted(k for k in case["grads"] if k != "__scale__")
        for k, (ga, gb) in grads.items():
            np.testing.assert_allclose(gb, case["grads"][k]["b"], rtol=5e-3, atol=1e-6)
            np.testing.assert_allclose(ga, case["grads"][k]["a"], rtol=5e-3, atol=1e-6)
    for loss, grads in outs[1:]:
        assert loss == outs[0][0]
        assert all(np.array_equal(g, w) for k in grads for g, w in zip(grads[k], outs[0][1][k]))


def test_qlora_step_under_a_plan_keeps_the_adapters_equal(ranks, qlora_case):
    """make_qlora_distill_step(plan=) on fsdp2 x sp2 (remat: each block's
    gathers and all-to-alls run again in the backward): the adapters after one
    step are equal on every rank bit for bit and equal the port's planless
    step's."""
    case = qlora_case
    rng = np.random.default_rng(8)
    cfg = tiny_config(**QLORA_CFG)
    batch = {"x0": case["x"][:1], "noise": rng.normal(size=case["x"][:1].shape),
             "t": np.asarray([700.0]), "context": case["c"][:1], "null_context": case["c"][1:]}
    batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    assert batch["context"].shape == (1, cfg.text_len, cfg.text_dim)
    kw = dict(params=case["params"], state=case["state"], lora_np=case["lora"], batch=batch,
              g=4.0)
    want = task_qlora_step(dims=None, **kw)
    outs = ranks(4).run(ME + "task_qlora_step", dims=(1, 2, 2, 1), **kw)
    for loss, gnorm, lora in outs:
        assert abs(loss - want[0]) <= 1e-5 * abs(want[0])
        assert abs(gnorm - want[1]) <= 1e-5 * want[1]
        for k, (a, b) in lora.items():
            np.testing.assert_allclose(b, want[2][k][1], rtol=1e-5, atol=1e-8)
            np.testing.assert_allclose(a, want[2][k][0], rtol=1e-5, atol=1e-8)
    for loss, gnorm, lora in outs[1:]:
        assert (loss, gnorm) == outs[0][:2]
        assert all(np.array_equal(x, y) for k in lora for x, y in zip(lora[k], outs[0][2][k]))


def test_lora_step_under_fsdp_merges_into_the_gathered_weight(ranks, tiny_models):
    """make_lora_distill_step(plan=) on fsdp2 x ring2 (remat): apply_lora keeps each
    stored weight's shard and merges w + scale a b into the gathered weight; the
    loss, the gradients' norm and the adapters after one step equal the port's
    planless step's on every rank, and every rank's adapters are equal bit for
    bit."""
    from wanq_tpu_torch.training.lora import SCALE, init_lora

    _, _, pnp, (x, t, c) = tiny_models
    lora = init_lora(params_from_numpy(pnp, device="cpu"), tdit.linear_layer_names(
        tiny_config()), rank=4, seed=1, targets=r"self_attn\.(q|o)|ffn\.2")
    rng = np.random.default_rng(3)
    lora_np = {k: float(v) if k == SCALE else {"a": v["a"].numpy(), "b": (0.3 * rng.normal(
        size=tuple(v["b"].shape))).astype(np.float32)} for k, v in lora.items()}
    batch = {"x0": x[:1], "noise": x[1:], "t": np.asarray([300.0], np.float32),
             "context": c[:1], "null_context": c[1:]}
    want = task_lora_step(pnp, lora_np, batch, None, 5.0)
    outs = ranks(4).run(ME + "task_lora_step", params=pnp, lora_np=lora_np, batch=batch,
                        dims=(1, 2, 1, 2), g=5.0)
    for loss, gnorm, adapted in outs:
        assert abs(loss - want[0]) <= 1e-5 * want[0] and abs(gnorm - want[1]) <= 1e-5 * want[1]
        for k, got in adapted.items():
            # the clipped gradients: each rank's part of dW sums over the ring before
            # dW b^T, the planless run after it (2.6e-5 on q's a, whose terms cancel)
            for g_, w_ in zip(got[2:], want[2][k][2:]):
                assert _rel(w_, g_) <= 1e-4, k
            # AdamW's first step moves an element by ~lr = 1e-3 whatever the size of
            # its gradient, so a gradient near 0 turns ulp differences into 1% of that
            for g_, w_ in zip(got[:2], want[2][k][:2]):
                np.testing.assert_allclose(g_, w_, rtol=1e-5, atol=1e-5, err_msg=k)
        assert all(np.array_equal(u, w) for k in adapted for u, w in zip(adapted[k],
                                                                          outs[0][2][k]))


@pytest.mark.parametrize("dims,full_shard", [((1, 2, 1, 1), False), ((1, 2, 2, 1), True)],
                         ids=["fsdp2", "fsdp2sp2_full_shard"])
def test_full_distill_grads_under_fsdp_match_wanq_tpu(ranks, dims, full_shard):
    """make_distill_step under FSDP: every linear weight trains as its shard,
    and the gather's backward puts the whole weight's gradient into the shard
    (under full_shard a reduce-scatter over sp, whose ranks hold other
    tokens); each rank's shard gradients and replicated gradients against
    the slices of jax.grad of wanq_tpu's distillation loss."""
    import jax
    import jax.numpy as jnp

    from wanq_tpu.models import dit as jdit

    cfg_j, student_j, student = _jax_models({}, seed=8)
    _, teacher_j, teacher = _jax_models({}, seed=7)
    # tests/test_torch_distill.py's batch: 3 x 2 x 3 = 18 tokens, padded to 80
    rng = np.random.default_rng(0)
    batch = {"x0": rng.normal(size=(1, 16, 3, 4, 6)), "noise": rng.normal(size=(1, 16, 3, 4, 6)),
             "t": np.asarray([600.0]), "context": rng.normal(size=(1, 16, 64)),
             "null_context": rng.normal(size=(1, 16, 64))}
    batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    g = 4.0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    xt = (1.0 - 0.6) * jb["x0"] + 0.6 * jb["noise"]

    def loss(p):
        fwd = lambda q, c: jdit.dit_forward(q, cfg_j, xt, jb["t"], c, 80, training=True)
        tc, tu = fwd(teacher_j, jb["context"]), fwd(teacher_j, jb["null_context"])
        return jnp.mean(jnp.square(fwd(p, jb["context"]) - jax.lax.stop_gradient(
            tu + g * (tc - tu))))

    l_want, g_want = jax.jit(jax.value_and_grad(loss))(student_j)
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(g_want)[0]}
    fs = 2 if not full_shard else 4
    num = den = 0.0
    for loss_t, index, grads in ranks(_world(dims)).run(
            ME + "task_distill_grads", student=student, teacher=teacher, batch=batch, dims=dims,
            g=g, full_shard=full_shard):
        assert abs(loss_t - float(l_want)) <= 1e-5 * float(l_want)
        assert sorted(grads) == sorted(want)
        n_stored = 0
        for path, (stored, got) in grads.items():
            w = want[path]
            if stored:
                n_stored += 1
                d = 1 if path.endswith("/w") else 0
                n = w.shape[d] // fs
                w = np.take(w, np.arange(index * n, (index + 1) * n), axis=d)
            assert got.shape == w.shape, path
            num += float(np.sum((got.astype(np.float64) - w) ** 2))
            den += float(np.sum(w.astype(np.float64) ** 2))
        assert n_stored > 0
    assert np.sqrt(num / den) <= 1e-4


# ---------------------------------------------------------------------------
# calibration and the map capture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def calib_case():
    """wanq_tpu's calibration sweep (2 steps, minmax, the GPTQ Hessian regex) on
    the tiny model from its own noise, and that noise and text."""
    import jax
    import jax.numpy as jnp

    from wanq_tpu.pipelines.text2video import WanT2V as JaxWanT2V
    from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
    from wanq_tpu_torch.pipelines.text2video import compute_target_shape

    cfg_j, pj, pnp = _jax_models({}, seed=0)
    rng = np.random.default_rng(5)
    c, cn = (rng.normal(size=(1, 16, 64)).astype(np.float32) for _ in range(2))
    want = JaxWanT2V(cfg_j, pj, quant_ctx=JaxQuantCtx(
        mode="calib", collect_minmax=True, hessian_regex=HESS_REGEX)).collect_calibration(
        jnp.asarray(c), jnp.asarray(cn), seed=7, **CALIB_KW)
    shape = compute_target_shape(tiny_config(), CALIB_KW["size"], CALIB_KW["frame_num"])
    noise = np.array(jax.random.normal(jax.random.PRNGKey(7), (1, *shape), jnp.float32))
    return pnp, c, cn, noise, {k: np.asarray(v, np.float64) for k, v in want.items()}


@pytest.mark.parametrize("dims", [(1, 1, 2, 2), (2, 2, 1, 1)], ids=["sp2ring2", "dp2fsdp2"])
def test_calibration_on_meshes_matches_wanq_tpu(ranks, calib_case, dims):
    """collect_calibration under sp2 x ring2 (tokens split four ways) and dp2 x
    fsdp2 (the CFG pair split over dp, the weights stored over fsdp), 32 tokens
    (a multiple of every sp x ring, so the rows are the planless run's): the
    Hessians summed over the ranks that split the rows, the absmax / minmax
    stacks reduced by max / min, on every rank, against wanq_tpu's sweep."""
    pnp, c, cn, noise, want = calib_case
    for got in ranks(_world(dims)).run(ME + "task_calibration", params=pnp, context=c,
                                       context_null=cn, noise=noise, dims=dims):
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if k.endswith(".hess"):
                np.testing.assert_allclose(got[k], w, rtol=2e-3, atol=2e-2, err_msg=k)
            else:
                assert got[k].shape == w.shape and _rel(w, got[k]) <= 1e-5, k


@pytest.mark.parametrize("dims", [(1, 1, 2, 1), (1, 1, 1, 2)], ids=["sp2", "ring2"])
def test_capture_maps_under_a_plan_equal_the_planless_ones(ranks, tiny_models, dims):
    """capture_attn_maps (pool 8, mean) under sp2 (the rank's 2 heads) and
    ring2 (the rank's half of the sequence): the rank's heads are gathered
    over the whole sequence for the pooled map, so no pool window meets a
    shard edge, and the heads over sp after it; every rank returns the
    planless maps."""
    from wanq_tpu_torch.pipelines.text2video import WanT2V, compute_target_shape

    _, _, pnp, _ = tiny_models
    rng = np.random.default_rng(12)
    c = rng.normal(size=(1, 16, 64)).astype(np.float32)
    lat = rng.normal(size=(1, *compute_target_shape(tiny_config(), (64, 64), 5))).astype(
        np.float32)
    want = WanT2V(tiny_config(), params_from_numpy(pnp, device="cpu"), device="cpu"
                  ).capture_attn_maps(torch.from_numpy(c), size=(64, 64), frame_num=5, pool=8,
                                      latents=torch.from_numpy(lat))
    for got in ranks(2).run(ME + "task_capture", params=pnp, context=c, latents=lat, dims=dims):
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].shape == w.shape == (4, 4, 4)
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-7, err_msg=k)


def test_get_calib_data_under_sp2_ring2_writes_the_one_process_npz(ranks, tmp_path):
    """get_calib_data --ulysses_size 2 --ring_size 2 --dit_fsdp (fsdp = 4 // 4
    = 1) in 4 processes, with the Hessians and the map capture: only rank 0
    writes, and its npz holds the one-process run's entries."""
    from wanq_tpu_torch.cli import get_calib_data

    base = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--random_init",
            "--device", "cpu", "--sample_steps", "2", "--collect_minmax", "--collect_hessian",
            HESS_REGEX, "--attn_map_pool", "8", "--attn_map_reduce", "mean",
            # guidance 2: CFG 5 grows the ranks' ulp differences (one-thread
            # products) over the steps on the tiny random model
            "--sample_guide_scale", "2"]
    one = np.load(get_calib_data.generate(get_calib_data.parse_args(
        base + ["--calib_save_path", str(tmp_path / "one.npz")])))
    four = str(tmp_path / "four.npz")
    paths = ranks(4).run(ME + "task_calib_cli", argv=base + [
        "--ulysses_size", "2", "--ring_size", "2", "--dit_fsdp", "--calib_save_path", four])
    assert paths == [four, None, None, None]
    got = np.load(four)
    assert sorted(got.files) == sorted(one.files)
    assert int(got["attn_map_pool"]) == 8 and got["blocks.0.self_attn.attn_map"].shape == (
        2, 4, 4, 4)
    for k in one.files:  # the second step's stats see the first step's ulp differences
        if k.endswith(".hess"):  # sums over other splits of the rows
            assert _rel(one[k], got[k]) <= 1e-5, k
        else:
            np.testing.assert_allclose(got[k], one[k], rtol=1e-4, atol=1e-6, err_msg=k)
