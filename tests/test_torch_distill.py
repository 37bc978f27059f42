"""The port's distillation trainer against wanq_tpu's on the CPU: one step of
each of the three step builders from the same state (loss, gradients,
updated parameters or adapters, EMA, the optimizer's moments) against
optax, ``draw_guidance``, the global-norm clip, and the data path (the
dataset, the length-grouped batches, the prefetcher).

Each builder runs on ``tiny`` (f32) from one state in both packages: the
JAX step as wanq_tpu builds it (jitted for the FP builders; run eagerly for
QLoRA, whose fake-quant arithmetic XLA's jit changes: jit and eager JAX read
1.5e-3 apart on such a model's gradients, see tests/test_torch_attn_grad.py).
Tolerances: the updated tree and its EMA within rel-L2 1e-5; for every
parameter trained (``make_distill_step``, a teacher of other weights) the
loss within rel 1e-5 and the gradients (the clipped ones, which optax's first
moment holds as 0.1 g) and the pre-clip global norm within 1e-4 over the
whole tree. The adapter steps are held to a loss within rel 1e-4 and
gradients within 5e-4: their teacher is the student's own base, so the loss
is the square of a residual of the same forward, and the head's product runs
on bf16 operands even in an f32 config (``qlinear``'s default compute dtype in
both packages), where the ~6e-8 differences of its f32 input flip bf16
roundings: on identical inputs the two heads read 5.4e-5 apart. Measured
(this file's draws): FP LoRA loss 1.7e-5, gradients 2.4e-4, adapters
6.6e-6; QLoRA loss 1.0e-6, gradients 1.2e-4, adapters 8e-8. With b ten times
smaller the residual is dominated by v_cond - v_uncond, 1.5% of v, and the
QLoRA loss reads 1.4e-4 apart.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu.quant.ptq import prepare_quant_state as jax_prepare
from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx
from wanq_tpu.training import data as jdata
from wanq_tpu.training import distill as jdistill
from wanq_tpu.training import lora as jlora
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import quant_state_from_numpy
from wanq_tpu_torch.quant.qlinear import QuantCtx
from wanq_tpu_torch.training import data as tdata
from wanq_tpu_torch.training import distill as tdistill
from wanq_tpu_torch.training import lora as tlora

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W4A8_MIXED = os.path.join(ROOT, "quant_configs", "wan_w4a8_mixed.yaml")
SEQ = 80  # 3 x 4 x 6 latents -> 72 tokens, padded
# the adapters' b: a trained adapter that moves the prediction by about its own
# size (|v_student - v_cond| / |v_student| = 1.2 on this model)
B_SCALE = 0.5


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k != "__scale__":
                out.update(_flat(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree.detach() if torch.is_tensor(tree) else tree,
                                      np.float64)
    return out


def _tree_rel(got, want) -> float:
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    num = sum(np.sum((g[k] - w[k]) ** 2) for k in w)
    return float(np.sqrt(num / sum(np.sum(w[k] ** 2) for k in w)))


def _models(seed):
    cfg_j, cfg_t = jax_tiny_config(), tiny_config()
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(seed))
    pt = tdit.init_params(cfg_t, seed, device="cpu")
    hw = (np.random.default_rng(seed + 100).normal(size=(cfg_t.dim, 64)) * 0.02).astype(
        np.float32)
    pj["head"]["head"]["w"] = jnp.asarray(hw)
    pt["head"]["head"]["w"] = torch.from_numpy(hw)
    return cfg_j, pj, cfg_t, pt


def _batch(seed, cfg):
    rng = np.random.default_rng(seed)
    b = {"x0": rng.normal(size=(1, 16, 3, 4, 6)), "noise": rng.normal(size=(1, 16, 3, 4, 6)),
         "t": np.asarray([600.0]),
         "context": rng.normal(size=(1, cfg.text_len, cfg.text_dim)),
         "null_context": rng.normal(size=(1, cfg.text_len, cfg.text_dim))}
    b = {k: v.astype(np.float32) for k, v in b.items()}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _adam_mu(opt_state):
    """optax chain(clip, adamw): the first moment, 0.1 x the clipped gradient
    after one step."""
    return opt_state[1][0].mu


def _check_step(out_j, out_t, tx_t, trained_t, loss_tol=1e-5, grad_tol=1e-4):
    params_j, ema_j, opt_j, loss_j, gnorm_j = out_j
    params_t, ema_t, _, loss_t, gnorm_t = out_t
    assert abs(float(loss_t) - float(loss_j)) <= loss_tol * abs(float(loss_j))
    assert abs(float(gnorm_t) - float(gnorm_j)) <= grad_tol * float(gnorm_j)
    # the clipped gradients: the port's .grad after the in-place clip, and
    # optax's first moment / (1 - b1)
    grads_j = jax.tree.map(lambda m: m / 0.1, _adam_mu(opt_j))
    grads_t = tdistill._tree_map(lambda t: t.grad if t.requires_grad else t, trained_t)
    assert _tree_rel(grads_t, grads_j) <= grad_tol
    assert _tree_rel(params_t, params_j) <= 1e-5
    assert _tree_rel(ema_t, ema_j) <= 1e-5
    exp_avg = {id(p): s["exp_avg"] for p, s in tx_t.state.items()}
    mu_t = tdistill._tree_map(lambda t: exp_avg[id(t)] if t.requires_grad else t, trained_t)
    assert _tree_rel(mu_t, _adam_mu(opt_j)) <= grad_tol


def test_draw_guidance_matches_jax():
    for seed in range(12):
        assert tdistill.draw_guidance(seed, 5.0) == jdistill.draw_guidance(seed, 5.0)
        assert tdistill.draw_guidance(seed, 3.0) == jdistill.draw_guidance(seed, 3.0)


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_clip_by_global_norm_matches_optax(rng, scale):
    """Both branches: a norm below the limit leaves the gradients as they
    are, one above scales them by max / norm (no epsilon)."""
    import optax

    g = [(rng.normal(size=s) * scale).astype(np.float32) for s in ((3, 4), (7,))]
    max_norm = 0.05
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in g], None)
    got = [torch.from_numpy(a.copy()) for a in g]
    norm = tdistill.clip_by_global_norm_(got, max_norm)
    assert abs(float(norm) - float(optax.global_norm([jnp.asarray(a) for a in g]))) <= 1e-6 * float(norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_make_distill_step_matches_optax():
    """Every parameter trains (lr 1e-3, clip 1.0), the teacher another
    tree."""
    cfg_j, teacher_j, cfg_t, teacher_t = _models(7)
    _, student_j, _, student_t = _models(8)
    dcfg = tdistill.DistillConfig(learning_rate=1e-3, seq_len=SEQ, max_grad_norm=0.05)
    jd = jdistill.DistillConfig(learning_rate=1e-3, seq_len=SEQ, max_grad_norm=0.05)
    state_j, tx_j = jdistill.init_train_state(student_j, jd)
    state_t, tx_t = tdistill.init_train_state(student_t, dcfg)
    bj, bt = _batch(0, cfg_t)
    g = tdistill.draw_guidance(0, dcfg.cfg_mid)
    out_j = jdistill.make_distill_step(cfg_j, jd, tx_j)(
        state_j.params, state_j.ema_params, state_j.opt_state, teacher_j, bj["x0"], bj["noise"],
        bj["t"], bj["context"], bj["null_context"], jnp.float32(g))
    step = tdistill.make_distill_step(cfg_t, dcfg, tx_t)
    out_t = step(state_t.params, state_t.ema_params, state_t.opt_state, teacher_t, bt["x0"],
                 bt["noise"], bt["t"], bt["context"], bt["null_context"], g)
    assert float(out_j[4]) > dcfg.max_grad_norm  # the clip scaled
    _check_step(out_j, out_t, tx_t, state_t.params)
    # the caller's tree is the untouched teacher-like copy
    assert torch.equal(student_t["blocks"][0]["ffn"]["0"]["w"],
                       tdit.init_params(cfg_t, 8, device="cpu")["blocks"][0]["ffn"]["0"]["w"])


def test_make_lora_distill_step_matches_optax(rng):
    """FP LoRA from adapters with b != 0 (lr 1e-3): the base is the
    teacher."""
    cfg_j, pj, cfg_t, pt = _models(7)
    names = jdit.linear_layer_names(cfg_j)
    lj, lt = jlora.init_lora(pj, names, rank=4, seed=1), tlora.init_lora(pt, names, rank=4,
                                                                        seed=1)
    for name in tlora.adapters(lt):
        b = (rng.normal(size=tuple(lt[name]["b"].shape)) * B_SCALE).astype(np.float32)
        lj[name]["b"], lt[name]["b"] = jnp.asarray(b), torch.from_numpy(b)
    dcfg = tdistill.DistillConfig(learning_rate=1e-3, seq_len=SEQ, max_grad_norm=100.0)
    jd = jdistill.DistillConfig(learning_rate=1e-3, seq_len=SEQ, max_grad_norm=100.0)
    state_j, tx_j = jdistill.init_train_state(lj, jd)
    state_t, tx_t = tdistill.init_train_state(lt, dcfg)
    bj, bt = _batch(1, cfg_t)
    g = tdistill.draw_guidance(1, dcfg.cfg_mid)
    out_j = jdistill.make_lora_distill_step(cfg_j, jd, tx_j)(
        state_j.params, state_j.ema_params, state_j.opt_state, pj, bj["x0"], bj["noise"],
        bj["t"], bj["context"], bj["null_context"], jnp.float32(g))
    out_t = tdistill.make_lora_distill_step(cfg_t, dcfg, tx_t)(
        state_t.params, state_t.ema_params, state_t.opt_state, pt, bt["x0"], bt["noise"],
        bt["t"], bt["context"], bt["null_context"], g)
    assert float(out_j[4]) < dcfg.max_grad_norm  # the clip left them
    _check_step(out_j, out_t, tx_t, state_t.params, loss_tol=1e-4, grad_tol=5e-4)
    assert float(out_t[0]["__scale__"]) == float(out_j[0]["__scale__"]) == 1.0


def test_make_qlora_distill_step_matches_optax(rng):
    """QLoRA over a W4/W8 int8 base (wan_w4a8_mixed.yaml, the FP copies of
    the quantized weights stripped) with adapters b != 0, alpha 8 (scale 2,
    which stays a constant); lr 1e-4 and remat, as the card's run."""
    from wanq_tpu.quant.ptq import strip_quantized_weights as jstrip
    from wanq_tpu_torch.quant.ptq import strip_quantized_weights
    from wanq_tpu_torch.quant.config import QuantConfig

    cfg_j, pj, cfg_t, pt = _models(7)
    names = jdit.linear_layer_names(cfg_j)
    pol, st, rot = jax_prepare(pj, names, JaxQuantConfig.from_yaml(W4A8_MIXED), targets="int8")
    jctx = JaxQuantCtx(mode="int8", policies=pol, state=st, rotations=rot)
    pol_t = QuantConfig.from_yaml(W4A8_MIXED).resolve_all(names)
    tctx = QuantCtx(mode="int8", policies=pol_t, state=quant_state_from_numpy(
        jax.tree.map(np.asarray, st), device="cpu"))
    pj, pt = jstrip(pj, pol), strip_quantized_weights(pt, pol_t)
    lj = jlora.init_lora_from_cfg(cfg_j, rank=4, seed=2, alpha=8.0)
    lt = tlora.init_lora_from_cfg(cfg_t, rank=4, seed=2, alpha=8.0, device="cpu")
    for name in tlora.adapters(lt):
        b = (rng.normal(size=tuple(lt[name]["b"].shape)) * B_SCALE).astype(np.float32)
        lj[name]["b"], lt[name]["b"] = jnp.asarray(b), torch.from_numpy(b)
    kw = dict(learning_rate=1e-4, seq_len=SEQ, remat=True)
    dcfg, jd = tdistill.DistillConfig(**kw), jdistill.DistillConfig(**kw)
    state_j, tx_j = jdistill.init_train_state(lj, jd)
    state_t, tx_t = tdistill.init_train_state(lt, dcfg)
    bj, bt = _batch(2, cfg_t)
    g = tdistill.draw_guidance(2, dcfg.cfg_mid)
    with jax.disable_jit():
        out_j = jdistill.make_qlora_distill_step(cfg_j, jd, tx_j)(
            state_j.params, state_j.ema_params, state_j.opt_state, pj, jctx, bj["x0"],
            bj["noise"], bj["t"], bj["context"], bj["null_context"], jnp.float32(g))
    out_t = tdistill.make_qlora_distill_step(cfg_t, dcfg, tx_t)(
        state_t.params, state_t.ema_params, state_t.opt_state, pt, tctx, bt["x0"], bt["noise"],
        bt["t"], bt["context"], bt["null_context"], g)
    _check_step(out_j, out_t, tx_t, state_t.params, loss_tol=1e-4, grad_tol=5e-4)
    assert float(out_t[0]["__scale__"]) == 2.0


def test_distill_step_loop_reduces_the_loss():
    """The port's outer loop (guidance drawn from the step count): 6 steps of
    FP LoRA at lr 1e-2 lower the loss; the EMA lags the adapters."""
    _, _, cfg_t, pt = _models(7)
    lora = tlora.init_lora(pt, tdit.linear_layer_names(cfg_t), rank=4, seed=1)
    dcfg = tdistill.DistillConfig(learning_rate=1e-2, seq_len=SEQ)
    state, tx = tdistill.init_train_state(lora, dcfg)
    step = tdistill.make_lora_distill_step(cfg_t, dcfg, tx)
    _, bt = _batch(3, cfg_t)
    losses = []
    for _ in range(6):
        state, info = tdistill.distill_step(state, step, pt, bt, dcfg)
        assert np.isfinite(info["loss"]) and np.isfinite(info["grad_norm"])
        losses.append(info["loss"])
    assert state.step == 6 and losses[-1] < losses[0]
    name = next(iter(tlora.adapters(lora)))
    b, ema = state.params[name]["b"].detach(), state.ema_params[name]["b"]
    assert 0 < float(ema.norm()) < float(b.norm())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _dataset(tmp_path, rng):
    entries = []
    for i, f in enumerate((3, 5, 3, 5, 3, 2, 5)):
        lat = rng.normal(size=(4, f, 2, 3)).astype(np.float32)
        ctx = rng.normal(size=(6, 8)).astype(np.float32)
        if i % 2:
            np.savez(tmp_path / f"s{i}.npz", latents=lat)
            np.savez(tmp_path / f"c{i}.npz", ctx)
            entries.append({"latent": f"s{i}.npz", "context": f"c{i}.npz"})
        else:
            np.savez(tmp_path / f"s{i}.npz", latents=lat, context=ctx)
            entries.append({"latent": str(tmp_path / f"s{i}.npz")})
    (tmp_path / "index.json").write_text(json.dumps(entries))
    return str(tmp_path / "index.json")


@pytest.mark.parametrize("num_latent_t", [-1, 3])
def test_dataset_and_batches_match_jax(tmp_path, rng, num_latent_t):
    index = _dataset(tmp_path, rng)
    dt, dj = tdata.LatentDataset(index, num_latent_t), jdata.LatentDataset(index, num_latent_t)
    assert len(dt) == len(dj) == 7 and dt.lengths() == dj.lengths()
    for i in range(7):
        a, b = dt[i], dj[i]
        assert sorted(a) == sorted(b) == ["context", "latents"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for seed in (0, 1, 5):
        for bs in (1, 2, 3):
            assert tdata.length_grouped_batches(dt.lengths(), bs, seed) == \
                jdata.length_grouped_batches(dj.lengths(), bs, seed)


def test_prefetcher_yields_the_stacked_batches(tmp_path, rng):
    index = _dataset(tmp_path, rng)
    ds = tdata.LatentDataset(index)
    batches = tdata.length_grouped_batches(ds.lengths(), 2, seed=0)
    want = list(jdata.prefetch_to_device(jdata.LatentDataset(index), batches))
    got = list(tdata.prefetch_to_device(ds, batches, prefetch=1, device="cpu"))
    assert len(got) == len(want) == len(batches)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_prefetcher_raises_a_loading_error(tmp_path, rng):
    index = _dataset(tmp_path, rng)
    ds = tdata.LatentDataset(index)
    os.remove(tmp_path / "s2.npz")
    with pytest.raises(FileNotFoundError):
        list(tdata.prefetch_to_device(ds, [[0], [2], [4]], device="cpu"))


class _Recording(tdata.LatentDataset):
    def __init__(self, index):
        super().__init__(index)
        self.seen = []

    def __getitem__(self, i):
        self.seen.append(i)
        return super().__getitem__(i)


def test_prefetcher_stages_ahead_on_a_thread(tmp_path, rng):
    """The next batches are read while the consumer holds the first."""
    ds = _Recording(_dataset(tmp_path, rng))
    it = tdata.prefetch_to_device(ds, [[0], [2], [4]], prefetch=2, device="cpu")
    next(it)
    deadline = time.time() + 10
    while len(ds.seen) < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert ds.seen == [0, 2, 4]
    assert len(list(it)) == 2
