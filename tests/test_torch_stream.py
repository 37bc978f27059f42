"""The streamed quantized base (quant/stream.py) and the generators it draws
from (models/dit.py: make_param_generator, make_block_generator,
make_nonblock_generator) in the port against wanq_tpu on the CPU.

The port's generators draw from a torch.Generator (as ``--random_init`` on
the card), not jax.random, so their bits differ from wanq_tpu's by design:
their trees, shapes and dtypes are held equal to wanq_tpu's, their moments
to each scheme's (as tests/test_torch_14b.py holds init_params_on_device's)
and their draws to be a function of the seed. Where a test holds the
streamed build against wanq_tpu's it hands wanq_tpu's generator draws (and
its head redraw) across as numpy, and runs wanq_tpu's builder eagerly
(``jax.disable_jit``, as tests/test_torch_distill.py runs its references).
Tolerances:
- the per-layer state of the plain W4A8 build: int codes equal bit for bit,
  the float leaves within rel 1e-6;
- the SVDQuant low-rank build (the sketch handed across too, as
  tests/test_torch_svdquant.py does): the bf16 factors' product within rel
  2e-3 (that file's 1e-3 is on outlier-heavy weights; the rank-8 subspace of
  these Gaussian weights is poorly separated, so QR and SVD in another
  library move it more: 1.5e-3 at worst over the 20 layers), the residual's
  codes >= 99.9% equal and never more than one apart, the scales within rel
  1e-4;
- the port's streamed forward against its conventional build from the same
  draws: tests/test_stream.py:31's rtol = atol = 1e-5;
- one QLoRA step on the streamed base against wanq_tpu's step on its own
  streamed base: the loss within 1e-4 and the adapter gradients within
  5e-4 (tests/test_torch_distill.py's QLoRA tolerances).
The per-block policy divergence from wanq_tpu (which applies blocks.0's
policy to every block) is pinned.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.configs import tiny_config as jax_tiny_config
from wanq_tpu.models import dit as jdit
from wanq_tpu.quant import QuantConfig as JaxQuantConfig
from wanq_tpu.quant import stream as jstream
from wanq_tpu.training import distill as jdistill
from wanq_tpu.training import lora as jlora
from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.params import params_from_numpy, quant_state_from_numpy
from wanq_tpu_torch.quant import QuantConfig, build_streamed_quant_base
from wanq_tpu_torch.quant import stream as tstream
from wanq_tpu_torch.quant import svd as tsvd
from wanq_tpu_torch.quant.ptq import params_get, prepare_quant_state
from wanq_tpu_torch.quant.qlinear import QuantCtx
from wanq_tpu_torch.quant.quantizers import unpack_int4
from wanq_tpu_torch.training import distill as tdistill
from wanq_tpu_torch.training import lora as tlora

QDICT = {
    "remain_fp_regex": r"text_embedding|time_embedding|time_projection|head\.head",
    "weight": {"n_bits": 4, "sym": False},
    "act": {"n_bits": 8, "sym": True},
}
# a static ffn.2 (the synthetic +-8 bounds) and W8 on the o projections
MIXED = {**QDICT, "weight": {"n_bits": [4, 8], "sym": False},
         "act": {"n_bits": 8, "sym": True, "static_regex": r"ffn\.2"},
         "mixed_precision": {"weight": {"layer_name_regex": ["", "", r"\.o$"]}}}
INT_KEYS = ("w_int4", "w_int8", "w_int4g")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _signature(tree):
    return sorted((k, None if v is None else (tuple(v.shape), str(v.dtype).split(".")[-1]))
                  for k, v in _leaves(tree))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


# ---------------------------------------------------------------------------
# the generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model_type", ["t2v", "i2v"])
def test_generator_trees_match_jax(model_type):
    """Tree, shapes and dtypes of each generator's draw equal wanq_tpu's (a
    bf16 config, so the weights' dtype is checked too); each draw lands on
    the device asked for."""
    kw = dict(model_type=model_type, param_dtype="bfloat16")
    if model_type == "i2v":
        kw.update(in_dim=36, clip_dim=80)
    cfg, jcfg = tiny_config(**kw), jax_tiny_config(**kw)
    key = jax.random.PRNGKey(0)
    pairs = ((tdit.make_block_generator(cfg, device="cpu")(100),
              jdit.make_block_generator(jcfg)(key)),
             (tdit.make_nonblock_generator(cfg, device="cpu")(0),
              jdit.make_nonblock_generator(jcfg)(key)),
             (tdit.make_param_generator(cfg, device="cpu")(0),
              jdit.make_param_generator(jcfg)(key)))
    for got, want in pairs:
        assert _signature(got) == _signature(want)
        assert all(v.device.type == "cpu" for _, v in _leaves(got) if v is not None)
    assert "blocks" not in pairs[1][0] and len(pairs[2][0]["blocks"]) == cfg.num_layers


@pytest.fixture
def small_draw_block(monkeypatch):
    """Draw blocks of 1000 elements, so every weight draws in several."""
    monkeypatch.setattr(tdit, "_DRAW_BLOCK", 1000)


def test_block_generator_moments_per_scheme(small_draw_block):
    """Each weight of a drawn block has its scheme's moments: xavier-uniform
    (mean within 4 standard errors of 0, the variance bound^2 / 3 within
    4 sqrt(2 / n) relative, inside the bound), modulation N(0, 1) / sqrt(dim);
    biases zero, norms one."""
    cfg = tiny_config(dim=256, ffn_dim=512, param_dtype="bfloat16")
    block = tdit.make_block_generator(cfg, device="cpu")(101)
    seen = set()
    for name, v in _leaves(block):
        if v is None:
            continue
        x = v.double()
        n = x.numel()
        if name.endswith(".w") and x.ndim == 2:
            bound = math.sqrt(6.0 / sum(x.shape))
            var = bound ** 2 / 3
            assert x.abs().max() <= bound * (1 + 2 ** -8), name
            assert abs(x.mean().item()) <= 4 * math.sqrt(var / n), name
            assert abs(x.var().item() / var - 1) <= 4 * math.sqrt(2 / n), name
            seen.add("xavier")
        elif name == "modulation":
            assert v.dtype == torch.float32 and v.shape == (1, 6, cfg.dim)
            assert abs(x.var().item() * cfg.dim - 1) <= 4 * math.sqrt(2 / n), name
            seen.add("modulation")
        elif name.endswith(".b"):
            assert not x.any(), name
        else:
            assert torch.equal(x, torch.ones_like(x)) or not x.any(), name
    assert seen == {"xavier", "modulation"}
    # the prelude: normal x 0.02 embeddings, a zero head
    pre = tdit.make_nonblock_generator(cfg, device="cpu")(0)
    for name in ("text_embedding.0", "text_embedding.2", "time_embedding.0"):
        w = params_get(pre, name)["w"].double()
        assert abs(w.var().item() / 0.02 ** 2 - 1) <= 4 * math.sqrt(2 / w.numel()), name
    assert not pre["head"]["head"]["w"].any()


def test_generators_are_deterministic_per_seed(small_draw_block):
    cfg = tiny_config()
    for make in (tdit.make_block_generator, tdit.make_nonblock_generator,
                 tdit.make_param_generator):
        gen = make(cfg, device="cpu")
        a, again, other = (list(_leaves(gen(s))) for s in (100, 100, 101))
        assert all(x[1] is None or torch.equal(x[1], y[1]) for x, y in zip(a, again))
        drawn = [(x[1], z[1]) for x, z in zip(a, other)
                 if x[1] is not None and x[1].std() > 0]
        assert drawn and not any(torch.equal(x, z) for x, z in drawn)
    # the param generator is init_params_on_device's draw
    whole = tdit.make_param_generator(cfg, device="cpu")(5)
    for (ka, va), (kb, vb) in zip(_leaves(whole),
                                  _leaves(tdit.init_params_on_device(cfg, 5, device="cpu"))):
        assert ka == kb and (va is None or torch.equal(va, vb))


# ---------------------------------------------------------------------------
# the streamed build against wanq_tpu's
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's streamed build draws wanq_tpu's generators' weights (and
    its head redraw) for the same seeds, handed across as numpy."""

    def to_torch(tree, device):
        return params_from_numpy(jax.tree.map(np.asarray, tree), device=device)

    def block_gen(cfg, device="cuda"):
        gen = jdit.make_block_generator(jax_tiny_config())
        return lambda seed: to_torch(gen(jax.random.PRNGKey(seed)), device)

    def nonblock_gen(cfg, device="cuda"):
        gen = jdit.make_nonblock_generator(jax_tiny_config())
        return lambda seed: to_torch(gen(jax.random.PRNGKey(seed)), device)

    def head(shape, dtype, device):
        w = 0.02 * jax.random.normal(jax.random.PRNGKey(tstream.HEAD_SEED), tuple(shape))
        return torch.from_numpy(np.array(w, np.float32)).to(device=device, dtype=dtype)

    monkeypatch.setattr(tdit, "make_block_generator", block_gen)
    monkeypatch.setattr(tdit, "make_nonblock_generator", nonblock_gen)
    monkeypatch.setattr(tstream, "head_draw", head)


def _jax_base(qdict):
    """wanq_tpu's streamed base, built eagerly: (stacked params, qctx)."""
    with jax.disable_jit():
        stacked, qctx, _ = jstream.build_streamed_quant_base(
            jax_tiny_config(), JaxQuantConfig.from_dict(qdict))
    return stacked, qctx


def _jax_layers(qctx, num_layers):
    """wanq_tpu's stacked state as the port's per-layer state."""
    flat = {f"blocks.{i}.{ln}": {k: np.asarray(v[i]) for k, v in st.items()}
            for ln, st in qctx.scan_state.items() for i in range(num_layers)}
    return quant_state_from_numpy(flat, device="cpu")


def test_streamed_state_matches_jax(jax_draws):
    cfg = tiny_config()
    params, qctx, qbytes = build_streamed_quant_base(cfg, QuantConfig.from_dict(QDICT),
                                                     device="cpu")
    _, jctx = _jax_base(QDICT)
    want = _jax_layers(jctx, cfg.num_layers)
    assert sorted(qctx.state) == sorted(want)
    assert len(qctx.state) == 10 * cfg.num_layers
    for name, st in qctx.state.items():
        assert sorted(st) == sorted(want[name]), name
        for key, leaf in st.items():
            w = want[name][key]
            assert leaf.dtype == w.dtype and leaf.shape == w.shape, (name, key)
            if key in INT_KEYS:
                assert torch.equal(leaf, w), (name, key)
            else:
                np.testing.assert_allclose(leaf.numpy(), w.numpy(), rtol=1e-6, atol=0,
                                           err_msg=f"{name}|{key}")
    assert qbytes == sum(np.asarray(v).nbytes for st in jctx.scan_state.values()
                         for v in st.values())
    assert all(params["blocks"][i]["self_attn"]["q"]["w"].shape == (1, 1)
               for i in range(cfg.num_layers))
    assert set(qctx.policies) == {f"blocks.{i}.{ln}" for i in range(cfg.num_layers)
                                  for ln in tstream.BLOCK_LINEARS}


def test_streamed_lowrank_state_matches_jax(jax_draws, monkeypatch):
    """The SVDQuant branch through the streamed build, from the same sketch."""
    def draw(n, r, seed, device):
        g = jax.random.normal(jax.random.PRNGKey(seed), (n, r), jnp.float32)
        return torch.from_numpy(np.array(g)).to(device)

    monkeypatch.setattr(tsvd, "gaussian_sketch", draw)
    qd = {**QDICT, "weight": dict(QDICT["weight"], lowrank_rank=8)}
    cfg = tiny_config()
    _, qctx, _ = build_streamed_quant_base(cfg, QuantConfig.from_dict(qd), device="cpu")
    _, jctx = _jax_base(qd)
    want = _jax_layers(jctx, cfg.num_layers)
    for name, st in qctx.state.items():
        w = want[name]
        assert sorted(st) == sorted(w) and st["lowrank_a"].dtype == torch.bfloat16, name
        prod = (st["lowrank_a"].float() @ st["lowrank_b"].float()).numpy()
        assert _rel((w["lowrank_a"].float() @ w["lowrank_b"].float()).numpy(), prod) <= 2e-3
        codes = unpack_int4(st["w_int4"]).numpy().astype(np.int32)
        diff = np.abs(codes - unpack_int4(w["w_int4"]).numpy().astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, name
        np.testing.assert_allclose(st["scale_w"].numpy(), w["scale_w"].numpy(), rtol=1e-4,
                                   atol=0, err_msg=name)


def _conventional(cfg, qcfg):
    """The port's conventional build from the streamed build's draws."""
    params = tdit.make_nonblock_generator(cfg, device="cpu")(tstream.PRELUDE_SEED)
    w = params["head"]["head"]["w"]
    params["head"]["head"]["w"] = tstream.head_draw(w.shape, w.dtype, "cpu")
    gen = tdit.make_block_generator(cfg, device="cpu")
    params["blocks"] = [gen(tstream.BLOCK_SEED + i) for i in range(cfg.num_layers)]
    names = [f"blocks.{i}.{ln}" for i in range(cfg.num_layers) for ln in tstream.BLOCK_LINEARS]
    calib = {f"{n}.{s}": np.asarray([v], np.float32) for n in names
             for s, v in (("act_max", 8.0), ("act_min", -8.0))}
    pol, state, rot = prepare_quant_state(params, names, qcfg, calib=calib, targets="int8")
    return params, QuantCtx(mode="int8", policies=pol, state=state, rotations=rot)


@pytest.mark.parametrize("qdict", [QDICT, MIXED], ids=["w4a8", "w4w8_static_ffn2"])
def test_streamed_forward_matches_conventional_build(rng, qdict):
    """The port's streamed base against prepare_quant_state on the same
    draws: equal state, and the forward within tests/test_stream.py:31's
    tolerance (the streamed base's FP weights are stripped placeholders)."""
    cfg = tiny_config()
    qcfg = QuantConfig.from_dict(qdict)
    params_s, qctx_s, _ = build_streamed_quant_base(cfg, qcfg, device="cpu")
    params_c, qctx_c = _conventional(cfg, qcfg)
    for name, st in qctx_c.state.items():
        assert all(torch.equal(v, qctx_s.state[name][k]) for k, v in st.items()), name
    x = torch.from_numpy(rng.normal(size=(1, cfg.in_dim, 2, 8, 8)).astype(np.float32))
    t = torch.tensor([500.0])
    txt = torch.from_numpy(rng.normal(size=(1, cfg.text_len, cfg.text_dim)).astype(np.float32))
    out_s = tdit.dit_forward(params_s, cfg, x, t, txt, 32, ctx=qctx_s)
    out_c = tdit.dit_forward(params_c, cfg, x, t, txt, 32, ctx=qctx_c)
    np.testing.assert_allclose(out_s.numpy(), out_c.numpy(), rtol=1e-5, atol=1e-5)
    if qdict is MIXED:
        assert "w_int8" in qctx_s.state["blocks.1.cross_attn.o"]
        assert "delta_a" in qctx_s.state["blocks.0.ffn.2"]


def test_per_block_policy_divergence_from_jax(jax_draws):
    """A regex that names one block: the port quantizes block 1's ffn.2 at W8
    and block 0's at W4, as the config says; wanq_tpu resolves blocks.0's
    policy and applies it to every block (its scan stacks one policy a
    class), so its block 1 stays W4."""
    qd = {**QDICT, "weight": {"n_bits": [4, 8], "sym": False},
          "mixed_precision": {"weight": {"layer_name_regex": ["", "", r"blocks\.1\.ffn\.2"]}}}
    cfg = tiny_config()
    _, qctx, _ = build_streamed_quant_base(cfg, QuantConfig.from_dict(qd), device="cpu")
    assert "w_int8" in qctx.state["blocks.1.ffn.2"] and "w_int4" in qctx.state["blocks.0.ffn.2"]
    assert qctx.policies["blocks.1.ffn.2"].weight.active_bits == 8
    assert qctx.policies["blocks.0.ffn.2"].weight.active_bits == 4
    _, jctx = _jax_base(qd)
    assert "w_int4" in jctx.scan_state["ffn.2"] and "w_int8" not in jctx.scan_state["ffn.2"]
    assert jctx.policies["blocks.1.ffn.2"].weight.active_bits == 4
    # the port's block 0 is wanq_tpu's, bit for bit
    want = _jax_layers(jctx, cfg.num_layers)
    assert torch.equal(qctx.state["blocks.0.ffn.2"]["w_int4"], want["blocks.0.ffn.2"]["w_int4"])


def test_qlora_step_on_streamed_base_matches_jax(jax_draws, rng):
    """One QLoRA step (rank 4, trained adapters b != 0, remat, lr 1e-4) on the
    port's streamed W4A8 base against wanq_tpu's step on its own streamed
    base (scan=True, as tools/qlora_smoke.py's 14B mode runs it)."""
    cfg, jcfg = tiny_config(), jax_tiny_config()
    params, qctx, _ = build_streamed_quant_base(cfg, QuantConfig.from_dict(QDICT), device="cpu")
    stacked, jctx = _jax_base(QDICT)
    targets = r"self_attn\.(q|k|v|o)|ffn\.(0|2)"
    lt = tlora.init_lora_from_cfg(cfg, rank=4, seed=3, targets=targets, device="cpu")
    lj = jlora.init_lora_from_cfg(jcfg, rank=4, seed=3, targets=targets)
    for name in tlora.adapters(lt):
        b = (rng.normal(size=tuple(lt[name]["b"].shape)) * 0.5).astype(np.float32)
        lj[name]["b"], lt[name]["b"] = jnp.asarray(b), torch.from_numpy(b)
    kw = dict(learning_rate=1e-4, seq_len=80, remat=True)
    dcfg, jd = tdistill.DistillConfig(**kw), jdistill.DistillConfig(**kw)
    state_j, tx_j = jdistill.init_train_state(lj, jd)
    state_t, tx_t = tdistill.init_train_state(lt, dcfg)
    b = {"x0": rng.normal(size=(1, 16, 3, 4, 6)), "noise": rng.normal(size=(1, 16, 3, 4, 6)),
         "t": np.asarray([500.0]), "c": rng.normal(size=(1, cfg.text_len, cfg.text_dim)),
         "n": rng.normal(size=(1, cfg.text_len, cfg.text_dim))}
    b = {k: v.astype(np.float32) for k, v in b.items()}
    with jax.disable_jit():
        out_j = jdistill.make_qlora_distill_step(jcfg, jd, tx_j, scan=True)(
            state_j.params, state_j.ema_params, state_j.opt_state, stacked, jctx,
            *(jnp.asarray(b[k]) for k in ("x0", "noise", "t", "c", "n")), jnp.float32(3.0))
    out_t = tdistill.make_qlora_distill_step(cfg, dcfg, tx_t)(
        state_t.params, state_t.ema_params, state_t.opt_state, params, qctx,
        *(torch.from_numpy(b[k]) for k in ("x0", "noise", "t", "c", "n")), 3.0)
    loss_j, loss_t = float(out_j[3]), float(out_t[3])
    assert math.isfinite(loss_t) and abs(loss_t - loss_j) <= 1e-4 * abs(loss_j)
    assert abs(float(out_t[4]) - float(out_j[4])) <= 5e-4 * float(out_j[4])
    grads_j = jax.tree.map(lambda m: np.asarray(m) / 0.1, out_j[2][1][0].mu)
    num = den = 0.0
    for name, ab in tlora.adapters(state_t.params).items():
        for leaf in "ab":
            g, w = ab[leaf].grad.double().numpy(), np.asarray(grads_j[name][leaf], np.float64)
            num += float(np.sum((g - w) ** 2))
            den += float(np.sum(w ** 2))
    assert math.sqrt(num / den) <= 5e-4
