"""Multi-GPU serving in the port (``wanq_tpu_torch/parallel``) against
``wanq_tpu`` on the CPU.

The multi-rank tests run in gloo process groups of 2, 3 and 4 ranks (a
group the size of each test's mesh): worker processes started once per module (``_Ranks``, a rendezvous file under the
test's tmp dir, so parallel test workers never share a port) that each join
the group through ``init_distributed`` from torchrun's environment variables
and then run the task functions of this file by name. Those functions, and
this file's top level, import no JAX: the ``wanq_tpu`` oracle runs in the
test process (8 virtual CPU devices from conftest.py), imported inside the
tests. Inputs and weights are numpy arrays from a seed, fed to both packages
(``models/params.py::params_from_numpy`` / ``quant_state_from_numpy``).

Tolerances: the ring and the fold 2e-5 / 1e-4 (``tests/test_ring_attention.py``);
the sharded DiT forwards 2e-4 / 1e-3 (``tests/test_sharding.py``); the int
states 3e-3 (``tests/test_int8_mesh.py``). ``wanq_tpu``'s ring leaves the pad
q rows of a band-distant rank unspecified (its hop predicate skips shards they
see); the port's pad rows are the single-device attention's, held there.
"""

import os
import subprocess
import sys
from multiprocessing.connection import Connection

import numpy as np
import pytest
import torch

from wanq_tpu_torch.configs import tiny_config
from wanq_tpu_torch.models import dit as tdit
from wanq_tpu_torch.models.attention import TemporalWindow
from wanq_tpu_torch.models.params import params_from_numpy, quant_state_from_numpy
from wanq_tpu_torch.parallel import ShardingPlan, make_mesh, shard_params
from wanq_tpu_torch.parallel import launch, ring, sharding
from wanq_tpu_torch.quant.qlinear import QuantCtx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
W8A8 = os.path.join(ROOT, "quant_configs", "wan_w8a8_speed.yaml")
W4A8 = os.path.join(ROOT, "quant_configs", "wan_w4a8_mixed.yaml")
SMALL = dict(dim=256, num_heads=2, num_layers=2, ffn_dim=512, text_len=32, text_dim=64,
             freq_dim=64)
TIMEOUT = 240  # seconds a task may take on every rank

# the worker: joins the gloo group from torchrun's variables, then runs tasks
_WORKER = r"""
import importlib, os, sys, traceback
sys.path[:0] = [os.environ["WANQ_ROOT"], os.environ["WANQ_TESTS"]]
from multiprocessing.connection import Connection
import torch
torch.set_num_threads(1)
from wanq_tpu_torch.parallel import init_distributed
tasks = Connection(int(sys.argv[1]), writable=False)
results = Connection(int(sys.argv[2]), readable=False)
results.send(("ok", init_distributed("cpu", init_method=sys.argv[3])))
while True:
    msg = tasks.recv()
    if msg is None:
        break
    fn, kw = msg
    try:
        out = ("ok", getattr(importlib.import_module("test_torch_parallel"), fn)(**kw))
    except BaseException:
        out = ("err", traceback.format_exc())
    results.send(out)
"""


class _Ranks:
    """``world`` worker processes in one gloo group; ``run(fn, **kw)`` calls
    this module's ``fn(**kw)`` on every rank and returns the results by rank."""

    def __init__(self, world: int, tmp):
        self.world, self.procs, self.conns = world, [], []
        rdzv = f"file://{tmp}/rendezvous"
        for rank in range(world):
            t_r, t_w = os.pipe()
            r_r, r_w = os.pipe()
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       WANQ_ROOT=ROOT, WANQ_TESTS=TESTS, OMP_NUM_THREADS="1")
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(t_r), str(r_w), rdzv], env=env,
                pass_fds=(t_r, r_w), stdout=log, stderr=subprocess.STDOUT, cwd=str(tmp)))
            os.close(t_r)
            os.close(r_w)
            self.conns.append((Connection(t_w, readable=False), Connection(r_r, writable=False)))
        self.joined = self._collect()

    def _collect(self):
        out, errors = [], []
        for rank, (_, res) in enumerate(self.conns):
            if not res.poll(TIMEOUT):
                self.close()
                raise AssertionError(f"rank {rank} of {self.world} gave no result in {TIMEOUT} s")
            status, val = res.recv()
            if status != "ok":
                errors.append(f"rank {rank}:\n{val}")
            out.append(val)
        if errors:
            raise AssertionError("\n".join(errors))
        return out

    def run(self, fn: str, **kw):
        for task, _ in self.conns:
            task.send((fn, kw))
        return self._collect()

    def close(self):
        for (task, res), proc in zip(self.conns, self.procs):
            try:
                task.send(None)
            except OSError:
                pass
        for proc in self.procs:
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
        for task, res in self.conns:
            task.close()
            res.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """ranks(world) -> the module's group of that size, started at first use."""
    pools = {}

    def get(world: int) -> _Ranks:
        if world not in pools:
            pools[world] = _Ranks(world, tmp_path_factory.mktemp(f"gloo{world}"))
        return pools[world]

    yield get
    for pool in pools.values():
        pool.close()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


# ---------------------------------------------------------------------------
# task functions, run on every rank of a group (no JAX here)
# ---------------------------------------------------------------------------


def _plan(dims, full_shard=False):
    """The ShardingPlan of mesh ``dims`` (dp, fsdp, sp, ring) over the group."""
    return ShardingPlan(make_mesh(*dims), full_shard)


def task_world():
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def task_ring(q, k, v, sp, ring_n, k_valid_len=None, window=None):
    """Ring attention of the global [B, S, H, D] q, k, v with heads over sp and
    the sequence over the ring: this rank's block of the output."""
    plan = _plan((1, 1, sp, ring_n))
    c = plan.mesh.coords
    s_r, h = q.shape[1] // ring_n, q.shape[2] // sp

    def mine(a):
        return torch.from_numpy(a[:, c["ring"] * s_r:(c["ring"] + 1) * s_r,
                                  c["sp"] * h:(c["sp"] + 1) * h])

    win = None if window is None else TemporalWindow(*window)
    out = plan.ring_attention(mine(q), mine(k), mine(v), k_valid_len=k_valid_len, window=win)
    return c["ring"], c["sp"], out.numpy()


def task_dit(cfg_kw, params, x, t, context, seq_len, dims, full_shard=False, quant=None,
             attn_window=None):
    """The sharded dit_forward of numpy weights (and a numpy int state:
    quant = (yaml, state)); every rank returns the whole output."""
    plan = _plan(dims, full_shard)
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import shard_quant_state

    cfg = tiny_config(**cfg_kw)
    pt = shard_params(params_from_numpy(params, device="cpu"), plan)
    ctx = None
    if quant is not None:
        yaml, state = quant
        policies = QuantConfig.from_yaml(yaml).resolve_all(tdit.linear_layer_names(cfg))
        ctx = QuantCtx(mode="int8", policies=policies, state=shard_quant_state(
            quant_state_from_numpy(state, device="cpu"), plan))
    elif attn_window is not None:
        ctx = QuantCtx(mode="fp", attn_window=attn_window)
    out = tdit.dit_forward(pt, cfg, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(context), seq_len, ctx=ctx, plan=plan)
    return out.numpy()


def task_i2v_generate(cfg_kw, params, img, context, context_null, clip_fea, y, noise, dims,
                      steps):
    """WanI2V.generate under the mesh ``dims`` with precomputed conditioning."""
    from wanq_tpu_torch.pipelines.image2video import WanI2V

    plan = _plan(dims)
    pipe = WanI2V(tiny_config(**cfg_kw), shard_params(params_from_numpy(params, device="cpu"),
                                                      plan), device="cpu", shardings=plan)
    return pipe.generate(torch.from_numpy(img), torch.from_numpy(context),
                         torch.from_numpy(context_null), max_area=32 * 32, frame_num=5,
                         sampling_steps=steps, guide_scale=2.0, clip_fea=torch.from_numpy(clip_fea),
                         y=torch.from_numpy(y), noise=torch.from_numpy(noise)).numpy()


def task_cached_generate(params, context, context_null, noise, dims):
    """WanT2V.generate under a static step cache (cond steps run B = 1 forwards)."""
    from wanq_tpu_torch.pipelines.text2video import StepCachePolicy, WanT2V

    plan = _plan(dims)
    pipe = WanT2V(tiny_config(), shard_params(params_from_numpy(params, device="cpu"), plan),
                  device="cpu", shardings=plan)
    out = pipe.generate(torch.from_numpy(context), torch.from_numpy(context_null),
                        size=(32, 32), frame_num=5, sampling_steps=6, seed=11,
                        noise=torch.from_numpy(noise),
                        cache_policy=StepCachePolicy(cfg_interval=2, reuse_interval=2, warmup=1,
                                                     tail=1))
    return out.numpy(), pipe.last_cache_stats


def task_fp_cli(argv):
    from wanq_tpu_torch.cli import fp_generate

    return fp_generate.generate(fp_generate.parse_args(argv))


def task_dit_raises(cfg_kw, params, x, t, context, seq_len, dims, attn_window):
    plan = _plan(dims)
    cfg = tiny_config(**cfg_kw)
    try:
        tdit.dit_forward(shard_params(params_from_numpy(params, device="cpu"), plan), cfg,
                         torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(context),
                         seq_len, ctx=QuantCtx(mode="fp", attn_window=attn_window), plan=plan)
    except NotImplementedError as e:
        return str(e)
    return "no error"


def task_generate(params, context, context_null, noise, sp):
    from wanq_tpu_torch.pipelines.text2video import WanT2V

    plan = _plan((1, 1, sp, 1))
    pipe = WanT2V(tiny_config(), shard_params(params_from_numpy(params, device="cpu"), plan),
                  device="cpu", shardings=plan)
    return pipe.generate(torch.from_numpy(context), torch.from_numpy(context_null),
                         size=(32, 32), frame_num=5, sampling_steps=2, seed=11,
                         noise=torch.from_numpy(noise)).numpy()


def task_cli(argv):
    from wanq_tpu_torch.cli import quant_generate

    return quant_generate.generate(quant_generate.parse_args(argv))


def task_t5(ids, sp):
    """umT5 (tiny) with --t5_fsdp's storage over fsdp = the group."""
    from wanq_tpu_torch.models.t5 import encoder_forward, init_t5_params, tiny_t5_config

    plan = _plan((1, sp, 1, 1))
    cfg = tiny_t5_config()
    params = sharding.shard_t5_params(init_t5_params(cfg, seed=0, device="cpu"), plan)
    emb = params["token_embedding"]
    return (tuple(emb.local.shape), encoder_forward(params, cfg, torch.from_numpy(ids), None,
                                                    plan=plan).numpy())


def task_t5_checkpoint(path, ids, mask):
    """T5EncoderModel from a reference-layout checkpoint under --t5_fsdp's plan
    (fsdp = the group): the kind and shape of every leaf this rank holds, and
    the encoder's states."""
    import torch.distributed as dist

    from wanq_tpu_torch.models.t5 import T5EncoderModel, tiny_t5_config

    plan = _plan((1, dist.get_world_size(), 1, 1))
    enc = T5EncoderModel(ids.shape[1], checkpoint_path=path, device="cpu", plan=plan,
                         cfg=tiny_t5_config(param_dtype="bfloat16"))
    return _held(enc.params), enc.encode_ids(ids, mask).numpy()


def _held(params):
    """{leaf path: (kind, the shape this rank stores)} of a param tree."""
    return {"/".join(p): ("Shard", tuple(leaf.local.shape)) if isinstance(leaf, sharding.Shard)
            else ("Tensor", tuple(leaf.shape)) for p, leaf in sharding._walk(params)}


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jax_models(cfg_kw, seed=0):
    """The same tiny weights in both packages (head.head redrawn: the
    reference zero-inits it); returns (cfg_j, params_j, numpy params)."""
    import jax
    import jax.numpy as jnp

    from wanq_tpu.configs import tiny_config as jax_tiny_config
    from wanq_tpu.models import dit as jdit

    cfg_j = jax_tiny_config(**cfg_kw)
    pj = jdit.init_params(cfg_j, jax.random.PRNGKey(seed))
    hw = pj["head"]["head"]["w"].shape
    pj["head"]["head"]["w"] = jnp.asarray(
        (np.random.default_rng(seed + 100).normal(size=hw) * 0.02).astype(np.float32))
    return cfg_j, pj, jax.tree.map(np.asarray, pj)


def _inputs(cfg_kw, frames=4, b=2, seed=5):
    cfg = tiny_config(**cfg_kw)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, cfg.in_dim, frames, 8, 8)).astype(np.float32)
    t = np.full((b,), 500.0, np.float32)
    c = rng.normal(size=(b, cfg.text_len, cfg.text_dim)).astype(np.float32)
    return x, t, c


def _jax_forward(cfg_j, pj, x, t, c, seq_len, ctx=None, eager=False):
    import jax
    import jax.numpy as jnp

    from wanq_tpu.models import dit as jdit

    args = (pj, cfg_j, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c), seq_len)
    if eager:
        with jax.disable_jit():
            return np.asarray(jdit.dit_forward(*args, ctx=ctx))
    return np.asarray(jdit.dit_forward(*args, ctx=ctx))


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.normal(size=(2, 64, 4, 32)).astype(np.float32) for _ in range(3))


# ---------------------------------------------------------------------------
# the fold and the hop, one process
# ---------------------------------------------------------------------------


def _jax_fold(q, k, v, chain, q_offset, kv_len, band):
    """wanq_tpu's _partial_attn over ``chain`` = [(k/v slice, kv_offset)]:
    the final (out, lse) [B, Sq, H, D], [B, H, Sq]."""
    import jax.numpy as jnp

    from wanq_tpu.parallel.ring import _NEG_INF, _partial_attn as jfold

    qt = jnp.asarray(q)
    b, sq, h, d = q.shape
    m, l, acc = (jnp.full((b, h, sq, 1), _NEG_INF), jnp.zeros((b, h, sq, 1)),
                 jnp.zeros((b, h, sq, d)))
    for sl, off in chain:
        m, l, acc = jfold(qt, jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]), 1 / np.sqrt(d),
                          m, l, acc, kv_offset=off, kv_len=kv_len, q_offset=q_offset, band=band)
    m, l, acc = (np.asarray(a, np.float64) for a in (m, l, acc))
    return (acc / l).transpose(0, 2, 1, 3), (m + np.log(l))[..., 0]


@pytest.mark.parametrize("band", [None, (8, 1)], ids=["dense", "band"])
def test_partial_attn_one_fold_and_a_chain_match_wanq_tpu(qkv, band):
    """``_partial_attn``, one fold (q rows 16..31 against keys 24..47) and a
    chain over four shards with offsets, against wanq_tpu's; the hop output
    and LSE of ``partial_attention`` and the LSE fold of the chain give the
    same numbers."""
    q, k, v = qkv
    qs, kv_len = q[:, 16:32], 56
    chains = {"one": [(slice(24, 48), 24)],
              "chain": [(slice(i, i + 16), i) for i in (32, 0, 48, 16)]}
    for name, chain in chains.items():
        want_o, want_lse = _jax_fold(qs, k, v, chain, 16, kv_len, band)
        b, sq, h, d = qs.shape
        m = torch.full((b, h, sq, 1), float("-inf"))
        l, acc = torch.zeros((b, h, sq, 1)), torch.zeros((b, h, sq, d))
        folded = None
        for sl, off in chain:
            kt, vt = torch.from_numpy(k[:, sl]), torch.from_numpy(v[:, sl])
            m, l, acc = ring._partial_attn(torch.from_numpy(qs), kt, vt, 1 / np.sqrt(d), m, l,
                                           acc, off, kv_len, 16, band)
            win = None if band is None else TemporalWindow(*band)
            folded = ring.fold_partial(folded, *ring.partial_attention(
                torch.from_numpy(qs), kt, vt, 1 / np.sqrt(d), 16, off, kv_len, win))
        got_o = (acc / l).transpose(1, 2).numpy()
        np.testing.assert_allclose(got_o, want_o, atol=2e-5, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose((m + torch.log(l))[..., 0].numpy(), want_lse, atol=2e-5,
                                   rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(folded[0].numpy(), want_o, atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(folded[1].numpy(), want_lse, atol=2e-5, rtol=1e-4)


def test_empty_rows_weigh_zero_in_the_fold(qkv):
    """A hop whose band misses some rows gives them o = 0 and lse = -inf
    (no NaN), and folding it leaves the other hop's numbers unchanged; a
    first hop that is wholly masked (wanq_tpu's finite -1e30 gives it p = 1)
    stays out of the sum."""
    q, k, v = qkv
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    win = TemporalWindow(8, 0)
    # q rows 0..15 (frames 0, 1) against keys 40..55 (frames 5, 6): nothing in band
    o, lse = ring.partial_attention(qt[:, :16], kt[:, 40:56], vt[:, 40:56], 0.2, 0, 40, 64, win)
    assert torch.equal(o, torch.zeros_like(o)) and bool(torch.isneginf(lse).all())
    near = ring.partial_attention(qt[:, :16], kt[:, :16], vt[:, :16], 0.2, 0, 0, 64, win)
    folded = ring.fold_partial(ring.fold_partial(None, o, lse), *near)
    assert torch.equal(folded[0], near[0].float()) and torch.equal(folded[1], near[1])
    both_empty = ring.fold_partial(ring.fold_partial(None, o, lse), o, lse)
    assert torch.equal(both_empty[0], o) and bool(torch.isneginf(both_empty[1]).all())


@pytest.mark.parametrize("n,radius", [(4, 1), (8, 0), (4, 3)])
def test_hop_predicate_matches_wanq_tpu_and_visits_pad_rows(n, radius):
    """``hop_visits`` is wanq_tpu's predicate (ring.py:133-140) on ranks without
    pad rows, and a rank holding pad rows visits every shard with a valid key."""
    s_loc, tpf, kv_len = 64 // n, 8, 56
    for idx in range(n):
        for src in range(n):
            q0, k0 = idx * s_loc, src * s_loc
            got = ring.hop_visits(q0, s_loc, k0, s_loc, kv_len, (tpf, radius))
            if k0 >= kv_len:
                assert not got
            elif q0 + s_loc > kv_len:
                assert got
            else:
                qf0, qf1 = q0 // tpf, (q0 + s_loc - 1) // tpf
                kf0, kf1 = k0 // tpf, (k0 + s_loc - 1) // tpf
                assert got == (kf0 <= qf1 + radius and kf1 >= qf0 - radius)


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------


def _mesh_at(dims, rank):
    """The port's Mesh of ``dims`` as rank ``rank`` sees it (no process group)."""
    coords = dict(zip(sharding.AXES, (int(c) for c in np.unravel_index(rank, dims))))
    return sharding.Mesh(dict(zip(sharding.AXES, dims)), coords, {})


def _slices(spec, shape, index):
    """The index tuple of slice ``index`` of ``shape`` under a LeafShard (all for None)."""
    out = [slice(0, n) for n in shape]
    if spec is not None:
        n = shape[spec.dim] // spec.count
        out[spec.dim] = slice(index * n, (index + 1) * n)
    return tuple(out)


@pytest.mark.parametrize("dims,full_shard", [
    ((1, 8, 1, 1), False), ((1, 2, 2, 2), False), ((1, 2, 2, 2), True), ((2, 1, 2, 2), True),
    ((1, 1, 3, 1), True)], ids=["fsdp8", "fsdp2sp2ring2", "full_shard", "dp2_full_shard",
                                 "sp3_full_shard"])
def test_leaf_slices_match_wanq_tpu_partition_specs(dims, full_shard):
    """Every rank's slice of every DiT leaf (tiny, and T2V-1.3B's widths for the
    divisibility rules) equals the slice that wanq_tpu's leaf_sharding's
    NamedSharding gives the device of the same index on the 8-device mesh."""
    import jax

    from wanq_tpu.parallel.sharding import leaf_sharding as jleaf, make_mesh as jmesh

    jm = jmesh(*dims)
    leaves = {("w", (96, 96)), ("w", (96, 192)), ("b", (192,)), ("b", (96,)), ("w", (64, 96)),
              ("w", (1536, 8960)), ("w", (16 * 4, 1536)), ("modulation", (1, 6, 96)),
              ("w", (96,)), ("b", (7,)), ("w", (96, 7))}
    for name, shape in sorted(leaves):
        want = jleaf(jm, name, len(shape), shape, full_shard).devices_indices_map(shape)
        for rank, dev in enumerate(np.asarray(jm.devices).ravel()):
            mesh = _mesh_at(dims, rank)
            plan = ShardingPlan(mesh, full_shard)
            spec = sharding.leaf_sharding(mesh, name, len(shape), shape, full_shard)
            got = _slices(spec, shape, plan.storage()[2])
            norm = tuple(slice(s.start or 0, shape[i] if s.stop is None else s.stop)
                         for i, s in enumerate(want[dev]))
            assert got == norm, (name, shape, rank)
    assert jax.device_count() == 8


def test_t5_and_quant_state_slices_match_wanq_tpu():
    """T5's token embedding on its vocab and linears on C_out over fsdp
    (shard_t5_params), and every int state leaf of a W8A8 / W4A8 / W4A4 layer
    on C_out with its per-channel vectors (quant_state_shardings; the port's
    int weights are K-major), the low-rank factors and masks replicated."""
    import jax
    from jax.sharding import PartitionSpec as P

    from wanq_tpu.parallel.sharding import make_mesh as jmesh
    from wanq_tpu.quant.ptq import quant_state_shardings as jq
    from wanq_tpu_torch.quant.ptq import quant_state_shardings

    jm = jmesh(1, 4, 1, 2)
    mesh = _mesh_at((1, 4, 1, 2), 0)
    for name, shape, want in (("token_embedding", (256, 32), sharding.LeafShard(0, 4)),
                              ("w", (32, 64), sharding.LeafShard(1, 4)),
                              ("w", (32, 6), None), ("norm", (32,), None)):
        assert sharding.t5_leaf_sharding(mesh, name, len(shape), shape) == want
    # JAX layouts [C_in(/2), C_out]; the port's int weights transpose to [C_out, ...]
    jstate = {"l": {"w_q": np.zeros((64, 32)), "w_int8": np.zeros((64, 32), np.int8),
                    "scale_w": np.zeros(32), "zp_w_int": np.zeros(32), "delta_w": np.zeros(32),
                    "zp_w": np.zeros(32), "channel_mask": np.zeros(64),
                    "delta_a": np.zeros(()), "lowrank_a": np.zeros((64, 8)),
                    "lowrank_b": np.zeros((8, 32))},
              "g": {"w_int4g": np.zeros((128, 32), np.uint8), "scale_wg": np.zeros((2, 32))}}
    specs = jq(jm, jax.tree.map(jax.numpy.asarray, jstate), full_shard=True)
    tstate = {"l": {k: torch.zeros(v.shape[::-1] if k == "w_int8" else v.shape)
                    for k, v in jstate["l"].items()},
              "g": {"w_int4g": torch.zeros(32, 128), "scale_wg": torch.zeros(2, 32)}}
    got = quant_state_shardings(tstate, mesh, full_shard=True)
    for layer, st in jstate.items():
        for key in st:
            jspec = specs[layer][key].spec
            split = any(a is not None for a in jspec)
            assert (got[layer][key] is not None) == split, (layer, key)
            if split:
                assert got[layer][key].count == 8
                out_dim = 0 if key in ("w_int8", "w_int4g") else got[layer][key].dim
                assert tstate[layer][key].shape[out_dim] == 32
    assert P() == specs["l"]["lowrank_a"].spec


def test_launch_is_a_no_op_at_world_one(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert launch.init_distributed("cpu") == 1 and not dist.is_initialized()
    assert launch.is_main_rank()


def test_training_and_calibration_under_a_plan_raise():
    """Item 10's second part: training and calibration under a mesh raise
    (a one-rank plan without a process group)."""
    cfg = tiny_config()
    params = tdit.init_params(cfg, 0, device="cpu")
    x, t, c = (torch.from_numpy(a) for a in _inputs({}, b=1))
    plan = ShardingPlan(make_mesh())
    with pytest.raises(NotImplementedError, match="item 10"):
        tdit.dit_forward(params, cfg, x, t, c, 64, plan=plan, training=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        tdit.dit_forward(params, cfg, x, t, c, 64, ctx=QuantCtx(mode="calib"), plan=plan)
    # a one-rank plan runs the whole forward's code: equal to the planless one
    want = tdit.dit_forward(params, cfg, x, t, c, 64)
    got = tdit.dit_forward(shard_params(params, plan), cfg, x, t, c, 64, plan=plan)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# multi-rank: launch, ring, the sharded forward, the pipeline, the CLI, T5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_init_distributed_joins_from_torchrun_variables(ranks, world):
    """Each worker called init_distributed("cpu") with RANK / WORLD_SIZE set:
    it returned the world size, and the group has the ranks in order."""
    pool = ranks(world)
    assert pool.joined == [world] * world
    assert pool.run("task_world") == [(r, world) for r in range(world)]


@pytest.mark.parametrize("case", [
    dict(ring_n=2), dict(ring_n=4), dict(ring_n=4, k_valid_len=40),
    dict(ring_n=4, k_valid_len=56, window=(8, 1)), dict(ring_n=4, k_valid_len=40, window=(8, 0)),
    dict(ring_n=2, sp=2, k_valid_len=40)],
    ids=["ring2", "ring4", "ring4_valid40", "ring4_window_skips", "ring4_pad_rank",
         "sp2ring2"])
def test_ring_attention_matches_wanq_tpu(ranks, qkv, case):
    """The port's ring over gloo ranks against wanq_tpu's ring_attention on the
    8-device mesh (its qkv_spec heads over sp, sequence over ring). At radius
    0 with 40 valid keys the last rank holds only pad rows and its shard no
    valid key: wanq_tpu skips hops its pad rows see, so its pad rows are
    unspecified; the port's equal the single-device attention."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from wanq_tpu.models.attention import TemporalWindow as JaxWindow, attention as jattn
    from wanq_tpu.parallel import make_mesh as jmesh
    from wanq_tpu.parallel.ring import ring_attention as jring

    q, k, v = qkv
    sp, ring_n = case.get("sp", 1), case["ring_n"]
    valid, window = case.get("k_valid_len"), case.get("window")
    jwin = None if window is None else JaxWindow(tokens_per_frame=window[0], radius=window[1])
    want = np.asarray(jring(*map(jnp.asarray, (q, k, v)), jmesh(1, 1, sp, ring_n), axis="ring",
                            k_valid_len=valid, window=jwin,
                            qkv_spec=P("dp", "ring", "sp", None) if sp > 1 else None))
    single = np.asarray(jattn(*map(jnp.asarray, (q, k, v)), k_valid_len=valid, window=jwin,
                              force_reference=True))
    out = np.zeros_like(q)
    s_r, h = q.shape[1] // ring_n, q.shape[2] // sp
    for r, s, block in ranks(sp * ring_n).run("task_ring", q=q, k=k, v=v, sp=sp, ring_n=ring_n,
                                              k_valid_len=valid, window=window):
        out[:, r * s_r:(r + 1) * s_r, s * h:(s + 1) * h] = block
    rows = valid if valid is not None and window is not None else q.shape[1]
    np.testing.assert_allclose(out[:, :rows], want[:, :rows], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out, single, atol=2e-5, rtol=1e-4)


TINY_DIMS = {
    "sp2": (1, 1, 2, 1), "fsdp2": (1, 2, 1, 1), "dp2": (2, 1, 1, 1), "ring2": (1, 1, 1, 2),
    "sp2ring2": (1, 1, 2, 2), "fsdp2sp2_full_shard": (1, 2, 2, 1), "sp3_4heads": (1, 1, 3, 1),
}


@pytest.fixture(scope="module")
def tiny_models():
    cfg_j, pj, pnp = _jax_models({})
    x, t, c = _inputs({}, frames=6)
    return cfg_j, pj, pnp, (x, t, c)


@pytest.mark.parametrize("name", list(TINY_DIMS))
def test_sharded_dit_forward_matches_wanq_tpu(ranks, tiny_models, name):
    """The tiny config (4 heads, head dim 24: the unfused chain) on each mesh
    against wanq_tpu's single-device dit_forward; every rank returns the whole
    output. sp 3 on 4 heads takes the gather route (all heads on the whole
    sequence); seq 96 = 6 x 4 x 4 tokens, a multiple of every sp x ring."""
    cfg_j, pj, pnp, (x, t, c) = tiny_models
    want = _jax_forward(cfg_j, pj, x, t, c, 96)
    world = int(np.prod(TINY_DIMS[name]))
    outs = ranks(world).run("task_dit", cfg_kw={}, params=pnp, x=x, t=t, context=c, seq_len=96,
                            dims=TINY_DIMS[name], full_shard=name.endswith("full_shard"))
    assert len(outs) == world
    for got in outs:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("dims", [(1, 1, 1, 2), (1, 1, 2, 1)], ids=["ring2", "sp2"])
def test_uniform_window_under_ring_and_ulysses_matches_wanq_tpu(ranks, tiny_models, dims):
    """A uniform window of one frame (6 frames: bands skip hops under ring)
    against wanq_tpu's single-device windowed forward; per-head radii under sp
    x ring > 1 raise."""
    cfg_j, pj, pnp, (x, t, c) = tiny_models
    from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx

    want = _jax_forward(cfg_j, pj, x, t, c, 96, ctx=JaxQuantCtx(mode="fp", attn_window=1))
    outs = ranks(2).run("task_dit", cfg_kw={}, params=pnp, x=x, t=t, context=c, seq_len=96,
                        dims=dims, attn_window=1)
    for got in outs:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    errs = ranks(2).run("task_dit_raises", cfg_kw={}, params=pnp, x=x, t=t, context=c,
                        seq_len=96, dims=dims, attn_window=(0, 1, 2, 3))
    assert all("per-head window radii" in e for e in errs)


@pytest.mark.parametrize("yaml", [W8A8, W4A8], ids=["w8a8", "w4a8"])
def test_int_states_under_fsdp2_sp2_match_wanq_tpu(ranks, yaml):
    """A head-dim-128 config (2 heads: the fused K1 / K2 / K8 / K3 / K4 routes
    on local rows, one head a rank) with the int state of wanq_tpu's PTQ,
    split on C_out over fsdp 2 with sp 2, against wanq_tpu's single-device
    eager forward at 3e-3."""
    import jax

    from wanq_tpu.models import dit as jdit
    from wanq_tpu.quant import QuantConfig as JaxQuantConfig
    from wanq_tpu.quant.ptq import prepare_quant_state as jax_prepare
    from wanq_tpu.quant.qlinear import QuantCtx as JaxQuantCtx

    cfg_j, pj, pnp = _jax_models(SMALL, seed=3)
    x, t, c = _inputs(SMALL, frames=4)
    cfg_t = tiny_config(**SMALL)
    cc = QuantCtx(mode="calib", collect_minmax=True)
    tdit.dit_forward(params_from_numpy(pnp, device="cpu"), cfg_t, torch.from_numpy(x),
                     torch.from_numpy(t), torch.from_numpy(c), 64, ctx=cc)
    calib = {k: v.float().numpy()[None] for k, v in cc.collect.items()}
    pol, st, rot = jax_prepare(pj, jdit.linear_layer_names(cfg_j),
                               JaxQuantConfig.from_yaml(yaml), calib=calib, targets="int8")
    want = _jax_forward(cfg_j, pj, x, t, c, 64, eager=True,
                        ctx=JaxQuantCtx(mode="int8", policies=pol, state=st, rotations=rot))
    state = jax.tree.map(np.asarray, st)
    for got in ranks(4).run("task_dit", cfg_kw=SMALL, params=pnp, x=x, t=t, context=c,
                            seq_len=64, dims=(1, 2, 2, 1), quant=(yaml, state)):
        np.testing.assert_allclose(got, want, atol=3e-3)


def test_pipeline_generate_sp2_matches_wanq_tpu(ranks, tiny_models):
    """WanT2V.generate under Ulysses 2 (2 UniPC steps, 32 x 32 x 5) from
    wanq_tpu's initial noise, against its single-device latents."""
    import jax
    import jax.numpy as jnp

    from wanq_tpu.pipelines.text2video import WanT2V as JaxWanT2V
    from wanq_tpu_torch.pipelines.text2video import compute_target_shape

    cfg_j, pj, pnp, _ = tiny_models
    rng = np.random.default_rng(2)
    ctx = rng.normal(size=(1, cfg_j.text_len, cfg_j.text_dim)).astype(np.float32)
    ctx_null = rng.normal(size=(1, cfg_j.text_len, cfg_j.text_dim)).astype(np.float32)
    want = np.asarray(JaxWanT2V(cfg_j, pj).generate(
        jnp.asarray(ctx), jnp.asarray(ctx_null), size=(32, 32), frame_num=5, sampling_steps=2,
        seed=11))
    shape = compute_target_shape(tiny_config(), (32, 32), 5)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(11), (1, *shape), jnp.float32))
    for got in ranks(2).run("task_generate", params=pnp, context=ctx, context_null=ctx_null,
                            noise=noise, sp=2):
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_quant_generate_cli_under_two_ranks_equals_one(ranks, tmp_path):
    """quant_generate --hardware --ulysses_size 2 --dit_fsdp in 2 processes
    (fsdp = 2 // 2 = 1, so the weights ride whole) writes the latents of the
    1-process run, and only rank 0 writes."""
    from wanq_tpu_torch.cli import quant_generate

    base = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--random_init",
            "--quant_config", W4A8, "--hardware", "--device", "cpu", "--sample_steps", "2",
            "--sample_guide_scale", "2"]
    one = np.load(quant_generate.generate(quant_generate.parse_args(
        base + ["--save_file", str(tmp_path / "one.npz")])))["latents"]
    two = str(tmp_path / "two.npz")
    paths = ranks(2).run("task_cli", argv=base + ["--ulysses_size", "2", "--dit_fsdp",
                                                  "--save_file", two])
    assert paths == [two, None]
    got = np.load(two)["latents"]
    np.testing.assert_allclose(got, one, atol=1e-5, rtol=1e-5)
    assert sorted(os.listdir(tmp_path)) == ["one.npz", "two.npz"]


def test_t5_fsdp_encoder_matches_wanq_tpu(ranks):
    """--t5_fsdp's storage over fsdp 4: the vocab split (256 / 4 rows a rank),
    the linears gathered a block at a time, against wanq_tpu's encoder."""
    import jax.numpy as jnp

    from wanq_tpu.models.t5 import encoder_forward as jenc, init_t5_params as jinit
    from wanq_tpu.models.t5 import tiny_t5_config as jcfg

    ids = (np.arange(24).reshape(2, 12) * 7 % jcfg().vocab_size).astype(np.int64)
    want = np.asarray(jenc(jinit(jcfg(), seed=0), jcfg(), jnp.asarray(ids), None))
    for shape, got in ranks(4).run("task_t5", ids=ids, sp=4):
        assert shape == (jcfg().vocab_size // 4, jcfg().dim)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_t5_fsdp_checkpoint_is_cut_as_it_is_read(ranks, tmp_path):
    """--t5_fsdp from a reference-layout checkpoint (bf16 linears, as the
    published one) over fsdp 4: each rank's converter keeps only its slice of
    the vocab and of every linear (the storage shard_t5_params gives the whole
    encoder), and the states equal the unsharded port's and wanq_tpu's."""
    import jax.numpy as jnp

    from wanq_tpu.models import t5 as jt5
    from wanq_tpu_torch.models import t5 as tt5

    cfg = tt5.tiny_t5_config(param_dtype="bfloat16")
    pt = tt5.init_t5_params(cfg, 6, device="cpu")
    sd = {"token_embedding.weight": pt["token_embedding"], "norm.weight": pt["norm"]["w"]}
    for i, bp in enumerate(pt["blocks"]):
        lin = {f"attn.{k}": bp["attn"][k] for k in "qkvo"}
        lin.update({"ffn.gate.0": bp["ffn"]["gate"]["0"], "ffn.fc1": bp["ffn"]["fc1"],
                    "ffn.fc2": bp["ffn"]["fc2"]})
        sd.update({f"blocks.{i}.{k}.weight": v["w"].t().contiguous() for k, v in lin.items()})
        sd.update({f"blocks.{i}.norm1.weight": bp["norm1"]["w"],
                   f"blocks.{i}.norm2.weight": bp["norm2"]["w"],
                   f"blocks.{i}.pos_embedding.embedding.weight":
                       bp["pos_embedding"]["embedding"]})
    path = str(tmp_path / "t5.pth")
    torch.save(sd, path)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, cfg.vocab_size, (2, 12))
    mask = (np.arange(12)[None] < np.array([[12], [7]])).astype(np.int64)
    whole = tt5.T5EncoderModel(12, checkpoint_path=path, cfg=cfg, device="cpu")
    one = whole.encode_ids(ids, mask).numpy()
    want = np.asarray(jt5.encoder_forward(jt5.convert_t5_state_dict(sd, dtype=jnp.bfloat16),
                                          jt5.tiny_t5_config(param_dtype="bfloat16"),
                                          jnp.asarray(ids), jnp.asarray(mask)))
    want = want * mask[:, :, None]
    stored = _held(sharding.shard_t5_params(whole.params, ShardingPlan(_mesh_at((1, 4, 1, 1),
                                                                                0))))
    assert stored["token_embedding"] == ("Shard", (cfg.vocab_size // 4, cfg.dim))
    assert stored["blocks/0/ffn/fc1/w"] == ("Shard", (cfg.dim, cfg.dim_ffn // 4))
    for held, got in ranks(4).run("task_t5_checkpoint", path=path, ids=ids, mask=mask):
        assert held == stored
        np.testing.assert_allclose(got, one, atol=1e-5, rtol=1e-5)
        assert _rel(want, got) <= 2e-3  # bf16 products, rounded at other sites


def test_i2v_generate_under_ulysses_matches_wanq_tpu(ranks):
    """WanI2V.generate (the tiny i2v config, precomputed CLIP features and y,
    4 UniPC steps) under sp 2 and under dp 2 x sp 2, from wanq_tpu's initial
    noise, against its single-device WanI2V."""
    import jax
    import jax.numpy as jnp

    from wanq_tpu.pipelines.image2video import WanI2V as JaxWanI2V
    from wanq_tpu_torch.pipelines.image2video import i2v_latent_size

    kw = dict(model_type="i2v", in_dim=36, clip_dim=32)
    cfg_j, pj, pnp = _jax_models(kw)
    rng = np.random.default_rng(11)
    img = rng.uniform(-1, 1, size=(3, 32, 32)).astype(np.float32)
    c, cn = (rng.normal(size=(1, cfg_j.text_len, cfg_j.text_dim)).astype(np.float32)
             for _ in range(2))
    lat_h, lat_w = i2v_latent_size(tiny_config(**kw), (32, 32), 32 * 32)
    clip_fea = rng.normal(size=(1, 257, 32)).astype(np.float32)
    y = rng.normal(size=(20, 2, lat_h, lat_w)).astype(np.float32)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(3), (1, 16, 2, lat_h, lat_w),
                                       jnp.float32))
    want = np.asarray(JaxWanI2V(cfg_j, pj).generate(
        jnp.asarray(img), jnp.asarray(c), jnp.asarray(cn), max_area=32 * 32, frame_num=5,
        sampling_steps=4, guide_scale=2.0, seed=3, clip_fea=jnp.asarray(clip_fea),
        y=jnp.asarray(y)))
    for dims in ((1, 1, 2, 1), (2, 1, 2, 1)):
        world = int(np.prod(dims))
        outs = ranks(world).run("task_i2v_generate", cfg_kw=kw, params=pnp, img=img, context=c,
                                context_null=cn, clip_fea=clip_fea, y=y, noise=noise, dims=dims,
                                steps=4)
        assert len(outs) == world
        for got in outs:
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_step_cache_under_dp2_runs_cond_steps_whole(ranks, tiny_models):
    """A static step cache under dp 2: full steps split the CFG pair over
    the dp ranks, cond steps (one B = 1 forward) run whole on each; the
    latents and the actions equal the single-process run's."""
    from wanq_tpu_torch.pipelines.text2video import StepCachePolicy, WanT2V, compute_target_shape

    _, _, pnp, _ = tiny_models
    rng = np.random.default_rng(4)
    c, cn = (rng.normal(size=(1, 16, 64)).astype(np.float32) for _ in range(2))
    noise = rng.normal(size=(1, *compute_target_shape(tiny_config(), (32, 32), 5))).astype(
        np.float32)
    pipe = WanT2V(tiny_config(), params_from_numpy(pnp, device="cpu"), device="cpu")
    want = pipe.generate(torch.from_numpy(c), torch.from_numpy(cn), size=(32, 32), frame_num=5,
                         sampling_steps=6, noise=torch.from_numpy(noise),
                         cache_policy=StepCachePolicy(cfg_interval=2, reuse_interval=2,
                                                      warmup=1, tail=1)).numpy()
    assert pipe.last_cache_stats["cond"] > 0
    for got, stats in ranks(2).run("task_cached_generate", params=pnp, context=c,
                                   context_null=cn, noise=noise, dims=(2, 1, 1, 1)):
        assert stats == pipe.last_cache_stats
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_fp_generate_from_a_checkpoint_under_fsdp2_ring2(ranks, tiny_models, tmp_path):
    """fp_generate on a checkpoint dir in 4 processes under --fsdp_size 2
    --ring_size 2: the loader keeps each tensor's storage slice as it reads
    it, and the latents equal the 1-process run's; only rank 0 writes."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    from wanq_tpu_torch.cli import fp_generate

    cfg = tiny_config()
    _, _, pnp, _ = tiny_models
    chip_smoke.write_dit_checkpoint(params_from_numpy(pnp, device="cpu"), cfg,
                                    str(tmp_path / "ckpt"), shards=2)
    rng = np.random.default_rng(1)
    np.savez(tmp_path / "ctx.npz", **{k: rng.normal(size=(1, 16, 64)).astype(np.float32)
                                      for k in ("context", "context_null")})
    # guidance 2: CFG 5 makes the tiny random model's loop ill-conditioned, and
    # the ranks' single-threaded products differ from this process's in ulps
    base = ["--task", "tiny", "--size", "64*64", "--frame_num", "5", "--sample_steps", "2",
            "--ckpt_dir", str(tmp_path / "ckpt"), "--context_file", str(tmp_path / "ctx.npz"),
            "--device", "cpu", "--sample_guide_scale", "2"]
    one = np.load(fp_generate.generate(fp_generate.parse_args(
        base + ["--save_file", str(tmp_path / "one.npz")])))["latents"]
    four = str(tmp_path / "four.npz")
    paths = ranks(4).run("task_fp_cli", argv=base + ["--fsdp_size", "2", "--ring_size", "2",
                                                     "--save_file", four])
    assert paths == [four, None, None, None]
    np.testing.assert_allclose(np.load(four)["latents"], one, atol=1e-5, rtol=1e-5)

