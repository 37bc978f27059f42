"""The sharding plan: FSDP weight storage, Ulysses sequence parallelism, ring
context parallelism and data parallelism over ``torch.distributed``
(counterpart of wanq_tpu/parallel/sharding.py).

``wanq_tpu`` is one GSPMD program: it pins shardings on a ``Mesh(('dp',
'fsdp', 'sp', 'ring'))`` and XLA inserts the collectives. The port is SPMD:
every rank runs the same code on its shard, and each pin of ``wanq_tpu``'s
``ShardingPlan`` becomes an explicit collective or a local slice at the same
point of the forward (``models/dit.py``):

* data parallelism: the batch (the CFG pair) splits over ``dp``; the output
  is all-gathered over ``dp`` before the CFG combination (a batch dp does not
  divide, as a cond step's or sequential CFG's, runs whole on every dp rank);
* tokens: after the patch embedding and the pad, each rank keeps its slice of
  the sequence. The slices go **ring-major** (xfuser's USP order: slice ``t =
  ring_index * sp + sp_index``), so the Ulysses all-to-all stays inside each
  ``sp`` group; ``wanq_tpu`` shards sp-major but lays attention out ring-major,
  a permutation over every rank. Positions are global (the RoPE and K3 tables
  are sliced at the rank's offset), so the numbers are ``wanq_tpu``'s; the
  final gather restores the order before ``head_forward``;
* Ulysses: self-attention's heads-major q, k, v [B, N, S_loc, D] go through an
  ``all_to_all`` inside the ``sp`` group to [B, N / sp, S_ring, D] (the rank's
  heads, the ring shard's whole sequence), K4 runs there locally (windows
  compose), and a second ``all_to_all`` brings the output back to the tokens;
* ring: the ring shard's sequence then rotates round the ``ring`` group
  (``parallel/ring.py``);
* a head count ``sp`` does not divide: every rank gathers the whole
  sequence's q, k, v over sp x ring, runs every head and keeps its tokens (what
  GSPMD computes there);
* FSDP: a block's linear weights (and quant state) are stored split on their
  output channels over the storage axes (``fsdp``, or every non-dp axis with
  ``full_shard``) and all-gathered at use, one collective a block into
  block-sized buffers that every block reuses.

A :class:`Mesh` holds this rank's coordinates and the process groups of every
axis set; ranks are laid out row-major over (dp, fsdp, sp, ring), as
``wanq_tpu``'s devices are.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "sp", "ring")
# the axis sets a Mesh makes a process group for: dp, and every non-empty set
# of the others (the sp x ring sequence group, the storage axes of full_shard)
_GROUP_AXES = (("dp",),) + tuple(
    c for r in (1, 2, 3) for c in itertools.combinations(("fsdp", "sp", "ring"), r))


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a (dp, fsdp, sp, ring) mesh of processes:
    ``coords`` its coordinates; ``groups`` maps each axis set to this rank's
    process group over it (None without a process group: one rank)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[Tuple[str, ...], Any]

    def group(self, *axes: str):
        return self.groups.get(tuple(a for a in AXES if a in axes))

    def index(self, *axes: str) -> int:
        """This rank's row-major position over ``axes`` (mesh order)."""
        i = 0
        for a in AXES:
            if a in axes:
                i = i * self.shape[a] + self.coords[a]
        return i


def make_mesh(dp: int = 1, fsdp: int = 1, sp: int = 1, ring: int = 1) -> Mesh:
    """The mesh over every rank of the process group (or the one process
    without one), whose size must be dp * fsdp * sp * ring. Every rank must
    call it (``dist.new_group`` is collective)."""
    shape = dict(zip(AXES, (dp, fsdp, sp, ring)))
    n = dp * fsdp * sp * ring
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"mesh dp={dp} fsdp={fsdp} sp={sp} ring={ring} needs {n} ranks, "
                         f"got {world}")
    me = dist.get_rank() if dist.is_initialized() else 0
    grid = np.arange(n).reshape(dp, fsdp, sp, ring)
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(me, grid.shape))))
    groups: Dict[Tuple[str, ...], Any] = {}
    if dist.is_initialized():
        for axes in _GROUP_AXES:
            keep = [AXES.index(a) for a in axes]
            other = [i for i in range(4) if i not in keep]
            # one group per setting of the other axes, its ranks in mesh order
            members = np.transpose(grid, other + keep).reshape(-1, math.prod(
                grid.shape[i] for i in keep))
            for row in members:
                g = dist.new_group([int(r) for r in row])
                if me in row:
                    groups[axes] = g
    return Mesh(shape, coords, groups)


def storage_axes(mesh: Mesh, full_shard: bool = False) -> Tuple[Tuple[str, ...], int]:
    """The axes that store the weights and their size: ``fsdp`` alone, or
    with ``full_shard`` every non-dp axis of size > 1 (``wanq_tpu``'s rule:
    the reference's --dit_fsdp over the ranks that also run sequence
    parallelism)."""
    if not full_shard:
        return ("fsdp",), mesh.shape["fsdp"]
    axes = tuple(a for a in ("fsdp", "sp", "ring") if mesh.shape[a] > 1) or ("fsdp",)
    return axes, math.prod(mesh.shape[a] for a in axes)


class LeafShard(NamedTuple):
    """A tensor stored split into ``count`` equal slices along ``dim``, slice
    i on the storage group's rank i."""

    dim: int
    count: int


def leaf_sharding(mesh: Mesh, leaf_name: str, ndim: int, shape, full_shard: bool = False
                  ) -> Optional[LeafShard]:
    """How one DiT parameter leaf is stored (``wanq_tpu``'s
    ``leaf_sharding``): a linear weight ``w`` [C_in, C_out] split on C_out and
    its bias ``b`` on its length, when the storage size divides it; None
    (replicated) for everything else."""
    _, fs = storage_axes(mesh, full_shard)
    if leaf_name == "w" and ndim == 2 and shape[1] % fs == 0:
        return LeafShard(1, fs)
    if leaf_name == "b" and ndim == 1 and shape[0] % fs == 0:
        return LeafShard(0, fs)
    return None


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_shardings(params, mesh: Mesh, full_shard: bool = False):
    """The tree of :func:`leaf_sharding` for the DiT's params."""
    return _map(params, lambda path, leaf: leaf_sharding(
        mesh, path[-1] if path else "", getattr(leaf, "ndim", 0), tuple(getattr(leaf, "shape", ())),
        full_shard) if torch.is_tensor(leaf) else None)


def t5_leaf_sharding(mesh: Mesh, leaf_name: str, ndim: int, shape) -> Optional[LeafShard]:
    """``wanq_tpu``'s ``shard_t5_params`` rule over ``fsdp``: the token
    embedding on its vocab, linear weights on their output dim."""
    fs = mesh.shape["fsdp"]
    if leaf_name == "token_embedding" and ndim == 2 and shape[0] % fs == 0:
        return LeafShard(0, fs)
    if leaf_name == "w" and ndim == 2 and shape[1] % fs == 0:
        return LeafShard(1, fs)
    return None


# byte alignment of each leaf inside a pack (its dtype view needs it)
_ALIGN = 16


class Shard:
    """This rank's slice ``local`` of a tensor of ``full_shape`` stored split
    along ``dim`` over a storage group; ``pack`` is the flat byte buffer that
    holds it with the other shards gathered in the same collective."""

    __slots__ = ("local", "dim", "full_shape", "pack", "offset")

    def __init__(self, local: torch.Tensor, dim: int, full_shape):
        self.local, self.dim, self.full_shape = local, dim, tuple(full_shape)
        self.pack, self.offset = None, 0

    @property
    def dtype(self):
        return self.local.dtype

    def __repr__(self):
        return f"Shard({tuple(self.local.shape)} of {self.full_shape} on dim {self.dim})"


def slice_leaf(t: torch.Tensor, spec: Optional[LeafShard], index: int):
    """The slice ``index`` of ``t`` under ``spec`` as a Shard, or ``t`` itself
    (replicated)."""
    if spec is None:
        return t
    n = t.shape[spec.dim] // spec.count
    return Shard(t.narrow(spec.dim, index * n, n).contiguous(), spec.dim, t.shape)


def pack_shards(tree):
    """Put the Shards of ``tree`` into one flat byte buffer (the unit of one
    all-gather; their ``local`` become views of it) and return ``tree``."""
    shards = [leaf for _, leaf in _walk(tree) if isinstance(leaf, Shard)]
    if not shards:
        return tree
    offsets, total = [], 0
    for sh in shards:
        offsets.append(total)
        total += -(-sh.local.numel() * sh.local.element_size() // _ALIGN) * _ALIGN
    flat = torch.zeros(total, dtype=torch.uint8, device=shards[0].local.device)
    for sh, off in zip(shards, offsets):
        nb = sh.local.numel() * sh.local.element_size()
        view = flat[off:off + nb].view(sh.dtype).view(sh.local.shape)
        view.copy_(sh.local)
        sh.local, sh.pack, sh.offset = view, flat, off
    return tree


@dataclasses.dataclass(eq=False)
class ShardingPlan:
    """Carried into ``dit_forward``; see the module docstring. ``full_shard``
    stores the weights over every non-dp axis."""

    mesh: Mesh
    full_shard: bool = False
    _buffers: Dict[Any, torch.Tensor] = dataclasses.field(default_factory=dict, repr=False)

    # ---- sizes and positions -------------------------------------------
    @property
    def ring_size(self) -> int:
        return self.mesh.shape["ring"]

    @property
    def sp_size(self) -> int:
        """The sequence-parallel degree sp x ring (what seq_len rounds up to)."""
        return self.mesh.shape["sp"] * self.ring_size

    @property
    def dp_size(self) -> int:
        return self.mesh.shape["dp"]

    def token_slice(self, seq_len: int) -> Tuple[int, int]:
        """(offset, length) of this rank's tokens: slice ring_index * sp +
        sp_index of the sp x ring equal slices (ring-major)."""
        n = self.sp_size
        if seq_len % n:
            raise ValueError(f"seq_len {seq_len} is not a multiple of sp x ring = {n}")
        s_loc = seq_len // n
        t = self.mesh.coords["ring"] * self.mesh.shape["sp"] + self.mesh.coords["sp"]
        return t * s_loc, s_loc

    def storage(self) -> Tuple[Any, int, int]:
        """(group, size, this rank's index) of the weight storage."""
        axes, fs = storage_axes(self.mesh, self.full_shard)
        return self.mesh.group(*axes), fs, self.mesh.index(*axes)

    # ---- data parallelism ----------------------------------------------
    def batch(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's rows of a [B, ...] input (B a multiple of dp)."""
        if x is None or self.dp_size == 1:
            return x
        if x.shape[0] % self.dp_size:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of dp {self.dp_size}")
        n = x.shape[0] // self.dp_size
        return x[self.mesh.coords["dp"] * n:(self.mesh.coords["dp"] + 1) * n]

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """All-gather the rows of x over dp, in batch order."""
        return _all_gather_dim0(x, self.mesh.group("dp"), self.dp_size)

    # ---- tokens ----------------------------------------------------------
    def tokens(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's tokens of a sequence-long tensor (``dim``: the sequence)."""
        off, n = self.token_slice(x.shape[dim])
        return x.narrow(dim, off, n)

    def gather_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S_loc, ...] -> [B, S, ...]: all-gather over sp x ring, the slices
        put back in token order (the group's rank s * ring + r holds slice r *
        sp + s)."""
        sp, ring = self.mesh.shape["sp"], self.ring_size
        out = _all_gather_dim0(x.unsqueeze(0), self.mesh.group("sp", "ring"), sp * ring)
        b, s_loc, rest = x.shape[0], x.shape[1], x.shape[2:]
        out = out.view(sp, ring, b, s_loc, *rest).transpose(0, 1)  # [ring, sp, B, S_loc, ...]
        return out.movedim(2, 0).reshape(b, ring * sp * s_loc, *rest)

    # ---- attention -----------------------------------------------------
    def can_shard_heads(self, n_heads: int) -> bool:
        """True when Ulysses splits the heads: sp divides their count."""
        return n_heads % self.mesh.shape["sp"] == 0

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        """Ulysses all-to-all inside the sp group: heads-major [B, N, S_loc, D]
        (any strides) -> [B, N / sp, sp * S_loc, D], contiguous: this rank's
        heads over the ring shard's sequence."""
        sp = self.mesh.shape["sp"]
        b, n, s_loc, d = x.shape
        inp = x.reshape(b, sp, n // sp, s_loc, d).transpose(0, 1).contiguous()
        out = _all_to_all(inp, self.mesh.group("sp"))
        return out.permute(1, 2, 0, 3, 4).reshape(b, n // sp, sp * s_loc, d)

    def tokens_from_heads(self, y: torch.Tensor) -> torch.Tensor:
        """The inverse all-to-all of :meth:`heads` on an attention output
        [B, S_ring, N / sp, D] (seq-major, as K4 writes it; any strides) ->
        this rank's tokens [B, S_loc, N * D], heads in global order."""
        sp = self.mesh.shape["sp"]
        b, s, nh, d = y.shape
        inp = y.reshape(b, sp, s // sp, nh, d).transpose(0, 1).contiguous()
        out = _all_to_all(inp, self.mesh.group("sp"))  # [sp (head slice), B, S_loc, N/sp, D]
        return out.permute(1, 2, 0, 3, 4).reshape(b, s // sp, sp * nh * d)

    def ulysses_attention(self, q, k, v, attend, k_valid_len: int, window, scale: float,
                          shard_heads: bool = True) -> torch.Tensor:
        """Self-attention of this rank's tokens: q, k, v heads-major [B, N,
        S_loc, D] views; ``attend(q, k, v)`` the single-device attention on
        [B, S, h, D] views of whole sequences (K4, K10 or the sim). Where sp
        divides N (and ``shard_heads``): :meth:`heads`, then ``attend`` on the
        rank's heads over the ring shard's sequence, or :meth:`ring_attention`
        over the ring (``scale`` and ``window`` on global positions), then
        :meth:`tokens_from_heads`; else every head on the sequence gathered over
        sp x ring, this rank's tokens kept (GSPMD's result there). Returns [B,
        S_loc, N * D]."""
        b, n, s_loc, d = q.shape
        if shard_heads and self.can_shard_heads(n):
            qh, kh, vh = (self.heads(t).transpose(1, 2) for t in (q, k, v))
            if self.ring_size > 1:
                y = self.ring_attention(qh, kh, vh, scale=scale, k_valid_len=k_valid_len,
                                        window=window)
            else:
                y = attend(qh, kh, vh)
            return self.tokens_from_heads(y)
        y = attend(*(self.gather_tokens(t.transpose(1, 2)) for t in (q, k, v)))
        return self.tokens(y).reshape(b, s_loc, n * d)

    def ring_attention(self, q, k, v, scale=None, k_valid_len=None, window=None):
        """Attention of the ring shard [B, S_ring, H, D] views over the ring
        group (``parallel/ring.py``)."""
        from wanq_tpu_torch.parallel.ring import ring_attention

        return ring_attention(q, k, v, group=self.mesh.group("ring"), scale=scale,
                              k_valid_len=k_valid_len, window=window)

    # ---- weights ---------------------------------------------------------
    def _buffer(self, key, shape, dtype, device) -> torch.Tensor:
        buf = self._buffers.get(key)
        if buf is None or buf.shape != tuple(shape) or buf.dtype != dtype:
            buf = self._buffers[key] = torch.empty(shape, dtype=dtype, device=device)
        return buf

    def gather_weights(self, tree, slot: str = "block"):
        """The tree with every Shard replaced by its whole tensor: one
        all-gather over the storage group per pack, into buffers kept under
        ``slot`` and the leaf's path, so every block reuses the same ones (the
        blocks run in turn on one stream). Replicated leaves pass through."""
        shards = [(p, leaf) for p, leaf in _walk(tree) if isinstance(leaf, Shard)]
        if not shards:
            return tree
        group, fs, _ = self.storage()
        gathered = {}
        for _, sh in shards:
            if id(sh.pack) in gathered:
                continue
            recv = self._buffer((slot, "recv", len(gathered)), (fs * sh.pack.numel(),),
                                torch.uint8, sh.pack.device)
            _all_gather_into(recv, sh.pack, group)
            gathered[id(sh.pack)] = recv.view(fs, sh.pack.numel())

        def whole(path, leaf):
            if not isinstance(leaf, Shard):
                return leaf
            nb = leaf.local.numel() * leaf.local.element_size()
            src = gathered[id(leaf.pack)][:, leaf.offset:leaf.offset + nb]
            src = src.view(leaf.dtype).view(fs, *leaf.local.shape)
            full = self._buffer((slot, path), leaf.full_shape, leaf.dtype, leaf.local.device)
            d = leaf.dim
            split = (*leaf.full_shape[:d], fs, leaf.local.shape[d], *leaf.full_shape[d + 1:])
            full.view(split).copy_(src.movedim(0, d))
            return full

        return _map(tree, whole)


def _all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    if group is None:
        out.copy_(x.reshape(-1))
    else:
        dist.all_gather_into_tensor(out, x, group=group)


def _all_gather_dim0(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[m, ...] -> [n * m, ...], the group's ranks in order."""
    if group is None:
        return x
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Slice i of x's dim 0 to the group's rank i; slice j of the result from
    rank j."""
    if group is None:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def shard_params(params, plan: ShardingPlan):
    """This rank's storage of the DiT's params: each leaf of
    :func:`param_shardings` cut to its slice, the blocks' shards packed one
    block a pack and the rest in one more (a block's weights gather in one
    collective)."""
    specs = param_shardings(params, plan.mesh, plan.full_shard)
    _, _, index = plan.storage()
    cut = _map(params, lambda path, leaf: slice_leaf(leaf, _at(specs, path), index)
               if torch.is_tensor(leaf) else leaf)
    return pack_params(cut)


def pack_params(params):
    """Pack the Shards of a DiT param tree: one pack a block, one for the rest."""
    for block in params.get("blocks", []):
        pack_shards(block)
    pack_shards({k: v for k, v in params.items() if k != "blocks"})
    return params


def shard_t5_params(params, plan: ShardingPlan):
    """The umT5 encoder's storage over ``fsdp`` (:func:`t5_leaf_sharding`),
    packed a block at a time."""
    fs_index = plan.mesh.index("fsdp")
    cut = _map(params, lambda path, leaf: slice_leaf(leaf, t5_leaf_sharding(
        plan.mesh, path[-1], leaf.ndim, tuple(leaf.shape)), fs_index)
        if torch.is_tensor(leaf) else leaf)
    return pack_t5_params(cut)


def pack_t5_params(params):
    """Pack the Shards of a umT5 param tree: one pack a block and one for the
    rest, but the token embedding (looked up where it lies, never gathered)."""
    for block in params.get("blocks", []):
        pack_shards(block)
    pack_shards({k: v for k, v in params.items() if k not in ("blocks", "token_embedding")})
    return params


def _at(tree, path):
    for p in path:
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree
