"""Worker and model placement for ``comm='axis'``: the port of the worker
part of ``repro.launch.shardings`` (``worker_state_shardings``) and of
its 2D model axis.

In the JAX package an axis state is one global array whose leading
worker dim lies on the ``'worker'`` mesh axis, and on a 2D mesh the row
dim of every packed ``(K, rows, 128)`` buffer lies on the ``'model'``
axis. Here each rank holds its own worker's rows: :func:`take_worker`
cuts rank w's ``(1, ...)`` slice out of a stacked ``(K, ...)`` tree, and
:func:`gather_workers` puts the K slices back together on every rank.
Under the 2D layout a rank of model index m also keeps only block m of
its worker's packed buffers (:func:`take_model_block`, the
``(1, rows / M, 128)`` rows of the row-sharded layout, and rows of the
delay rings likewise) and :func:`gather_model` assembles the worker's
whole buffers again; every other leaf (the count, the ``(K, L)`` scales,
ages, batches) is replicated over the model group.

The 2D layout's sharding plan is the port of ``make_plan(mode='axis')``
and its rule engine (``param_pspec`` with the head-aware rules): for each
stacked leaf, the dim that the worker's model group cuts, or none. Where
JAX hands the plan's ``PartitionSpec``s to GSPMD as constraints, the port
acts on them itself: a rank of a worker's model group holds its plan
shard of every matrix, moved out of its packed block and back by
:class:`Redistribution` (built once per ``(PackSpec, plan, rank)``, two
counted ``model_redistribute`` calls a step), and multiplies with it
through ``train.grad.PlanCtx``. Vector leaves (norm scales, biases that
are added to whole activations) and leaves the plan replicates are held
whole on every rank. The TPU meshes' modes (``stacked`` / ``pods`` /
``global``) and the serving side of the plans (``serve_groups``, the
batch and cache specs, ``tree_shardings``) are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch._tree import keystr, tree_map
from repro_torch.kernels import pack as packing
from repro_torch.launch.mesh import (WorkerGroup, all_gather_workers,
                                     model_all_gather, model_redistribute)

PyTree = Any


def take_worker(tree: PyTree, rank: int, K: int,
                copy: bool = True) -> PyTree:
    """Worker ``rank``'s slice of every tensor leaf whose leading dim is
    the worker count ``K``, as a ``(1, ...)`` copy of its own (a view
    without ``copy``); other leaves (scalars, host counters, worker-free
    tensors) pass as they are."""
    def one(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == K:
            x = x.narrow(0, rank, 1)
            return x.clone(memory_format=torch.contiguous_format) \
                if copy else x
        return x

    return tree_map(one, tree)


def gather_workers(tree: PyTree, wg: WorkerGroup,
                   kind: str = "worker_all_gather") -> PyTree:
    """Every worker's ``(1, ...)`` slice of each tensor leaf, concatenated
    along the worker dim in worker order (equal to the bit), on every
    rank; non-tensor leaves pass as they are. Every rank must call it
    with a tree of the same structure and shapes; under the 2D layout the
    slices come from the ranks of this rank's model index. The bytes are
    counted under ``kind``."""
    def one(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1:
            return all_gather_workers(x, wg, kind)
        return x

    return tree_map(one, tree)


def take_model_block(state: Any, wg: WorkerGroup) -> Any:
    """A packed state (its buffers the worker's whole ``(1, rows, 128)``
    row-sharded layout) cut to this rank's block m: rows
    ``[m rows / M, (m + 1) rows / M)`` of every packed buffer, as copies
    of their own. Anything else passes as it is."""
    if wg.M == 1 or not hasattr(state, "map_buffers"):
        return state
    m = wg.model_rank

    def block(x: torch.Tensor, dim: int) -> torch.Tensor:
        rows = x.shape[dim] // wg.M
        return x.narrow(dim, m * rows, rows).clone(
            memory_format=torch.contiguous_format)

    return state.map_buffers(block)


def gather_model(state: Any, wg: WorkerGroup) -> Any:
    """The inverse of :func:`take_model_block`: every packed buffer of the
    rank's block assembled from the M blocks of its worker, on every rank
    of the model group (one all-gather a buffer). Every rank of the group
    must call it."""
    if wg.M == 1 or not hasattr(state, "map_buffers"):
        return state
    return state.map_buffers(lambda x, dim: model_all_gather(x, wg, dim))


# ------------------------------ the 2D plan ----------------------------------

_LAYER_STACK_KEYS = ("layers", "enc_layers", "dec_layers")
# the worker-mapping modes of the JAX package's TPU meshes
_TPU_MODES = ("stacked", "pods", "global")
# vector leaves that a column-parallel product's output takes as its own
# shard (starcoder2's ``b_in`` beside ``w_in``); every other vector leaf
# is held whole
SPLIT_VECTORS = ("b_in",)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """The port of JAX's ``ShardingPlan`` for ``mode='axis'``: a worker
    axis of ``K`` workers and, when ``M`` > 1, a model group of M ranks a
    worker that cuts the leaves by :func:`param_pspec`. ``model_cfg``
    carries the head-aware rules (``_head_aware_rule``)."""

    K: int
    M: int
    mode: str = "axis"
    model_cfg: Any = None

    def for_group(self, group: WorkerGroup) -> "ShardingPlan":
        """The same plan over another group's (K, M): an elastic resize
        keeps its plan this way."""
        return dataclasses.replace(self, K=group.K, M=group.M)


def make_plan(arch: Any, group: "WorkerGroup | Tuple[int, int]", *,
              mode: str = "axis") -> ShardingPlan:
    """The plan of ``arch`` (an ``ArchConfig``) over ``group``, a
    ``WorkerGroup`` or its ``(K, M)``: JAX's ``make_plan(arch, mesh,
    mode='axis')`` with the group in place of the mesh.

    Raises ``NotImplementedError`` for the TPU meshes' modes and
    ``ValueError`` for an unknown one."""
    if mode in _TPU_MODES:
        raise NotImplementedError(
            f"mode={mode!r} maps workers onto a TPU mesh's data and pod "
            "axes; the port runs comm='axis' groups only (mode='axis')")
    if mode != "axis":
        raise ValueError(f"unknown worker mode {mode!r}")
    K, M = ((group.K, group.M) if isinstance(group, WorkerGroup)
            else (int(group[0]), int(group[1])))
    return ShardingPlan(K=K, M=M, mode=mode,
                        model_cfg=getattr(arch, "model", arch))


def _path_names(path: "Sequence[Any] | str") -> List[str]:
    """The key names of a leaf path: the port's ``('['layers']',
    '['attn']', ...)`` entries, a ``keystr``, or plain names."""
    if isinstance(path, str):
        path = [path]
    out: List[str] = []
    for p in path:
        for part in str(p).replace(".", "[").split("["):
            part = part.strip("]'\"")
            if part:
                out.append(part)
    return out


def _assign_model(shape: Sequence[int], M: int,
                  skip: Sequence[int] = ()) -> Optional[int]:
    """JAX's greedy ``_assign_groups`` for the one ``('model',)`` group:
    the largest dim not skipped that M divides (the first of equals), or
    none."""
    cand = [(d, shape[d]) for d in range(len(shape))
            if d not in skip and shape[d] % M == 0 and shape[d] >= M
            and M > 1]
    if not cand:
        return None
    return max(cand, key=lambda t: t[1])[0]


def _head_aware_rule(plan: ShardingPlan, leaf: str) -> str:
    """'col' (the greedy rule), 'row' (the input dim) or 'replicate' for
    the model group's cut of this leaf: JAX's rules, family-blind, with
    its reasons (a GQA K/V projection whose KV heads do not divide the
    model group is replicated; so are the ssm family's ``u``, ``gn`` and
    ``gn_b`` and the hybrid family's conv and decay leaves; the hybrid's
    ``in_proj`` / ``out_proj`` are cut on their input dim)."""
    cfg = plan.model_cfg
    if cfg is None or plan.M <= 1:
        return "col"
    M = plan.M
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    if leaf in ("wk", "wv"):
        if cfg.n_kv_heads % M == 0:
            return "col"
        return ("replicate" if cfg.n_kv_heads * hd * 2 <= cfg.d_model
                else "col")
    if leaf in ("bk", "bv") and cfg.n_kv_heads % M != 0:
        return "replicate"
    if leaf in ("u", "gn", "gn_b") and cfg.family == "ssm":
        return "replicate"
    if leaf in ("in_proj", "out_proj") and cfg.family in ("hybrid",):
        return "row"
    if leaf in ("conv_w", "conv_b", "A_log", "D", "dt_bias") \
            and cfg.family in ("hybrid",):
        return "replicate"
    return "col"


def param_pspec(plan: ShardingPlan, path: "Sequence[Any] | str",
                shape: Tuple[int, ...], *, stacked: bool = True
                ) -> Optional[int]:
    """The dim of ``shape`` (the worker dim first when ``stacked``) that
    the model group cuts, or ``None``: where JAX's ``param_pspec`` puts
    ``'model'`` in the leaf's ``PartitionSpec``. The worker dim and a
    per-layer stack's layer dim are never cut; the rest follows
    :func:`_head_aware_rule` and the greedy rule."""
    if len(shape) == 0 or plan.M <= 1:
        return None
    names = _path_names(path)
    d0 = 1 if stacked else 0
    skip = [d0] if any(k in names for k in _LAYER_STACK_KEYS) \
        and len(shape) > d0 else []
    inner = tuple(shape[d0:])
    inner_skip = [s - d0 for s in skip]
    rule = _head_aware_rule(plan, names[-1] if names else "")
    if rule == "replicate":
        return None
    if rule == "row" and len(inner) - len(inner_skip) >= 2:
        row = next(i for i in range(len(inner)) if i not in inner_skip)
        return row + d0 if inner[row] % plan.M == 0 else None
    d = _assign_model(inner, plan.M, inner_skip)
    return None if d is None else d + d0


@dataclasses.dataclass(frozen=True)
class LeafCut:
    """One leaf under a plan: its last key name, its per-worker shape,
    whether it lies in a per-layer stack, the per-worker dim the plan cuts
    (``None``: none), and how a rank holds it: ``'shard'`` (its 1/M slice
    of ``cut``) or ``'whole'``."""

    name: str
    shape: Tuple[int, ...]
    layered: bool
    cut: Optional[int]
    held: str

    @property
    def use_cut(self) -> Optional[int]:
        """The cut dim of one use of the leaf: of a layer's slice for a
        per-layer stack, else of the leaf."""
        if self.held != "shard":
            return None
        return self.cut - 1 if self.layered else self.cut

    def shard_shape(self, M: int) -> Tuple[int, ...]:
        if self.held != "shard":
            return self.shape
        s = list(self.shape)
        s[self.cut] //= M
        return tuple(s)


def leaf_cuts(plan: ShardingPlan, spec: packing.PackSpec) -> List[LeafCut]:
    """Every leaf of ``spec`` (a stacked one) under ``plan``: a matrix the
    plan cuts is held as its shard, and so is a vector of
    :data:`SPLIT_VECTORS`; other vectors and the leaves the plan does not
    cut are held whole."""
    from repro_torch._tree import _paths

    paths: List[Tuple[str, ...]] = []
    _paths(spec.treedef, (), paths)
    out = []
    for path, shape in zip(paths, spec.shapes):
        names = _path_names(path)
        layered = any(k in names for k in _LAYER_STACK_KEYS)
        cut = param_pspec(plan, path, shape, stacked=True)
        per_use = len(shape) - 1 - int(layered)
        name = names[-1] if names else keystr(path)
        held = ("shard" if cut is not None and (
            per_use >= 2 or name in SPLIT_VECTORS) else "whole")
        out.append(LeafCut(name, tuple(shape[1:]), layered,
                           None if cut is None else cut - 1, held))
    return out


# ------------------------- block <-> plan shards -----------------------------

# (source offset in the leaf's chunk, destination offset in the shard,
# runs, run length, source stride, destination stride)
Piece = Tuple[int, int, int, int, int, int]


def _run_pieces(size: int, chunk: int, run: int, M: int, j: int,
                m: int) -> List[Piece]:
    """The elements of a leaf's chunk ``j`` (flat ``[j chunk, (j + 1)
    chunk)`` of the leaf, ``size`` elements long) that shard ``m`` holds,
    for a leaf cut into runs of ``run`` elements dealt to the shards in
    turn (run q belongs to shard ``q % M``, at ``(q // M) run`` there):
    at most one partial run at each end and one strided piece of whole
    runs between."""
    lo, hi = j * chunk, min((j + 1) * chunk, size)
    out: List[Piece] = []
    if lo >= hi:
        return out
    if lo % run:
        q = lo // run
        end = min((q + 1) * run, hi)
        if q % M == m:
            out.append((0, (q // M) * run + lo % run, 1, end - lo, 0, 0))
        if end == hi:
            return out
    qa, qb = -(-lo // run), hi // run
    q0 = qa + (m - qa) % M
    if q0 < qb:
        out.append((q0 * run - lo, (q0 // M) * run,
                    (qb - 1 - q0) // M + 1, run, M * run, run))
    if hi % run and qb % M == m:
        out.append((qb * run - lo, (qb // M) * run, 1, hi - qb * run, 0, 0))
    return out


def _strided(flat: torch.Tensor, offset: int, piece: Piece,
             src: bool) -> torch.Tensor:
    """The piece's ``(runs, length)`` view of a flat tensor, on its
    source (``src``) or its destination side."""
    s_off, d_off, count, length, s_stride, d_stride = piece
    off, stride = (s_off, s_stride) if src else (d_off, d_stride)
    return flat.as_strided((count, length), (stride, 1),
                           flat.storage_offset() + offset + off)


class Redistribution:
    """The index maps between this rank's packed block and its plan
    shards, built once per ``(PackSpec, plan, model rank)`` on the host:
    for each leaf and each pair (block j, shard m) the strided pieces of
    :func:`_run_pieces`. A leaf held whole takes every block's chunk.

    :meth:`to_shards` moves a ``(1, rows / M, 128)`` block out to the
    rank's shards (one ``model_redistribute``: each rank receives from
    each peer the elements of its shards that the peer's block holds);
    :meth:`to_block` moves shard-shaped gradients back into a block (the
    reverse call; a whole leaf's gradient, the same on every rank, gives
    this rank its own chunk with nothing sent). No rank receives a whole
    matrix: of a matrix leaf cut into M runs a row, a rank receives about
    (M - 1) / M^2 of its elements."""

    def __init__(self, spec: packing.PackSpec, plan: ShardingPlan, m: int):
        if spec.row_shards != plan.M or not spec.stacked:
            raise ValueError(
                f"a plan over M={plan.M} needs a stacked row-sharded spec "
                f"of {plan.M} blocks; got row_shards={spec.row_shards}")
        self.spec, self.plan, self.m = spec, plan, m
        self.cuts = leaf_cuts(plan, spec)
        M = plan.M
        chunks = packing.local_chunk_elems(spec)
        # pieces[i][(j, k)]: leaf i, from block j to the shard of rank k
        self.pieces: List[Dict[Tuple[int, int], List[Piece]]] = []
        for lc, size, c in zip(self.cuts, spec.sizes, chunks):
            by_pair: Dict[Tuple[int, int], List[Piece]] = {}
            for j in range(M):
                for k in range(M):
                    if lc.held == "whole":
                        lo, hi = j * c, min((j + 1) * c, size)
                        by_pair[(j, k)] = ([(0, lo, 1, hi - lo, 0, 0)]
                                           if hi > lo else [])
                    else:
                        run = (math.prod(lc.shape[lc.cut:]) // M)
                        by_pair[(j, k)] = _run_pieces(size, c, run, M, j, k)
            self.pieces.append(by_pair)
        self.offsets = spec.offsets
        self.chunks = chunks

    def _count(self, i: int, j: int, k: int) -> int:
        return sum(p[2] * p[3] for p in self.pieces[i][(j, k)])

    def shard_shapes(self) -> List[Tuple[int, ...]]:
        """Each leaf's shape on this rank, the worker dim first."""
        return [(1,) + lc.shard_shape(self.plan.M) for lc in self.cuts]

    def to_shards(self, block: torch.Tensor, group: WorkerGroup
                  ) -> List[torch.Tensor]:
        """This rank's shard of every leaf (a whole leaf for one held
        whole), in the block's dtype, from its ``(1, rows / M, 128)``
        ``block``: one counted ``model_redistribute`` over the model
        group."""
        M, m = self.plan.M, self.m
        flat = block.detach().reshape(-1)
        shards = [torch.empty(math.prod(s), dtype=block.dtype,
                              device=block.device)
                  for s in self.shard_shapes()]
        sends, sizes = {}, {}
        for k in range(M):
            if k == m:
                continue
            parts = [_strided(flat, o, p, True)
                     for i, o in enumerate(self.offsets)
                     for p in self.pieces[i][(m, k)]]
            sends[k] = (torch.cat([x.reshape(-1) for x in parts]) if parts
                        else flat.new_empty(0))
            sizes[k] = sum(self._count(i, k, m)
                           for i in range(len(self.cuts)))
        for i, o in enumerate(self.offsets):
            for p in self.pieces[i][(m, m)]:
                _strided(shards[i], 0, p, False).copy_(
                    _strided(flat, o, p, True))
        got = model_redistribute(sends, sizes, group)
        for k, buf in got.items():
            at = 0
            for i in range(len(self.cuts)):
                for p in self.pieces[i][(k, m)]:
                    n = p[2] * p[3]
                    _strided(shards[i], 0, p, False).copy_(
                        buf[at:at + n].view(p[2], p[3]))
                    at += n
        return [x.view(s) for x, s in zip(shards, self.shard_shapes())]

    def to_block(self, grads: Sequence[torch.Tensor], group: WorkerGroup,
                 dtype: torch.dtype) -> torch.Tensor:
        """The ``(1, rows / M, 128)`` block of ``dtype`` whose elements
        are this rank's part of ``grads`` (one shard-shaped tensor a leaf,
        as :meth:`to_shards` gives the params), zero in the padding: one
        counted ``model_redistribute``, the reverse of :meth:`to_shards`.
        A leaf held whole has its whole gradient on every rank, and this
        rank keeps its own chunk of it."""
        spec, M, m = self.spec, self.plan.M, self.m
        block = torch.empty(spec.block_shape(), dtype=dtype,
                            device=grads[0].device)
        flat = block.view(-1)
        gflat = [g.detach().reshape(-1) for g in grads]
        for i, (o, c, size) in enumerate(zip(self.offsets, self.chunks,
                                             spec.sizes)):
            valid = max(0, min(c, size - m * c))
            flat[o + valid:o + c].zero_()
        sends, sizes = {}, {}
        for k in range(M):
            if k == m:
                continue
            parts = [_strided(gflat[i], 0, p, False)
                     for i, lc in enumerate(self.cuts) if lc.held == "shard"
                     for p in self.pieces[i][(k, m)]]
            sends[k] = (torch.cat([x.reshape(-1) for x in parts]).to(dtype)
                        if parts else flat.new_empty(0))
            sizes[k] = sum(self._count(i, m, k)
                           for i, lc in enumerate(self.cuts)
                           if lc.held == "shard")
        for i, o in enumerate(self.offsets):
            for p in self.pieces[i][(m, m)]:
                _strided(flat, o, p, True).copy_(
                    _strided(gflat[i], 0, p, False))
        got = model_redistribute(sends, sizes, group)
        for k, buf in got.items():
            at = 0
            for i, o in enumerate(self.offsets):
                if self.cuts[i].held != "shard":
                    continue
                for p in self.pieces[i][(m, k)]:
                    n = p[2] * p[3]
                    _strided(flat, o, p, True).copy_(
                        buf[at:at + n].view(p[2], p[3]))
                    at += n
        return block
