"""Tree <-> lane-aligned buffer packing: the port of ``repro.kernels.pack``.

The D-Adam kernels work on one ``(rows, 128)`` (flat) or ``(K, rows, 128)``
(stacked) buffer; parameters are ragged trees. A :class:`PackSpec` records
the leaf layout once, and :func:`pack` / :func:`unpack` move congruent
trees in and out of the buffer. The layouts, offsets and padding are equal
element for element to the JAX package's, so buffers cross between the two
packages as plain copies:

* **flat** (``make_spec(tree)``): every element of every leaf, in leaf
  order, in one buffer padded to whole ``(block_rows, 128)`` tiles;
* **stacked** (``stacked=True``): the leading worker dim K is kept, and
  row k of the buffer holds exactly worker k's elements;
* **stacked + leaf-aligned** (``leaf_align=True``): every leaf segment is
  padded to whole tiles, so each leaf owns a tile-aligned row range
  (:func:`leaf_row_ranges`). This is the resident layout of the packed
  optimizer state.

Padding is zero, and the optimizer kernels map zeros to zeros, so a
resident buffer's padding stays zero across steps. Mixed-dtype trees pack
in the widest float dtype and cast back per leaf. Integer leaves are
rejected. The row-sharded 2D layout (``row_shards > 1``) is not ported yet.

:func:`unpack_worker` and :func:`unpack_mean` decode ONE per-worker tree
straight out of a stacked buffer (the serving publish path): one worker's
row block, or the mean over the worker dim taken in the packed domain.
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch._tree import TreeDef, tree_flatten, tree_leaves, tree_unflatten

PyTree = Any

LANE = 128
# the tile quantum of the resident layout, equal to the JAX package's so
# that offsets and padding agree element for element
BLOCK_ROWS = 256


class PackSpec(NamedTuple):
    treedef: TreeDef
    shapes: Tuple[Tuple[int, ...], ...]   # full leaf shapes (incl. K if stacked)
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]                # per-(worker-)leaf element counts
    offsets: Tuple[int, ...]              # per-leaf start in the padded
    #                                       per-worker flat buffer
    n: int                                # true elements per worker
    rows: int                             # padded rows: rows * LANE >= n
    k: Optional[int]                      # worker count; None in flat mode

    @property
    def stacked(self) -> bool:
        return self.k is not None

    @property
    def padded(self) -> int:
        return self.rows * LANE

    @property
    def leaf_aligned(self) -> bool:
        """True when every leaf segment starts on a LANE boundary."""
        return all(o % LANE == 0 for o in self.offsets) and \
            self.padded % LANE == 0

    def buf_shape(self) -> Tuple[int, ...]:
        return ((self.k, self.rows, LANE) if self.stacked
                else (self.rows, LANE))


def _require_float(dtypes, what: str) -> None:
    for dt in dtypes:
        if not dt.is_floating_point:
            raise ValueError(
                f"{what} requires float leaves; got dtype {dt} — packing "
                "integer data through the float buffer would corrupt it in "
                "the kernels' sqrt/sign math (cast it explicitly first, or "
                "keep it out of the packed tree)")


def make_spec(tree: PyTree, *, stacked: bool = False,
              block_rows: int = 1, leaf_align: bool = False,
              row_shards: int = 1) -> PackSpec:
    """Record the layout of ``tree``, padded to whole ``(block_rows, LANE)``
    tiles (every leaf segment, with ``leaf_align``)."""
    if row_shards < 1:
        raise ValueError(f"row_shards must be >= 1, got {row_shards}")
    if row_shards > 1:
        raise NotImplementedError(
            "the row-sharded 2D layout (row_shards > 1) is not ported yet "
            "(ROADMAP queue 1: multi-GPU comm)")
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot pack an empty pytree")
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    _require_float(dtypes, "pack()")
    k: Optional[int] = None
    if stacked:
        ks = {s[0] if s else None for s in shapes}
        if len(ks) != 1 or None in ks:
            raise ValueError(
                f"stacked pack needs a shared leading worker dim; got {shapes}")
        (k,) = ks
        sizes = tuple(math.prod(s[1:]) for s in shapes)
    else:
        sizes = tuple(math.prod(s) for s in shapes)
    per_tile = block_rows * LANE
    if leaf_align:
        seg = tuple(sz + (-sz) % per_tile for sz in sizes)
        padded = sum(seg)
    else:
        seg = sizes
        n_true = sum(sizes)
        padded = n_true + (-n_true) % per_tile
    offsets = tuple(sum(seg[:i]) for i in range(len(seg)))
    return PackSpec(treedef=treedef, shapes=shapes, dtypes=dtypes,
                    sizes=sizes, offsets=offsets, n=sum(sizes),
                    rows=padded // LANE, k=k)


def leaf_row_ranges(spec: PackSpec) -> Tuple[Tuple[int, int], ...]:
    """Per-leaf (row_start, row_end) within the buffer; needs the
    leaf-aligned layout."""
    if not spec.leaf_aligned:
        raise ValueError("leaf_row_ranges needs a leaf_align=True spec")
    ends = spec.offsets[1:] + (spec.padded,)
    return tuple((o // LANE, e // LANE)
                 for o, e in zip(spec.offsets, ends))


def pack(tree: PyTree, spec: PackSpec,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Copy ``tree`` into a fresh zero-filled ``spec.buf_shape()`` buffer,
    on the device of its first leaf. ``dtype`` defaults to the widest
    dtype among the leaves."""
    leaves = tree_leaves(tree)
    got = tuple(tuple(l.shape) for l in leaves)
    if got != spec.shapes:
        raise ValueError(f"tree does not match spec: {got} vs {spec.shapes}")
    _require_float([l.dtype for l in leaves], "pack()")
    dt = dtype
    if dt is None:
        dt = leaves[0].dtype
        for l in leaves[1:]:
            dt = torch.promote_types(dt, l.dtype)
    buf = torch.zeros(spec.buf_shape(), dtype=dt, device=leaves[0].device)
    flat = buf.view(spec.k, -1) if spec.stacked else buf.view(-1)
    for l, o, sz in zip(leaves, spec.offsets, spec.sizes):
        flat[..., o:o + sz] = l.reshape(flat.shape[:-1] + (sz,))
    return buf


def _leaf_views(buf: torch.Tensor, spec: PackSpec) -> List[torch.Tensor]:
    """Each leaf's range of ``buf`` in the leaf's shape: a view of ``buf``
    (cast to the leaf's dtype where it differs from the buffer's)."""
    flat = buf.reshape(spec.k, -1) if spec.stacked else buf.reshape(-1)
    return [flat[..., o:o + sz].reshape(shape).to(dt)
            for o, sz, dt, shape in zip(spec.offsets, spec.sizes,
                                        spec.dtypes, spec.shapes)]


class _Unpack(torch.autograd.Function):
    """The leaf views of :func:`_leaf_views`, with a backward that builds
    the packed gradient in ONE buffer: each leaf's gradient is copied into
    its range and only the padding (and the range of a leaf without a
    gradient) is zeroed. Autograd through plain views would give every
    leaf a zero-filled buffer of the whole packed size and then add them;
    this is the counterpart of JAX's transpose of ``unpack``, one pad."""

    @staticmethod
    def forward(ctx, buf: torch.Tensor, spec: PackSpec):
        ctx.spec, ctx.buf_dtype, ctx.buf_device = spec, buf.dtype, buf.device
        ctx.set_materialize_grads(False)
        return tuple(_leaf_views(buf, spec))

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        out = torch.empty(spec.buf_shape(), dtype=ctx.buf_dtype,
                          device=ctx.buf_device)
        flat = out.view(spec.k, -1) if spec.stacked else out.view(-1)
        ends = spec.offsets[1:] + (spec.padded,)
        for g, o, sz, end, shape in zip(grads, spec.offsets, spec.sizes,
                                        ends, spec.shapes):
            dst = flat[..., o:o + sz]
            if g is None:
                dst.zero_()
            else:
                dst.view(shape).copy_(g)
            if end > o + sz:
                flat[..., o + sz:end].zero_()
        return out, None


def unpack(buf: torch.Tensor, spec: PackSpec) -> PyTree:
    """Inverse of :func:`pack`. Every leaf whose dtype is the buffer's is
    a VIEW of ``buf``. When autograd records the call (``buf`` requires
    grad), the leaves come from one ``autograd.Function`` whose backward
    writes the gradient of every leaf into one packed buffer, zero in the
    padding: the packed grad pipeline differentiates a loss through these
    leaves and gets the gradient packed."""
    if torch.is_grad_enabled() and buf.requires_grad:
        leaves = list(_Unpack.apply(buf, spec))
    else:
        leaves = _leaf_views(buf, spec)
    return tree_unflatten(spec.treedef, leaves)


def _unpack_one_row(row: torch.Tensor, spec: PackSpec) -> PyTree:
    """Decode one worker's ``(rows, LANE)`` block into the per-worker
    tree (leaf shapes without the leading K dim)."""
    flat = row.reshape(-1)
    leaves = [flat[o:o + sz].to(dt).reshape(shape[1:])
              for o, sz, dt, shape in zip(spec.offsets, spec.sizes,
                                          spec.dtypes, spec.shapes)]
    return tree_unflatten(spec.treedef, leaves)


def _check_stacked(buf: torch.Tensor, spec: PackSpec, what: str) -> None:
    if not spec.stacked:
        raise ValueError(f"{what} needs a stacked spec")
    if tuple(buf.shape) != spec.buf_shape():
        raise ValueError(f"buffer shape {tuple(buf.shape)} does not match "
                         f"spec {spec.buf_shape()}")


def unpack_worker(buf: torch.Tensor, spec: PackSpec, k: int) -> PyTree:
    """Worker ``k``'s param tree straight from the stacked buffer, reading
    1/K of it. The leaves are a copy: the published tree does not change
    when the trainer's buffer does."""
    _check_stacked(buf, spec, "unpack_worker")
    k = int(k)
    if not 0 <= k < spec.k:
        raise ValueError(f"worker index {k} out of range for K={spec.k}")
    return _unpack_one_row(buf[k].clone(), spec)


def unpack_mean(buf: torch.Tensor, spec: PackSpec) -> PyTree:
    """The consensus-mean param tree straight from the stacked buffer: the
    worker dim is reduced in the packed domain into one ``(rows, LANE)``
    block and that block decoded. The workers are summed in index order in
    f32 and divided by K, then rounded to the buffer's dtype (JAX's
    ``jnp.mean`` also accumulates a bf16 buffer in f32), so the result
    does not depend on a reduction order; it agrees with JAX's to f32
    rounding."""
    _check_stacked(buf, spec, "unpack_mean")
    acc = buf[0].to(torch.float32, copy=True)
    for i in range(1, spec.k):
        acc += buf[i]
    return _unpack_one_row((acc / spec.k).to(buf.dtype), spec)
