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
  optimizer state;
* **row-sharded** (``leaf_align=True, row_shards=M``): the 2D worker x
  model layout. Every leaf segment is padded to a whole multiple of M
  tiles and split into M equal chunks, and the buffer's row dim is M
  contiguous shard blocks: block j holds the j-th chunk of EVERY leaf, in
  leaf order. A rank of a worker's model group holds one
  ``(1, rows / M, 128)`` block, and :func:`leaf_row_ranges` gives the
  leaves' row ranges within a block, the same in every block, so the
  per-(worker, leaf) kernels run unchanged on it.
  :func:`unpack_local` decodes a block into its leaf chunks and
  :func:`mirror_local` cuts unpacked per-worker data into the same
  chunks.

Padding is zero, and the optimizer kernels map zeros to zeros, so a
resident buffer's padding stays zero across steps. Mixed-dtype trees pack
in the widest float dtype and cast back per leaf. Integer leaves are
rejected.

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
    #                                       per-worker flat buffer; within
    #                                       one shard block when
    #                                       row_shards > 1
    n: int                                # true elements per worker
    rows: int                             # padded rows: rows * LANE >= n
    k: Optional[int]                      # worker count; None in flat mode
    row_shards: int = 1                   # model shards of the row dim

    @property
    def stacked(self) -> bool:
        return self.k is not None

    @property
    def padded(self) -> int:
        return self.rows * LANE

    @property
    def local_rows(self) -> int:
        """Rows of one shard block (``rows`` when not row-sharded)."""
        return self.rows // self.row_shards

    @property
    def leaf_aligned(self) -> bool:
        """True when every leaf segment starts on a LANE boundary."""
        return all(o % LANE == 0 for o in self.offsets) and \
            self.padded % LANE == 0

    def buf_shape(self) -> Tuple[int, ...]:
        return ((self.k, self.rows, LANE) if self.stacked
                else (self.rows, LANE))

    def block_shape(self) -> Tuple[int, ...]:
        """The shape of one shard block, ``(K, local_rows, LANE)``: what
        a rank of a model group holds (the whole buffer when
        ``row_shards`` is 1)."""
        return (self.k, self.local_rows, LANE)


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
    tiles (every leaf segment, with ``leaf_align``). With ``row_shards=M``
    (which needs ``stacked`` and ``leaf_align``) every segment is padded
    to a multiple of M tiles and split across M equal shard blocks."""
    if row_shards < 1:
        raise ValueError(f"row_shards must be >= 1, got {row_shards}")
    if row_shards > 1 and not (stacked and leaf_align):
        raise ValueError(
            "row_shards > 1 needs stacked=True and leaf_align=True (the "
            "row-sharded layout is defined over leaf-aligned shard blocks)")
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
        quantum = per_tile * row_shards
        seg = tuple(sz + (-sz) % quantum for sz in sizes)
        padded = sum(seg)
        # offsets within one shard block (the whole buffer when
        # row_shards is 1): the cumulative chunk starts
        chunks = tuple(s // row_shards for s in seg)
    else:
        chunks = sizes
        n_true = sum(sizes)
        padded = n_true + (-n_true) % per_tile
    offsets = tuple(sum(chunks[:i]) for i in range(len(chunks)))
    return PackSpec(treedef=treedef, shapes=shapes, dtypes=dtypes,
                    sizes=sizes, offsets=offsets, n=sum(sizes),
                    rows=padded // LANE, k=k, row_shards=row_shards)


def leaf_row_ranges(spec: PackSpec) -> Tuple[Tuple[int, int], ...]:
    """Per-leaf (row_start, row_end) within the buffer; needs the
    leaf-aligned layout. For a row-sharded spec the ranges are those
    within one shard block, the same in every block."""
    if not spec.leaf_aligned:
        raise ValueError("leaf_row_ranges needs a leaf_align=True spec")
    return tuple((o // LANE, (o + c) // LANE)
                 for o, c in zip(spec.offsets, _shard_chunks(spec)))


def _shard_chunks(spec: PackSpec) -> Tuple[int, ...]:
    """Per-leaf element count within one shard block (the whole segment
    when ``row_shards`` is 1)."""
    ends = spec.offsets[1:] + (spec.local_rows * LANE,)
    return tuple(e - o for o, e in zip(spec.offsets, ends))


def local_chunk_elems(spec: PackSpec) -> Tuple[int, ...]:
    """Per-leaf element count of one shard block's chunk of the leaf (the
    whole padded segment when ``row_shards`` is 1); needs the
    leaf-aligned layout. Every block has the same chunk lengths."""
    if not spec.leaf_aligned:
        raise ValueError("local_chunk_elems needs a leaf_align=True spec")
    return _shard_chunks(spec)


def _blocks(buf: torch.Tensor, spec: PackSpec) -> torch.Tensor:
    """A row-sharded stacked buffer viewed ``(K, M, local_rows * LANE)``:
    shard block j at ``[:, j]``."""
    return buf.view(spec.k, spec.row_shards, -1)


def _write_leaf(dst: torch.Tensor, g: torch.Tensor, sz: int, c: int,
                zero_pad: bool) -> None:
    """Copy the ``(K, sz)`` elements of ``g`` into a leaf's ``(K, M, c)``
    chunks ``dst`` of a row-sharded buffer: chunk j takes elements
    ``[j c, (j + 1) c)``; with ``zero_pad`` the slots past ``sz`` are
    zeroed."""
    K = dst.shape[0]
    flat = g.reshape(K, sz)
    whole = sz // c if c else 0
    if whole:
        dst[:, :whole].copy_(flat[:, :whole * c].view(K, whole, c))
    rem = sz - whole * c
    if rem:
        dst[:, whole, :rem].copy_(flat[:, whole * c:])
    if zero_pad:
        if rem:
            dst[:, whole, rem:].zero_()
            whole += 1
        dst[:, whole:].zero_()


def pack(tree: PyTree, spec: PackSpec,
         dtype: Optional[torch.dtype] = None,
         block: Optional[int] = None) -> torch.Tensor:
    """Copy ``tree`` into a fresh zero-filled ``spec.buf_shape()`` buffer,
    on the device of its first leaf. ``dtype`` defaults to the widest
    dtype among the leaves. With ``block=j`` (a row-sharded spec) only
    shard block j is made, ``spec.block_shape()``: equal to the bit to
    rows ``[j local_rows, (j + 1) local_rows)`` of the whole buffer."""
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
    if block is not None:
        if spec.row_shards == 1 or not 0 <= block < spec.row_shards:
            raise ValueError(f"block {block} of a spec of "
                             f"{spec.row_shards} row shards")
        buf = torch.zeros(spec.block_shape(), dtype=dt,
                          device=leaves[0].device)
        flat = buf.view(spec.k, -1)
        for l, o, c, sz in zip(leaves, spec.offsets, _shard_chunks(spec),
                               spec.sizes):
            lo = block * c
            n = max(0, min(c, sz - lo))
            if n:
                flat[:, o:o + n].copy_(l.reshape(spec.k, sz)[:, lo:lo + n])
        return buf
    buf = torch.zeros(spec.buf_shape(), dtype=dt, device=leaves[0].device)
    if spec.row_shards > 1:
        blocks = _blocks(buf, spec)
        for l, o, c, sz in zip(leaves, spec.offsets, _shard_chunks(spec),
                               spec.sizes):
            if sz:
                _write_leaf(blocks[:, :, o:o + c], l, sz, c, False)
        return buf
    flat = buf.view(spec.k, -1) if spec.stacked else buf.view(-1)
    for l, o, sz in zip(leaves, spec.offsets, spec.sizes):
        flat[..., o:o + sz] = l.reshape(flat.shape[:-1] + (sz,))
    return buf


def _leaf_views(buf: torch.Tensor, spec: PackSpec) -> List[torch.Tensor]:
    """Each leaf's range of ``buf`` in the leaf's shape: a view of ``buf``
    (cast to the leaf's dtype where it differs from the buffer's). A
    row-sharded leaf lies in M chunks and is a copy."""
    if spec.row_shards > 1:
        blocks = _blocks(buf, spec)
        return [blocks[:, :, o:o + c].reshape(spec.k, -1)[:, :sz]
                .reshape(shape).to(dt)
                for o, c, sz, dt, shape in zip(
                    spec.offsets, _shard_chunks(spec), spec.sizes,
                    spec.dtypes, spec.shapes)]
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
        if spec.row_shards > 1:
            blocks = _blocks(out, spec)
            for g, o, c, sz in zip(grads, spec.offsets, _shard_chunks(spec),
                                   spec.sizes):
                dst = blocks[:, :, o:o + c]
                if g is None:
                    dst.zero_()
                else:
                    _write_leaf(dst, g, sz, c, True)
            return out, None
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
    a VIEW of ``buf`` (a copy in the row-sharded layout, where a leaf lies
    in M chunks). When autograd records the call (``buf`` requires
    grad), the leaves come from one ``autograd.Function`` whose backward
    writes the gradient of every leaf into one packed buffer, zero in the
    padding: the packed grad pipeline differentiates a loss through these
    leaves and gets the gradient packed."""
    if spec.row_shards > 1 and tuple(buf.shape) != spec.buf_shape():
        raise ValueError(
            f"unpack of a row-sharded spec needs the whole buffer "
            f"{spec.buf_shape()}, got {tuple(buf.shape)} (one shard block "
            "decodes with unpack_local)")
    if torch.is_grad_enabled() and buf.requires_grad:
        leaves = list(_Unpack.apply(buf, spec))
    else:
        leaves = _leaf_views(buf, spec)
    return tree_unflatten(spec.treedef, leaves)


def _unpack_one_row(row: torch.Tensor, spec: PackSpec) -> PyTree:
    """Decode one worker's ``(rows, LANE)`` block into the per-worker
    tree (leaf shapes without the leading K dim)."""
    if spec.row_shards > 1:
        flat = row.reshape(spec.row_shards, -1)
        leaves = [flat[:, o:o + c].reshape(-1)[:sz].to(dt).reshape(shape[1:])
                  for o, c, sz, dt, shape in zip(
                      spec.offsets, _shard_chunks(spec), spec.sizes,
                      spec.dtypes, spec.shapes)]
        return tree_unflatten(spec.treedef, leaves)
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


# ----------------------- one shard block (the 2D layout) ---------------------


def _local_views(block: torch.Tensor, spec: PackSpec) -> List[torch.Tensor]:
    flat = block.reshape(block.shape[0], -1)
    return [flat[:, o:o + c].to(dt)
            for o, c, dt in zip(spec.offsets, _shard_chunks(spec),
                                spec.dtypes)]


class _UnpackLocal(torch.autograd.Function):
    """:func:`unpack_local`'s chunks, with a backward that writes every
    chunk's gradient straight into one block-sized buffer (the chunks
    tile the block, so nothing else is zeroed but the chunks of leaves
    without a gradient)."""

    @staticmethod
    def forward(ctx, block: torch.Tensor, spec: PackSpec):
        ctx.spec, ctx.shape = spec, tuple(block.shape)
        ctx.dtype, ctx.device = block.dtype, block.device
        ctx.set_materialize_grads(False)
        return tuple(_local_views(block, spec))

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        out = torch.empty(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        flat = out.view(ctx.shape[0], -1)
        for g, o, c in zip(grads, spec.offsets, _shard_chunks(spec)):
            if g is None:
                flat[:, o:o + c].zero_()
            else:
                flat[:, o:o + c].copy_(g)
        return out, None


def unpack_local(block: torch.Tensor, spec: PackSpec) -> PyTree:
    """The leaf chunks of one shard block of a row-sharded buffer: the
    model-parallel counterpart of :func:`unpack`.

    ``block`` is one ``(K_local, local_rows, LANE)`` block (``K_local`` is
    1 on a rank). Returns a tree of the spec's structure whose leaf i is
    the flat ``(K_local, local_chunk_elems(spec)[i])`` chunk of that leaf,
    in the leaf's dtype: block j's chunk is elements ``[j c, (j + 1) c)``
    of the zero-padded flat leaf, so the M chunks in order give
    :func:`unpack`'s leaves. The chunks are views of ``block`` where the
    dtypes agree; under autograd they come from one ``autograd.Function``
    whose backward writes the gradient of every chunk into one
    block-sized buffer."""
    if not spec.stacked:
        raise ValueError("unpack_local needs a stacked spec")
    local_chunk_elems(spec)
    if block.dim() != 3 or block.shape[1] * block.shape[2] != \
            spec.local_rows * LANE:
        raise ValueError(
            f"unpack_local expects one (K_local, {spec.local_rows}, {LANE}) "
            f"row-shard block; got {tuple(block.shape)}")
    if torch.is_grad_enabled() and block.requires_grad:
        leaves = list(_UnpackLocal.apply(block, spec))
    else:
        leaves = _local_views(block, spec)
    return tree_unflatten(spec.treedef, leaves)


def mirror_local(tree: PyTree, spec: PackSpec, shard_idx: int) -> PyTree:
    """Cut an unpacked per-worker tree (leaf shapes without the K dim:
    targets, masks, anchors) into shard ``shard_idx``'s chunk layout: flat
    ``(local_chunk_elems[i],)`` leaves, zero past each leaf's true size,
    so elementwise losses work chunk against chunk."""
    leaves, treedef = tree_flatten(tree)
    if treedef != spec.treedef:
        raise ValueError(f"tree does not match spec treedef: {treedef} "
                         f"vs {spec.treedef}")
    chunks = local_chunk_elems(spec)
    got = tuple(tuple(l.shape) for l in leaves)
    want = tuple(s[1:] for s in spec.shapes)
    if got != want:
        raise ValueError(
            f"mirror_local needs per-worker leaf shapes {want}; got {got}")
    j = int(shard_idx)
    out = []
    for leaf, c, sz in zip(leaves, chunks, spec.sizes):
        flat = leaf.reshape(-1)
        seg = c * spec.row_shards
        if seg > sz:
            flat = torch.nn.functional.pad(flat, (0, seg - sz))
        out.append(flat[j * c:(j + 1) * c])
    return tree_unflatten(spec.treedef, out)
