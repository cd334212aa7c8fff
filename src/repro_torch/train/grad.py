"""The gradient pipeline: how the per-worker gradients are computed, the port
of ``repro.train.grad``.

``make_grad_pipeline(loss, opt)`` reads the optimizer's config and returns
a :class:`GradPipeline` in one of three modes:

* **reference**: tree state. The loss runs on the stacked params, whose
  leaves are made leaves of the autograd graph, and the grads come back as
  a stacked tree.
* **packed**: packed-resident state (``backend='packed'``). The resident
  ``(K, rows, 128)`` buffer itself requires grad, the params are views of
  it from ``packing.unpack``, and the gradient of the summed per-worker
  losses comes back as one packed buffer with zero padding, written leaf
  by leaf by ``unpack``'s backward, with no pack. This is the counterpart
  of differentiating through ``unpack`` in the JAX package. Under the 2D
  worker x model layout (``cfg.model_parallel`` = M > 1) a rank holds one
  ``(1, rows / M, 128)`` block: each step all-gathers the worker's M
  blocks over the model group once, differentiates through the whole
  buffer, and keeps its own rows of the gradient. That moves one
  worker's parameters a step, as JAX's GSPMD does through ``unpack`` on a
  2D mesh.
* **sharded-packed**: the 2D layout with a model-parallel loss,
  ``sharded_loss(chunks, batch, ctx) -> scalar``, evaluated on the rank's
  own block: ``chunks`` are the block's flat per-leaf chunks
  (``packing.unpack_local``, padding kept, the worker dim dropped),
  ``batch`` the worker's batch without its K dim, and ``ctx`` a
  :class:`ShardCtx` whose ``psum`` (:func:`psum_replicated`),
  ``mirror``, ``full_leaf`` and :func:`row_parallel_dot` are the only
  ways the M ranks of a worker meet; it returns the worker's whole loss,
  the same on every rank of the group. Nothing is all-gathered: the
  gradient of the block comes back from ``unpack_local``'s backward, and
  the group's collectives are the loss's own sums (counted on the
  ``WorkerGroup`` as ``model_sum``).

* **planned**: the 2D layout with a sharding plan (``plan=``, from
  ``launch.shardings.make_plan``; the dense, MoE and vision-language
  families): the port of JAX's
  packed route under ``loss_param_constraints``. Each step moves the
  rank's block out to its plan shard of every matrix (one counted
  ``model_redistribute``; vectors and the leaves the plan replicates come
  whole), runs ``loss(params, batch, shard=ctx)`` on them, where ``ctx``
  is a :class:`PlanCtx` through which the model multiplies with its
  shards (row-parallel products summed over the group in f32,
  column-parallel products whose outputs stay split, a vocab-parallel
  embedding and cross-entropy; the MoE's expert weights as batched
  products of the same kinds), and moves the shards' gradients back into
  the rank's ``(1, rows / M, 128)`` gradient block (the reverse call).
  Nothing is all-gathered: the group's collectives are the two
  redistributions a step and the model's ``model_sum`` calls.

A loss here is ``loss(params_stacked, batch_stacked) -> (K,)``: the
worker dim is written out. Workers do not share params, so the gradient of
the summed losses is each worker's own gradient. ``microbatch`` > 1
accumulates over that many chunks of each worker's batch.

``damping_chunks=C`` builds either mode's adaptive-batch-damping variant
(``train.damping``): ``value_and_grad(state, batch, n)`` with ``n`` a
``(K,)`` int tensor of live-chunk counts. Every step evaluates all C
chunks, as the JAX package's masked scan does, and keeps worker k's
contribution from chunk i only where ``i < n[k]``: one fixed launch
sequence whatever the counts, and ``n`` never reaches the host. The masks
are ``masked_fill`` (a NaN in a masked chunk stays out, where ``0 * nan``
would not), the first chunk's gradient becomes the accumulator and later
ones are masked and added in place, so no temporary of the packed
buffer's size is made beyond the chunk's own gradient.

The reference mode accumulates in f32, as JAX's per-worker loop does from
its f32 zeros: a first chunk's gradient in another dtype (bf16 params)
becomes an f32 copy before it is the accumulator, and the gradients come
back in f32; an f32 gradient is taken as it is. The packed mode
accumulates in the buffer's dtype in both packages. The loss sums are
f32 in both modes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch._tree import (keystr, tree_flatten, tree_map,
                               tree_map_with_path, tree_unflatten)
from repro_torch.kernels import pack as packing
from repro_torch.launch.mesh import WorkerGroup, model_all_gather, model_sum
from repro_torch.launch.shardings import (LeafCut, Redistribution,
                                          ShardingPlan, leaf_cuts)

PyTree = Any
# the model families whose losses take a sharding plan's ``shard=``
PLAN_FAMILIES = ("dense", "moe", "vlm")


# ------------------------------ shard context -------------------------------


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: WorkerGroup):
        return model_sum(x.detach(), group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def psum_replicated(x: torch.Tensor, group: WorkerGroup) -> torch.Tensor:
    """The sum of ``x`` over the worker's model group
    (``launch.mesh.model_sum``, the same bits on every rank), whose
    backward is the identity: the adjoint for a loss that is the same on
    every rank of the group, each rank keeping its own cotangent. The
    adjoint of a plain sum would be another sum over the group, and would
    multiply every gradient by M. Every sharded loss reduces with it
    (``ShardCtx.psum``)."""
    return _PsumReplicated.apply(x, group)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """What a model-parallel loss knows of its shard: the pack spec (the
    leaf layout) and the rank's ``WorkerGroup``, whose model group is the
    worker's M ranks."""

    spec: packing.PackSpec
    group: WorkerGroup

    @property
    def n_shards(self) -> int:
        return self.group.M

    @property
    def index(self) -> int:
        """This rank's model index."""
        return self.group.model_rank

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model group, the only way a sharded loss ties
        the shards together; its backward is the identity
        (:func:`psum_replicated`)."""
        return psum_replicated(x, self.group)

    def mirror(self, tree: PyTree) -> PyTree:
        """A per-worker tree of full leaf shapes (targets, anchors) cut
        into this shard's chunk layout (``packing.mirror_local``)."""
        return packing.mirror_local(tree, self.spec, self.index)

    def full_leaf(self, chunk: torch.Tensor, leaf_idx: int) -> torch.Tensor:
        """Leaf ``leaf_idx``'s whole per-worker value from this shard's
        chunk, by one sum over the group of a vector of the leaf's true
        size that is zero outside this shard's part: for SMALL leaves
        (biases, norms), whose size is what the sum moves."""
        spec = self.spec
        sz = spec.sizes[leaf_idx]
        c = chunk.numel()
        lo = min(self.index * c, sz)
        mine = min(c, sz - lo)
        flat = chunk.reshape(-1)
        vals = torch.cat([flat.new_zeros(lo), flat[:mine],
                          flat.new_zeros(sz - lo - mine)])
        return self.psum(vals).reshape(spec.shapes[leaf_idx][1:])


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, rows_local: int, group: WorkerGroup):
        ctx.shape, ctx.rows, ctx.group = tuple(x.shape), rows_local, group
        start = group.model_rank * rows_local
        return x[..., start:start + rows_local]

    @staticmethod
    def backward(ctx, ct):
        full = ct.new_zeros(ctx.shape)
        start = ctx.group.model_rank * ctx.rows
        full[..., start:start + ctx.rows] = ct
        return model_sum(full, ctx.group), None, None


def _slice_replicated(x: torch.Tensor, rows_local: int,
                      group: WorkerGroup) -> torch.Tensor:
    """This shard's ``rows_local`` slice of the last dim of an activation
    that is the same on every rank of the group. Its backward puts the
    cotangent into the full width and sums it over the group, so the
    cotangent leaving it is again the same on every rank: with a plain
    slice, a lower row-parallel layer would get a slice-shaped cotangent
    and lose most of its weight gradient."""
    return _SliceReplicated.apply(x, rows_local, group)


def row_parallel_dot(x: torch.Tensor, w_chunk: torch.Tensor, d_out: int,
                     ctx: ShardCtx) -> torch.Tensor:
    """``x @ W`` with W's rows in this shard's flat chunk: Megatron's
    row-parallel linear over the packed layout. The chunk is a
    contiguous piece of the flattened ``(d_in, d_out)`` matrix, whole
    rows of it when ``d_out`` divides the chunk (any power of two up to
    the tile quantum does); ``x``'s columns are padded with zeros to
    every shard's rows (the padding rows of W are zero), this shard's
    columns are taken, and the product is summed over the group. ``x``
    must be the same on every rank of the group, and so is the result:
    row-parallel layers compose."""
    c = w_chunk.numel()
    if c % d_out:
        raise ValueError(
            f"chunk of {c} elements is not whole rows of d_out={d_out}; "
            "pick a d_out dividing the tile quantum "
            f"({packing.BLOCK_ROWS * packing.LANE} elements)")
    rows_local = c // d_out
    W = w_chunk.reshape(rows_local, d_out)
    rows_total = rows_local * ctx.n_shards
    d_in = x.shape[-1]
    if rows_total < d_in:
        raise ValueError(f"chunked rows {rows_total} < d_in {d_in}")
    xp = torch.nn.functional.pad(x, (0, rows_total - d_in))
    xl = _slice_replicated(xp, rows_local, ctx.group)
    return ctx.psum(xl @ W.to(x.dtype))


class _SumCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: WorkerGroup):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return model_sum(ct.to(torch.float32), ctx.group).to(ct.dtype), None


def sum_cotangent(x: torch.Tensor, group: WorkerGroup) -> torch.Tensor:
    """``x`` itself, whose backward sums the cotangent over the worker's
    model group (in f32, rounded once to its dtype): the mirror of
    :func:`psum_replicated`, for an activation that is the same on every
    rank and enters a matrix cut on its output dim. Each rank's product
    then gives only its part of the activation's cotangent, and the sum
    makes it whole again on every rank."""
    return _SumCotangent.apply(x, group)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched: an expert weight's products) with an
    f32 result: a bf16 GEMM that keeps its f32 accumulator on the card,
    the products of the upcast operands on the CPU (exact for bf16 inputs,
    as the GEMM's are). f32 operands (the router) multiply in f32."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


class _PartialProduct(torch.autograd.Function):
    """``a @ b`` in f32 (:func:`_mm_f32`), whose backward runs in the
    operands' dtype, as the product ``a @ b`` would: a row-parallel
    product's partial, summed over the group before it is rounded."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, ct):
        a, b = ctx.saved_tensors
        g = ct.to(a.dtype)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def matrix_cut(lc: LeafCut) -> Optional[int]:
    """The dim of one use of a leaf that a rank holds 1/M of, counted among
    a matrix's two dims (0: input, 1: output) for a batched ``(E, d_in,
    d_out)`` expert weight too; a vector's own dim; ``None`` when held
    whole. A cut on an expert weight's expert dim is refused: the plan's
    rule never takes it for the ported configs (``d_model`` and ``d_ff``
    are larger than the expert count), and the products here cut only the
    matrices."""
    c = lc.use_cut
    batch = len(lc.shape) - int(lc.layered) - 2
    if c is None or batch <= 0:
        return c
    if c < batch:
        raise ValueError(f"{lc.name!r} is cut on its expert dim; the plan "
                         "context cuts an expert weight on d_model or d_ff")
    return c - batch


class PlanCtx:
    """What a loss under a sharding plan knows of its rank: the group and,
    by leaf name, how the rank holds each leaf (``launch.shardings.
    LeafCut``). The dense models multiply through it (``shard=``):

    * :meth:`project`: products whose outputs the model needs whole. A
      matrix cut on its input dim is a row-parallel product: the rank's
      columns of the input (``_slice_replicated``, whose backward puts the
      cotangent together over the group) times its rows, the partials
      summed over the group in f32 and rounded once, so several products
      of one input go out in one sum. A matrix cut on its output dim is a
      column-parallel product (:func:`sum_cotangent` on the input) whose
      output is assembled; a whole matrix is used whole.
    * :meth:`up` / :meth:`down`: the MLP. Matrices cut on their output dim
      (``w_gate``, ``w_up``, ``w_in`` and its ``b_in``) leave the hidden
      activation split, and the matrix after them, cut on its input dim,
      takes it as it is: one sum each way. The MoE's expert weights
      ``(E, d_in, d_out)`` go through the same methods as batched products
      on expert-major ``(E, slots, d)`` activations, each cut on one of its
      matrix dims (:func:`matrix_cut`), and :meth:`down`'s ``combine``
      combines a row-parallel partial before its one sum.
    * :meth:`embed` and :meth:`vocab_loss`: a vocab-parallel lookup (zero
      outside the rank's rows, then one sum) and cross-entropy (the
      logits of the rank's vocab rows, their log-sum-exp and the gold
      logit summed over the group), so the logits are never whole.

    Activations are the same on every rank between these products, and so
    are their cotangents; the attention itself runs whole on every rank,
    as under JAX's layout, and so do the MoE's routing, dispatch and
    combine. The router, an f32 leaf, enters :meth:`project` with an f32
    input: its row-parallel product multiplies and sums in f32, so the
    routing is the same bits on every rank."""

    def __init__(self, group: WorkerGroup, cuts: "list[LeafCut]"):
        self.group = group
        self.cuts: dict = {}
        for lc in cuts:
            c = matrix_cut(lc)
            if self.cuts.get(lc.name, c) != c:
                raise ValueError(f"two leaves named {lc.name!r} are cut "
                                 "differently; the plan context keys leaves "
                                 "by name")
            self.cuts[lc.name] = c

    @property
    def M(self) -> int:
        return self.group.M

    @property
    def m(self) -> int:
        return self.group.model_rank

    def cut(self, name: str) -> Optional[int]:
        """The dim of one use of leaf ``name`` that this rank holds 1/M of
        (:func:`matrix_cut`), or ``None`` when it holds the leaf whole."""
        return self.cuts[name]

    def gather_cols(self, y: torch.Tensor, full: int) -> torch.Tensor:
        """The whole of an activation split on its last dim (this rank's
        ``y``, of ``full / M`` columns), by one sum of zero-padded parts;
        the cotangent, the same on every rank, is cut back to the rank's
        columns."""
        w = y.shape[-1]
        lo = self.m * w
        return psum_replicated(
            torch.nn.functional.pad(y, (lo, full - lo - w)), self.group)

    def _rows_in(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The rank's columns of ``x`` for a matrix ``w`` cut on its input
        dim, flattened to 2-D for a 2-D ``w`` (a batched ``w`` takes the
        expert-major ``(E, slots, d)`` as it is)."""
        width = w.shape[-2]
        xl = _slice_replicated(x, width, self.group)
        return xl.reshape(-1, width) if w.dim() == 2 else xl

    def _project(self, x: torch.Tensor, items) -> list:
        """``[(w, cut)] -> [x @ w]`` whole, ``cut`` the dim of ``w`` this
        rank holds 1/M of (0: input, 1: output, ``None``: whole)."""
        dt, lead = x.dtype, x.shape[:-1]
        outs: list = [None] * len(items)
        rows = [i for i, (_, c) in enumerate(items) if c == 0]
        cols = [i for i, (_, c) in enumerate(items) if c == 1]
        if rows:
            x2 = self._rows_in(x, items[rows[0]][0])
            parts = [_PartialProduct.apply(x2, items[i][0].to(dt))
                     for i in rows]
            total = psum_replicated(torch.cat(parts, -1) if len(parts) > 1
                                    else parts[0], self.group).to(dt)
            at = 0
            for i, p in zip(rows, parts):
                n = p.shape[-1]
                outs[i] = total[..., at:at + n].reshape(lead + (n,))
                at += n
        if cols:
            xs = sum_cotangent(x, self.group)
            for i in cols:
                w = items[i][0]
                outs[i] = self.gather_cols(xs @ w.to(dt),
                                           w.shape[-1] * self.M)
        for i, (w, c) in enumerate(items):
            if c is None:
                outs[i] = x @ w.to(dt)
        return outs

    def project(self, x: torch.Tensor, items) -> list:
        """``[(w, name)] -> [x @ w]``, each output whole on every rank."""
        return self._project(x, [(w, self.cut(n)) for w, n in items])

    def up(self, x: torch.Tensor, items, biases=()) -> tuple:
        """``([x @ w + b], split)`` for ``items`` ``[(w, name)]`` and their
        ``biases`` ``[(b or None, name)]``: split (the rank's columns)
        when every matrix is cut on its output dim and every bias with it,
        else whole."""
        dt = x.dtype
        biases = list(biases) or [(None, None)] * len(items)
        split = all(self.cut(n) == 1 for _, n in items) and all(
            b is None or self.cut(bn) == 0 for b, bn in biases)
        if split:
            xs = sum_cotangent(x, self.group)
            outs = [xs @ w.to(dt) for w, _ in items]
        else:
            outs = self.project(x, items)
        for i, (b, bn) in enumerate(biases):
            if b is None:
                continue
            if not split and self.cut(bn) == 0:
                b = self.gather_cols(b.to(dt), b.shape[-1] * self.M)
            outs[i] = outs[i] + b.to(dt)
        return outs, split

    def down(self, h: torch.Tensor, w: torch.Tensor, name: str,
             split: bool, combine=None) -> torch.Tensor:
        """``h @ w`` whole, ``h`` the output of :meth:`up` (split or
        whole): a matrix cut on its input dim takes a split ``h`` as it is
        (a whole one sliced), its f32 partial summed once and rounded.

        ``combine``: ``(fn, z)`` with ``fn(z, y)`` linear in ``y`` and
        ``z`` an activation the same on every rank (the MoE's gates);
        returns ``fn(z, h @ w)``. A partial is combined before its sum
        (in f32, the combined output smaller than the product's), and
        ``z``, which then meets only the rank's part, has its cotangent
        summed (:func:`sum_cotangent`)."""
        dt = h.dtype
        fn, z = combine if combine is not None else (None, None)
        if self.cut(name) == 0:
            lead = h.shape[:-1]
            x = (h.reshape(-1, h.shape[-1]) if split and w.dim() == 2
                 else h if split else self._rows_in(h, w))
            part = _PartialProduct.apply(x, w.to(dt))
            part = part.reshape(lead + (part.shape[-1],))
            if fn is not None:
                part = fn(sum_cotangent(z, self.group), part)
            return psum_replicated(part, self.group).to(dt)
        if split:
            h = self.gather_cols(h, h.shape[-1] * self.M)
        out = self.project(h, [(w, name)])[0]
        return out if fn is None else fn(z, out)

    def embed(self, table: torch.Tensor, name: str, tokens: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
        """The rows of ``table`` (vocab x d) at ``tokens``, whole, in
        ``dtype``: a table cut on the vocab looks up the rank's rows, zero
        elsewhere, and sums once."""
        cut = self.cut(name)
        tok = tokens.long()
        if cut == 0:
            n = table.shape[0]
            t = tok - self.m * n
            ok = (t >= 0) & (t < n)
            rows = table[t.clamp(0, n - 1)].to(dtype)
            return psum_replicated(
                torch.where(ok[..., None], rows, rows.new_zeros(())),
                self.group)
        rows = table[tok].to(dtype)
        if cut == 1:
            return self.gather_cols(rows, table.shape[1] * self.M)
        return rows

    def vocab_loss(self, h: torch.Tensor, w: torch.Tensor, name: str,
                   labels: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, *,
                   transposed: bool = False) -> torch.Tensor:
        """``common.cross_entropy_loss(h @ w, labels, mask)`` (``w.T`` for
        a tied embedding, ``transposed``). Cut on the vocab, the rank's
        logits give their f32 log-sum-exp and the gold logit where the
        label is theirs, and one sum over the group of the M log-sum-exps
        (each in its slot) and the gold logits gives the loss."""
        dt = h.dtype
        cut = self.cut(name)
        if cut is not None and transposed:
            cut = 1 - cut
        W = w.to(dt)
        W = W.T if transposed else W
        if cut != 1:
            logits = self._project(h, [(W, cut)])[0].to(torch.float32)
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        else:
            lf = (sum_cotangent(h, self.group) @ W).to(torch.float32)
            n = lf.shape[-1]
            t = labels.long() - self.m * n
            ok = (t >= 0) & (t < n)
            mine = torch.gather(lf, -1, t.clamp(0, n - 1)[..., None])[..., 0]
            lse = torch.logsumexp(lf, dim=-1)
            zero = lse.new_zeros(lse.shape)
            parts = [lse if j == self.m else zero for j in range(self.M)]
            total = psum_replicated(torch.stack(
                parts + [torch.where(ok, mine, zero)]), self.group)
            logz = torch.logsumexp(total[:self.M], dim=0)
            gold = total[self.M]
        nll = logz - gold
        if mask is not None:
            nll = nll * mask
            return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
        return torch.mean(nll)


def plan_model_sums(plan: ShardingPlan, spec: packing.PackSpec,
                    cfg: Any) -> int:
    """The ``model_sum`` calls of one forward and backward of the model
    ``cfg`` (the dense, MoE or vision-language family) through
    :class:`PlanCtx` under ``plan``, counted as its methods make them:

    * the embedding: 1 (a table cut on either dim), else 0; the VLM's
      projector: 1 when cut (its input, the patches, takes no gradient);
    * a layer: q, k and v: 2 when one of them is cut on its input dim (the
      summed partials, and the input's cotangent put together), 1 more
      when one is cut on its output dim (the input's summed cotangent) and
      1 more for each such output put together; ``wo``: 2 when cut;
    * the feed-forward: 1 when its first matrices (and ``b_in``) are all
      cut on their output dim (the input's summed cotangent), else as
      ``project`` counts them (a split-off ``b_in`` assembled: 1); then
      the last matrix: cut on its input dim, 1 (the partial's sum) and 1
      more for a whole input's slice; else a split hidden put together
      (1) and ``project``'s count;
    * a MoE layer: the router as ``project`` counts it (its f32 sum and
      its input's cotangent: 2), the experts as the feed-forward, and 1
      more when ``w_down``'s partial is combined before its sum (the
      gates' cotangent);
    * the loss: 2 with the head (or the tied table) cut (on the vocab: the
      input's summed cotangent and the log-sum-exp and gold sum; on
      d_model: a row-parallel product), else 0.

    For llama3.2-1b and the other SwiGLU configs that is ``6 L + 3``."""
    cuts = {lc.name: matrix_cut(lc) for lc in leaf_cuts(plan, spec)}

    def project(names) -> int:
        cs = [cuts[n] for n in names]
        rows, cols = cs.count(0), cs.count(1)
        return 2 * bool(rows) + (1 + cols if cols else 0)

    def ffn(ups, biases, down, combine=False) -> int:
        split = all(cuts[n] == 1 for n in ups) and all(
            cuts[b] == 0 for b in biases)
        n = 1 if split else project(ups) + sum(cuts[b] == 0 for b in biases)
        if cuts[down] == 0:
            return n + 1 + (not split) + combine
        return n + split + project((down,))

    moe = "router" in cuts
    layer = project(("wq", "wk", "wv")) + project(("wo",))
    if moe:
        layer += project(("router",)) + ffn(("w_gate", "w_up"), (), "w_down",
                                            combine=True)
    elif cfg.mlp_kind == "gelu":
        layer += ffn(("w_in",), tuple(b for b in ("b_in",) if b in cuts),
                     "w_out")
    else:
        layer += ffn(("w_gate", "w_up"), (), "w_down")
    loss = 0 if cuts["embed" if cfg.tie_embeddings else "lm_head"] is None \
        else 2
    return (int(cuts["embed"] is not None)
            + int(cuts.get("projector") is not None)
            + cfg.n_layers * layer + loss)


def plan_sum_bytes(cfg: Any, batch: int, seq: int, M: int) -> int:
    """An upper bound on one ``model_sum`` call's bytes under a plan, for
    a chunk of ``batch`` sequences of ``seq`` tokens of the model ``cfg``
    (the VLM's ``n_patches`` positions before each): an f32 activation a
    position of the widest of q, k and v together, d_model, d_ff, the
    router's E logits and the loss's M + 1 rows; for a MoE, an f32
    activation an expert slot (``E x C`` a token group) of d_model or of
    the gate's and up's 2 d_ff together."""
    from repro_torch.models import moe

    hd = cfg.resolved_head_dim
    positions = batch * (seq + cfg.n_patches)
    width = max((cfg.n_heads + 2 * cfg.n_kv_heads) * hd, cfg.d_model,
                cfg.d_ff, cfg.n_experts, M + 1)
    out = 4 * positions * width
    if cfg.n_experts:
        g, C = moe.capacity(positions, cfg.experts_per_token, cfg.n_experts,
                            cfg.capacity_factor, cfg.moe_group_size)
        slots = cfg.n_experts * C * (positions // g)
        out = max(out, 4 * slots * max(cfg.d_model, 2 * cfg.d_ff))
    return out


# ------------------------------- the pipeline -------------------------------


@dataclasses.dataclass(frozen=True)
class GradPipeline:
    """``value_and_grad(state, batch) -> (losses (K,), grads)`` with
    ``grads`` in the optimizer's form: a stacked tree (reference), a
    packed ``(K, rows, 128)`` buffer (packed), or the rank's
    ``(1, rows / M, 128)`` block (the 2D layout's packed, sharded-packed
    and planned). With ``damping_chunks`` > 0 it takes a third
    argument, the ``(K,)`` live-chunk counts ``n`` (the rank's ``(1,)``
    under ``comm='axis'``)."""

    mode: str    # 'reference' | 'packed' | 'sharded-packed' | 'planned'
    value_and_grad: Callable[..., Any]
    microbatch: int = 1
    damping_chunks: int = 0   # 0 = undamped 2-arg pipeline


def _split_micro(batch: PyTree, microbatch: int, i: int) -> PyTree:
    """Chunk ``i`` of ``microbatch`` equal chunks of every leaf's
    per-worker batch dim (dim 1): ``(K, b, ...) -> (K, b/microbatch, ...)``."""
    def chunk(path, x):
        b = x.shape[1]
        if b % microbatch:
            divisors = [d for d in range(1, b + 1) if b % d == 0]
            nearest = min(divisors, key=lambda d: (abs(d - microbatch), -d))
            raise ValueError(
                f"batch leaf {keystr(path) or '<root>'}: "
                f"per-worker batch dim {b} is not divisible into "
                f"{microbatch} accumulation chunks (microbatch / damping "
                f"max_chunks); nearest valid count is {nearest}")
        c = b // microbatch
        return x[:, i * c:(i + 1) * c]

    return tree_map_with_path(chunk, batch)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32: itself if it is, else an f32 copy."""
    return x.to(torch.float32)


def _accumulate(one: Callable[[PyTree], Any], batch: PyTree,
                microbatch: int, add: Callable, scale: Callable,
                start: Callable = lambda g: g):
    """Average ``one``'s (losses, grads) over the microbatch chunks; the
    first chunk's ``start(grads)`` is the accumulator."""
    if microbatch <= 1:
        return one(batch)
    lsum, acc = None, None
    for i in range(microbatch):
        losses, g = one(_split_micro(batch, microbatch, i))
        lsum = _f32(losses) if lsum is None else lsum + losses
        acc = start(g) if acc is None else add(acc, g)
        del g
    return lsum / microbatch, scale(acc, microbatch)


def _accumulate_damped(one: Callable[[PyTree], Any], batch: PyTree,
                       chunks: int, n: torch.Tensor, mask: Callable,
                       add: Callable, divide: Callable,
                       start: Callable = lambda g: g):
    """Average ``one``'s (losses, grads) over the first ``n[k]`` of
    ``chunks`` chunks of worker k's batch: every chunk is evaluated, and
    ``mask(g, off)`` zeroes the workers ``off`` ((K,) bool) whose count
    the chunk is past; the first chunk's ``start(mask(g, off))`` is the
    accumulator. The sums run in ``_accumulate``'s order, so with ``n``
    equal to ``chunks`` everywhere the result is microbatch=chunks' to the
    bit."""
    lsum, acc = None, None
    for i in range(chunks):
        losses, g = one(_split_micro(batch, chunks, i))
        off = n <= i
        losses = losses.masked_fill(off, 0.0)
        g = mask(g, off)
        lsum = _f32(losses) if lsum is None else lsum + losses
        acc = start(g) if acc is None else add(acc, g)
        del g   # the next chunk's backward must not find this one alive
    nf = n.to(lsum.dtype)
    return lsum / nf, divide(acc, nf)


def _worker_shaped(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The ``(K,)`` vector ``v`` shaped to broadcast over ``x``'s dims."""
    return v.view((-1,) + (1,) * (x.dim() - 1))


def make_grad_pipeline(loss: Callable[[PyTree, PyTree], torch.Tensor],
                       opt: Any, *, microbatch: int = 1,
                       sharded_loss: Optional[Callable] = None,
                       plan: Any = None,
                       damping_chunks: int = 0) -> GradPipeline:
    """Build the gradient pipeline for ``opt`` (a DecentralizedOptimizer):
    ``backend='packed'`` takes the through-unpack path, or under the 2D
    layout with a ``sharded_loss`` the sharded-packed path and with a
    ``plan`` the planned path; everything else the reference path. A
    ``sharded_loss`` without a 2D optimizer is not used, as in the JAX
    package.

    Args:
      loss: ``(params_stacked, batch_stacked) -> (K,)`` per-worker losses.
      opt: the optimizer; its config decides the mode.
      microbatch: gradient-accumulation chunks per step (>= 1).
      sharded_loss: ``(chunks, batch, ctx) -> scalar``, the worker's loss
        from this rank's block (see the module's docstring); selects the
        ``'sharded-packed'`` mode under the 2D layout.
      plan: a ``launch.shardings.ShardingPlan`` (``make_plan(arch,
        group)``) over the optimizer's group: on the 2D layout's packed
        mode (no ``sharded_loss``) it selects the ``'planned'`` mode, and
        ``loss`` must take ``shard=``. Elsewhere (1D, the reference
        backend, a sharded loss) it changes nothing, as in JAX.
      damping_chunks: > 0 builds the damped variant, a 3-arg
        ``value_and_grad(state, batch, n)`` over this many chunks, masking
        each worker's chunks past its count ``n[k]``. Exclusive with
        ``microbatch`` > 1.

    Raises:
      ValueError: ``microbatch < 1``, ``damping_chunks < 0``, both
        ``damping_chunks`` and ``microbatch`` > 1, or a plan over another
        model group size than the optimizer's.
      NotImplementedError: a plan for a family other than the dense, MoE
        and vision-language ones on the planned mode.
    """
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    if damping_chunks:
        if damping_chunks < 1:
            raise ValueError(
                f"damping_chunks must be >= 1, got {damping_chunks}")
        if microbatch > 1:
            raise ValueError(
                "damping owns the accumulation loop (its max_chunks IS "
                "the chunk count); microbatch > 1 alongside "
                "damping_chunks is ambiguous — set one, not both")
    packed = getattr(opt.cfg, "backend", "reference") == "packed"
    two_d = packed and getattr(opt.cfg, "model_parallel", 1) > 1
    mb = 1 if damping_chunks else microbatch
    if two_d and plan is not None and sharded_loss is None:
        family = getattr(plan.model_cfg, "family", None)
        if family not in PLAN_FAMILIES:
            raise NotImplementedError(
                f"plan= for the {family!r} family: the port's sharding plan "
                f"runs the {', '.join(PLAN_FAMILIES)} families; the ssm, "
                "hybrid and audio families are ROADMAP queue 4.3's next "
                "slices")
        if plan.M != opt.group.M:
            raise ValueError(f"the plan cuts {plan.M} ways; the optimizer's "
                             f"model group has {opt.group.M} ranks")
        vag = _planned_vag(loss, plan, opt.group, microbatch,
                           damping_chunks)
        return GradPipeline("planned", vag, mb, damping_chunks)
    if two_d and sharded_loss is not None:
        if opt.sharded_value_and_grad is None:
            raise ValueError(
                "sharded_loss needs a 2D comm='axis' optimizer; this one "
                "has no sharded execution hook")
        vag = _sharded_packed_vag(sharded_loss, opt, microbatch,
                                  damping_chunks)
        return GradPipeline("sharded-packed", vag, mb, damping_chunks)
    if packed:
        vag = _packed_vag(loss, microbatch, damping_chunks,
                          opt.group if two_d else None)
    else:
        vag = _reference_vag(loss, opt, microbatch, damping_chunks)
    return GradPipeline("packed" if packed else "reference", vag, mb,
                        damping_chunks)


def _reference_vag(loss, opt, microbatch: int, damping_chunks: int):
    """Autograd w.r.t. the stacked leaves, accumulated in f32 as JAX's
    per-worker loop does: a first chunk's leaf gradient in another dtype
    becomes an f32 copy (an f32 one is taken as it is), and the later
    chunks' gradients are added into it. A leaf's gradient may be a view
    autograd made (an expanded tensor), so the damped masks here are out
    of place: the masked first chunk is the accumulator, and the undamped
    sums are out of place."""

    def start(g):
        return tree_map(_f32, g)

    def one_of(state):
        leaves, td = tree_flatten(opt.params_of(state))

        def one(b):
            with torch.enable_grad():
                xs = [x.detach().requires_grad_(True) for x in leaves]
                losses = loss(tree_unflatten(td, xs), b)
                grads = torch.autograd.grad(losses.sum(), xs)
            return losses.detach(), tree_unflatten(td, list(grads))

        return one

    if damping_chunks:
        def mask(g, off):
            return tree_map(lambda x: x.masked_fill(_worker_shaped(off, x),
                                                    0.0), g)

        def damped_vag(state, batch, n):
            return _accumulate_damped(
                one_of(state), batch, damping_chunks, n, mask,
                lambda a, g: tree_map(torch.Tensor.add_, a, g),
                lambda a, nf: tree_map(
                    lambda x: x.div_(_worker_shaped(nf, x)), a), start)

        return damped_vag

    def reference_vag(state, batch):
        return _accumulate(
            one_of(state), batch, microbatch,
            lambda a, g: tree_map(torch.add, a, g),
            lambda a, n: tree_map(lambda x: x / n, a), start)

    return reference_vag


def _packed_vag(loss, microbatch: int, damping_chunks: int,
                group: Optional[WorkerGroup] = None):
    """Differentiate through ``packing.unpack``, whose backward writes
    every leaf's gradient into one fresh packed buffer: the damped masks,
    sums and division work on it in place. With ``group`` (the 2D layout)
    the worker's whole buffer is all-gathered once a step and each chunk's
    gradient cut to this rank's rows."""

    def one_of(state):
        whole = state.buf
        rows = None
        if group is not None:
            whole = model_all_gather(whole.detach(), group)
            rows = state.spec.local_rows
            start = group.model_rank * rows

        def one(b):
            with torch.enable_grad():
                buf = whole.detach().requires_grad_(True)
                losses = loss(packing.unpack(buf, state.spec), b)
                (grad,) = torch.autograd.grad(losses.sum(), buf)
            if rows is not None:
                grad = grad[:, start:start + rows].contiguous()
            return losses.detach(), grad

        return one

    if damping_chunks:
        def damped_vag(state, batch, n):
            return _accumulate_damped(
                one_of(state), batch, damping_chunks, n,
                lambda g, off: g.masked_fill_(_worker_shaped(off, g), 0.0),
                torch.Tensor.add_,
                lambda a, nf: a.div_(_worker_shaped(nf, a)))

        return damped_vag

    def vag(state, batch):
        return _accumulate(one_of(state), batch, microbatch, torch.add,
                           lambda a, n: a / n)

    return vag


def _planned_vag(loss, plan: ShardingPlan, group: WorkerGroup,
                 microbatch: int, damping_chunks: int):
    """The planned route: the rank's block out to its plan shards (one
    ``model_redistribute``), every chunk's loss and shard gradients
    through ``loss(params, batch, shard=PlanCtx)``, accumulated leaf by
    leaf as the packed route accumulates its buffer (the same adds, masks
    and division), and the sum back into a ``(1, rows / M, 128)`` block
    (the reverse call). The index maps are built at the first step of a
    spec and kept."""
    built: list = []

    def maps(spec):
        for sp, rd, ctx in built:
            if sp == spec:
                return rd, ctx
        rd = Redistribution(spec, plan, group.model_rank)
        ctx = PlanCtx(group, rd.cuts)
        built[:] = [(spec, rd, ctx)]
        return rd, ctx

    def one_of(state):
        spec = state.spec
        rd, ctx = maps(spec)
        shards = [x.to(dt) for x, dt in zip(
            rd.to_shards(state.buf, group), spec.dtypes)]

        def one(b):
            with torch.enable_grad():
                xs = [x.detach().requires_grad_(True) for x in shards]
                losses = loss(tree_unflatten(spec.treedef, xs), b,
                              shard=ctx)
                grads = torch.autograd.grad(losses.sum(), xs,
                                            allow_unused=True)
            return losses.detach(), [torch.zeros_like(x) if g is None else g
                                     for x, g in zip(xs, grads)]

        def block(grads):
            return rd.to_block(grads, group, state.buf.dtype)

        return one, block

    if damping_chunks:
        def damped_vag(state, batch, n):
            one, block = one_of(state)
            losses, grads = _accumulate_damped(
                one, batch, damping_chunks, n,
                lambda gs, off: [g.masked_fill_(_worker_shaped(off, g), 0.0)
                                 for g in gs],
                lambda a, gs: [x.add_(g) for x, g in zip(a, gs)],
                lambda a, nf: [x.div_(_worker_shaped(nf, x)) for x in a])
            return losses, block(grads)

        return damped_vag

    def vag(state, batch):
        one, block = one_of(state)
        losses, grads = _accumulate(
            one, batch, microbatch,
            lambda a, gs: [torch.add(x, g) for x, g in zip(a, gs)],
            lambda a, k: [x / k for x in a])
        return losses, block(grads)

    return vag


def _sharded_packed_vag(sharded_loss, opt, microbatch: int,
                        damping_chunks: int):
    """The model-parallel path: the loss runs on this rank's block through
    ``packing.unpack_local``, whose backward writes the gradient straight
    into a block-sized buffer, with nothing all-gathered. Each chunk's
    loss is the worker's (the same on every rank of the group), so the
    losses are ``(1,)``; damping masks with the rank's ``(1,)`` count."""
    group = opt.group

    def local_vag_of(state):
        spec = state.spec
        ctx = ShardCtx(spec=spec, group=group)

        def one(block, b):
            worker_batch = tree_map(lambda x: x[0], b)
            with torch.enable_grad():
                blk = block.detach().requires_grad_(True)
                chunks = tree_map(lambda x: x[0],
                                  packing.unpack_local(blk, spec))
                loss = sharded_loss(chunks, worker_batch, ctx)
                (grad,) = torch.autograd.grad(loss, blk)
            return loss.detach().reshape(1), grad

        return one

    if damping_chunks:
        def damped_vag(state, batch, n):
            one = local_vag_of(state)

            def local_vag(block, batch_n):
                b, n_local = batch_n
                return _accumulate_damped(
                    lambda mb: one(block, mb), b, damping_chunks, n_local,
                    lambda g, off: g.masked_fill_(_worker_shaped(off, g),
                                                  0.0),
                    torch.Tensor.add_,
                    lambda a, nf: a.div_(_worker_shaped(nf, a)))

            return opt.sharded_value_and_grad(local_vag, state, (batch, n))

        return damped_vag

    def vag(state, batch):
        one = local_vag_of(state)

        def local_vag(block, b):
            return _accumulate(lambda mb: one(block, mb), b, microbatch,
                               torch.add, lambda a, k: a / k)

        return opt.sharded_value_and_grad(local_vag, state, batch)

    return vag
