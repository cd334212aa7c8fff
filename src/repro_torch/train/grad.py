"""The gradient pipeline: how the per-worker gradients are computed, the port
of ``repro.train.grad``.

``make_grad_pipeline(loss, opt)`` reads the optimizer's config and returns
a :class:`GradPipeline` in one of two modes:

* **reference**: tree state. The loss runs on the stacked params, whose
  leaves are made leaves of the autograd graph, and the grads come back as
  a stacked tree.
* **packed**: packed-resident state (``backend='packed'``). The resident
  ``(K, rows, 128)`` buffer itself requires grad, the params are views of
  it from ``packing.unpack``, and the gradient of the summed per-worker
  losses comes back as one packed buffer with zero padding, written leaf
  by leaf by ``unpack``'s backward, with no pack. This is the counterpart
  of differentiating through ``unpack`` in the JAX package.

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

PyTree = Any


@dataclasses.dataclass(frozen=True)
class GradPipeline:
    """``value_and_grad(state, batch) -> (losses (K,), grads)`` with
    ``grads`` in the optimizer's form: a stacked tree (reference) or a
    packed ``(K, rows, 128)`` buffer (packed). With ``damping_chunks`` > 0
    it takes a third argument, the ``(K,)`` live-chunk counts ``n``."""

    mode: str                 # 'reference' | 'packed'
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
    ``backend='packed'`` takes the through-unpack path, everything else the
    reference path.

    Args:
      loss: ``(params_stacked, batch_stacked) -> (K,)`` per-worker losses.
      opt: the optimizer; its config decides the mode.
      microbatch: gradient-accumulation chunks per step (>= 1).
      sharded_loss, plan: the 2D worker x model mesh's; not ported yet.
      damping_chunks: > 0 builds the damped variant, a 3-arg
        ``value_and_grad(state, batch, n)`` over this many chunks, masking
        each worker's chunks past its count ``n[k]``. Exclusive with
        ``microbatch`` > 1.

    Raises:
      ValueError: ``microbatch < 1``, ``damping_chunks < 0``, or both
        ``damping_chunks`` and ``microbatch`` > 1.
      NotImplementedError: ``sharded_loss`` or ``plan``.
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
    if sharded_loss is not None or plan is not None:
        what = ("the sharded damped path" if damping_chunks
                else "sharded_loss / plan")
        raise NotImplementedError(
            f"{what} belongs to the 2D worker x model mesh, not ported yet "
            "(ROADMAP queue 1: multi-GPU comm)")
    packed = getattr(opt.cfg, "backend", "reference") == "packed"
    if packed:
        vag = _packed_vag(loss, microbatch, damping_chunks)
    else:
        vag = _reference_vag(loss, opt, microbatch, damping_chunks)
    return GradPipeline("packed" if packed else "reference", vag,
                        1 if damping_chunks else microbatch, damping_chunks)


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


def _packed_vag(loss, microbatch: int, damping_chunks: int):
    """Differentiate through ``packing.unpack``, whose backward writes
    every leaf's gradient into one fresh packed buffer: the damped masks,
    sums and division work on it in place."""

    def one_of(state):
        def one(b):
            with torch.enable_grad():
                buf = state.buf.detach().requires_grad_(True)
                losses = loss(packing.unpack(buf, state.spec), b)
                (grad,) = torch.autograd.grad(losses.sum(), buf)
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
