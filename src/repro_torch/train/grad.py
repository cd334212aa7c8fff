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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.kernels import pack as packing

PyTree = Any


@dataclasses.dataclass(frozen=True)
class GradPipeline:
    """``value_and_grad(state, batch) -> (losses (K,), grads)`` with
    ``grads`` in the optimizer's form: a stacked tree (reference) or a
    packed ``(K, rows, 128)`` buffer (packed)."""

    mode: str                 # 'reference' | 'packed'
    value_and_grad: Callable[..., Any]
    microbatch: int = 1


def _split_micro(batch: PyTree, microbatch: int, i: int) -> PyTree:
    """Chunk ``i`` of ``microbatch`` equal chunks of every leaf's
    per-worker batch dim (dim 1): ``(K, b, ...) -> (K, b/microbatch, ...)``."""
    def chunk(x):
        b = x.shape[1]
        if b % microbatch:
            divisors = [d for d in range(1, b + 1) if b % d == 0]
            nearest = min(divisors, key=lambda d: (abs(d - microbatch), -d))
            raise ValueError(
                f"per-worker batch dim {b} is not divisible into "
                f"{microbatch} accumulation chunks; nearest valid count is "
                f"{nearest}")
        c = b // microbatch
        return x[:, i * c:(i + 1) * c]

    return tree_map(chunk, batch)


def _accumulate(one: Callable[[PyTree], Any], batch: PyTree,
                microbatch: int, add: Callable, scale: Callable):
    """Average ``one``'s (losses, grads) over the microbatch chunks."""
    if microbatch <= 1:
        return one(batch)
    lsum, acc = None, None
    for i in range(microbatch):
        losses, g = one(_split_micro(batch, microbatch, i))
        lsum = losses if lsum is None else lsum + losses
        acc = g if acc is None else add(acc, g)
    return lsum / microbatch, scale(acc, microbatch)


def make_grad_pipeline(loss: Callable[[PyTree, PyTree], torch.Tensor],
                       opt: Any, *, microbatch: int = 1) -> GradPipeline:
    """Build the gradient pipeline for ``opt`` (a DecentralizedOptimizer):
    ``backend='packed'`` takes the through-unpack path, everything else the
    reference path.

    Args:
      loss: ``(params_stacked, batch_stacked) -> (K,)`` per-worker losses.
      opt: the optimizer; its config decides the mode.
      microbatch: gradient-accumulation chunks per step (>= 1).
    """
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    if getattr(opt.cfg, "backend", "reference") == "packed":
        return GradPipeline("packed", _packed_vag(loss, microbatch),
                            microbatch)

    def reference_vag(state, batch):
        leaves, td = tree_flatten(opt.params_of(state))

        def one(b):
            with torch.enable_grad():
                xs = [x.detach().requires_grad_(True) for x in leaves]
                losses = loss(tree_unflatten(td, xs), b)
                grads = torch.autograd.grad(losses.sum(), xs)
            return losses.detach(), tree_unflatten(td, list(grads))

        return _accumulate(
            one, batch, microbatch,
            lambda a, g: tree_map(torch.add, a, g),
            lambda a, n: tree_map(lambda x: x / n, a))

    return GradPipeline("reference", reference_vag, microbatch)


def _packed_vag(loss, microbatch: int):
    """Differentiate through ``packing.unpack``, whose backward writes
    every leaf's gradient into one packed buffer."""

    def vag(state, batch):
        def one(b):
            with torch.enable_grad():
                buf = state.buf.detach().requires_grad_(True)
                losses = loss(packing.unpack(buf, state.spec), b)
                (grad,) = torch.autograd.grad(losses.sum(), buf)
            return losses.detach(), grad

        return _accumulate(one, batch, microbatch, torch.add,
                           lambda a, n: a / n)

    return vag
