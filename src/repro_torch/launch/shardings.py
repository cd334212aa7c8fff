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
ages, batches) is replicated over the model group. The sharding plans of
the TPU meshes (``make_plan``, the ``stacked`` / ``pods`` / ``global``
modes) are not ported.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch._tree import tree_map
from repro_torch.launch.mesh import (WorkerGroup, all_gather_workers,
                                     model_all_gather)

PyTree = Any


def take_worker(tree: PyTree, rank: int, K: int) -> PyTree:
    """Worker ``rank``'s slice of every tensor leaf whose leading dim is
    the worker count ``K``, as a ``(1, ...)`` copy of its own; other
    leaves (scalars, host counters, worker-free tensors) pass as they
    are."""
    def one(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == K:
            return x.narrow(0, rank, 1).clone(
                memory_format=torch.contiguous_format)
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
