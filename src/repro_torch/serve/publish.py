"""Param publishing from the packed training state to serving readers: the
port of ``repro.serve.publish``.

A :class:`ParamStore` holds the live serving params and a version
counter; :func:`publish_params` decodes ONE per-worker
param tree straight out of a packed optimizer state (``pack.unpack_worker``
/ ``unpack_mean``: 1/K of the buffer, or its packed-domain mean; never the
K-way unpack), and :func:`publish_from_state` composes the two into the
hot-swap that ``train.online`` installs on the trainer.

Swap semantics, as in JAX:

* readers never block and never see a torn tree: ``snapshot()`` is one
  attribute read of an immutable ``(version, params)`` pair, which the
  writer replaces in one reference assignment;
* a reader holding version v keeps its tensors alive by reference while
  v+1 lands, and the caching allocator reuses their memory only after
  the last reference goes, in stream order. So the store keeps no slot
  for the previous version (JAX's two-slot ring would hold a second
  full copy of the model resident here for nothing);
* versions are monotone; the writer lock only serialises publishers.

``like=`` places each published leaf with ``.to(device=, dtype=)`` of its
counterpart leaf before the swap (there is no sharding in the port yet).
"""
from __future__ import annotations

import threading
from typing import Any, Optional, Tuple

import torch

from repro_torch._tree import tree_map
from repro_torch.core.dadam import mean_params
from repro_torch.kernels import pack as packing

PyTree = Any


def _placed_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return x.to(device=ref.device, dtype=ref.dtype)


class ParamStore:
    """Versioned, lock-free param store.

    ``publish(params)`` swaps an immutable ``(version, params)`` pair in
    one reference assignment; ``snapshot()`` reads that pair in one
    attribute load, and the pair's references keep that version alive for
    as long as the reader holds it. The writer lock serialises concurrent
    publishers only; readers never take it."""

    def __init__(self):
        self._current: Optional[Tuple[int, PyTree]] = None
        self._version = 0
        self._write_lock = threading.Lock()

    @property
    def version(self) -> int:
        """Version of the current snapshot (0 before the first publish)."""
        cur = self._current
        return 0 if cur is None else cur[0]

    def publish(self, params: PyTree, *, like: Optional[PyTree] = None
                ) -> int:
        """Swap ``params`` in as the new current snapshot; returns its
        version. With ``like=`` every leaf is first moved to its
        counterpart's device and dtype."""
        if like is not None:
            params = tree_map(_placed_like, params, like)
        with self._write_lock:
            self._version += 1
            # one reference assignment of an immutable pair: a concurrent
            # snapshot() sees the old or the new pair, whole
            self._current = (self._version, params)
            return self._version

    def snapshot(self) -> Tuple[int, PyTree]:
        """The current ``(version, params)`` pair: one atomic read."""
        cur = self._current
        if cur is None:
            raise ValueError(
                "ParamStore is empty: publish() params before serving")
        return cur


def publish_params(state: Any, *, mode: str = "mean", worker: int = 0,
                   like: Optional[PyTree] = None) -> PyTree:
    """One per-worker param tree out of an optimizer state (or a stacked
    param tree), without a K-way unpack for packed states.

    ``state``: a packed state (``PackedDAdamState`` / ``PackedCDAdamState``,
    decoded from its ``(K, rows, 128)`` buffer), a reference state
    (``.params``) or a stacked param tree. ``mode="mean"`` publishes the
    consensus mean, ``"worker"`` worker ``worker``'s replica. The result
    has no leading K dim and shares no memory with the live state."""
    if mode not in ("mean", "worker"):
        raise ValueError(f"mode must be 'mean' or 'worker', got {mode!r}")
    buf = getattr(state, "buf", None)
    spec = getattr(state, "spec", None)
    if buf is not None and isinstance(spec, packing.PackSpec):
        if mode == "worker":
            params = packing.unpack_worker(buf, spec, worker)
        else:
            params = packing.unpack_mean(buf, spec)
    else:
        stacked = getattr(state, "params", state)
        if mode == "worker":
            params = tree_map(lambda x: x[worker].clone(), stacked)
        else:
            params = mean_params(stacked)
    if like is not None:
        params = tree_map(_placed_like, params, like)
    return params


def publish_from_state(store: ParamStore, state: Any, *,
                       mode: str = "mean", worker: int = 0,
                       like: Optional[PyTree] = None) -> int:
    """``publish_params`` then ``store.publish``; returns the new version.
    The hook ``train.online`` installs on the trainer."""
    return store.publish(
        publish_params(state, mode=mode, worker=worker, like=like))


def publish_hbm_bytes(state: Any, *, mode: str = "mean") -> dict:
    """Device-memory traffic of one publish from a packed state: read and
    write bytes of the unpack-once path beside those of the full K-way
    unpack it replaces (the JAX package's accounting, byte for byte)."""
    buf, spec = state.buf, state.spec
    row_bytes = spec.rows * packing.LANE * buf.element_size()
    out_bytes = sum(sz * dt.itemsize
                    for sz, dt in zip(spec.sizes, spec.dtypes))
    read = row_bytes if mode == "worker" else spec.k * row_bytes
    return {
        "mode": mode,
        "read_bytes": int(read),
        "write_bytes": int(out_bytes),
        "full_unpack_read_bytes": int(spec.k * row_bytes),
        "full_unpack_write_bytes": int(spec.k * out_bytes),
    }
