"""Checkpointing, the port of ``repro.checkpoint.io``, in the same on-disk
format, so a checkpoint crosses between the two packages both ways.

Format: one ``.npz`` holding the leaves under the keys
``"{i:05d}|{tree path}"`` (``i`` the leaf's place in ``jax.tree_util``'s
order: dict keys sorted, NamedTuple fields in order, ``None`` fields
skipped) and a JSON sidecar ``<path>.json`` with ``step``, ``meta`` and
``leaves``, the list of ``[key, dtype name]``. bfloat16 is stored as its
uint16 view. The file is written to a temporary name and renamed.

Packed-resident optimizer states (``PackedDAdamState`` /
``PackedCDAdamState``) are unpacked to their portable NamedTuple form on
save and repacked into the like-state's layout on restore, so a
checkpoint written by either backend restores into the other. The
transient straggler-comm buffers (D-Adam ``stale``, CD-Adam ``pending``)
are never written: a restored state gets them back COLD, zero payloads
at ``COLD_AGE`` ages and all-zero delay rings. The port's step counter is
a host int and is written and read as the int32 ``moments/count`` leaf.

Checkpoints cross comm modes too, as the JAX package's do: with
``group=`` (a ``comm='axis'`` state, each rank holding its worker's
``(1, ...)`` slice) ``save`` gathers every optimizer state's slices to
all K workers and rank 0 writes the file a stacked state writes, and
``restore`` reads the K workers' rows and gives each rank its own. So a
stacked checkpoint restores onto an axis state and back. Under the 2D
worker x model layout (each rank one block of its worker's row-sharded
buffers) ``save`` first gathers every packed state over the model group,
so the file holds the portable form of all K workers, as the stacked and
1D forms do; ``restore`` repacks a rank's worker with ``row_shards=M`` and
keeps its block. Stacked, 1D and 2D checkpoints restore onto each other,
equal to the bit.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_map
from repro_torch.core import cdadam, dadam
from repro_torch.launch.mesh import WorkerGroup, barrier
from repro_torch.launch.shardings import (gather_model, gather_workers,
                                          take_model_block, take_worker)

PyTree = Any

_PACKED = (dadam.PackedDAdamState, cdadam.PackedCDAdamState)
_STATES = _PACKED + (dadam.DAdamState, cdadam.CDAdamState)


def _is_packed(x: Any) -> bool:
    return isinstance(x, _PACKED)


def _has_transient(x: Any) -> bool:
    """Reference states carrying live straggler-comm buffers."""
    return (isinstance(x, (dadam.DAdamState, cdadam.CDAdamState))
            and x[-1] is not None)


def _needs_adapt(x: Any) -> bool:
    return _is_packed(x) or _has_transient(x)


def _sans_transient(x: Any) -> Any:
    if isinstance(x, dadam.PackedDAdamState):
        return x.with_stale(None)
    if isinstance(x, cdadam.PackedCDAdamState):
        return x.with_pending(None)
    if isinstance(x, dadam.DAdamState):
        return x._replace(stale=None)
    if isinstance(x, cdadam.CDAdamState):
        return x._replace(pending=None)
    return x


def _portable_of(x: Any) -> Any:
    """The backend-agnostic checkpoint form of one optimizer state."""
    return x.unpacked() if _is_packed(x) else _sans_transient(x)


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_states(fn: Callable[[Any], Any], tree: PyTree) -> PyTree:
    """``fn`` applied to every optimizer state in ``tree``."""
    if isinstance(tree, _STATES):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_states(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_states(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_states(fn, v) for v in tree)
    return tree


def _to_portable(tree: PyTree, group: Optional[WorkerGroup] = None
                 ) -> PyTree:
    """Packed states unpacked (under the 2D layout after gathering their
    blocks over the model group, which every rank of it must do),
    transient buffers stripped, the rest as it is."""
    if group is None or group.M == 1:
        return _map_states(_portable_of, tree)
    return _map_states(lambda s: _portable_of(gather_model(s, group)), tree)


def _leaves_with_path(tree: PyTree, path: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` in ``jax.tree_util``'s order: dict keys sorted,
    NamedTuple fields by name, sequences by index, ``None`` no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _leaves_with_path(v, path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


def _rebuild(like: PyTree, leaves: Iterator[Any]) -> PyTree:
    """``like``'s structure with its leaves taken from ``leaves`` in
    :func:`_leaves_with_path` order."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _leaf_to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, (bool, np.bool_)):
        arr = np.asarray(leaf)
    elif isinstance(leaf, (int, np.integer)):
        # the host step counter: the JAX package's int32 scalar
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _leaf_from_numpy(arr: np.ndarray, dtype_name: str, ref: Any,
                     key: str) -> Any:
    arr = np.array(arr)       # a writable, C-ordered copy; 0-d stays 0-d
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    ref_shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) else ()
    if tuple(t.shape) != ref_shape:
        raise ValueError(f"shape mismatch at {key}: {tuple(t.shape)} vs "
                         f"{ref_shape}")
    if isinstance(ref, torch.Tensor):
        return t.to(device=ref.device, dtype=ref.dtype)
    if isinstance(ref, (int, np.integer)):
        return int(t)
    return type(ref)(t.item())


def _placed_like(tree: PyTree, ref: PyTree) -> PyTree:
    """``tree``'s tensors on the devices of their ``ref`` counterparts."""
    leaves = [x for _, x in _leaves_with_path(tree)]
    refs = [x for _, x in _leaves_with_path(ref)]
    if len(leaves) != len(refs):
        raise ValueError(f"tree has {len(leaves)} leaves, the live state "
                         f"{len(refs)}")
    placed = [x.to(r.device) if isinstance(x, torch.Tensor)
              and isinstance(r, torch.Tensor) else x
              for x, r in zip(leaves, refs)]
    return _rebuild(tree, iter(placed))


def _cold_stale(st: dadam.StaleBufs) -> dadam.StaleBufs:
    """COLD D-Adam staleness buffers shaped like ``st``: zero payloads and
    ``COLD_AGE`` ages, so the first round takes fresh payloads."""
    return dadam.StaleBufs(tree_map(torch.zeros_like, tuple(st.bufs)),
                           torch.full_like(st.age, dadam.COLD_AGE))


def _cold_pending(pending: Any) -> Any:
    """COLD CD-Adam delay rings: all-zero payload slots, which decode to
    zero hat updates until real traffic refills them."""
    return tree_map(torch.zeros_like, pending)


def _with_cold_transient(out: Any, orig: Any) -> Any:
    if isinstance(orig, dadam.PackedDAdamState) and orig.stale is not None:
        return out.with_stale(_cold_stale(orig.stale))
    if isinstance(orig, cdadam.PackedCDAdamState) and \
            orig.pending is not None:
        return out.with_pending(_cold_pending(orig.pending))
    if isinstance(orig, dadam.DAdamState) and orig.stale is not None:
        return out._replace(stale=_cold_stale(orig.stale))
    if isinstance(orig, cdadam.CDAdamState) and orig.pending is not None:
        return out._replace(pending=_cold_pending(orig.pending))
    return out


def _adapt(slot: Any, orig: Any,
           group: Optional[WorkerGroup] = None) -> Any:
    if _is_packed(orig) and orig.spec.row_shards > 1:
        dev = orig.buf.device
        out = type(orig).from_unpacked(
            tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                     else x, slot), row_shards=orig.spec.row_shards)
        out = take_model_block(out, group)
    elif _is_packed(orig):
        out = type(orig).from_unpacked(_placed_like(slot,
                                                    _portable_of(orig)))
    elif _has_transient(orig):
        out = _placed_like(slot, _sans_transient(orig))
    else:
        return _placed_like(slot, orig)
    return _with_cold_transient(out, orig)


def place_like(portable: PyTree, like: PyTree,
               group: Optional[WorkerGroup] = None) -> PyTree:
    """Adapt a portable (backend-agnostic) state tree into ``like``'s
    backend layout, device and transient-comm structure.

    Packed states in ``like`` are repacked into its layout (the
    row-sharded one of its spec, cut to ``group``'s model block, under the
    2D layout); live
    straggler-comm buffers are rebuilt COLD rather than copied from
    ``like`` (a restored or resized worker holds no valid in-flight
    neighbour traffic); other tensors move to their ``like`` counterpart's
    device. Shared by :func:`restore` and ``core.elastic.resize_state``.
    Raises ``ValueError`` when the two trees do not match."""
    if isinstance(like, _STATES):
        return _adapt(portable, like, group)
    if isinstance(like, dict):
        return {k: place_like(portable[k], v, group)
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(place_like(p, v, group)
                            for p, v in zip(portable, like)))
    if isinstance(like, (list, tuple)):
        if len(portable) != len(like):
            raise ValueError("tree structures differ")
        return type(like)(place_like(p, v, group)
                          for p, v in zip(portable, like))
    return _placed_like(portable, like)


def _widened(state: Any, K: int) -> Any:
    """A stand-in for the K-worker form of a rank's portable state: every
    tensor leaf an expanded (no memory) CPU view of shape ``(K, ...)`` in
    the leaf's dtype, for :func:`restore`'s shape and dtype checks."""
    return tree_map(lambda x: torch.zeros((), dtype=x.dtype).expand(
        (K,) + tuple(x.shape[1:])) if isinstance(x, torch.Tensor) else x,
        state)


def save(path: str, tree: PyTree, *, step: int = 0,
         meta: Optional[Dict[str, Any]] = None,
         group: Optional[WorkerGroup] = None) -> None:
    """Write ``tree`` (optimizer states anywhere in it, on any device) to
    ``path`` and ``path + '.json'``. With ``group`` (``comm='axis'``) every
    rank must call it: the optimizer states are gathered over the worker
    dim, rank 0 writes the stacked form (other leaves as rank 0 holds
    them), and every rank returns once the file is written; under the 2D
    layout the packed states are first gathered over the model groups."""
    portable = _to_portable(tree, group)
    if group is not None:
        portable = _map_states(lambda s: gather_workers(s, group), portable)
        if group.rank == 0:
            _write(path, portable, step, meta)
        barrier(group)
        return
    _write(path, portable, step, meta)


def _write(path: str, portable: PyTree, step: int,
           meta: Optional[Dict[str, Any]]) -> None:
    arrays: Dict[str, np.ndarray] = {}
    order: List[Tuple[str, str]] = []
    for i, (p, leaf) in enumerate(_leaves_with_path(portable)):
        key = f"{i:05d}|{'/'.join(p)}"
        arrays[key], dtype_name = _leaf_to_numpy(leaf)
        order.append((key, dtype_name))
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    with open(path + ".json", "w") as f:
        json.dump({"step": step, "meta": meta or {}, "leaves": order}, f)


def restore(path: str, like: PyTree,
            group: Optional[WorkerGroup] = None) -> Tuple[PyTree, int]:
    """Restore into the structure, dtypes and devices of ``like`` (shapes
    checked); returns ``(tree, step)``. Optimizer states in ``like``
    (either backend, with or without live straggler-comm buffers) are
    restored through their portable form and adapted back with
    :func:`place_like`. With ``group`` (``like`` a ``comm='axis'`` rank's
    state) the file's optimizer states hold all K workers, and each rank
    keeps its own row (under the 2D layout, repacked row-sharded and cut
    to its model block; every rank must call it)."""
    portable_like = _to_portable(like, group)
    file_like = portable_like
    if group is not None:
        file_like = _map_states(lambda s: _widened(s, group.K),
                                portable_like)
    with open(path + ".json") as f:
        side = json.load(f)
    refs = [x for _, x in _leaves_with_path(file_like)]
    if len(side["leaves"]) != len(refs):
        raise ValueError(f"checkpoint has {len(side['leaves'])} leaves, "
                         f"expected {len(refs)}")
    with np.load(path) as data:
        leaves = [_leaf_from_numpy(data[key], dtype_name, ref, key)
                  for (key, dtype_name), ref in zip(side["leaves"], refs)]
    restored = _rebuild(portable_like, iter(leaves))
    if group is not None:
        restored = _map_states(
            lambda s: take_worker(s, group.rank, group.K), restored)
    return place_like(restored, like, group), side["step"]
