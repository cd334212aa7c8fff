"""Carry weights and optimizer state across from the JAX package.

The JAX side hands over numpy arrays (``jax.tree_util.tree_map(np.asarray,
...)``); nothing here imports JAX. Leaf order is ``jax.tree_util``'s
(sorted dict keys) in both packages, and the packed layouts are equal
element for element, so a packed state crosses as a plain copy, live
straggler buffers (D-Adam ``stale``, CD-Adam ``pending`` rings) included.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.core.cdadam import PackedCDAdamState
from repro_torch.core.dadam import PackedDAdamState, StaleBufs
from repro_torch.kernels import pack as packing
from repro_torch.kernels.pack import BLOCK_ROWS

PyTree = Any


def tensor_from_numpy(a, device: "str | torch.device" = "cuda"
                      ) -> torch.Tensor:
    """A copy of ``a`` on ``device`` with the same dtype; bfloat16
    (``ml_dtypes``) arrays cross through their 16-bit pattern."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as numpy; a bfloat16 tensor as an
    ``ml_dtypes.bfloat16`` array of the same bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: PyTree, device: "str | torch.device" = "cuda"
                      ) -> PyTree:
    """A nested dict/list of numpy arrays becomes the port's params, with
    the same structure, leaf order and dtypes."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree: PyTree) -> PyTree:
    """The reverse of :func:`params_from_numpy`; bfloat16 leaves come back
    as ``ml_dtypes.bfloat16`` arrays, as ``np.asarray`` gives them for a
    JAX array."""
    return tree_map(_to_numpy, tree)


def _resident_buffers(named, params_like: PyTree, device):
    """``(spec, tensors)``: the numpy buffers on ``device``, each checked
    against the port's leaf-aligned layout of ``params_like``."""
    spec = packing.make_spec(params_like, stacked=True,
                             block_rows=BLOCK_ROWS, leaf_align=True)
    bufs = []
    for name, x in named:
        b = tensor_from_numpy(x, device)
        if tuple(b.shape) != spec.buf_shape():
            raise ValueError(f"{name} has shape {tuple(b.shape)}; the port's "
                             f"layout of these params is {spec.buf_shape()}")
        bufs.append(b)
    return spec, bufs




def dadam_state_from_numpy(buf, m, v, count, params_like: PyTree,
                           device: "str | torch.device" = "cuda", *,
                           stale_bufs: Optional[Sequence[Any]] = None,
                           stale_age=None) -> PackedDAdamState:
    """A JAX ``PackedDAdamState``'s buffers become the port's.
    ``params_like`` is the port's stacked params tree (any values); the
    buffers must have the shape of the port's own layout for it. A state
    with live staleness / overlap buffers hands over ``stale.bufs`` (one
    packed buffer per offset) and ``stale.age`` ((K, deg) int32, kept on
    the host CPU by the port)."""
    bufs_in = tuple(stale_bufs or ())
    names = ("buf", "m", "v") + tuple(f"stale_bufs[{i}]"
                                      for i in range(len(bufs_in)))
    spec, bufs = _resident_buffers(zip(names, (buf, m, v) + bufs_in),
                                   params_like, device)
    stale = None
    if stale_bufs is not None:
        age = torch.from_numpy(np.array(stale_age, dtype=np.int32))
        if tuple(age.shape) != (spec.k, len(bufs_in)):
            raise ValueError(f"stale_age has shape {tuple(age.shape)}, "
                             f"expected {(spec.k, len(bufs_in))}")
        stale = StaleBufs(tuple(bufs[3:]), age)
    return PackedDAdamState(*bufs[:3], int(count), spec, spec, stale)


def dadam_state_to_numpy(state: PackedDAdamState) -> Dict[str, Any]:
    """The reverse: ``{'buf', 'm', 'v'}`` as numpy arrays, ``count`` as an
    int and, with live buffers, ``stale_bufs`` (a tuple) and
    ``stale_age``."""
    out: Dict[str, Any] = {k: _to_numpy(getattr(state, k))
                           for k in ("buf", "m", "v")}
    out["count"] = int(state.count)
    if getattr(state, "stale", None) is not None:
        out["stale_bufs"] = tuple(_to_numpy(b) for b in state.stale.bufs)
        out["stale_age"] = _to_numpy(state.stale.age)
    return out


def _rings_from_numpy(pending: Sequence[Any], spec: packing.PackSpec,
                      device) -> Tuple[Dict[str, torch.Tensor], ...]:
    out = []
    for i, ring in enumerate(pending):
        q = tensor_from_numpy(ring["q"], device)
        sc = tensor_from_numpy(ring["scale"], device)
        K, rows = spec.buf_shape()[:2]
        if (q.dim() != 4 or tuple(q.shape[:1] + q.shape[2:])
                != (K, rows, packing.LANE) or q.dtype != torch.int8
                or tuple(sc.shape[:2]) != tuple(q.shape[:2])):
            raise ValueError(
                f"pending[{i}] has q {tuple(q.shape)} {q.dtype} and scale "
                f"{tuple(sc.shape)}; the port's ring for this layout is q "
                f"(K, T, {rows}, {packing.LANE}) int8, scale (K, T[, L])")
        out.append({"q": q, "scale": sc})
    return tuple(out)


def cdadam_state_from_numpy(buf, m, v, count, hat_buf,
                            hat_nbr_bufs: Sequence[Any], params_like: PyTree,
                            device: "str | torch.device" = "cuda", *,
                            pending: Optional[Sequence[Any]] = None
                            ) -> PackedCDAdamState:
    """A JAX ``PackedCDAdamState``'s buffers become the port's, one
    ``hat_nbr_bufs`` entry per topology offset, in the topology's order.
    A state with live delay rings hands over ``pending``, one
    ``{"q", "scale"}`` dict per offset."""
    hat_nbr_bufs = tuple(hat_nbr_bufs)
    names = ("buf", "m", "v", "hat_buf") + tuple(
        f"hat_nbr_bufs[{i}]" for i in range(len(hat_nbr_bufs)))
    spec, bufs = _resident_buffers(
        zip(names, (buf, m, v, hat_buf) + hat_nbr_bufs), params_like, device)
    rings = (None if pending is None
             else _rings_from_numpy(pending, spec, resolve_device(device)))
    return PackedCDAdamState(*bufs[:3], int(count), bufs[3], tuple(bufs[4:]),
                             spec, spec, rings)


def cdadam_state_to_numpy(state: PackedCDAdamState) -> Dict[str, Any]:
    """The reverse: ``{'buf', 'm', 'v', 'hat_buf'}`` as numpy arrays,
    ``hat_nbr_bufs`` as a tuple of them, ``count`` as an int and, with
    live rings, ``pending`` as a tuple of ``{"q", "scale"}`` dicts."""
    out = dadam_state_to_numpy(state)
    out["hat_buf"] = _to_numpy(state.hat_buf)
    out["hat_nbr_bufs"] = tuple(_to_numpy(h) for h in state.hat_nbr_bufs)
    if state.pending is not None:
        out["pending"] = tuple({k: _to_numpy(v) for k, v in ring.items()}
                               for ring in state.pending)
    return out
