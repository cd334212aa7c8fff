"""Carry weights and optimizer state across from the JAX package.

The JAX side hands over numpy arrays (``jax.tree_util.tree_map(np.asarray,
...)``); nothing here imports JAX. Leaf order is ``jax.tree_util``'s
(sorted dict keys) in both packages, and the packed layouts are equal
element for element, so a packed state crosses as a plain copy.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.core.dadam import PackedDAdamState
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


def params_from_numpy(tree: PyTree, device: "str | torch.device" = "cuda"
                      ) -> PyTree:
    """A nested dict/list of numpy arrays becomes the port's params, with
    the same structure, leaf order and dtypes."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree: PyTree) -> PyTree:
    """The reverse of :func:`params_from_numpy`; bfloat16 leaves come back
    as ``ml_dtypes.bfloat16`` arrays, as ``np.asarray`` gives them for a
    JAX array."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return tree_map(one, tree)


def dadam_state_from_numpy(buf, m, v, count, params_like: PyTree,
                           device: "str | torch.device" = "cuda"
                           ) -> PackedDAdamState:
    """A JAX ``PackedDAdamState``'s buffers become the port's.
    ``params_like`` is the port's stacked params tree (any values); the
    buffers must have the shape of the port's own layout for it."""
    spec = packing.make_spec(params_like, stacked=True,
                             block_rows=BLOCK_ROWS, leaf_align=True)
    bufs = [tensor_from_numpy(x, device) for x in (buf, m, v)]
    for name, b in zip(("buf", "m", "v"), bufs):
        if tuple(b.shape) != spec.buf_shape():
            raise ValueError(f"{name} has shape {tuple(b.shape)}; the port's "
                             f"layout of these params is {spec.buf_shape()}")
    return PackedDAdamState(*bufs, int(count), spec, spec)


def dadam_state_to_numpy(state: PackedDAdamState) -> Dict[str, Any]:
    """The reverse: ``{'buf', 'm', 'v'}`` as numpy arrays and ``count``
    as an int."""
    out: Dict[str, Any] = {
        k: getattr(state, k).detach().cpu().numpy()
        for k in ("buf", "m", "v")}
    out["count"] = int(state.count)
    return out
