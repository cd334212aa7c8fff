"""The recompile gate, the port of ``repro.analysis.jaxpr_lint``'s
``RecompileWatch`` (JXL003).

JAX hashes the abstract signature of every call of a jitted function: more
distinct signatures than a limit means XLA is compiling again and again.
The port runs eagerly and keeps the same contract over the same
signature: the structure of the call's arguments, and for each leaf its
shape, dtype and device when it is a tensor, or its type name when it is
not (a host ``int`` such as the packed states' ``count`` keys by type, as
a Python scalar retraces by type in JAX; keying it by value would make
every step a new signature).

The packed states (``PackedDAdamState``, ``PackedCDAdamState``) are
dataclasses, which ``_tree`` keeps whole. JAX flattens them into their
buffers, the count and the payload rings, with the pack specs as static
aux data; the signature descends into them the same way: every field is
a child but a ``PackSpec``, which is keyed by value as part of the
structure.

``DecodeEngine`` keeps one watch a phase (limit: the bucket count) and
``DecentralizedTrainer(recompile_limit=)`` one over its step, built fresh
at each rebind (construction, elastic resize, damping lr decay).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch._tree import tree_flatten
from repro_torch.kernels.pack import PackSpec


class RecompileError(RuntimeError):
    pass


def _leaf_signature(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        values = [getattr(x, f.name) for f in dataclasses.fields(x)]
        return (type(x),
                tuple(v for v in values if isinstance(v, PackSpec)),
                signature([v for v in values
                           if not isinstance(v, PackSpec)]))
    return (type(x).__name__,)


def signature(tree: Any) -> Any:
    """The hashable abstract signature of ``tree``: its structure and each
    leaf's (shape, dtype, device), or its type name when it is not a
    tensor; dataclass leaves are opened (see the module docstring)."""
    leaves, treedef = tree_flatten(tree)
    return treedef, tuple(_leaf_signature(x) for x in leaves)


class SignatureWatch:
    """Counts the distinct signatures of the calls of one function. More
    than ``limit`` means a shape, dtype, device or structure escaped the
    set the caller pinned; :meth:`check` raises then. A legitimate rebuild
    (an elastic resize, an lr-decay rebind) builds a fresh watch rather
    than raising the limit."""

    def __init__(self, name: str = "fn", limit: int = 1):
        self.name = name
        self.limit = int(limit)
        self.signatures: Dict[Any, int] = {}

    def observe(self, *args: Any) -> int:
        """Record one call; returns the number of distinct signatures."""
        sig = signature(args)
        self.signatures[sig] = self.signatures.get(sig, 0) + 1
        return len(self.signatures)

    def check(self) -> None:
        n = len(self.signatures)
        if n > self.limit:
            raise RecompileError(
                f"`{self.name}` saw {n} distinct input signatures (limit "
                f"{self.limit}): each one is a program shape outside the "
                "set it was pinned to. Pin shapes and dtypes (pad batches "
                "into the buckets, keep the chunk counts static) or start "
                "a fresh watch at a legitimate rebuild")
