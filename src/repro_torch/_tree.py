"""Nested dict/list/tuple trees, flattened in ``jax.tree_util``'s order.

Dict keys are SORTED, as ``jax.tree_util`` sorts them. ``torch.utils._pytree``
keeps insertion order instead, which would shift every offset of the packed
layout against the JAX reference. Everything that is not a dict, list or
tuple is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

PyTree = Any


class TreeDef(NamedTuple):
    """The structure of a tree: ``kind`` is 'leaf', 'dict', 'list' or
    'tuple'; ``keys`` the sorted dict keys (else ``None``)."""

    kind: str
    keys: Any
    children: Tuple["TreeDef", ...]


LEAF = TreeDef("leaf", None, ())


def _walk(node, leaves: List[Any]) -> TreeDef:
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return TreeDef("dict", keys,
                       tuple(_walk(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return TreeDef(kind, None, tuple(_walk(c, leaves) for c in node))
    leaves.append(node)
    return LEAF


def tree_flatten(tree: PyTree) -> Tuple[List[Any], TreeDef]:
    # module-level helpers, not nested recursive closures: a closure that
    # calls itself is a reference cycle, which would keep the leaves (and
    # the tensors) alive until the cyclic garbage collector runs
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _build(td: TreeDef, it) -> PyTree:
    if td.kind == "leaf":
        return next(it)
    children = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.keys, children))
    return children if td.kind == "list" else tuple(children)


def tree_unflatten(treedef: TreeDef, leaves) -> PyTree:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_leaves(tree: PyTree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves, td = tree_flatten(tree)
    others = []
    for r in rest:
        rl, rtd = tree_flatten(r)
        if rtd != td:
            raise ValueError(f"tree structures differ: {td} vs {rtd}")
        others.append(rl)
    return tree_unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])
