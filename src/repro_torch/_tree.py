"""Nested containers flattened in ``jax.tree_util``'s order.

The nodes, as ``jax.tree_util`` treats them:

- ``dict``: children by SORTED key (``torch.utils._pytree`` keeps
  insertion order instead, which would shift every offset of the packed
  layout against the JAX reference);
- ``collections.OrderedDict``: children in insertion order, rebuilt as an
  ``OrderedDict``;
- a NamedTuple (a tuple subclass with ``_fields``): its fields in order,
  rebuilt as its own class;
- ``list`` and ``tuple``: children in order;
- ``None``: a node with no children, so it adds no leaf.

Everything else is a leaf.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, List, NamedTuple, Tuple

PyTree = Any


class TreeDef(NamedTuple):
    """The structure of a tree: ``kind`` is 'leaf', 'none', 'dict',
    'odict', 'namedtuple', 'list' or 'tuple'; ``keys`` the dict keys in
    flattening order (else ``None``); ``node_type`` the NamedTuple class
    (else ``None``), so that two NamedTuple classes of one shape differ."""

    kind: str
    keys: Any
    children: Tuple["TreeDef", ...]
    node_type: Any = None


LEAF = TreeDef("leaf", None, ())
NONE = TreeDef("none", None, ())


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _walk(node, leaves: List[Any]) -> TreeDef:
    if node is None:
        return NONE
    if isinstance(node, dict):
        ordered = isinstance(node, collections.OrderedDict)
        keys = tuple(node) if ordered else tuple(sorted(node))
        return TreeDef("odict" if ordered else "dict", keys,
                       tuple(_walk(node[k], leaves) for k in keys))
    if _is_namedtuple(node):
        return TreeDef("namedtuple", None,
                       tuple(_walk(c, leaves) for c in node), type(node))
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
    if td.kind == "none":
        return None
    children = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.keys, children))
    if td.kind == "odict":
        return collections.OrderedDict(zip(td.keys, children))
    if td.kind == "namedtuple":
        return td.node_type(*children)
    return children if td.kind == "list" else tuple(children)


def tree_unflatten(treedef: TreeDef, leaves) -> PyTree:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_leaves(tree: PyTree) -> List[Any]:
    return tree_flatten(tree)[0]


def _paths(td: TreeDef, prefix: Tuple[str, ...],
           out: List[Tuple[str, ...]]) -> None:
    """The leaves' paths of ``td``, in its flattening order."""
    if td.kind == "leaf":
        out.append(prefix)
        return
    if td.kind in ("dict", "odict"):
        names = [f"[{k!r}]" for k in td.keys]
    elif td.kind == "namedtuple":
        names = [f".{f}" for f in td.node_type._fields]
    else:       # list, tuple; 'none' has no children
        names = [f"[{i}]" for i in range(len(td.children))]
    for name, child in zip(names, td.children):
        _paths(child, prefix + (name,), out)


def keystr(path: Tuple[str, ...]) -> str:
    """A leaf's path as ``jax.tree_util.keystr`` writes it:
    ``['a'][0].field``."""
    return "".join(path)


def tree_map_with_path(fn: Callable, tree: PyTree) -> PyTree:
    """``fn(path, leaf)`` over the leaves, in flattening order; ``path`` is
    a tuple of JAX's key entries (``['key']``, ``[index]``, ``.field``)."""
    leaves, td = tree_flatten(tree)
    paths: List[Tuple[str, ...]] = []
    _paths(td, (), paths)
    return tree_unflatten(td, [fn(p, x) for p, x in zip(paths, leaves)])


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves, td = tree_flatten(tree)
    others = []
    for r in rest:
        rl, rtd = tree_flatten(r)
        if rtd != td:
            raise ValueError(f"tree structures differ: {td} vs {rtd}")
        others.append(rl)
    return tree_unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])
