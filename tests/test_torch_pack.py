"""The port's pack layer (``repro_torch.kernels.pack``) against the JAX
package's, on the randomized fixtures of ``tests/test_pack_property.py``.

Buffers must be equal element for element: same leaf order (sorted dict
keys), offsets, padding and dtype. Also: ``unpack`` inverts ``pack``
exactly and returns views of the buffer, padding is zero, non-float leaves
are rejected, and DeepFM's leaf order and row ranges agree at the paper's
full width.
"""
import collections
import gc
import weakref
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pack as jpack
from repro_torch import _tree
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import pack as tpack

torch.set_num_threads(2)

LANE = tpack.LANE


def random_tree(rng: np.random.Generator, stacked_k):
    """The generator of tests/test_pack_property.py: 1-5 leaves, awkward
    shapes, mixed f32/bf16 leaves, half of them nested."""
    n_leaves = int(rng.integers(1, 6))
    dims_pool = [1, 2, 3, 5, 7, 11, 13, 17, 127, 129, 300]
    tree = {}
    for i in range(n_leaves):
        rank = int(rng.integers(0, 4))
        shape = tuple(int(rng.choice(dims_pool)) for _ in range(rank))
        if stacked_k is not None:
            shape = (stacked_k,) + shape
        dtype = jnp.bfloat16 if rng.random() < 0.3 else jnp.float32
        leaf = jnp.asarray(rng.standard_normal(shape), dtype)
        if rng.random() < 0.5:
            tree.setdefault("nest", {})[f"l{i}"] = leaf
        else:
            tree[f"l{i}"] = leaf
    return tree


def both(jtree):
    """The JAX tree and the port's copy of it (bf16 bits carried across)."""
    return jtree, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def layout(seed):
    rng = np.random.default_rng(seed)
    stacked = bool(rng.random() < 0.7)
    k = int(rng.integers(1, 6)) if stacked else None
    block_rows = int(rng.choice([1, 2, 8, 32]))
    leaf_align = bool(stacked and rng.random() < 0.7)
    return rng, stacked, k, block_rows, leaf_align


@pytest.mark.parametrize("seed", range(12))
def test_pack_equals_jax_bitwise(seed):
    rng, stacked, k, block_rows, leaf_align = layout(seed)
    jtree, ttree = both(random_tree(rng, k))
    kw = dict(stacked=stacked, block_rows=block_rows, leaf_align=leaf_align)
    jspec = jpack.make_spec(jtree, **kw)
    tspec = tpack.make_spec(ttree, **kw)
    assert (tspec.offsets, tspec.sizes, tspec.rows, tspec.k, tspec.n) == \
        (jspec.offsets, jspec.sizes, jspec.rows, jspec.k, jspec.n)
    jbuf, tbuf = jpack.pack(jtree, jspec), tpack.pack(ttree, tspec)
    assert tuple(tbuf.shape) == tuple(jbuf.shape) == tspec.buf_shape()
    assert str(tbuf.dtype).split(".")[-1] == jnp.dtype(jbuf.dtype).name
    np.testing.assert_array_equal(as_f32(tbuf), as_f32(jbuf))


@pytest.mark.parametrize("seed", range(12))
def test_unpack_inverts_pack_with_zero_padding(seed):
    rng, stacked, k, block_rows, leaf_align = layout(seed)
    _, ttree = both(random_tree(rng, k))
    spec = tpack.make_spec(ttree, stacked=stacked, block_rows=block_rows,
                           leaf_align=leaf_align)
    buf = tpack.pack(ttree, spec)
    back = tpack.unpack(buf, spec)
    for a, b in zip(_tree.tree_leaves(back), _tree.tree_leaves(ttree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(as_f32(a), as_f32(b))
    flat = as_f32(buf).reshape(spec.k or 1, -1)
    mask = np.zeros(flat.shape[1], bool)
    for o, sz in zip(spec.offsets, spec.sizes):
        mask[o:o + sz] = True
    assert np.all(flat[:, ~mask] == 0.0)
    if leaf_align:
        ranges = tpack.leaf_row_ranges(spec)
        assert ranges[0][0] == 0 and ranges[-1][1] == spec.rows
        for (r0, r1), sz in zip(ranges, spec.sizes):
            assert (r1 - r0) % block_rows == 0 and (r1 - r0) * LANE >= sz
    else:
        with pytest.raises(ValueError, match="leaf_align"):
            tpack.leaf_row_ranges(spec)


def test_unpack_returns_views_of_the_buffer():
    tree = {"w": torch.randn(3, 13, 7), "b": torch.randn(3),
            "n": {"u": torch.randn(3, 5)}}
    spec = tpack.make_spec(tree, stacked=True, block_rows=8, leaf_align=True)
    buf = tpack.pack(tree, spec)
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel() * 4
    for leaf in _tree.tree_leaves(tpack.unpack(buf, spec)):
        assert leaf.untyped_storage().data_ptr() == \
            buf.untyped_storage().data_ptr()
        assert lo <= leaf.data_ptr() < hi
    # a write through the buffer shows in the views
    buf.zero_()
    assert float(tpack.unpack(buf, spec)["w"].abs().sum()) == 0.0


@pytest.mark.parametrize("seed", range(12))
def test_unpack_gradient_is_one_buffer_equal_to_the_views(seed):
    """The packed gradient through ``unpack`` (one buffer, written leaf by
    leaf by its backward) equals, bit for bit, the gradient through plain
    views of the buffer (autograd's zero-fill and sum per leaf), its
    padding zero; a leaf the loss does not read gets zeros. The leaves
    are views of the buffer also when autograd records the call."""
    rng, stacked, k, block_rows, leaf_align = layout(seed)
    _, ttree = both(random_tree(rng, k))
    spec = tpack.make_spec(ttree, stacked=stacked, block_rows=block_rows,
                           leaf_align=leaf_align)
    base = tpack.pack(ttree, spec)
    coefs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in spec.shapes]
    # the leaf the loss does not read; len(coefs): every leaf is read
    skip = int(rng.integers(0, len(coefs) + 1)) if len(coefs) > 1 else 1

    def loss(leaves):
        return sum(torch.sum(c * x.to(torch.float32) ** 2)
                   for i, (c, x) in enumerate(zip(coefs, leaves))
                   if i != skip)

    buf = base.clone().requires_grad_(True)
    leaves = _tree.tree_leaves(tpack.unpack(buf, spec))
    for x, dt in zip(leaves, spec.dtypes):
        if dt == buf.dtype:
            assert x.untyped_storage().data_ptr() == \
                buf.untyped_storage().data_ptr()
    (got,) = torch.autograd.grad(loss(leaves), buf)
    old = base.clone().requires_grad_(True)
    loss(tpack._leaf_views(old, spec)).backward()
    assert got.shape == old.grad.shape and got.dtype == old.grad.dtype
    assert torch.equal(got.view(torch.uint8), old.grad.view(torch.uint8))
    flat = got.reshape(spec.k or 1, -1)
    mask = torch.zeros(flat.shape[1], dtype=torch.bool)
    for o, sz in zip(spec.offsets, spec.sizes):
        mask[o:o + sz] = True
    assert torch.all(flat[:, ~mask] == 0)
    if skip < len(coefs):
        o, sz = spec.offsets[skip], spec.sizes[skip]
        assert torch.all(flat[:, o:o + sz] == 0)


def test_tree_flatten_sorts_dict_keys_like_jax():
    tree = {"z": 1.0, "a": [2.0, {"y": 3.0, "b": 4.0}], "m": (5.0, 6.0)}
    leaves, td = _tree.tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    assert _tree.tree_unflatten(td, leaves) == tree
    assert _tree.tree_map(lambda x, y: x + y, tree, tree)["a"][1]["y"] == 6.0


class _Pair(NamedTuple):
    a: Any
    b: Any


class _OtherPair(NamedTuple):
    a: Any
    b: Any


@pytest.mark.parametrize("case", ["none", "ordered_dict", "namedtuple"])
def test_tree_nodes_match_jax_tree_util(case):
    """``None``, ``OrderedDict`` and NamedTuple nodes flatten, rebuild and
    map as ``jax.tree_util`` does them (numpy leaves on both sides)."""
    rng = np.random.default_rng(0)
    x, y, z = (rng.standard_normal(3).astype(np.float32) for _ in range(3))
    if case == "none":
        tree = {"a": None, "b": x}
    elif case == "ordered_dict":
        tree = collections.OrderedDict([("z", x), ("a", y), ("m", z)])
    else:
        tree = {"s": _Pair(x, [y, None]), "t": z}
    leaves, td = _tree.tree_flatten(tree)
    jleaves, jtd = jax.tree_util.tree_flatten(tree)
    assert len(leaves) == len(jleaves)
    assert all(a is b for a, b in zip(leaves, jleaves))
    back = _tree.tree_unflatten(td, leaves)
    jback = jax.tree_util.tree_unflatten(jtd, jleaves)
    assert type(back) is type(jback)
    mapped = _tree.tree_map(lambda v: v * 2, tree)
    jmapped = jax.tree_util.tree_map(lambda v: v * 2, tree)
    assert jax.tree_util.tree_structure(mapped) == \
        jax.tree_util.tree_structure(jmapped)
    for a, b in zip(_tree.tree_leaves(mapped),
                    jax.tree_util.tree_leaves(jmapped)):
        np.testing.assert_array_equal(a, b)
    if case == "none":
        assert len(leaves) == 1 and back["a"] is None
        assert mapped["a"] is None
    elif case == "ordered_dict":
        assert list(back) == ["z", "a", "m"]
        assert isinstance(mapped, collections.OrderedDict)
        assert [v is w for v, w in zip(leaves, (x, y, z))] == [True] * 3
    else:
        assert type(mapped["s"]) is _Pair and mapped["s"].b[1] is None
        other = {"s": _OtherPair(x, [y, None]), "t": z}
        with pytest.raises(ValueError, match="structures differ"):
            _tree.tree_map(lambda u, v: u + v, tree, other)
        with pytest.raises(ValueError):
            jax.tree_util.tree_map(lambda u, v: u + v, tree, other)


def test_tree_map_keeps_no_leaf_alive():
    """Flattening makes no reference cycle: once a tree_map returns, its
    inputs are freed without the cyclic garbage collector (a 4.94 GB
    model init held ~3.9 GB more on the card until it ran)."""
    x = torch.zeros(3)
    ref = weakref.ref(x)
    gc.disable()
    try:
        out = _tree.tree_map(lambda t: t + 1, {"b": [x, (x,)], "a": x})
        del x
        assert ref() is None
    finally:
        gc.enable()
    assert _tree.tree_leaves(out)[0].tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("bad", [
    {"ids": np.arange(8, dtype=np.int32)},
    {"mask": np.ones((4,), bool)},
    {"w": np.ones((4, 4), np.float32), "ids": np.arange(8, dtype=np.int32)},
])
def test_non_float_leaves_rejected(bad):
    with pytest.raises(ValueError, match="float"):
        tpack.make_spec(params_from_numpy(bad, "cpu"))


def test_int_tree_rejected_against_float_spec():
    spec = tpack.make_spec({"w": torch.ones(4, 4), "ids": torch.ones(8)})
    with pytest.raises(ValueError, match="float"):
        tpack.pack({"w": torch.ones(4, 4),
                    "ids": torch.arange(8, dtype=torch.int32)}, spec)


def test_rejections():
    with pytest.raises(ValueError, match="empty"):
        tpack.make_spec({"a": {}, "b": ()})
    with pytest.raises(ValueError, match="worker dim"):
        tpack.make_spec({"a": torch.ones(2, 3), "b": torch.ones(4, 3)},
                        stacked=True)
    spec = tpack.make_spec({"w": torch.ones(3, 8)}, stacked=True)
    with pytest.raises(ValueError, match="match spec"):
        tpack.pack({"w": torch.ones(3, 9)}, spec)
    with pytest.raises(NotImplementedError, match="row_shards"):
        tpack.make_spec({"w": torch.ones(3, 8)}, stacked=True,
                        leaf_align=True, row_shards=2)


def test_bf16_roundtrip_through_numpy_is_exact():
    jtree = {"b": jnp.asarray([1.0, -0.5, 1024.0, 3e-3], jnp.bfloat16)}
    _, ttree = both(jtree)
    assert ttree["b"].dtype == torch.bfloat16
    back = params_to_numpy(ttree)["b"]
    np.testing.assert_array_equal(back.view(np.uint16),
                                  np.asarray(jtree["b"]).view(np.uint16))


@pytest.mark.parametrize("width", ["small", "paper"])
def test_deepfm_leaf_order_and_row_ranges_match_jax(width):
    """At the paper's width (39 x 25,000 features, embed 10, MLP
    400-400-400) the resident buffer is (8, 89344, 128). Shapes only: the
    specs are built from JAX ShapeDtypeStructs and torch meta tensors."""
    from repro.models.deepfm import init_deepfm

    F, fpf, E, hidden = ((4, 16, 4, (16, 16)) if width == "small"
                         else (39, 25_000, 10, (400, 400, 400)))
    K = 8
    shapes = jax.eval_shape(
        lambda: init_deepfm(jax.random.PRNGKey(0), F * fpf, F, E, hidden))
    jstk = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct((K,) + s.shape, s.dtype), shapes)
    tstk = jax.tree_util.tree_map(
        lambda s: torch.empty((K,) + s.shape, device="meta"), shapes)
    kw = dict(stacked=True, block_rows=tpack.BLOCK_ROWS, leaf_align=True)
    jspec, tspec = jpack.make_spec(jstk, **kw), tpack.make_spec(tstk, **kw)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jstk)[0]]
    assert paths[:4] == ["['bias']", "['embed']", "['linear']",
                         "['mlp'][0]['b']"]
    assert tspec.shapes == jspec.shapes
    assert tspec.offsets == jspec.offsets and tspec.rows == jspec.rows
    assert tpack.leaf_row_ranges(tspec) == jpack.leaf_row_ranges(jspec)
    if width == "paper":
        assert tspec.n == 11_202_602
        assert tspec.buf_shape() == (8, 89344, 128)
