"""The port's compressors against the JAX package's.

Every compressor of the zoo on the same numpy inputs: ``apply``, the wire
payload of ``encode`` and its ``decode``, ``wire_bytes`` and
``delta_bound``, and the tree helpers. Payload arrays that are integers
(sign bits, levels, indices) must be equal; floats agree at the repo's f32
tolerance (rtol = atol = 2e-5): the L1 scale is a sum, taken in another
order by each package. ``randk`` takes JAX's draw through its ``indices``
injection point, since ``jax.random`` cannot be reproduced in torch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro_torch._tree import tree_leaves
from repro_torch.core import compression as tcomp

TOL = dict(rtol=2e-5, atol=2e-5)
SHAPES = [(), (5,), (1000,), (37, 53)]


def jax_randk_indices(fraction, seed=0):
    def indices(d):
        k = max(1, int(round(d * fraction)))
        return np.array(jax.random.permutation(jax.random.PRNGKey(seed),
                                               d)[:k])
    return indices


ZOO = {
    "identity": ({}, {}),
    "sign": ({}, {}),
    "topk": (dict(fraction=1 / 16), dict(fraction=1 / 16)),
    "topk-quarter": (dict(fraction=0.25), dict(fraction=0.25)),
    "randk": (dict(fraction=0.25, seed=3),
              dict(fraction=0.25, indices=jax_randk_indices(0.25, 3))),
    "quantize": (dict(levels=16), dict(levels=16)),
    "quantize-4": (dict(levels=4), dict(levels=4)),
}


def pair(name):
    jkw, tkw = ZOO[name]
    base = name.split("-")[0]
    return jcomp.make_compressor(base, **jkw), tcomp.make_compressor(base,
                                                                     **tkw)


def sample(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_payload_equal(ours, theirs):
    if isinstance(theirs, dict):
        assert sorted(ours) == sorted(theirs)
        for k in theirs:
            assert_payload_equal(ours[k], theirs[k])
        return
    a, b = ours.numpy(), np.asarray(theirs)
    assert a.shape == b.shape
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if np.issubdtype(b.dtype, np.integer):
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", sorted(ZOO))
def test_compressor_matches_jax(name, shape):
    jc, tc = pair(name)
    assert tc.name == jc.name
    x = sample(shape)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(tc.apply(xt).numpy(), np.asarray(jc.apply(xj)),
                               **TOL)
    tp, jp = tc.encode(xt), jc.encode(xj)
    assert_payload_equal(tp, jp)
    dec = tc.decode(tp, shape, torch.float32)
    assert tuple(dec.shape) == shape
    np.testing.assert_allclose(dec.numpy(), np.asarray(
        jc.decode(jp, shape, jnp.float32)), **TOL)
    np.testing.assert_allclose(tc.roundtrip(xt).numpy(),
                               tc.apply(xt).numpy(), rtol=0, atol=0)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        assert tc.wire_bytes(shape, dt) == jc.wire_bytes(shape, jdt)
    for d in (1, 7, 1000, 4096):
        assert tc.delta_bound(d) == jc.delta_bound(d)


@pytest.mark.parametrize("name", sorted(set(ZOO) - {"randk"}))
def test_compressors_contract(name):
    """Definition 2 on a random vector: ||x - Q(x)||^2 <= (1 - delta)
    ||x||^2, with the compressor's own delta bound (randk's holds only in
    expectation)."""
    _, tc = pair(name)
    x = torch.from_numpy(sample((512,), 4)).double()
    err = float(((x - tc.apply(x)) ** 2).sum())
    assert err <= (1 - tc.delta_bound(512)) * float((x ** 2).sum()) + 1e-9


def test_tree_helpers_match_jax():
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((13, 7)).astype(np.float32),
            "b": [rng.standard_normal((5,)).astype(np.float32)],
            "s": np.float32(0.5)}
    ttree = {"w": torch.from_numpy(tree["w"]),
             "b": [torch.from_numpy(tree["b"][0])],
             "s": torch.tensor(0.5)}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    for name in ("sign", "topk", "identity"):
        jc, tc = pair(name)
        assert tcomp.tree_wire_bytes(tc, ttree) == \
            jcomp.tree_wire_bytes(jc, jtree)
        got = tree_leaves(tcomp.tree_apply(tc, ttree))
        want = jax.tree_util.tree_leaves(jcomp.tree_apply(jc, jtree))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert tcomp.tree_dense_bytes(ttree) == jcomp.tree_dense_bytes(jtree)


def test_randk_draws_from_its_seed_without_an_injection():
    a = tcomp.randk(0.25, seed=1).encode(torch.arange(40.0))
    b = tcomp.randk(0.25, seed=1).encode(torch.arange(40.0))
    c = tcomp.randk(0.25, seed=2).encode(torch.arange(40.0))
    assert torch.equal(a["indices"], b["indices"])
    assert not torch.equal(a["indices"], c["indices"])
    assert a["indices"].dtype == torch.int32 and a["indices"].numel() == 10


def test_bad_arguments_raise_as_in_jax():
    with pytest.raises(KeyError):
        tcomp.make_compressor("qsgd")
    for fn, kw in ((tcomp.topk, dict(fraction=0.0)),
                   (tcomp.randk, dict(fraction=1.5)),
                   (tcomp.quantize, dict(levels=1)),
                   (tcomp.quantize, dict(levels=128))):
        with pytest.raises(ValueError):
            fn(**kw)
