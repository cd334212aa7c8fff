"""The row-sharded pack layer (``make_spec(row_shards=M)``) against the JAX
package's, element for element at M in {2, 4}, on the ragged tree of
``tests/test_grad_pipeline.py`` plus a zero-size leaf: the spec, ``pack``,
``unpack``, ``unpack_worker``, ``unpack_mean``, ``leaf_row_ranges``,
``local_chunk_elems``, ``unpack_local`` and ``mirror_local`` of every shard
block; then the gradients of ``unpack`` and ``unpack_local`` (one buffer
each) and the refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pack as jpack
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.kernels import pack as tpack

MS = [2, 4]
K = 4


def ragged(seed=0):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((K, 13, 7)),
            "b": rng.standard_normal((K, 5)),
            "n": {"u": rng.standard_normal((K, 3, 11, 2))},
            "z": np.zeros((K, 0))}
    arrays = {k: (v.astype(np.float32) if not isinstance(v, dict) else
                  {kk: vv.astype(np.float32) for kk, vv in v.items()})
              for k, v in tree.items()}
    return (jax.tree_util.tree_map(jnp.asarray, arrays),
            tree_map(torch.from_numpy, arrays))


def specs(M):
    jt, tt = ragged()
    kw = dict(stacked=True, block_rows=tpack.BLOCK_ROWS, leaf_align=True,
              row_shards=M)
    js, ts = jpack.make_spec(jt, **kw), tpack.make_spec(tt, **kw)
    return jt, tt, js, ts


def equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


@pytest.mark.parametrize("M", MS)
def test_spec_and_pack_match_jax(M):
    jt, tt, js, ts = specs(M)
    assert (ts.offsets, ts.sizes, ts.rows, ts.n, ts.k, ts.row_shards) == \
        (js.offsets, js.sizes, js.rows, js.n, js.k, js.row_shards)
    assert ts.local_rows == js.local_rows == ts.rows // M
    assert ts.rows % (M * tpack.BLOCK_ROWS) == 0
    assert tpack.leaf_row_ranges(ts) == jpack.leaf_row_ranges(js)
    assert tpack.local_chunk_elems(ts) == jpack.local_chunk_elems(js)
    equal(jpack.pack(jt, js), tpack.pack(tt, ts))


@pytest.mark.parametrize("M", MS)
def test_unpack_worker_and_mean_match_jax(M):
    jt, tt, js, ts = specs(M)
    jb, tb = jpack.pack(jt, js), tpack.pack(tt, ts)
    for a, b in zip(jax.tree_util.tree_leaves(jpack.unpack(jb, js)),
                    tree_leaves(tpack.unpack(tb, ts))):
        equal(a, b)
    for k in range(K):
        for a, b in zip(
                jax.tree_util.tree_leaves(jpack.unpack_worker(jb, js, k)),
                tree_leaves(tpack.unpack_worker(tb, ts, k))):
            equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(jpack.unpack_mean(jb, js)),
                    tree_leaves(tpack.unpack_mean(tb, ts))):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("M", MS)
def test_unpack_local_and_mirror_local_match_jax(M):
    jt, tt, js, ts = specs(M)
    jb, tb = jpack.pack(jt, js), tpack.pack(tt, ts)
    lr = ts.local_rows
    per_worker_j = jax.tree_util.tree_map(lambda x: x[0], jt)
    per_worker_t = tree_map(lambda x: x[0], tt)
    for j in range(M):
        blk = slice(j * lr, (j + 1) * lr)
        for a, b in zip(
                jax.tree_util.tree_leaves(jpack.unpack_local(jb[:, blk], js)),
                tree_leaves(tpack.unpack_local(tb[:, blk], ts))):
            equal(a, b)
        for a, b in zip(
                jax.tree_util.tree_leaves(
                    jpack.mirror_local(per_worker_j, js, j)),
                tree_leaves(tpack.mirror_local(per_worker_t, ts, j))):
            equal(a, b)


@pytest.mark.parametrize("M", MS)
def test_chunks_concat_to_unpack(M):
    """The M blocks' chunks, in order and without their padding, are the
    leaves (the shard-invariant layout)."""
    _, tt, _, ts = specs(M)
    tb = tpack.pack(tt, ts)
    lr = ts.local_rows
    per = [tree_leaves(tpack.unpack_local(tb[:, j * lr:(j + 1) * lr], ts))
           for j in range(M)]
    for i, (leaf, sz) in enumerate(zip(tree_leaves(tt), ts.sizes)):
        cat = torch.cat([p[i] for p in per], dim=1)[:, :sz]
        assert torch.equal(cat.reshape(leaf.shape), leaf)


@pytest.mark.parametrize("M", MS)
def test_gradients_are_one_buffer(M):
    """``unpack``'s and ``unpack_local``'s backward each write the
    gradient of every leaf into one buffer, zero in the padding."""
    _, tt, _, ts = specs(M)
    tb = tpack.pack(tt, ts)
    buf = tb.clone().requires_grad_(True)
    leaves = tree_leaves(tpack.unpack(buf, ts))
    assert all(type(x.grad_fn).__name__ == "_UnpackBackward"
               for x in leaves)
    (g,) = torch.autograd.grad(sum((x * x).sum() for x in leaves[:-1]), buf)
    assert torch.equal(g, 2 * tb)
    block = tb[:1, :ts.local_rows].clone().requires_grad_(True)
    chunks = tree_leaves(tpack.unpack_local(block, ts))
    assert all(type(x.grad_fn).__name__ == "_UnpackLocalBackward"
               for x in chunks)
    # a chunk without a gradient gets zeros
    (g,) = torch.autograd.grad((chunks[0] * 3).sum(), block)
    want = torch.zeros_like(block).view(1, -1)
    o, c = ts.offsets[0], tpack.local_chunk_elems(ts)[0]
    want[:, o:o + c] = 3
    assert torch.equal(g.view(1, -1), want)


def test_rejections():
    _, tt, _, ts = specs(2)
    flat = tpack.make_spec(tt, stacked=True)
    with pytest.raises(ValueError, match="leaf_align"):
        tpack.unpack_local(torch.zeros(1, 1, 128), flat)
    with pytest.raises(ValueError, match="row-shard block"):
        tpack.unpack_local(tpack.pack(tt, ts), ts)
    with pytest.raises(ValueError, match="whole buffer"):
        tpack.unpack(torch.zeros(ts.block_shape()), ts)
    with pytest.raises(ValueError, match="per-worker leaf shapes"):
        tpack.mirror_local(tt, ts, 0)
    with pytest.raises(ValueError, match="leaf_align"):
        tpack.make_spec(tt, stacked=True, row_shards=2)
