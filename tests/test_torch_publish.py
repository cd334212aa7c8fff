"""The port's train->serve publish path against the JAX package's: the
unpack-once decode (``pack.unpack_worker`` / ``unpack_mean``) on the
fixtures of ``tests/test_publish.py``, ``publish_params`` on packed
states, the HBM accounting, and the ``ParamStore`` under threads.

``unpack_worker`` slices and copies, so it is held bit for bit.
``unpack_mean`` sums the workers in index order and divides by K where
JAX calls ``jnp.mean``: held to the f32 tolerance (rtol 2e-6, a few
roundings of K = 4 terms), not to the bit.
"""
import gc
import sys
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_optimizer as jax_make_optimizer
from repro.kernels import pack as jpack
from repro.serve import publish_hbm_bytes as jax_publish_hbm_bytes
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.convert import params_from_numpy
from repro_torch.core.api import make_optimizer
from repro_torch.kernels import pack as tpack
from repro_torch.serve import (ParamStore, publish_from_state,
                               publish_hbm_bytes, publish_params)

torch.set_num_threads(2)

K = 4
MEAN_TOL = dict(rtol=2e-6, atol=1e-7)


def ragged_tree(seed, k, dtype=jnp.float32):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {
        "w": jax.random.normal(ks[0], (k, 13, 7), dtype),
        "b": jax.random.normal(ks[1], (k, 5), dtype),
        "nest": {"u": jax.random.normal(ks[2], (k, 3, 11, 2), dtype)},
    }


def both(jtree):
    return jtree, params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jtree), "cpu")


def assert_close(port, jtree, **tol):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = tree_leaves(port)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == tuple(b.shape)
        if tol:
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), **tol)
        else:
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))


# ---------------------------- unpack-once parity -----------------------------


@pytest.mark.parametrize("layout", ["flat", "leaf_align"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_unpack_worker_and_mean_match_jax(layout, dtype):
    jtree, ttree = both(ragged_tree(0, K, dtype))
    kw = {"flat": {}, "leaf_align": dict(leaf_align=True, block_rows=2)}
    jspec = jpack.make_spec(jtree, stacked=True, **kw[layout])
    tspec = tpack.make_spec(ttree, stacked=True, **kw[layout])
    jbuf, tbuf = jpack.pack(jtree, jspec), tpack.pack(ttree, tspec)
    for k in range(K):
        assert_close(tpack.unpack_worker(tbuf, tspec, k),
                     jpack.unpack_worker(jbuf, jspec, k))
    # a bf16 buffer: the f32 mean rounded once to bf16 on both sides, so
    # at most one bf16 ulp (2^-7 relative) apart
    tol = MEAN_TOL if dtype == jnp.float32 else dict(rtol=2 ** -7, atol=0)
    assert_close(tpack.unpack_mean(tbuf, tspec),
                 jpack.unpack_mean(jbuf, jspec), **tol)


def test_unpack_mean_sums_in_worker_order():
    jtree, ttree = both(ragged_tree(1, K))
    spec = tpack.make_spec(ttree, stacked=True)
    buf = tpack.pack(ttree, spec)
    want = (((buf[0] + buf[1]) + buf[2]) + buf[3]) / K
    got = tpack.unpack_mean(buf, spec)
    assert torch.equal(got["w"], want.reshape(-1)[spec.offsets[2]:
                                                  spec.offsets[2] + 91]
                       .reshape(13, 7))


def test_unpack_worker_validates_and_copies():
    _, ttree = both(ragged_tree(2, K))
    spec = tpack.make_spec(ttree, stacked=True)
    buf = tpack.pack(ttree, spec)
    with pytest.raises(ValueError, match="worker"):
        tpack.unpack_worker(buf, spec, K)
    flat_tree = tree_map(lambda x: x[0], ttree)
    flat_spec = tpack.make_spec(flat_tree)
    with pytest.raises(ValueError, match="stacked"):
        tpack.unpack_worker(tpack.pack(flat_tree, flat_spec), flat_spec, 0)
    with pytest.raises(ValueError, match="shape"):
        tpack.unpack_mean(buf[:, :1], spec)
    one = tpack.unpack_worker(buf, spec, 1)
    buf.zero_()          # the trainer's buffer moves on: the copy does not
    assert float(one["w"].abs().sum()) > 0


# ----------------------- publish_params == params_of ------------------------


def trained_state(backend="packed"):
    opt = make_optimizer("d-adam", K, eta=1e-2, period=2, backend=backend,
                         device="cpu")
    _, ttree = both(ragged_tree(3, K))
    state = opt.init(ttree)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        grads = tree_map(lambda x: torch.randn(x.shape, generator=gen),
                         opt.params_of(state))
        if backend == "packed":
            grads = tpack.pack(grads, state.spec)
        state = opt.step(state, grads)
    return opt, state


@pytest.mark.parametrize("backend", ["reference", "packed"])
def test_publish_params_matches_params_of(backend):
    opt, state = trained_state(backend)
    ref = opt.params_of(state)
    for k in range(K):
        got = publish_params(state, mode="worker", worker=k)
        for a, b in zip(tree_leaves(got), tree_leaves(ref)):
            assert torch.equal(a, b[k])
    mean = publish_params(state, mode="mean")
    for a, b in zip(tree_leaves(mean), tree_leaves(ref)):
        np.testing.assert_allclose(a.numpy(), b.mean(0).numpy(), **MEAN_TOL)


def test_publish_params_plain_tree_mode_and_like():
    _, ttree = both(ragged_tree(4, K))
    got = publish_params(ttree, mode="worker", worker=2)
    assert torch.equal(got["nest"]["u"], ttree["nest"]["u"][2])
    with pytest.raises(ValueError, match="mode"):
        publish_params(ttree, mode="median")
    like = tree_map(lambda x: torch.zeros(x.shape[1:],
                                          dtype=torch.bfloat16), ttree)
    placed = publish_params(ttree, mode="mean", like=like)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(placed))


def test_hbm_accounting_matches_jax():
    jtree, ttree = both(ragged_tree(5, K))
    jstate = jax_make_optimizer("d-adam", K=K, backend="pallas").init(jtree)
    tstate = make_optimizer("d-adam", K, backend="packed",
                            device="cpu").init(ttree)
    assert tuple(tstate.buf.shape) == tuple(jstate.buf.shape)
    for mode in ("worker", "mean"):
        assert publish_hbm_bytes(tstate, mode=mode) == \
            jax_publish_hbm_bytes(jstate, mode=mode)
    w = publish_hbm_bytes(tstate, mode="worker")
    assert w["read_bytes"] * K == w["full_unpack_read_bytes"]
    assert w["read_bytes"] == tstate.buf.numel() * 4 // K


# -------------------------------- ParamStore ---------------------------------


def test_versions_monotone():
    store = ParamStore()
    assert store.version == 0
    with pytest.raises(ValueError, match="empty"):
        store.snapshot()
    versions = [store.publish({"w": torch.full((3,), float(i))})
                for i in range(5)]
    assert versions == [1, 2, 3, 4, 5]
    v, params = store.snapshot()
    assert v == 5 and float(params["w"][0]) == 4.0


def test_publish_from_state_bumps_version():
    _, state = trained_state()
    store = ParamStore()
    assert publish_from_state(store, state, mode="worker") == 1
    assert publish_from_state(store, state, mode="mean") == 2
    for a, b in zip(tree_leaves(store.snapshot()[1]),
                    tree_leaves(publish_params(state, mode="mean"))):
        assert torch.equal(a, b)


def test_reader_always_sees_complete_snapshot():
    """Under a publisher storm every snapshot a reader takes holds one
    version in all its leaves, and versions never run backwards (8
    readers, thread switches every microsecond)."""
    store = ParamStore()

    def tree_for(v):
        return {"a": torch.full((4,), float(v)),
                "n": {"b": torch.full((2,), float(v))}}

    store.publish(tree_for(1))
    stop = threading.Event()
    torn, regressions = [], []

    def reader():
        last = 0
        while not stop.is_set():
            version, params = store.snapshot()
            vals = set(torch.cat([params["a"], params["n"]["b"]]).tolist())
            if vals != {float(version)}:
                torn.append((version, vals))
            if version < last:
                regressions.append((last, version))
            last = version

    threads = [threading.Thread(target=reader) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for v in range(2, 200):
            store.publish(tree_for(v))
    finally:
        stop.set()
        sys.setswitchinterval(interval)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not torn, f"torn snapshots: {torn[:3]}"
    assert not regressions, f"version regressions: {regressions[:3]}"
    assert store.version == 199


def test_concurrent_publishers_never_lose_versions():
    store = ParamStore()
    seen, lock = [], threading.Lock()

    def publisher():
        for _ in range(50):
            v = store.publish({"w": torch.zeros(1)})
            with lock:
                seen.append(v)

    threads = [threading.Thread(target=publisher) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(seen) == list(range(1, 201))


def test_previous_version_stays_resident():
    """A reader's snapshot stays valid across a publish for as long as
    the reader holds it, and the store keeps no reference of its own to
    a retired version."""
    store = ParamStore()
    store.publish({"w": torch.full((3,), 1.0)})
    _, held = store.snapshot()
    store.publish({"w": torch.full((3,), 2.0)})
    assert torch.equal(held["w"], torch.full((3,), 1.0))
    retired = weakref.ref(held["w"])
    del held
    gc.collect()
    assert retired() is None
    assert torch.equal(store.snapshot()[1]["w"], torch.full((3,), 2.0))
