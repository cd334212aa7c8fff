"""Checkpoints cross between the JAX package and the port, both ways, and
elastic resize carries state as JAX's does.

A checkpoint written by ``repro.checkpoint.io.save`` restores into the
port (``repro_torch.checkpoint.io.restore``) on both backends, equal leaf
for leaf; one written by the port restores into the JAX package. The
transient straggler buffers are never written and come back cold (zero
payloads, ``COLD_AGE`` ages; zero delay rings). ``resize_state`` must
carry params, moments and the step count as JAX's does.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.core import elastic as jelastic
from repro.core import make_optimizer as jax_make_optimizer
from repro_torch import convert
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint import io as tio
from repro_torch.core import dadam, elastic
from repro_torch.core.api import make_optimizer

torch.set_num_threads(2)

K = 8
FTOL = dict(rtol=2e-5, atol=2e-6)
BACKENDS = {"reference": "reference", "packed": "pallas"}
# live straggler buffers on both kinds; no straggler draw, so the two
# packages' trajectories agree without handing the arrival mask across
KINDS = {"d-adam": dict(staleness=2), "cd-adam": dict(overlap=True)}


def wb_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, 13, 7)).astype(np.float32),
            "b": rng.standard_normal((K, 5)).astype(np.float32)}


def noise(t, like):
    rng = np.random.default_rng(100 + t)
    return jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), like)


def jax_state(kind, backend, steps=5, **kw):
    params = wb_tree()
    jopt = jax_make_optimizer(kind, K, eta=1e-2, period=2,
                              backend=BACKENDS[backend], **kw)
    js = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    jstep = jax.jit(jopt.step)
    for t in range(steps):
        g = jax.tree_util.tree_map(lambda x, n: 0.5 * x + 0.1 * n,
                                   jopt.params_of(js), noise(t, params))
        js = jstep(js, g)
    return jopt, js


def port_state(kind, backend, steps=5, **kw):
    params = wb_tree()
    topt = make_optimizer(kind, K, eta=1e-2, period=2, backend=backend,
                          device="cpu", **kw)
    ts = topt.init(convert.params_from_numpy(params, "cpu"))
    for t in range(steps):
        g = tree_map(lambda x, n: 0.5 * x + 0.1 * torch.from_numpy(n),
                     topt.params_of(ts), noise(t, params))
        ts = topt.step(ts, g)
    return topt, ts


def portable_leaves_equal(ours, theirs):
    """The port's portable state against JAX's, leaf for leaf, exactly."""
    la = tio._to_portable(ours)
    lb = jio._to_portable(theirs)
    a = [x for _, x in tio._leaves_with_path(la)]
    b = jax.tree_util.tree_leaves(lb)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        np.testing.assert_array_equal(x, np.asarray(y))


def assert_cold(state):
    if isinstance(state, (dadam.DAdamState, dadam.PackedDAdamState)):
        assert torch.all(state.stale.age == dadam.COLD_AGE)
        assert all(not x.any() for x in tree_leaves(state.stale.bufs))
    else:
        assert all(not x.any() for x in tree_leaves(state.pending))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jax_checkpoint_restores_into_the_port(tmp_path, kind, backend):
    jopt, js = jax_state(kind, backend, **KINDS[kind])
    path = str(tmp_path / "ckpt.npz")
    jio.save(path, {"opt": js}, step=5, meta={"by": "jax"})
    topt = make_optimizer(kind, K, eta=1e-2, period=2, backend=backend,
                          device="cpu", **KINDS[kind])
    like = {"opt": topt.init(convert.params_from_numpy(wb_tree(9), "cpu"))}
    restored, step = tio.restore(path, like)
    ts = restored["opt"]
    assert step == 5 and type(ts) is type(like["opt"])
    assert ts.moments.count == 5 and isinstance(ts.moments.count, int)
    portable_leaves_equal(ts, js)
    assert_cold(ts)
    # the restored state steps on in parity with JAX's restored twin
    jrest, _ = jio.restore(path, {"opt": jopt.init(jax.tree_util.tree_map(
        jnp.asarray, wb_tree(9)))})
    g = noise(7, wb_tree())
    js2 = jax.jit(jopt.step)(jrest["opt"],
                             jax.tree_util.tree_map(jnp.asarray, g))
    ts2 = topt.step(ts, convert.params_from_numpy(g, "cpu"))
    for x, y in zip(tree_leaves(topt.params_of(ts2)),
                    jax.tree_util.tree_leaves(jopt.params_of(js2))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **FTOL)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_port_checkpoint_restores_into_jax(tmp_path, kind, backend):
    topt, ts = port_state(kind, backend, **KINDS[kind])
    path = str(tmp_path / "ckpt.npz")
    tio.save(path, ts, step=5)
    jopt = jax_make_optimizer(kind, K, eta=1e-2, period=2,
                              backend=BACKENDS[backend], **KINDS[kind])
    jlike = jopt.init(jax.tree_util.tree_map(jnp.asarray, wb_tree(9)))
    js, step = jio.restore(path, jlike)
    assert step == 5 and int(js.moments.count) == 5
    portable_leaves_equal(ts, js)


def test_leaf_keys_and_sidecar_match_jax(tmp_path):
    """The packed D-Adam state of a {"w", "b"} tree: the same keys, order
    and dtypes on disk from both packages."""
    _, js = jax_state("d-adam", "packed")
    _, ts = port_state("d-adam", "packed")
    jio.save(str(tmp_path / "j.npz"), js)
    tio.save(str(tmp_path / "t.npz"), ts)
    sides = [json.load(open(tmp_path / f"{n}.npz.json")) for n in "jt"]
    assert sides[0] == sides[1]
    keys = [k.split("|")[1] for k, _ in sides[1]["leaves"]]
    assert keys == ["params/b", "params/w", "moments/m/b", "moments/m/w",
                    "moments/v/b", "moments/v/w", "moments/count"]
    assert sides[1]["leaves"][-1][1] == "int32"
    _, jc = jax_state("cd-adam", "reference")
    jio.save(str(tmp_path / "jc.npz"), jc)
    ckeys = [k.split("|")[1] for k, _ in json.load(
        open(tmp_path / "jc.npz.json"))["leaves"]]
    _, tc = port_state("cd-adam", "reference")
    tio.save(str(tmp_path / "tc.npz"), tc)
    assert ckeys == [k.split("|")[1] for k, _ in json.load(
        open(tmp_path / "tc.npz.json"))["leaves"]]
    assert ckeys[7:] == ["hat_self/b", "hat_self/w", "hat_nbrs/0/b",
                         "hat_nbrs/0/w", "hat_nbrs/1/b", "hat_nbrs/1/w"]


def test_bf16_and_plain_trees_cross_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    tree = {"a": torch.from_numpy(x).to(torch.bfloat16),
            "n": [torch.arange(5, dtype=torch.int32), 7]}
    tio.save(str(tmp_path / "t.npz"), tree, step=3)
    back, step = tio.restore(str(tmp_path / "t.npz"),
                             {"a": torch.zeros(4, 6, dtype=torch.bfloat16),
                              "n": [torch.zeros(5, dtype=torch.int32), 0]})
    assert step == 3 and back["n"][1] == 7
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["n"][0],
                                                             tree["n"][0])
    jback, _ = jio.restore(str(tmp_path / "t.npz"),
                           {"a": jnp.zeros((4, 6), jnp.bfloat16),
                            "n": [jnp.zeros(5, jnp.int32),
                                  jnp.zeros((), jnp.int32)]})
    np.testing.assert_array_equal(
        np.asarray(jback["a"], np.float32),
        tree["a"].to(torch.float32).numpy())
    with pytest.raises(ValueError, match="shape"):
        tio.restore(str(tmp_path / "t.npz"),
                    {"a": torch.zeros(4, 5, dtype=torch.bfloat16),
                     "n": [torch.zeros(5, dtype=torch.int32), 0]})
    with pytest.raises(ValueError, match="leaves"):
        tio.restore(str(tmp_path / "t.npz"), {"a": torch.zeros(4, 6)})


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_restore_across_backends_and_into_a_buffered_like(tmp_path, backend):
    """A synchronous reference checkpoint restores into a packed state with
    live overlap buffers (and back), values equal, buffers cold."""
    other = "reference" if backend == "packed" else "packed"
    topt, ts = port_state("d-adam", backend)
    tio.save(str(tmp_path / "c.npz"), ts)
    opt2 = make_optimizer("d-adam", K, backend=other, overlap=True,
                          device="cpu")
    like = opt2.init(convert.params_from_numpy(wb_tree(1), "cpu"))
    got, _ = tio.restore(str(tmp_path / "c.npz"), like)
    assert type(got) is type(like)
    for a, b in zip(tree_leaves(opt2.params_of(got)),
                    tree_leaves(topt.params_of(ts))):
        assert torch.equal(a, b)
    assert_cold(got)
    assert got.stale.bufs[0] is not like.stale.bufs[0]


@pytest.mark.parametrize("strategy", ["clone", "mean"])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_resize_matches_jax(kind, backend, strategy):
    """K 8 -> 6 (clone) or 8 -> 6 -> 10 (strategy): params, moments and
    count as JAX's ``resize_state`` carries them; buffers restart cold."""
    jopt, js = jax_state(kind, backend, **KINDS[kind])
    topt, ts = port_state(kind, backend, **KINDS[kind])
    for k_new, strat in ((6, "clone"), (10, strategy)):
        kw = dict(eta=1e-2, period=2, **KINDS[kind])
        js = jelastic.resize_state(
            js, jax_make_optimizer(kind, k_new, backend=BACKENDS[backend],
                                   **kw), strategy=strat)
        ts = elastic.resize_state(
            ts, make_optimizer(kind, k_new, backend=backend, device="cpu",
                               **kw), strategy=strat)
        tp, jp = tio._to_portable(ts), jio._to_portable(js)
        assert tp.moments.count == int(jp.moments.count) == 5
        for ours, theirs in ((tp.params, jp.params), (tp.moments.m,
                                                      jp.moments.m),
                             (tp.moments.v, jp.moments.v)):
            for x, y in zip(tree_leaves(ours),
                            jax.tree_util.tree_leaves(theirs)):
                assert x.shape[0] == k_new
                np.testing.assert_allclose(x.numpy(), np.asarray(y), **FTOL)
        assert_cold(ts)
    with pytest.raises(ValueError, match="strategy"):
        elastic.resize_state(ts, topt, strategy="nope")
