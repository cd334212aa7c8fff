"""The port's D-Adam optimizer against the JAX package's.

Ten jitted JAX steps and ten port steps from the same numpy params, with
grads computed on each side from its own params by the same rule (the
pattern of ``tests/test_backend_parity.py``), must leave params and both
moments within the repo's optimizer-state tolerance (rtol 2e-5, atol
2e-6): ring, torus and exponential at K=8, period 1 and 3, on both
backends ('reference' against 'reference', 'packed' against 'pallas').
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dadam as jdadam
from repro.core import make_optimizer as jax_make_optimizer
from repro.core import topology as jtopology
from repro_torch import convert
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import dadam, topology
from repro_torch.core.api import make_optimizer
from repro_torch.kernels import pack as packing

torch.set_num_threads(2)

FTOL = dict(rtol=2e-5, atol=2e-6)
K = 8
ZOO = ["ring", "torus", "exponential", "fully_connected"]
BACKENDS = {"reference": "reference", "packed": "pallas"}


def ragged_tree(seed=0):
    """Lane-hostile leaf shapes (primes, one scalar per worker)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, 13, 7)).astype(np.float32),
            "b": rng.standard_normal((K, 5)).astype(np.float32),
            "nest": {"u": rng.standard_normal((K, 3, 11, 2)).astype(
                         np.float32),
                     "v": rng.standard_normal((K,)).astype(np.float32)}}


def noise(t, like):
    rng = np.random.default_rng(100 + t)
    return jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), like)


def jax_grads(params, t, like):
    return jax.tree_util.tree_map(lambda x, n: 0.5 * x + 0.1 * jnp.asarray(n),
                                  params, noise(t, like))


def torch_grads(params, t, like):
    return tree_map(lambda x, n: 0.5 * x + 0.1 * torch.from_numpy(n),
                    params, noise(t, like))


def assert_trees_close(a, b, **tol):
    la = [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                     np.float32) for x in tree_leaves(a)]
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, np.asarray(y, np.float32),
                                   **(tol or FTOL))


def run_both(backend, name, period, steps=10, **kw):
    params = ragged_tree()
    jopt = jax_make_optimizer("d-adam", K, eta=1e-2, period=period,
                              weight_decay=0.01, topology=name,
                              backend=BACKENDS[backend], **kw)
    topt = make_optimizer("d-adam", K, eta=1e-2, period=period,
                          weight_decay=0.01, topology=name, backend=backend,
                          device="cpu", **kw)
    js = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    ts = topt.init(convert.params_from_numpy(params, "cpu"))
    jstep = jax.jit(jopt.step)
    for t in range(steps):
        js = jstep(js, jax_grads(jopt.params_of(js), t, params))
        ts = topt.step(ts, torch_grads(topt.params_of(ts), t, params))
    return js, ts


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("period", [1, 3])
@pytest.mark.parametrize("name", ["ring", "torus", "exponential"])
def test_ten_step_state_parity(backend, period, name):
    js, ts = run_both(backend, name, period)
    assert ts.moments.count == int(js.moments.count) == 10
    assert_trees_close(ts.params, js.params)
    assert_trees_close(ts.moments.m, js.moments.m)
    assert_trees_close(ts.moments.v, js.moments.v)
    if backend == "packed":
        # the resident buffers themselves line up element for element
        for ours, theirs in ((ts.buf, js.buf), (ts.m, js.m), (ts.v, js.v)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       **FTOL)
            # the padding stays exactly zero across steps
            flat = ours.reshape(K, -1)
            mask = torch.zeros(flat.shape[1], dtype=torch.bool)
            for o, sz in zip(ts.spec.offsets, ts.spec.sizes):
                mask[o:o + sz] = True
            assert torch.count_nonzero(flat[:, ~mask]) == 0


def test_reference_bias_correction_and_dense_mixing_parity():
    js, ts = run_both("reference", "ring", 2, steps=6, mixing="dense")
    assert_trees_close(ts.params, js.params)
    params = ragged_tree()
    jopt = jax_make_optimizer("d-adam", K, eta=1e-2, period=2)
    jcfg = jdadam.DAdamConfig(eta=1e-2, period=2, bias_correction=True)
    tcfg = dadam.DAdamConfig(eta=1e-2, period=2, bias_correction=True)
    js = jdadam.init(jax.tree_util.tree_map(jnp.asarray, params), jcfg)
    ts = dadam.init(convert.params_from_numpy(params, "cpu"), tcfg)
    for t in range(5):
        js = jdadam.step(js, jax_grads(js.params, t, params), jopt.topo,
                         jcfg)
        ts = dadam.step(ts, torch_grads(ts.params, t, params),
                        topology.make_topology("ring", K), tcfg)
    assert_trees_close(ts.params, js.params)


def test_state_carried_across_from_jax_keeps_stepping_in_parity():
    """A JAX packed state crosses with convert.dadam_state_from_numpy (a
    copy, no repack) and both packages step on from it."""
    params = ragged_tree()
    jopt = jax_make_optimizer("d-adam", K, eta=1e-2, period=2,
                              backend="pallas")
    topt = make_optimizer("d-adam", K, eta=1e-2, period=2,
                          backend="packed", device="cpu")
    js = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    jstep = jax.jit(jopt.step)
    for t in range(3):
        js = jstep(js, jax_grads(jopt.params_of(js), t, params))
    ts = convert.dadam_state_from_numpy(
        np.asarray(js.buf), np.asarray(js.m), np.asarray(js.v),
        np.asarray(js.count), convert.params_from_numpy(params, "cpu"),
        "cpu")
    assert ts.count == 3
    assert_trees_close(ts.unpacked().params, js.unpacked().params,
                       rtol=0, atol=0)
    assert ts.unpacked().moments.count == 3
    back = convert.dadam_state_to_numpy(ts)
    np.testing.assert_array_equal(back["buf"], np.asarray(js.buf))
    for t in range(3, 6):
        js = jstep(js, jax_grads(jopt.params_of(js), t, params))
        ts = topt.step(ts, torch_grads(topt.params_of(ts), t, params))
    assert_trees_close(ts.params, js.params)
    with pytest.raises(ValueError, match="layout"):
        convert.dadam_state_from_numpy(
            np.asarray(js.buf)[:, :8], np.asarray(js.m), np.asarray(js.v),
            3, convert.params_from_numpy(params, "cpu"), "cpu")


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_round_equals_p_steps_then_gossip(backend):
    """opt.round (p local steps, then one gossip) == p calls of opt.step
    with the comm on the p-th, on the same grads."""
    Kr, d, p = 4, 6, 3
    centers = torch.from_numpy(
        np.random.default_rng(0).standard_normal((Kr, d)).astype(np.float32))
    opt = make_optimizer("d-adam", Kr, eta=0.05, period=p, tau=1e-3,
                         backend=backend, device="cpu")
    s1 = opt.init({"x": torch.zeros(Kr, d)})
    if backend == "packed":
        centers_buf = packing.pack({"x": centers}, s1.spec)

        def grad_fn(buf, batch):
            return 2.0 * (buf - centers_buf)
    else:
        def grad_fn(params, batch):
            return {"x": 2.0 * (params["x"] - centers)}
    s1 = opt.round(s1, grad_fn, torch.zeros(p, Kr, 1))
    s2 = opt.init({"x": torch.zeros(Kr, d)})
    for _ in range(p):
        s2 = opt.step(s2, {"x": 2.0 * (opt.params_of(s2)["x"] - centers)})
    assert s1.moments.count == s2.moments.count == p
    np.testing.assert_allclose(opt.params_of(s1)["x"].numpy(),
                               opt.params_of(s2)["x"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_consensus_error_and_mean_params_match_jax():
    params = ragged_tree(3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = convert.params_from_numpy(params, "cpu")
    np.testing.assert_allclose(float(dadam.consensus_error(tp)),
                               float(jdadam.consensus_error(jp)), rtol=1e-6)
    assert_trees_close(dadam.mean_params(tp), jdadam.mean_params(jp),
                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ZOO)
@pytest.mark.parametrize("mixing", ["roll", "dense"])
def test_comm_bytes_match_jax(name, mixing):
    params = ragged_tree()
    jopt = jax_make_optimizer("d-adam", K, topology=name, mixing=mixing)
    topt = make_optimizer("d-adam", K, topology=name, mixing=mixing,
                          device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = convert.params_from_numpy(params, "cpu")
    assert topt.comm_bytes_per_round(tp) == jopt.comm_bytes_per_round(jp)
    assert topt.comm_bytes_round_list(tp) == jopt.comm_bytes_round_list(jp)


@pytest.mark.parametrize("name", ZOO)
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_gossip_adam_eligibility_matches_jax(name, k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jt = jtopology.make_topology(name, k)
        tt = topology.make_topology(name, k)
    for mixing in ("roll", "dense"):
        for period in (1, 4):
            jcfg = jdadam.DAdamConfig(mixing=mixing, period=period,
                                      backend="pallas")
            tcfg = dadam.DAdamConfig(mixing=mixing, period=period,
                                     backend="packed")
            assert dadam._gossip_adam_eligible(tt, tcfg) == \
                jdadam._gossip_adam_eligible(jt, jcfg)


@pytest.mark.parametrize("name", ZOO)
@pytest.mark.parametrize("k", [1, 2, 3, 5, 7, 8, 9, 12])
def test_topology_zoo_matches_jax(name, k):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        tt = topology.make_topology(name, k)
        jt = jtopology.make_topology(name, k)
    if name == "torus" and k in (2, 3, 5, 7):
        assert tt.name == "ring"    # prime K: the ring fallback
        assert sum(issubclass(w.category, RuntimeWarning) for w in seen) == 2
    np.testing.assert_array_equal(tt.weights, jt.weights)
    assert tt.self_weight == jt.self_weight
    assert tt.offset_weights == jt.offset_weights
    assert [repr(o) for o in tt.offsets] == [repr(o) for o in jt.offsets]
    np.testing.assert_allclose(topology.offsets_matrix(tt), tt.weights,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["ring", "torus", "exponential"])
def test_shift_and_dense_gossip_agree(name):
    topo = topology.make_topology(name, K)
    params = convert.params_from_numpy(ragged_tree(4), "cpu")
    a = dadam.gossip_shift(params, topo)
    b = dadam.gossip_dense(params, topo.weights)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-6)
    # the packed einsum branch (dense mixing) equals the kernel branch
    spec = packing.make_spec(params, stacked=True, block_rows=8,
                             leaf_align=True)
    buf = packing.pack(params, spec)
    dense = dadam.gossip_packed(buf, topo,
                                dadam.DAdamConfig(mixing="dense"))
    fused = dadam.gossip_packed(buf, topo, dadam.DAdamConfig())
    np.testing.assert_allclose(dense.numpy(), fused.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_options_not_ported_raise_and_bad_configs_are_rejected():
    with pytest.raises(NotImplementedError):
        make_optimizer("d-adam", K, device="cpu", comm="axis")
    # the straggler-tolerant runtime builds, with JAX's validation rules
    for kw in (dict(staleness=1), dict(overlap=True)):
        assert make_optimizer("d-adam", K, device="cpu", **kw).cfg.validate() \
            is None
    for kw, match in ((dict(staleness=-1), ">= 0"),
                      (dict(straggler_rate=0.3), "staleness bound"),
                      (dict(staleness=1, straggler_rate=1.0), r"\[0, 1\)"),
                      (dict(staleness=1, overlap=True), "ambiguous"),
                      (dict(overlap=True, mixing="dense"), "roll"),
                      (dict(staleness=2, mixing="dense"), "roll")):
        with pytest.raises(ValueError, match=match):
            make_optimizer("d-adam", K, device="cpu", **kw)
    # CD-Adam and D-PSGD build; "adam" is no kind, as in the JAX package
    assert make_optimizer("cd-adam", K, device="cpu").compressor.name == "sign"
    assert make_optimizer("d-psgd", K, device="cpu").compressor is None
    with pytest.raises(KeyError):
        make_optimizer("adam", K, device="cpu")
    sched = make_optimizer("d-adam", K, topology="one-peer-exp",
                           device="cpu").topo
    assert len(sched.entries) == 3 and sched.union_offsets() == (1, 7, 2, 6, 4)
    with pytest.raises(ValueError, match="dense"):
        make_optimizer("d-adam", K, topology="one-peer-exp", mixing="dense",
                       device="cpu")
    with pytest.raises(KeyError):
        make_optimizer("sgd", K, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        make_optimizer("d-adam", K, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="bias"):
        make_optimizer("d-adam", K, backend="packed", bias_correction=True,
                       device="cpu")
    with pytest.raises(ValueError, match="K=4"):
        make_optimizer("d-adam", K, topology=topology.ring(4), device="cpu")
    opt = make_optimizer("d-adam-vanilla", K, period=8, device="cpu")
    assert opt.cfg.period == 1
    assert opt.rebuild(eta=0.5).cfg.eta == 0.5
