"""The port's straggler-tolerant runtime against the JAX package's.

Ten jitted JAX steps and ten port steps from the same numpy params, with
grads computed on each side from its own params by the same rule (the
pattern of ``tests/test_torch_dadam.py``), at K=8 and period 2:

* D-Adam on both backends: staleness tau=2 with straggler rate 0.3 (the
  port is handed JAX's threefry arrival mask through numpy, by
  ``make_optimizer(arrival=)``), overlap, and the one-peer-exponential
  schedule with and without staleness. Params, moments, the stale
  buffers and their ages must agree: f32 within rtol 2e-5 / atol 2e-6,
  ages exactly.
* CD-Adam with delay rings: tau=2 at rate 0.3, and overlap; the sign
  compressor on both backends, top-k on the reference. Params, moments,
  hats and the rings: int8 payloads exactly, f32 within the tolerance.

Within the port, bit for bit: tau=0 equals the synchronous step, a
single-entry schedule equals its static topology, and CD-Adam's overlap
equals staleness=1 with every edge one round late.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dadam as jdadam
from repro.core import make_optimizer as jax_make_optimizer
from repro_torch import convert
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import cdadam, dadam
from repro_torch.core.api import make_optimizer
from repro_torch.core.schedule import static_schedule
from repro_torch.core.topology import make_topology

torch.set_num_threads(2)

FTOL = dict(rtol=2e-5, atol=2e-6)
K = 8
BACKENDS = {"reference": "reference", "packed": "pallas"}
STRAGGLE = dict(staleness=2, straggler_rate=0.3, straggler_seed=1)


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


def assert_leaves_close(ours, theirs):
    """Integer leaves (int8 payloads, indices, ages) exactly; float leaves
    at the f32 tolerance."""
    la = [x.detach().numpy() if isinstance(x, torch.Tensor) else
          np.asarray(x) for x in tree_leaves(ours)]
    lb = [np.asarray(y) for y in jax.tree_util.tree_leaves(theirs)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape
        if np.issubdtype(y.dtype, np.integer):
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, **FTOL)


def jax_arrival(jopt):
    """JAX's threefry arrival draw of ``jopt``, handed over as numpy."""
    deg = len(jopt.topo.offsets)

    def arrival(r):
        return np.asarray(jdadam._arrival_mask(jopt.cfg, r, K, deg))

    return arrival


def run_both(kind, backend, steps=10, period=2, **kw):
    params = ragged_tree()
    common = dict(eta=1e-2, period=period, weight_decay=0.01, **kw)
    jopt = jax_make_optimizer(kind, K, backend=BACKENDS[backend], **common)
    extra = {}
    if kind == "d-adam" and kw.get("straggler_rate"):
        extra["arrival"] = jax_arrival(jopt)
    topt = make_optimizer(kind, K, backend=backend, device="cpu", **common,
                          **extra)
    js = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    ts = topt.init(convert.params_from_numpy(params, "cpu"))
    jstep = jax.jit(jopt.step)
    for t in range(steps):
        js = jstep(js, jax_grads(jopt.params_of(js), t, params))
        ts = topt.step(ts, torch_grads(topt.params_of(ts), t, params))
    return js, ts


DADAM_CASES = {
    "tau2": dict(topology="ring", **STRAGGLE),
    "overlap": dict(topology="ring", overlap=True),
    "one_peer_exp": dict(topology="one-peer-exp"),
    "one_peer_exp_tau2": dict(topology="one-peer-exp", **STRAGGLE),
}


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("case", sorted(DADAM_CASES))
def test_dadam_ten_step_async_parity(backend, case):
    js, ts = run_both("d-adam", backend, **DADAM_CASES[case])
    assert ts.moments.count == int(js.moments.count) == 10
    assert_leaves_close(ts.params, js.params)
    assert_leaves_close(ts.moments.m, js.moments.m)
    assert_leaves_close(ts.moments.v, js.moments.v)
    if js.stale is None:
        assert ts.stale is None
        return
    assert ts.stale.age.dtype == torch.int32
    np.testing.assert_array_equal(ts.stale.age.numpy(),
                                  np.asarray(js.stale.age))
    assert len(ts.stale.bufs) == len(js.stale.bufs)
    for ours, theirs in zip(ts.stale.bufs, js.stale.bufs):
        assert_leaves_close(ours, theirs)
    if "straggler_rate" in DADAM_CASES[case]:
        # the trace held some payloads back: buffered copies were mixed
        assert int(ts.stale.age.max()) >= 1


CDADAM_CASES = {
    "tau2": dict(topology="ring", **STRAGGLE),
    "overlap": dict(topology="ring", overlap=True),
    "one_peer_exp_overlap": dict(topology="one-peer-exp", overlap=True),
}


def assert_cdadam_close(ts, js):
    assert_leaves_close(ts.params, js.params)
    assert_leaves_close(ts.moments.m, js.moments.m)
    assert_leaves_close(ts.moments.v, js.moments.v)
    assert_leaves_close(ts.hat_self, js.hat_self)
    assert len(ts.hat_nbrs) == len(js.hat_nbrs)
    for ours, theirs in zip(ts.hat_nbrs, js.hat_nbrs):
        assert_leaves_close(ours, theirs)
    assert len(ts.pending) == len(js.pending)
    for ours, theirs in zip(ts.pending, js.pending):
        assert_leaves_close(ours, theirs)


@pytest.mark.parametrize("backend,comp,case", [
    (b, c, case) for b, c in (("reference", "sign"), ("packed", "sign"),
                              ("reference", "topk"))
    for case in sorted(CDADAM_CASES)
    if not (c == "topk" and case == "one_peer_exp_overlap")])
def test_cdadam_ten_step_ring_parity(backend, comp, case):
    js, ts = run_both("cd-adam", backend, gamma=0.4, compressor=comp,
                      **CDADAM_CASES[case])
    assert ts.moments.count == int(js.moments.count) == 10
    assert ts.pending is not None
    assert_cdadam_close(ts, js)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_dadam_tau0_is_the_synchronous_step_bitwise(backend):
    params = convert.params_from_numpy(ragged_tree(1), "cpu")
    like = ragged_tree(1)
    kw = dict(eta=1e-2, period=2, backend=backend, device="cpu")
    sync = make_optimizer("d-adam", K, **kw)
    tau0 = make_optimizer("d-adam", K, staleness=0, **kw)
    s1, s2 = sync.init(params), tau0.init(params)
    for t in range(6):
        s1 = sync.step(s1, torch_grads(sync.params_of(s1), t, like))
        s2 = tau0.step(s2, torch_grads(tau0.params_of(s2), t, like))
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        assert torch.equal(a, b)
    assert not s2.stale.age.any()


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("kw", [{}, dict(overlap=True),
                                dict(staleness=2, straggler_rate=0.3)],
                         ids=["sync", "overlap", "tau2"])
def test_single_entry_schedule_is_its_static_topology_bitwise(backend, kw):
    params = convert.params_from_numpy(ragged_tree(2), "cpu")
    like = ragged_tree(2)
    common = dict(eta=1e-2, period=2, backend=backend, device="cpu", **kw)
    static = make_optimizer("d-adam", K, topology="torus", **common)
    sched = make_optimizer("d-adam", K,
                           topology=static_schedule(make_topology("torus",
                                                                  K)),
                           **common)
    s1, s2 = static.init(params), sched.init(params)
    for t in range(6):
        s1 = static.step(s1, torch_grads(static.params_of(s1), t, like))
        s2 = sched.step(s2, torch_grads(sched.params_of(s2), t, like))
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        assert torch.equal(a, b)


def all_late_seed(deg=2, tries=512):
    """A straggler seed whose tau=1 delay table is all ones: the overlap
    schedule."""
    for seed in range(tries):
        cfg = cdadam.CDAdamConfig(staleness=1, straggler_rate=0.97,
                                  straggler_seed=seed)
        if (cdadam._payload_delays(cfg, K, deg) == 1).all():
            return seed
    raise AssertionError(f"no all-late seed in {tries} tries")


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_cdadam_overlap_is_staleness_one_bitwise(backend):
    params = convert.params_from_numpy(ragged_tree(3), "cpu")
    like = ragged_tree(3)
    kw = dict(eta=1e-2, period=2, backend=backend, device="cpu")
    ov = make_optimizer("cd-adam", K, overlap=True, **kw)
    t1 = make_optimizer("cd-adam", K, staleness=1, straggler_rate=0.97,
                        straggler_seed=all_late_seed(), **kw)
    s1, s2 = ov.init(params), t1.init(params)
    for t in range(8):
        s1 = ov.step(s1, torch_grads(ov.params_of(s1), t, like))
        s2 = t1.step(s2, torch_grads(t1.params_of(s2), t, like))
    for a, b in zip(tree_leaves((s1.params, s1.hat_self, s1.hat_nbrs)),
                    tree_leaves((s2.params, s2.hat_self, s2.hat_nbrs))):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(
        cdadam._payload_delays(ov.cfg, K, 2), np.ones((K, 2), np.int32))


@pytest.mark.parametrize("kind", ["d-adam", "cd-adam"])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_round_equals_p_steps_with_buffers(kind, backend):
    """opt.round (p local steps, then one gossip) carries the payload
    buffers as p calls of opt.step do."""
    like = ragged_tree(4)
    kw = dict(eta=1e-2, period=3, backend=backend, device="cpu",
              topology="one-peer-exp", overlap=True)
    opt = make_optimizer(kind, K, **kw)
    s1 = s2 = opt.init(convert.params_from_numpy(like, "cpu"))
    for rnd in range(2):
        grads = [torch_grads(convert.params_from_numpy(like, "cpu"),
                             3 * rnd + t, like) for t in range(3)]
        s1 = opt.round(s1, lambda p, b: grads[int(b[0])],
                       torch.arange(3).reshape(3, 1))
        for g in grads:
            s2 = opt.step(s2, g)
    for a, b in zip(tree_leaves(opt.params_of(s1)),
                    tree_leaves(opt.params_of(s2))):
        assert torch.equal(a, b)
    bufs = (s1.stale.bufs, s2.stale.bufs) if kind == "d-adam" else \
        (s1.pending, s2.pending)
    for a, b in zip(tree_leaves(bufs[0]), tree_leaves(bufs[1])):
        assert torch.equal(a, b)


def test_default_arrival_is_seeded_and_checked():
    cfg = dadam.DAdamConfig(staleness=2, straggler_rate=0.3,
                            straggler_seed=1)
    draw = dadam.default_arrival(cfg, K, 2)
    a, b = draw(3), draw(3)
    assert a.dtype == torch.bool and a.shape == (K, 2)
    assert torch.equal(a, b) and not torch.equal(draw(3), draw(4))
    # the seed enters the draw (the CPU generator keeps 32 bits of a seed)
    other = dadam.default_arrival(
        dataclasses.replace(cfg, straggler_seed=2), K, 2)
    assert any(not torch.equal(draw(r), other(r)) for r in range(4))
    share = float(torch.stack([draw(r) for r in range(200)]).float().mean())
    assert 0.6 < share < 0.8              # about 1 - rate arrive
    with pytest.raises(ValueError, match="shape"):
        dadam._arrival_mask(cfg, 0, K, 2, lambda r: np.ones((K, 3), bool))
    ones = dadam._arrival_mask(dataclasses.replace(cfg, straggler_rate=0.0),
                               0, K, 2, lambda r: np.zeros((K, 2), bool))
    assert bool(ones.all())               # no stragglers: the draw is unused


def test_cold_overlap_round_is_the_synchronous_round():
    """The first overlapped round folds the fresh payloads in (cold
    buffers), so it equals the synchronous gossip; the second mixes the
    first round's payloads."""
    params = convert.params_from_numpy(ragged_tree(5), "cpu")
    topo = make_topology("ring", K)
    cfg = dadam.DAdamConfig(overlap=True)
    stale = dadam.init_stale(params, topo)
    mixed, stale = dadam.gossip_shift_overlap(params, stale, topo, cfg)
    for a, b in zip(tree_leaves(mixed),
                    tree_leaves(dadam.gossip_shift(params, topo))):
        assert torch.equal(a, b)
    assert not stale.age.any()
    later = tree_map(lambda x: x + 1.0, params)
    mixed2, _ = dadam.gossip_shift_overlap(later, stale, topo, cfg)
    want = dadam._mix_trees(later, stale.bufs, topo)
    for a, b in zip(tree_leaves(mixed2), tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["d-adam", "cd-adam"])
def test_live_buffers_cross_with_convert(kind):
    """A JAX packed state with live stale buffers (D-Adam tau=2) or delay
    rings (CD-Adam tau=2) crosses to the port as numpy, back equal, and
    both packages step on from it in parity."""
    params = ragged_tree(6)
    kw = dict(eta=1e-2, period=2, topology="ring", **STRAGGLE)
    jopt = jax_make_optimizer(kind, K, backend="pallas", **kw)
    extra = {"arrival": jax_arrival(jopt)} if kind == "d-adam" else {}
    topt = make_optimizer(kind, K, backend="packed", device="cpu", **kw,
                          **extra)
    js = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    jstep = jax.jit(jopt.step)
    for t in range(5):
        js = jstep(js, jax_grads(jopt.params_of(js), t, params))
    like = convert.params_from_numpy(params, "cpu")
    base = [np.asarray(x) for x in (js.buf, js.m, js.v, js.count)]
    if kind == "d-adam":
        ts = convert.dadam_state_from_numpy(
            *base, like, "cpu",
            stale_bufs=[np.asarray(b) for b in js.stale.bufs],
            stale_age=np.asarray(js.stale.age))
        back = convert.dadam_state_to_numpy(ts)
        np.testing.assert_array_equal(back["stale_age"],
                                      np.asarray(js.stale.age))
        for ours, theirs in zip(back["stale_bufs"], js.stale.bufs):
            np.testing.assert_array_equal(ours, np.asarray(theirs))
    else:
        pending = [jax.tree_util.tree_map(np.asarray, p) for p in js.pending]
        ts = convert.cdadam_state_from_numpy(
            *base, np.asarray(js.hat_buf),
            [np.asarray(h) for h in js.hat_nbr_bufs], like, "cpu",
            pending=pending)
        back = convert.cdadam_state_to_numpy(ts)
        for ours, theirs in zip(back["pending"], pending):
            for key in ("q", "scale"):
                np.testing.assert_array_equal(ours[key], theirs[key])
        with pytest.raises(ValueError, match="pending"):
            convert.cdadam_state_from_numpy(
                *base, np.asarray(js.hat_buf),
                [np.asarray(h) for h in js.hat_nbr_bufs], like, "cpu",
                pending=[{"q": p["q"][:, :, :2], "scale": p["scale"]}
                         for p in pending])
    for t in range(5, 10):
        js = jstep(js, jax_grads(jopt.params_of(js), t, params))
        ts = topt.step(ts, torch_grads(topt.params_of(ts), t, params))
    assert_leaves_close(ts.params, js.params)
    if kind == "d-adam":
        np.testing.assert_array_equal(ts.stale.age.numpy(),
                                      np.asarray(js.stale.age))
    else:
        assert_cdadam_close(ts, js)


def test_launches_run_the_async_paths_on_the_cpu(capsys):
    from repro_torch.launch import deepfm_ctr, heterogeneity

    res = deepfm_ctr.run("d-adam overlap, one-peer-exp", steps=4,
                         n_fields=4, features_per_field=16, hidden=(16, 16),
                         period=2, topology="one-peer-exp", overlap=True,
                         device="cpu")
    assert np.isfinite(res.log.loss[-1]) and res.state.stale is not None
    assert len(res.state.stale.bufs) == 5 and res.state.count == 4
    record = heterogeneity.main(["--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert out.splitlines()[-1].startswith("JSON {")
    kinds = [r["scenario"] for r in record["records"]]
    assert kinds == ["skew"] * 3 + ["straggler"] * 2 + ["schedule"] * 2 + [
        "churn"]
    assert record["records"][-1]["workers_after"] == K
    assert all(np.isfinite(r["loss"]) for r in record["records"][:-1])
