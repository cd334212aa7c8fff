"""The port's CD-Adam and D-PSGD against the JAX package's.

Ten jitted JAX steps and ten port steps from the same numpy params, with
grads computed on each side from its own params by the same rule (the
pattern of ``tests/test_torch_dadam.py``), must leave params, both moments,
``hat_self`` and every ``hat_nbrs`` copy within the repo's optimizer-state
tolerance (rtol 2e-5, atol 2e-6): ring, torus and exponential at K=8,
period 1 and 3, 'reference' against 'reference' and 'packed' against
'pallas' (both sign-scale granularities). The sign compressor is
discontinuous at 0; these random inputs put no residual within rounding of
0, so the int8 payloads agree exactly and the tolerance holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbaselines
from repro.core import make_optimizer as jax_make_optimizer
from repro.core.dadam import DAdamConfig as JaxDAdamConfig
from repro.data import ctr_batch_stacked as jax_ctr_batch_stacked
from repro.data import make_ctr_task
from repro.models import deepfm as jdeepfm
from repro.train import DecentralizedTrainer as JaxTrainer
from repro_torch import convert
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import baselines, cdadam
from repro_torch.core.api import make_optimizer
from repro_torch.core.dadam import DAdamConfig
from repro_torch.kernels import pack as packing
from repro_torch.models import deepfm
from repro_torch.train.loop import DecentralizedTrainer

torch.set_num_threads(2)

FTOL = dict(rtol=2e-5, atol=2e-6)
K = 8
GRAPHS = ["ring", "torus", "exponential"]
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
    la = [np.asarray(x.detach(), np.float32) for x in tree_leaves(a)]
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, np.asarray(y, np.float32),
                                   **(tol or FTOL))


def assert_states_close(ts, js):
    assert_trees_close(ts.params, js.params)
    assert_trees_close(ts.moments.m, js.moments.m)
    assert_trees_close(ts.moments.v, js.moments.v)
    assert_trees_close(ts.hat_self, js.hat_self)
    assert len(ts.hat_nbrs) == len(js.hat_nbrs)
    for ours, theirs in zip(ts.hat_nbrs, js.hat_nbrs):
        assert_trees_close(ours, theirs)


def padding_mask(spec):
    mask = torch.zeros(spec.padded, dtype=torch.bool)
    for o, sz in zip(spec.offsets, spec.sizes):
        mask[o:o + sz] = True
    return mask


def run_both(kind, backend, name, period, steps=10, **kw):
    params = ragged_tree()
    common = dict(eta=1e-2, period=period, weight_decay=0.01, topology=name)
    jopt = jax_make_optimizer(kind, K, backend=BACKENDS[backend], **common,
                              **kw)
    topt = make_optimizer(kind, K, backend=backend, device="cpu", **common,
                          **kw)
    js = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    ts = topt.init(convert.params_from_numpy(params, "cpu"))
    jstep = jax.jit(jopt.step)
    for t in range(steps):
        js = jstep(js, jax_grads(jopt.params_of(js), t, params))
        ts = topt.step(ts, torch_grads(topt.params_of(ts), t, params))
    return js, ts


@pytest.mark.parametrize("backend,scales", [("reference", "leaf"),
                                            ("packed", "leaf"),
                                            ("packed", "worker")])
@pytest.mark.parametrize("period", [1, 3])
@pytest.mark.parametrize("name", GRAPHS)
def test_ten_step_state_parity(backend, scales, period, name):
    js, ts = run_both("cd-adam", backend, name, period, gamma=0.4,
                      scales=scales)
    assert ts.moments.count == int(js.moments.count) == 10
    assert_states_close(ts, js)
    if backend == "packed":
        # the six resident buffers line up element for element, and their
        # padding stays exactly zero
        pairs = [(ts.buf, js.buf), (ts.m, js.m), (ts.v, js.v),
                 (ts.hat_buf, js.hat_buf)]
        pairs += list(zip(ts.hat_nbr_bufs, js.hat_nbr_bufs))
        mask = padding_mask(ts.spec)
        for ours, theirs in pairs:
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       **FTOL)
            assert torch.count_nonzero(ours.reshape(K, -1)[:, ~mask]) == 0


@pytest.mark.parametrize("comp,kw", [("identity", {}), ("topk", {}),
                                     ("quantize", dict(levels=8)),
                                     ("randk", dict(fraction=0.25))])
def test_reference_compressors_parity(comp, kw):
    """The reference round with each compressor of the zoo; randk takes
    the JAX package's draw through its ``indices`` injection point."""
    tkw = dict(kw)
    if comp == "randk":
        def indices(d, frac=kw["fraction"]):
            k = max(1, int(round(d * frac)))
            return np.array(jax.random.permutation(
                jax.random.PRNGKey(0), d)[:k])
        tkw["indices"] = indices
    params = ragged_tree(1)
    jopt = jax_make_optimizer("cd-adam", K, eta=1e-2, period=2,
                              compressor=comp, **kw)
    topt = make_optimizer("cd-adam", K, eta=1e-2, period=2, compressor=comp,
                          device="cpu", **tkw)
    js = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    ts = topt.init(convert.params_from_numpy(params, "cpu"))
    jstep = jax.jit(jopt.step)
    for t in range(6):
        js = jstep(js, jax_grads(jopt.params_of(js), t, params))
        ts = topt.step(ts, torch_grads(topt.params_of(ts), t, params))
    assert_states_close(ts, js)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_round_equals_p_steps_then_comm(backend):
    """opt.round (p local steps, then one compressed gossip) == p calls of
    opt.step with the comm on the p-th, on the same grads."""
    Kr, d, p = 4, 6, 3
    centers = torch.from_numpy(
        np.random.default_rng(0).standard_normal((Kr, d)).astype(np.float32))
    opt = make_optimizer("cd-adam", Kr, eta=0.05, period=p, tau=1e-3,
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
    for a, b in [(s1.params, s2.params), (s1.hat_self, s2.hat_self)] + list(
            zip(s1.hat_nbrs, s2.hat_nbrs)):
        np.testing.assert_allclose(a["x"].numpy(), b["x"].numpy(),
                                   rtol=1e-5, atol=1e-6)
    # the round communicated: the hats moved off their zero init
    assert float(s1.hat_self["x"].abs().sum()) > 0


def test_unpacked_state_on_the_packed_backend_takes_the_reference_round():
    params = ragged_tree(2)
    opt = make_optimizer("cd-adam", K, eta=1e-2, period=2, backend="packed",
                         device="cpu")
    ref = make_optimizer("cd-adam", K, eta=1e-2, period=2, device="cpu")
    packed = opt.init(convert.params_from_numpy(params, "cpu"))
    s1 = packed.unpacked()
    s2 = ref.init(convert.params_from_numpy(params, "cpu"))
    for t in range(4):
        s1 = opt.step(s1, torch_grads(s1.params, t, params))
        s2 = ref.step(s2, torch_grads(s2.params, t, params))
        packed = opt.step(packed, torch_grads(packed.params, t, params))
    assert isinstance(s1, cdadam.CDAdamState)
    for a, b in [(s1.params, s2.params), (s1.hat_self, s2.hat_self),
                 (packed.hat_self, s2.hat_self)]:
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **FTOL)


def test_state_carried_across_from_jax_keeps_stepping_in_parity():
    """A JAX packed CD-Adam state crosses with convert (a copy, no
    repack) and both packages step on from it."""
    params = ragged_tree()
    kw = dict(eta=1e-2, period=2, topology="torus")
    jopt = jax_make_optimizer("cd-adam", K, backend="pallas", **kw)
    topt = make_optimizer("cd-adam", K, backend="packed", device="cpu", **kw)
    js = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    jstep = jax.jit(jopt.step)
    for t in range(3):
        js = jstep(js, jax_grads(jopt.params_of(js), t, params))
    args = [np.asarray(x) for x in (js.buf, js.m, js.v, js.count,
                                    js.hat_buf)]
    nbrs = [np.asarray(h) for h in js.hat_nbr_bufs]
    like = convert.params_from_numpy(params, "cpu")
    ts = convert.cdadam_state_from_numpy(*args, nbrs, like, "cpu")
    assert ts.count == 3 and len(ts.hat_nbr_bufs) == len(topt.topo.offsets)
    assert_states_close(ts.unpacked(), js.unpacked())
    back = convert.cdadam_state_to_numpy(ts)
    np.testing.assert_array_equal(back["hat_buf"], np.asarray(js.hat_buf))
    for ours, theirs in zip(back["hat_nbr_bufs"], js.hat_nbr_bufs):
        np.testing.assert_array_equal(ours, np.asarray(theirs))
    assert back["count"] == 3
    for t in range(3, 7):
        js = jstep(js, jax_grads(jopt.params_of(js), t, params))
        ts = topt.step(ts, torch_grads(topt.params_of(ts), t, params))
    assert_states_close(ts, js)
    with pytest.raises(ValueError, match="layout"):
        convert.cdadam_state_from_numpy(*args, [nbrs[0][:, :8]] + nbrs[1:],
                                        like, "cpu")


@pytest.mark.parametrize("name", GRAPHS + ["fully_connected"])
@pytest.mark.parametrize("comp", [dict(scales="leaf"),
                                  dict(scales="worker"),
                                  dict(compressor="topk", fraction=0.1)])
def test_comm_bytes_match_jax(name, comp):
    params = ragged_tree()
    backend = "packed" if comp.get("scales") == "worker" else "reference"
    jopt = jax_make_optimizer("cd-adam", K, topology=name,
                              backend=BACKENDS[backend], **comp)
    topt = make_optimizer("cd-adam", K, topology=name, backend=backend,
                          device="cpu", **comp)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = convert.params_from_numpy(params, "cpu")
    assert topt.comm_bytes_per_round(tp) == jopt.comm_bytes_per_round(jp)
    assert topt.comm_bytes_round_list(tp) == jopt.comm_bytes_round_list(jp)


@pytest.mark.parametrize("period", [1, 3])
@pytest.mark.parametrize("name", GRAPHS)
def test_dpsgd_ten_step_parity(name, period):
    js, ts = run_both("d-psgd", "reference", name, period)
    assert ts.count == int(js.count) == 10
    assert_trees_close(ts.params, js.params)
    assert_trees_close(ts.velocity, js.velocity)


def test_dpsgd_momentum_and_cadam_parity():
    from repro.core.topology import make_topology as jax_topology
    from repro_torch.core.topology import make_topology

    params = ragged_tree(5)
    jcfg = jbaselines.DPSGDConfig(eta=0.05, momentum=0.9, weight_decay=0.01,
                                  period=2, mixing="dense")
    tcfg = baselines.DPSGDConfig(eta=0.05, momentum=0.9, weight_decay=0.01,
                                 period=2, mixing="dense")
    js = jbaselines.dpsgd_init(jax.tree_util.tree_map(jnp.asarray, params),
                               jcfg)
    ts = baselines.dpsgd_init(convert.params_from_numpy(params, "cpu"), tcfg)
    for t in range(5):
        js = jbaselines.dpsgd_step(js, jax_grads(js.params, t, params),
                                   jax_topology("ring", K), jcfg)
        ts = baselines.dpsgd_step(ts, torch_grads(ts.params, t, params),
                                  make_topology("ring", K), tcfg)
    assert_trees_close(ts.params, js.params)
    assert_trees_close(ts.velocity, js.velocity)

    one = jax.tree_util.tree_map(lambda x: x[0], params)
    jc, tc = JaxDAdamConfig(eta=1e-2), DAdamConfig(eta=1e-2)
    js = jbaselines.cadam_init(jax.tree_util.tree_map(jnp.asarray, one), jc)
    ts = baselines.cadam_init(convert.params_from_numpy(one, "cpu"), tc)
    for t in range(4):
        js = jbaselines.cadam_step(js, jax_grads(js.params, t, one), jc)
        ts = baselines.cadam_step(ts, torch_grads(ts.params, t, one), tc)
    assert ts.moments.count == int(js.moments.count) == 4
    assert_trees_close(ts.params, js.params)
    assert_trees_close(ts.moments.v, js.moments.v)


# ------------------------------- trainer -----------------------------------

F, FPF, E, HIDDEN, B = 4, 16, 4, (16, 16), 32
TASK = make_ctr_task(seed=0, n_fields=F, features_per_field=FPF,
                     embed_dim=E)


def jax_batch(t):
    return jax.tree_util.tree_map(
        np.asarray, jax_ctr_batch_stacked(
            TASK, jax.random.fold_in(jax.random.PRNGKey(1), t), K, B))


@pytest.mark.parametrize("kind,backend", [("cd-adam", "packed"),
                                          ("d-psgd", "reference")])
def test_fit_trajectory_tracks_jax(kind, backend):
    """Five steps at period 2 of DeepFM from the same init and batches:
    losses, comm MB, the final params and (CD-Adam) hats."""
    steps = 5
    kw = dict(eta=1e-2, period=2, topology="ring")
    jopt = jax_make_optimizer(kind, K, backend=BACKENDS[backend], **kw)
    topt = make_optimizer(kind, K, backend=backend, device="cpu", **kw)
    p0 = jdeepfm.init_deepfm(jax.random.PRNGKey(0), TASK.n_features, F, E,
                             HIDDEN)
    batches = [jax_batch(t) for t in range(steps)]
    jtr = JaxTrainer(jdeepfm.deepfm_loss, jopt)
    js, jlog = jtr.fit(jtr.init(p0), iter(
        jax.tree_util.tree_map(jnp.asarray, b) for b in batches), steps,
        log_every=1)
    ttr = DecentralizedTrainer(deepfm.deepfm_loss, topt)
    assert ttr.pipeline.mode == ("packed" if backend == "packed"
                                 else "reference")
    ts, tlog = ttr.fit(ttr.init(convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p0), "cpu")), iter(
        convert.params_from_numpy(b, "cpu") for b in batches), steps,
        log_every=1)
    np.testing.assert_allclose(tlog.loss, jlog.loss, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tlog.comm_mb, jlog.comm_mb, rtol=1e-12)
    assert tlog.comm_rounds_total == jlog.comm_rounds_total == 2
    assert_trees_close(topt.params_of(ts), jopt.params_of(js))
    assert_trees_close(ttr.averaged_params(ts), jtr.averaged_params(js))
    assert ttr.comm_mb_per_round(ts) == pytest.approx(
        jtr.comm_mb_per_round(js))
    if kind == "cd-adam":
        assert_trees_close(ts.hat_self, js.hat_self)


def test_bad_combinations_raise_as_in_jax():
    with pytest.raises(ValueError, match="sign"):
        make_optimizer("cd-adam", K, backend="packed", compressor="topk",
                       device="cpu")
    with pytest.raises(ValueError, match="reference"):
        make_optimizer("d-psgd", K, backend="packed", device="cpu")
    with pytest.raises(ValueError, match="overlap"):
        make_optimizer("d-psgd", K, overlap=True, device="cpu")
    with pytest.raises(ValueError, match="scales"):
        make_optimizer("d-adam", K, scales="worker", device="cpu")
    with pytest.raises(ValueError, match="packed"):
        make_optimizer("cd-adam", K, scales="worker", device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        make_optimizer("cd-adam", K, gamma=0.0, device="cpu")
    with pytest.raises(KeyError):
        make_optimizer("cd-adam", K, compressor="nope", device="cpu")
    with pytest.raises(NotImplementedError):
        make_optimizer("cd-adam", K, device="cpu", comm="axis")
    for kw in (dict(staleness=1), dict(overlap=True)):
        assert make_optimizer("cd-adam", K, device="cpu", **kw).cfg.gamma \
            == 0.4
    with pytest.raises(ValueError, match="static-graph"):
        make_optimizer("d-psgd", K, topology="one-peer-exp", device="cpu")
    opt = make_optimizer("cd-adam", K, gamma=0.3, device="cpu")
    assert opt.compressor.name == "sign" and opt.cfg.gamma == 0.3
    assert opt.rebuild(gamma=0.5).cfg.gamma == 0.5
    assert make_optimizer("d-psgd", K, device="cpu").round is None
