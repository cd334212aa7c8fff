"""The port's topology schedules against the JAX package's.

The zoo of schedules must be equal, entry for entry: weights, offsets
(``rand-ring``'s seeded ``PermShift`` permutations included), offset and
self weights, the union edge set and its views. The comm accounting of a
schedule (the per-round list, the union rule for per-edge state) must
equal JAX's, and a schedule run through the trainer must log the same
comm MB.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_optimizer as jax_make_optimizer
from repro.core import schedule as jschedule
from repro_torch import convert
from repro_torch.core import schedule
from repro_torch.core.api import make_optimizer, resolve_topology
from repro_torch.core.topology import make_topology, offsets_matrix

torch.set_num_threads(2)

K = 8
SPECS = ["one-peer-exp", "one-peer-exponential", "rand-ring", "rand-ring:6",
         "rand_ring:3", "ring", "torus", "exponential"]


def assert_topologies_equal(t, j):
    assert t.name == j.name
    np.testing.assert_array_equal(t.weights, j.weights)
    assert t.self_weight == j.self_weight
    assert t.offset_weights == j.offset_weights
    assert [repr(o) for o in t.offsets] == [repr(o) for o in j.offsets]


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 12])
@pytest.mark.parametrize("spec", SPECS)
def test_schedule_zoo_matches_jax(spec, k):
    with warnings.catch_warnings():   # prime-K torus: the ring fallback
        warnings.simplefilter("ignore", RuntimeWarning)
        ts = schedule.make_schedule(spec, k)
        js = jschedule.make_schedule(spec, k)
    assert ts.name == js.name and ts.K == js.K == k
    assert len(ts.entries) == len(js.entries)
    for t, j in zip(ts.entries, js.entries):
        assert_topologies_equal(t, j)
        np.testing.assert_allclose(offsets_matrix(t), t.weights, atol=1e-12)
    assert [repr(o) for o in ts.union_offsets()] == \
        [repr(o) for o in js.union_offsets()]
    for t, j in zip(ts.union_views(), js.union_views()):
        assert_topologies_equal(t, j)
    np.testing.assert_array_equal(ts.mean_weights, js.mean_weights)
    np.testing.assert_allclose(ts.spectral_gap, js.spectral_gap, rtol=1e-12)
    for r in range(7):
        assert ts.at(r).name == js.at(r).name


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_randomized_rings_draw_the_jax_permutations(seed):
    ts = schedule.randomized_rings(K, n_entries=5, seed=seed)
    js = jschedule.randomized_rings(K, n_entries=5, seed=seed)
    perms = [[o.perm for o in e.offsets] for e in ts.entries]
    assert perms == [[o.perm for o in e.offsets] for e in js.entries]
    assert len({p[0] for p in perms}) > 1       # the entries differ
    again = schedule.make_schedule("rand-ring:5", K, seed=seed)
    assert [[o.perm for o in e.offsets] for e in again.entries] == perms


def test_schedule_helpers():
    sched = schedule.one_peer_exponential(K)
    assert sched.union_offsets() == (1, 7, 2, 6, 4)
    assert sched.offsets == sched.union_offsets()
    assert schedule.comm_offsets(sched) == (1, 7, 2, 6, 4)
    assert schedule.comm_offsets(make_topology("ring", K)) == (1, 7)
    # K=8, h=4: +4 and -4 are one permutation, weight 2/3
    assert sched.entries[2].offsets == (4,)
    views = sched.union_views()
    assert [v.offset_weights[4] for v in views] == [0.0, 0.0, 2.0 / 3.0]
    one = schedule.static_schedule(make_topology("ring", K))
    assert one.n_entries == 1 and one.at(5) is one.entries[0]
    assert isinstance(resolve_topology("rand-ring:3", K),
                      schedule.TopologySchedule)
    with pytest.raises(KeyError):
        schedule.make_schedule("nope", K)
    with pytest.raises(ValueError, match="share K"):
        schedule.TopologySchedule("mixed", (make_topology("ring", 4),
                                            make_topology("ring", 8)))
    with pytest.raises(ValueError, match="at least one"):
        schedule.TopologySchedule("empty", ())


def ragged_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, 13, 7)).astype(np.float32),
            "b": rng.standard_normal((K, 5)).astype(np.float32)}


@pytest.mark.parametrize("kind,kw", [
    ("d-adam", {}), ("d-adam", dict(staleness=2)),
    ("d-adam", dict(overlap=True)), ("d-adam", dict(staleness=0)),
    ("cd-adam", {}), ("cd-adam", dict(scales="worker"))],
    ids=["dadam", "dadam-tau2", "dadam-overlap", "dadam-tau0", "cdadam",
         "cdadam-worker"])
@pytest.mark.parametrize("spec", ["one-peer-exp", "rand-ring:3"])
def test_schedule_comm_bytes_match_jax(spec, kind, kw):
    """Plain D-Adam pays each round's own degree; per-edge state (CD-Adam
    payloads, staleness or overlap buffers) exchanges over the union."""
    backend = "packed" if kw.get("scales") == "worker" else "reference"
    jopt = jax_make_optimizer(kind, K, topology=spec,
                              backend={"packed": "pallas"}.get(backend,
                                                                backend),
                              **kw)
    topt = make_optimizer(kind, K, topology=spec, backend=backend,
                          device="cpu", **kw)
    params = ragged_tree()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = convert.params_from_numpy(params, "cpu")
    assert topt.comm_bytes_per_round(tp) == jopt.comm_bytes_per_round(jp)
    assert topt.comm_bytes_round_list(tp) == jopt.comm_bytes_round_list(jp)


def test_schedule_trainer_logs_the_per_round_bytes():
    """The trainer's comm MB follow the schedule's per-round list across
    resumed fits: one-peer-exp at K=8 sends 2, 2, 1 neighbour copies."""
    from repro_torch.train.loop import DecentralizedTrainer

    opt = make_optimizer("d-adam", K, topology="one-peer-exp", period=1,
                         device="cpu")
    tr = DecentralizedTrainer(lambda p, b: (p["x"] ** 2).sum(-1), opt)
    state = tr.init({"x": torch.ones(4)})
    batches = iter(lambda: {"y": torch.zeros(K, 1)}, None)
    state, log = tr.fit(state, batches, 2, log_every=1)
    state, log = tr.fit(state, batches, 2, log_every=1, log=log)
    per = 16 / 1e6                       # one neighbour's 4 f32 values
    np.testing.assert_allclose(log.comm_mb, [2 * per, 4 * per, 5 * per,
                                             7 * per])
