"""Online publish under ``comm='axis'`` (``serve.publish.publish_params``
with a group, ``train.online.train_online``), against the port's stacked
publish and the JAX package's axis run.

The port's runs are one world of 8 gloo ranks spawned on the CPU: a 1D
group of 4 (both backends, the mean and one worker's replica) and the 2D
layout at (4, 2) and (2, 4); the JAX runs are made in one subprocess with
8 forced host devices (``tests/_jax_elastic_axis.py``) on Auto-typed
meshes. The same numpy inputs go to both: a linear model's weights and 6
steps of batches. A trainer takes 6 steps of packed (or reference) D-Adam
at period 2 and publishes every 2.

* Every rank's store ends with the history ``[(2, 1), (4, 2), (6, 3)]``,
  JAX's, and every published tree is the same on every rank, to the bit.
* The last tree equals, to the bit, the port's stacked
  ``publish_params`` of the gathered final state; every tree is within
  f32 rtol / atol 2e-5 of JAX's, as are the logged losses.

Every group has a 60 s collective timeout and the spawn a deadline.
"""
import numpy as np
import pytest
import torch

import _elastic_ranks as ranks
from _axis2d_ranks import run_jax
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import dadam
from repro_torch.launch.mesh import spawn
from repro_torch.serve.publish import publish_params

FTOL = dict(rtol=2e-5, atol=2e-5)
SPAWN_TIMEOUT_S = 240
STEPS, EVERY = 6, 2


def online(K, M, mode="mean", backend="packed", worker=0):
    return dict(type="online", kind="d-adam", backend=backend, K=K, M=M,
                steps=STEPS, publish_every=EVERY, mode=mode, worker=worker,
                opt=dict(eta=5e-2, period=2))


CASES = {
    "online-1d-mean": online(4, 1),
    "online-1d-reference-mean": online(4, 1, backend="reference"),
    "online-1d-worker": online(4, 1, mode="worker", worker=3),
    "online-2d-mean": online(4, 2),
    "online-2d-worker": online(2, 4, mode="worker", worker=1),
}


def write_inputs(path, seed=1):
    rng = np.random.default_rng(seed)
    arrays = {"mlp_w": rng.standard_normal((16, 4)).astype(np.float32)}
    for t in range(STEPS):
        arrays[f"mlp_x{t}"] = rng.standard_normal((8, 8, 16)).astype(
            np.float32)
        arrays[f"mlp_y{t}"] = rng.standard_normal((8, 8, 4)).astype(
            np.float32)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("online")
    write_inputs(d / "inputs.npz")
    return d


@pytest.fixture(scope="module")
def jax_runs(folder):
    return run_jax(folder / "inputs.npz", CASES, folder / "jax.npz",
                   script="_jax_elastic_axis.py")


@pytest.fixture(scope="module")
def torch_runs(folder):
    return spawn(ranks.world_rank, ranks.WORLD,
                 (CASES, str(folder / "inputs.npz")),
                 timeout_s=SPAWN_TIMEOUT_S, threads=1)


def members(torch_runs, name):
    c = CASES[name]
    got = [res[name] for res in torch_runs if res[name]["member"]]
    assert len(got) == c["K"] * c["M"]
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_has_the_same_history_as_jax(name, torch_runs,
                                                jax_runs):
    want = [(2, 1), (4, 2), (6, 3)]
    assert [tuple(p) for p in jax_runs[name]["published"]] == want
    for res in members(torch_runs, name):
        assert res["published"] == want and res["version"] == 3


@pytest.mark.parametrize("name", sorted(CASES))
def test_published_trees_equal_on_every_rank_and_near_jax(name, torch_runs,
                                                          jax_runs):
    got = members(torch_runs, name)
    theirs = jax_runs[name]
    for v, leaves in enumerate(got[0]["trees"]):
        for res in got[1:]:
            for a, b in zip(res["trees"][v], leaves):
                np.testing.assert_array_equal(a, b)
        for j, x in enumerate(leaves):
            np.testing.assert_allclose(x, theirs[f"v{v + 1}_{j}"], **FTOL,
                                       err_msg=f"{name} v{v + 1} leaf {j}")
    np.testing.assert_allclose(got[0]["log"]["loss"], theirs["loss"],
                               **FTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_last_publish_is_the_stacked_publish_of_the_gathered_state(
        name, torch_runs):
    c = CASES[name]
    final = tree_map(lambda x: torch.from_numpy(x)
                     if isinstance(x, np.ndarray) else x,
                     torch_runs[0][name]["final"])
    if c["backend"] == "packed":
        final = dadam.PackedDAdamState.from_unpacked(final)
    want = publish_params(final, mode=c["mode"], worker=c["worker"])
    for res in members(torch_runs, name):
        for a, b in zip(res["trees"][-1], tree_leaves(want)):
            np.testing.assert_array_equal(a, b.numpy())
