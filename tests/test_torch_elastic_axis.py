"""Elastic membership under ``comm='axis'``: ranks that leave and join a
worker group (``core.elastic.resize_state``, ``DecentralizedTrainer
.resize``), against the port's stacked resize and the JAX package's axis
resize.

The port's runs are one world of 8 gloo ranks spawned on the CPU; each
membership is a worker group over a prefix of it, so the same 8 processes
leave (a group of 6 or 3 after one of 4 or 6), join (6 after 4) and change
layout (the 2D (4, 2) -> (2, 4) and (3, 2)). The JAX runs are made in one
subprocess with 8 forced host devices (``tests/_jax_elastic_axis.py``), the
new optimizer on an Auto-typed mesh over the first K' x M' devices. The
same numpy inputs go to both: the ragged tree of
``tests/test_comm_axis.py``, weight decay 0.01, 2 steps before the resize
and 2 after with grads ``0.5 x + 0.1 noise_t``.

* Contract: every member of the new group holds, equal to the bit, its
  worker's slice of the port's stacked ``resize_state`` of the gathered old
  state (its model block under the 2D layout, repacked to the new
  ``row_shards``); a leaver and a spare get ``None``; the count is kept,
  CD-Adam hats restart at zero and straggler buffers cold.
* Against JAX: the state after the resize and after 2 more steps, f32
  within rtol / atol 2e-5, counts and ages exactly.
* The bytes of the resize, counted under ``"resize"``.
* The trainer with AdaDamp under axis, resized 4 -> 6 with joiners: its
  log, params, damping level and evaluations against JAX's.
* A group of 6 inside the world of 8: ``exchange``'s global peer ranks.

Every group has a 60 s collective timeout and the spawn a deadline.
"""
import numpy as np
import pytest
import torch

import _elastic_ranks as ranks
from _axis2d_ranks import run_jax
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import cdadam, dadam
from repro_torch.core.elastic import resize_state
from repro_torch.launch.mesh import WorkerGroup, spawn
from repro_torch.launch.shardings import take_model_block, take_worker

FTOL = dict(rtol=2e-5, atol=2e-5)
SPAWN_TIMEOUT_S = 240
ADAM = dict(eta=1e-2, period=1, weight_decay=0.01)
PRE, POST = 2, 2


def resize(kind, backend, K0, K1, strategy="clone", M0=1, M1=1, **extra):
    return dict(type="resize", kind=kind, backend=backend, K0=K0, K1=K1,
                M0=M0, M1=M1, strategy=strategy, pre=PRE, post=POST,
                opt=dict(ADAM), **extra)


CASES = {
    **{f"d-adam-{b}-4to6-{s}": resize("d-adam", b, 4, 6, s)
       for b in ("reference", "packed") for s in ("clone", "mean")},
    **{f"d-adam-{b}-6to3": resize("d-adam", b, 6, 3)
       for b in ("reference", "packed")},
    "cd-adam-packed-4to2": resize("cd-adam", "packed", 4, 2),
    "d-adam-tau2-packed-4to6": dict(
        resize("d-adam", "packed", 4, 6), masks={"4": "masks4",
                                                 "6": "masks6"},
        opt=dict(ADAM, staleness=2, straggler_rate=0.3)),
    "2d-d-adam-42to24": resize("d-adam", "packed", 4, 2, M0=2, M1=4),
    "2d-cd-adam-42to32": resize("cd-adam", "packed", 4, 3, M0=2, M1=2),
    "trainer-adadamp-4to6": dict(
        type="trainer_resize", kind="d-adam", backend="packed", K0=4,
        K1=6, M0=1, M1=1, strategy="mean", pre=PRE, post=POST,
        damping="adadamp:2", opt=dict(eta=5e-2, period=2)),
}
TORCH_ONLY = {"exchange-6of8": dict(type="exchange", K=6)}


def write_inputs(path, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 13, 7), "b": (8, 5), "u": (8, 3, 11, 2)}
    arrays = {}
    for prefix in ["params"] + [f"noise{t}" for t in range(PRE + POST)]:
        for name, shape in shapes.items():
            arrays[f"{prefix}/{name}"] = rng.standard_normal(shape).astype(
                np.float32)
    for k in (4, 6):
        arrays[f"masks{k}"] = rng.random((PRE + POST, k, 2)) >= 0.3
    arrays["mlp_w"] = rng.standard_normal((16, 4)).astype(np.float32)
    for t in range(PRE + POST):
        arrays[f"mlp_x{t}"] = rng.standard_normal((8, 8, 16)).astype(
            np.float32)
        arrays[f"mlp_y{t}"] = rng.standard_normal((8, 8, 4)).astype(
            np.float32)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    write_inputs(d / "inputs.npz")
    return d


@pytest.fixture(scope="module")
def inputs(folder):
    with np.load(folder / "inputs.npz") as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def jax_runs(folder):
    return run_jax(folder / "inputs.npz", CASES, folder / "jax.npz",
                   script="_jax_elastic_axis.py")


@pytest.fixture(scope="module")
def torch_runs(folder):
    return spawn(ranks.world_rank, ranks.WORLD,
                 ({**CASES, **TORCH_ONLY}, str(folder / "inputs.npz")),
                 timeout_s=SPAWN_TIMEOUT_S, threads=1)


def members(torch_runs, name):
    return [(r, res[name]) for r, res in enumerate(torch_runs)
            if res[name]["member"]]


def stacked_reference(c, old, inputs):
    """The port's stacked ``resize_state`` of the gathered old state."""
    old = tree_map(lambda x: torch.from_numpy(x)
                   if isinstance(x, np.ndarray) else x, old)
    if c["backend"] == "packed":
        cls = (cdadam.PackedCDAdamState if c["kind"] == "cd-adam"
               else dadam.PackedDAdamState)
        old = cls.from_unpacked(old)
    return resize_state(old, ranks.make_opt(c, c["K1"], None, inputs),
                        strategy=c["strategy"])


def reference_slice(c, ref, w, m):
    """Member (w, m)'s part of the stacked reference: worker w's slice,
    under the 2D layout repacked row-sharded and cut to block m."""
    if c["backend"] != "packed":
        return ranks.local(take_worker(ref, w, c["K1"]))
    one = take_worker(ref.unpacked(), w, c["K1"])
    st = type(ref).from_unpacked(one, row_shards=c["M1"])
    wg = WorkerGroup(group=None, rank=w, K=c["K1"], device=torch.device(
        "cpu"), backend="gloo", M=c["M1"], model_rank=m)
    st = take_model_block(st, wg)
    out = ranks.local(st)
    stale = getattr(ref, "stale", None)
    if stale is not None:
        out["age"] = stale.age[w:w + 1].numpy()
    return out


RESIZE = sorted(n for n, c in CASES.items() if c["type"] == "resize")


@pytest.mark.parametrize("name", RESIZE)
def test_members_hold_their_slice_of_the_stacked_resize(name, torch_runs,
                                                        inputs):
    c = CASES[name]
    ref = stacked_reference(c, torch_runs[0][name]["old"], inputs)
    got = members(torch_runs, name)
    assert len(got) == c["K1"] * c["M1"]
    for r, res in got:
        assert (res["w"], res["m"]) == divmod(r, c["M1"])
        want = reference_slice(c, ref, res["w"], res["m"])
        assert sorted(res["local"]) == sorted(want), (name, r)
        for key, val in want.items():
            np.testing.assert_array_equal(res["local"][key], val,
                                          err_msg=f"{name} rank {r} {key}")


@pytest.mark.parametrize("name", RESIZE)
def test_leavers_and_spares_get_none(name, torch_runs):
    c = CASES[name]
    for r, res in enumerate(torch_runs):
        assert res[name]["member"] == (r < c["K1"] * c["M1"])
        assert res[name]["got_none"] == (not res[name]["member"])


@pytest.mark.parametrize("name", RESIZE)
def test_resize_matches_jax_axis_resize(name, torch_runs, jax_runs):
    ours, theirs = torch_runs[0][name], jax_runs[name]
    for key, want in theirs.items():
        got = np.asarray(ours[key])
        assert got.shape == want.shape, (name, key, got.shape, want.shape)
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {key}")
        else:
            np.testing.assert_allclose(got, want, **FTOL,
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", RESIZE)
def test_count_kept_hats_zero_buffers_cold(name, torch_runs):
    c = CASES[name]
    for r, res in members(torch_runs, name):
        local = res["local"]
        assert int(local["count"]) == PRE
        for key in local:
            if key == "hat" or key.startswith("nbr"):
                assert not np.any(local[key]), (name, r, key)
        if "age" in local:
            assert (local["age"] == dadam.COLD_AGE).all(), (name, r)
    if "masks" in c:
        assert "age" in torch_runs[0][name]["local"]


@pytest.mark.parametrize("name", RESIZE)
def test_resize_bytes_are_counted(name, torch_runs, inputs):
    """Each old rank puts its worker's params and moments into the
    all-gather once; global rank 0 also sends every joiner its worker's
    slices."""
    c = CASES[name]
    one = sum(x.nbytes for x in tree_leaves(
        ranks.tree_from(inputs, "params", 1)))
    per_worker = 3 * one
    joiners = max(0, c["K1"] * c["M1"] - c["K0"] * c["M0"])
    for r, res in enumerate(torch_runs):
        got = res[name]["resize"]
        if r >= c["K0"] * c["M0"]:
            assert got == {"count": 0, "bytes": 0, "max_bytes": 0}, \
                (name, r)
            continue
        sent = per_worker * (1 + (joiners if r == 0 else 0))
        assert got["bytes"] == sent, (name, r, got)


def test_trainer_resize_with_damping_matches_jax(torch_runs, jax_runs):
    name = "trainer-adadamp-4to6"
    got = members(torch_runs, name)
    assert [r for r, _ in got] == list(range(6))
    theirs = jax_runs[name]
    for r, res in got:
        assert res["steps_total"] == PRE + POST
        assert res["comm_rounds_total"] == (PRE + POST) // 2
        for key in ("loss", "consensus", "comm_mb"):
            np.testing.assert_allclose(res[key], theirs[key], **FTOL,
                                       err_msg=f"rank {r} {key}")
        np.testing.assert_array_equal(res["evals"], theirs["evals"])
        assert res["evals_total"] == int(theirs["evals_total"])
        np.testing.assert_allclose(res["level"], theirs["level"], **FTOL)
        for j in range(2):
            np.testing.assert_allclose(res[f"p{j}"], theirs[f"p{j}"],
                                       **FTOL, err_msg=f"rank {r} p{j}")
        # every member holds the same log, damping state and params
        for key in ("loss", "evals", "level", "p0", "p1"):
            np.testing.assert_array_equal(res[key], got[0][1][key])
    for r in (6, 7):
        assert torch_runs[r][name]["got_none"]


def test_a_group_of_six_inside_a_world_of_eight(torch_runs):
    for r, res in enumerate(torch_runs):
        res = res["exchange-6of8"]
        assert res["world"] == 8 and res["member"] == (r < 6)
        if r < 6:
            np.testing.assert_array_equal(
                res["got"], np.full((3, 5), float((r - 1) % 6)))
