"""The 2D worker x model layout of the packed backend (``comm='axis'`` with
a group of K x M ranks), against the JAX package's 2D mesh execution.

The port's runs are 8 gloo ranks spawned on the CPU at (K, M) = (4, 2)
and (2, 4), and 4 ranks for the 1D layout beside it; the JAX runs are made
in one subprocess with 8 forced host devices by ``tests/_jax_axis_2d.py``,
on an Auto-typed ``jax.sharding.Mesh`` (the JAX package's
``make_worker_mesh`` builds Explicit axes, on which its 2D path fails).
The same numpy inputs go to both: the ragged tree of
``tests/test_comm_axis_2d.py``, K noises, weight decay 0.01, grads
``0.5 x + 0.1 noise_t``.

* Validation: JAX's ``TestValidation`` refusals, in-process.
* Placement: one ``(1, rows / M, 128)`` block a rank, the spec's
  ``row_shards`` M.
* Step and round parity (D-Adam, CD-Adam with leaf and worker scales):
  the port's buffers, gathered over both axes, against JAX's global
  arrays at rtol 2e-5 / atol 1e-6 (JAX's own 2D-vs-stacked tolerance).
* The 10-step trainer chain of ``tests/test_comm_axis_2d.py``: 2D, 1D,
  stacked packed and reference, each against JAX's run of the same mode.
* Checkpoints: 1D -> 2D -> stacked equal to the bit, a JAX-written 2D
  checkpoint restored onto the port's 2D state equal to the bit, and the
  restored 2D state stepping as the 1D one does.
* Bytes a worker a round: unchanged by M.
* ``sign_compress_stacked(reduce_axis=)``'s plain version, each rank on
  its block with the model group's sum, against JAX's ``reduce_axis=
  'model'`` in a 2D shard_map: q exactly, scales and hats within f32, and
  every rank of a worker with the same scales to the bit.

Every group has a 60 s collective timeout and every spawn a deadline.
"""
import numpy as np
import pytest
import torch

import _axis2d_ranks as ranks
from repro_torch.checkpoint.io import restore
from repro_torch.core.api import make_optimizer
from repro_torch.core.cdadam import CDAdamConfig
from repro_torch.core.dadam import DAdamConfig
from repro_torch.kernels import pack as packing
from repro_torch.launch.mesh import WorkerGroup, make_worker_group, spawn

FTOL = dict(rtol=2e-5, atol=1e-6)
CHAIN_TOL = dict(rtol=2e-4, atol=2e-5)   # JAX's trainer-chain tolerance
SPAWN_TIMEOUT_S = 240
ADAM = dict(eta=1e-2, period=2, weight_decay=0.01)
FACTORS = ((4, 2), (2, 4))
KINDS = {"d-adam": ("d-adam", None), "cd-adam-leaf": ("cd-adam", "leaf"),
         "cd-adam-worker": ("cd-adam", "worker")}
STEP_CASES = {f"steps-{name}-K{k}xM{m}": dict(
    type="steps", kind=kind, scales=scales, K=k, M=m, backend="pallas",
    steps=4, opt=ADAM)
    for name, (kind, scales) in KINDS.items() for k, m in FACTORS}
ROUND_CASES = {f"round-{kind}": dict(type="round", kind=kind, K=4, M=2,
                                     backend="pallas",
                                     opt=dict(eta=1e-2, period=3))
               for kind in ("d-adam", "cd-adam")}
CHAIN_MODES = ("reference", "packed", "axis1d", "axis2d")
CHAIN_CASES = {f"chain-{kind}-{mode}": dict(
    type="fit", kind=kind, K=4, M=2, mode=mode, loss="quad", steps=10,
    log_every=5, backend="reference" if mode == "reference" else "pallas",
    opt=dict(eta=5e-2, period=2))
    for kind in ("d-adam", "cd-adam") for mode in CHAIN_MODES}
SIGN_CASES = {f"sign-K{k}xM{m}": dict(type="sign", K=k, M=m)
              for k, m in FACTORS}


def by_factor(cases, k, m):
    return {n: c for n, c in cases.items() if (c["K"], c["M"]) == (k, m)}


def write_inputs(path, K=4, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (K, 13, 7), "b": (K, 5), "u": (K, 3, 11, 2)}
    arrays = {}
    for prefix in ["params"] + [f"noise{t}" for t in range(4)]:
        for name, shape in shapes.items():
            arrays[f"{prefix}/{name}"] = rng.standard_normal(shape).astype(
                np.float32)
    arrays["centers"] = rng.standard_normal((K, 37)).astype(np.float32)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("axis2d")
    write_inputs(d / "inputs.npz")
    return d


def ckpt_cases(folder):
    """JAX's 2D states saved after 4 steps; the port's 1D states saved
    after one (spawn ``torch_1d``), restored onto its 2D states and saved
    again (spawn ``torch_42``)."""
    jax_cases = {f"ck-{kind}": dict(
        STEP_CASES[f"steps-{kind}-K4xM2"], save=str(folder / f"jax-{kind}"))
        for kind in ("d-adam", "cd-adam-leaf")}
    src = {f"ck-src-{kind}": dict(type="ckpt_src", kind=kind, K=4, M=1,
                                  backend="pallas", opt=ADAM,
                                  save=str(folder / f"ck1d-{kind}.npz"))
           for kind in ("d-adam", "cd-adam")}
    dst = {f"ck-dst-{kind}": dict(
        type="ckpt_dst", kind=kind, K=4, M=2, backend="pallas", opt=ADAM,
        restore=[str(folder / f"ck1d-{kind}.npz"),
                 str(folder / f"jax-{jkind}")],
        save=str(folder / f"ck2d-{kind}.npz"))
        for kind, jkind in (("d-adam", "d-adam"), ("cd-adam", "cd-adam-leaf"))}
    return jax_cases, src, dst


@pytest.fixture(scope="module")
def jax_2d(folder):
    cases = {**STEP_CASES, **ROUND_CASES, **CHAIN_CASES, **SIGN_CASES,
             **ckpt_cases(folder)[0]}
    return ranks.run_jax(folder / "inputs.npz", cases, folder / "jax.npz")


@pytest.fixture(scope="module")
def torch_1d(folder):
    cases = {**{n: c for n, c in CHAIN_CASES.items()
                if c["mode"] == "axis1d"}, **ckpt_cases(folder)[1]}
    return spawn(ranks.cases_rank, 4,
                 (4, 1, cases, str(folder / "inputs.npz")),
                 timeout_s=SPAWN_TIMEOUT_S, threads=1)


@pytest.fixture(scope="module")
def torch_42(folder, torch_1d, jax_2d):
    cases = {**by_factor(STEP_CASES, 4, 2), **ROUND_CASES,
             **{n: c for n, c in CHAIN_CASES.items()
                if c["mode"] == "axis2d"},
             **by_factor(SIGN_CASES, 4, 2), **ckpt_cases(folder)[2],
             "steps-reference-K4xM2": dict(STEP_CASES["steps-d-adam-K4xM2"],
                                           backend="reference")}
    return spawn(ranks.cases_rank, 8,
                 (4, 2, cases, str(folder / "inputs.npz")),
                 timeout_s=SPAWN_TIMEOUT_S, threads=1)


@pytest.fixture(scope="module")
def torch_24(folder):
    cases = {**by_factor(STEP_CASES, 2, 4), **by_factor(SIGN_CASES, 2, 4)}
    return spawn(ranks.cases_rank, 8,
                 (2, 4, cases, str(folder / "inputs.npz")),
                 timeout_s=SPAWN_TIMEOUT_S, threads=1)


def inputs_of(folder):
    with np.load(folder / "inputs.npz") as data:
        return {k: data[k] for k in data.files}


def results(name, torch_42, torch_24):
    return torch_42 if name in torch_42[0] else torch_24


# ------------------------------ validation ----------------------------------


def fake_group(K=4, M=2):
    """A group object for the construction-time checks, which make no
    collective call."""
    return WorkerGroup(group=None, rank=0, K=K, device=torch.device("cpu"),
                       backend="gloo", M=M)


class TestValidation:
    def test_model_parallel_requires_axis_comm(self):
        with pytest.raises(ValueError, match="comm='axis'"):
            DAdamConfig(model_parallel=2, backend="packed").validate()

    def test_model_parallel_requires_packed_backend(self):
        with pytest.raises(ValueError, match="packed"):
            DAdamConfig(comm="axis", model_parallel=2,
                        backend="reference").validate()

    def test_model_parallel_must_be_positive(self):
        with pytest.raises(ValueError, match="model_parallel"):
            DAdamConfig(model_parallel=0).validate()
        with pytest.raises(ValueError, match="model_parallel"):
            make_worker_group(2, model_parallel=0, device="cpu")

    def test_cdadam_inherits_2d_validation(self):
        with pytest.raises(ValueError, match="packed"):
            CDAdamConfig(comm="axis", model_parallel=2,
                         backend="reference").validate()

    def test_staleness_refused_under_2d(self):
        with pytest.raises(ValueError, match="model_parallel == 1"):
            DAdamConfig(comm="axis", model_parallel=2, backend="packed",
                        staleness=1).validate()
        with pytest.raises(ValueError, match="model_parallel == 1"):
            make_optimizer("d-adam", 4, comm="axis", group=fake_group(),
                           backend="packed", staleness=1)

    def test_the_group_declares_2d_for_the_packed_backend(self):
        packed = make_optimizer("cd-adam", 4, comm="axis",
                                group=fake_group(), backend="packed")
        assert packed.cfg.model_parallel == 2
        assert packed.sharded_value_and_grad is not None
        ref = make_optimizer("d-adam", 4, comm="axis", group=fake_group(),
                             backend="reference")
        assert ref.cfg.model_parallel == 1
        assert ref.sharded_value_and_grad is None

    def test_wrong_worker_count_on_2d_group_rejected(self):
        with pytest.raises(ValueError, match="size K"):
            make_optimizer("d-adam", 5, comm="axis", group=fake_group(),
                           backend="packed")


# ------------------------------ placement -----------------------------------


@pytest.mark.parametrize("factor", FACTORS, ids=lambda f: f"K{f[0]}xM{f[1]}")
def test_one_row_block_per_rank(factor, torch_42, torch_24):
    k, m = factor
    res = torch_42 if factor == (4, 2) else torch_24
    for kind in KINDS:
        for r in res:
            got = r[f"steps-{kind}-K{k}xM{m}"]
            assert got["rows"] % (m * packing.BLOCK_ROWS) == 0
            assert got["block"] == (1, got["rows"] // m, packing.LANE)


# ---------------------------- step and round --------------------------------


def assert_close(ours: dict, theirs: dict, keys, what: str, tol=FTOL):
    for key in keys:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert a.shape == b.shape, (what, key, a.shape, b.shape)
        np.testing.assert_allclose(a, b, **tol, err_msg=f"{what} {key}")


def packed_keys(d: dict):
    return [k for k in d if k in ("buf", "m", "v", "hat")
            or k.startswith("nbr") or (k.startswith("p") and k[1:].isdigit())]


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_2d_steps_match_jax(name, jax_2d, torch_42, torch_24):
    want = jax_2d[name]
    for rank, r in enumerate(results(name, torch_42, torch_24)):
        assert_close(r[name], want, packed_keys(want), f"{name} rank {rank}")


@pytest.mark.parametrize("name", sorted(ROUND_CASES))
def test_2d_round_matches_jax(name, jax_2d, torch_42):
    want = jax_2d[name]
    for rank, r in enumerate(torch_42):
        got = r[name]
        assert got["count"] == int(want["count"]) == 3
        # grad_fn sees the rank's block
        assert set(got["grad_fn_shapes"]) == {
            (1, want["buf"].shape[1] // 2, packing.LANE)}
        assert_close(got, want, packed_keys(want), f"{name} rank {rank}")


def test_reference_backend_on_2d_group_stays_1d(folder, torch_42):
    """Under backend='reference' the 2D group keeps the 1D layout: every
    rank of a worker holds the worker's whole state, and the run is the
    stacked one."""
    c = dict(STEP_CASES["steps-d-adam-K4xM2"], backend="reference")
    want = ranks.run_steps(c, inputs_of(folder))
    for rank, r in enumerate(torch_42):
        assert_close(r["steps-reference-K4xM2"], want,
                     [k for k in want if k.startswith("p")],
                     f"reference rank {rank}")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bytes_per_round_unchanged_by_model_axis(kind, folder, jax_2d,
                                                 torch_42, torch_24):
    c = STEP_CASES[f"steps-{kind}-K4xM2"]
    stacked = ranks.run_steps(dict(c, steps=0), inputs_of(folder))["bytes"]
    for factor, res in (("K4xM2", torch_42), ("K2xM4", torch_24)):
        name = f"steps-{kind}-{factor}"
        for r in res:
            assert r[name]["bytes"] == int(jax_2d[name]["bytes"])
    for r in torch_42:
        assert r[f"steps-{kind}-K4xM2"]["bytes"] == stacked > 0


# ------------------------------ trainer chain -------------------------------


@pytest.mark.parametrize("name", sorted(CHAIN_CASES))
def test_trainer_chain_matches_jax(name, folder, jax_2d, torch_1d, torch_42):
    c = CHAIN_CASES[name]
    want = jax_2d[name]
    if c["mode"] in ("reference", "packed"):
        runs = [ranks.run_fit(c, inputs_of(folder))]
    else:
        runs = [r[name] for r in (torch_1d if c["mode"] == "axis1d"
                                  else torch_42)]
    for got in runs:
        np.testing.assert_allclose(got["loss"], want["loss"], **CHAIN_TOL)
        np.testing.assert_allclose(got["p0"], want["p0"], **CHAIN_TOL)
        np.testing.assert_allclose(got["consensus"], want["consensus"],
                                   rtol=1e-3, atol=1e-6)
        np.testing.assert_array_equal(got["evals"], want["evals"])


@pytest.mark.parametrize("kind", ["d-adam", "cd-adam"])
def test_trainer_chain_2d_1d_packed_agree_tightly(kind, folder, torch_1d,
                                                  torch_42):
    """The three packed runtimes of the port agree to f32 rounding."""
    packed = ranks.run_fit(CHAIN_CASES[f"chain-{kind}-packed"],
                           inputs_of(folder))
    for mode, res in (("axis1d", torch_1d), ("axis2d", torch_42)):
        for r in res:
            np.testing.assert_allclose(r[f"chain-{kind}-{mode}"]["p0"],
                                       packed["p0"], rtol=2e-5, atol=2e-6)


# ------------------------------- checkpoints --------------------------------


@pytest.mark.parametrize("kind", ["d-adam", "cd-adam"])
def test_checkpoint_1d_to_2d_to_stacked_bit_equal(kind, folder, torch_1d,
                                                  torch_42):
    saved = torch_1d[0][f"ck-src-{kind}"]["saved"]
    for rank, r in enumerate(torch_42):
        got = r[f"ck-dst-{kind}"]
        assert got["step0"] == 1 and got["row_shards0"] == 2
        assert got["block0"][0] == 1
        for a, b in zip(got["restored0"], saved):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank}")
        # the restored 2D state steps as the 1D one did
        for a, b in zip(got["after"], torch_1d[0][f"ck-src-{kind}"]["after"]):
            if isinstance(a, np.ndarray):
                np.testing.assert_allclose(a, b, **FTOL)
    # the 2D checkpoint restores onto a stacked state, equal to the bit
    c = dict(type="steps", kind=kind, K=4, M=1, backend="pallas", opt=ADAM)
    like = ranks.make_opt(c).init(ranks.tree_from(inputs_of(folder),
                                                  "params", 4))
    st, step = restore(str(folder / f"ck2d-{kind}.npz"), like)
    assert step == 2
    for a, b in zip(ranks.portable(st, None), saved):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,jkind", [("d-adam", "d-adam"),
                                        ("cd-adam", "cd-adam-leaf")])
def test_jax_2d_checkpoint_restores_onto_the_ports_2d_state(
        kind, jkind, jax_2d, torch_42):
    want = jax_2d[f"ck-{jkind}"]
    for rank, r in enumerate(torch_42):
        got = r[f"ck-dst-{kind}"]
        assert got["step1"] == 4
        leaves = [x for x in got["restored1"] if isinstance(x, np.ndarray)
                  and x.ndim > 0]
        wants = [want[k] for k in sorted((k for k in want
                                          if k.startswith("u")),
                                         key=lambda k: int(k[1:]))
                 if want[k].ndim > 0]
        assert len(leaves) == len(wants)
        for a, b in zip(leaves, wants):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank}")


# ---------------------- sign_compress_stacked(reduce_axis) ------------------


@pytest.mark.parametrize("name", sorted(SIGN_CASES))
@pytest.mark.parametrize("scales", ["leaf", "worker"])
def test_sign_compress_reduce_axis_matches_jax(name, scales, jax_2d,
                                               torch_42, torch_24):
    c = SIGN_CASES[name]
    K, M = c["K"], c["M"]
    want = jax_2d[name]
    res = results(name, torch_42, torch_24)
    rows = want["x"].shape[1] // M
    for rank, r in enumerate(res):
        w, m = divmod(rank, M)
        got = r[name]
        blk = slice(m * rows, (m + 1) * rows)
        np.testing.assert_array_equal(got[f"{scales}_q"][0],
                                      want[f"{scales}_q"][w, blk])
        np.testing.assert_allclose(got[f"{scales}_scale"][0],
                                   want[f"{scales}_scale"][w], rtol=1e-6)
        np.testing.assert_allclose(got[f"{scales}_hat"][0],
                                   want[f"{scales}_hat"][w, blk], **FTOL)
        # every rank of worker w holds the same scales, to the bit
        np.testing.assert_array_equal(got[f"{scales}_scale"],
                                      res[w * M][name][f"{scales}_scale"])
