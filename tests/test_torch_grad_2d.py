"""The 2D layout's gradient pipeline and damping under ``comm='axis'``,
against the JAX package's trainer on its 2D mesh (``tests/_jax_axis_2d.py``
in a subprocess with 8 host devices, on an Auto-typed mesh).

* The sharded-packed mode (``sharded_loss``, ``ShardCtx``,
  ``row_parallel_dot``): ``tests/test_grad_pipeline.py``'s
  ``sharded_mlp_loss`` (a 1600 x 64 weight that spans every shard at
  M = 2 and M = 4, and a bias assembled by ``full_leaf``), its
  ``sharded_quad_loss`` (``mirror`` and ``psum``) and the two-layer
  row-parallel composition, each 10 (6) trainer steps on 8 gloo ranks,
  held to JAX's run of the same mode: gradients are not scaled by M.
  D-Adam within rtol 2e-4 / atol 2e-5 (JAX's tolerance for its sharded
  chain); CD-Adam, whose sign compressor turns a matmul's reduction-order
  differences (torch's against XLA's, or sharded against whole) into a few
  flipped signs, within JAX's own flip budget for it.
* The packed mode under M > 1 (the worker's blocks all-gathered once a
  step), microbatch 2 in the sharded mode, the sharded damped path and
  the packed damped path under 2D, and damping under the 1D axis layout,
  each against JAX's trainer.
* The collective counters (``WorkerGroup.collective_summary``): no
  model-group all-gather in the sharded-packed mode, one a step in the
  packed mode.
* The training CLI's run at ``--model-parallel 2`` (its sharding plan) on
  CPU ranks against ``--model-parallel 1``, at f32 compute.
"""
import numpy as np
import pytest
import torch

import _axis2d_ranks as ranks
from repro_torch.core.api import make_optimizer
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import spawn
from repro_torch.train.grad import make_grad_pipeline
from repro_torch.train.loop import DecentralizedTrainer

SPAWN_TIMEOUT_S = 300
CHAIN_TOL = dict(rtol=2e-4, atol=2e-5)
DIN, DOUT, B, STEPS = 1600, 64, 8, 10
FIT = dict(type="fit", steps=STEPS, log_every=5, opt=dict(eta=1e-2, period=2))


def fit(name, kind, K, M, mode, loss="mlp", **kw):
    backend = "reference" if mode == "reference" else "pallas"
    return name, dict(FIT, kind=kind, K=K, M=M, mode=mode, loss=loss,
                      backend=backend, **kw)


CASES = dict([
    *[fit(f"sharded-{kind}-K{k}xM{m}", kind, k, m, "axis2d", sharded=True)
      for kind in ("d-adam", "cd-adam") for k, m in ((4, 2), (2, 4))],
    *[fit(f"reference-{kind}-K{k}", kind, k, 0, "reference")
      for kind in ("d-adam", "cd-adam") for k in (4, 2)],
    *[fit(f"unpack2d-{kind}", kind, 4, 2, "axis2d")
      for kind in ("d-adam", "cd-adam")],
    fit("two-layer-sharded", "d-adam", 4, 2, "axis2d", loss="two_layer",
        sharded=True, steps=6, log_every=3),
    fit("two-layer-reference", "d-adam", 4, 0, "reference",
        loss="two_layer", steps=6, log_every=3),
    fit("quad-sharded", "d-adam", 4, 2, "axis2d", loss="mean_quad",
        sharded=True, opt=dict(eta=5e-2, period=2)),
    fit("quad-reference", "d-adam", 4, 0, "reference", loss="mean_quad",
        opt=dict(eta=5e-2, period=2)),
    *[fit(f"sharded-microbatch-{mb}", "d-adam", 4, 2, "axis2d",
          sharded=True, microbatch=mb, steps=4, log_every=2)
      for mb in (1, 2)],
    fit("damped-sharded", "d-adam", 4, 2, "axis2d", sharded=True,
        damping="adadamp:2"),
    fit("damped-unpack2d", "d-adam", 4, 2, "axis2d", damping="adadamp:2"),
    *[fit(f"damped-axis1d-{kind}", kind, 4, 0, "axis1d",
          damping="adadamp:2") for kind in ("d-adam", "cd-adam")],
])


def write_inputs(path, K=4, seed=1):
    rng = np.random.default_rng(seed)
    arrays = {"mlp_w": (rng.standard_normal((DIN, DOUT)) * 0.02),
              "tl_w1": (rng.standard_normal((DIN, ranks.D_H)) * 0.02),
              "tl_w2": (rng.standard_normal((ranks.D_H, DOUT)) * 0.05),
              "centers": rng.standard_normal((K, 37))}
    for t in range(STEPS):
        arrays[f"mlp_x{t}"] = rng.standard_normal((K, B, DIN))
        arrays[f"mlp_y{t}"] = rng.standard_normal((K, B, DOUT))
    np.savez(path, **{k: v.astype(np.float32) for k, v in arrays.items()})


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("grad2d")
    write_inputs(d / "inputs.npz")
    return d


@pytest.fixture(scope="module")
def jax_fits(folder):
    return ranks.run_jax(folder / "inputs.npz", CASES, folder / "jax.npz")


def spawned(folder, K, M, select):
    cases = {n: c for n, c in CASES.items() if select(c)}
    return spawn(ranks.cases_rank, K * max(M, 1),
                 (K, max(M, 1), cases, str(folder / "inputs.npz")),
                 timeout_s=SPAWN_TIMEOUT_S, threads=1)


@pytest.fixture(scope="module")
def torch_42(folder):
    return spawned(folder, 4, 2, lambda c: c["mode"] == "axis2d"
                   and (c["K"], c["M"]) == (4, 2))


@pytest.fixture(scope="module")
def torch_24(folder):
    return spawned(folder, 2, 4, lambda c: c["mode"] == "axis2d"
                   and (c["K"], c["M"]) == (2, 4))


@pytest.fixture(scope="module")
def torch_1d(folder):
    return spawned(folder, 4, 0, lambda c: c["mode"] == "axis1d")


def runs_of(name, folder, torch_42, torch_24, torch_1d):
    c = CASES[name]
    if c["mode"] == "reference":
        with np.load(folder / "inputs.npz") as data:
            inputs = {k: data[k] for k in data.files}
        return [ranks.run_fit(c, inputs)]
    res = {(4, 2): torch_42, (2, 4): torch_24}.get((c["K"], c["M"]),
                                                    torch_1d)
    return [r[name] for r in res]


def flip_budget(got, want):
    """JAX's own bound for CD-Adam's sharded run against another
    (``test_sharded_equals_unpack_equals_reference``)."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=5e-3,
                               atol=5e-3)
    d = np.abs(got["p1"] - want["p1"])
    assert d.mean() < 1e-4, f"mean drift {d.mean():.2e}"
    assert (d > 1e-3).mean() < 0.01
    assert d.max() < 0.1


@pytest.mark.parametrize("name", sorted(CASES))
def test_trainer_matches_jax(name, folder, jax_fits, torch_42, torch_24,
                             torch_1d):
    c = CASES[name]
    want = jax_fits[name]
    for got in runs_of(name, folder, torch_42, torch_24, torch_1d):
        assert got["mode"] == str(want["mode"])
        np.testing.assert_array_equal(got["evals"], want["evals"])
        if c["kind"] == "cd-adam":
            flip_budget(got, want)
            continue
        np.testing.assert_allclose(got["loss"], want["loss"], **CHAIN_TOL)
        for key in (k for k in want if k.startswith("p")):
            np.testing.assert_allclose(got[key], want[key], **CHAIN_TOL,
                                       err_msg=f"{name} {key}")
        if c.get("damping"):
            np.testing.assert_allclose(got["level"], want["level"],
                                       rtol=1e-5)


@pytest.mark.parametrize("kind", ["d-adam", "cd-adam"])
@pytest.mark.parametrize("factor", ["K4xM2", "K2xM4"])
def test_sharded_equals_reference(kind, factor, folder, jax_fits, torch_42,
                                  torch_24, torch_1d):
    """The chain of ``tests/test_grad_pipeline.py``: the port's sharded
    run against JAX's reference run of the same K (so a gradient scaled by
    M could not pass)."""
    want = jax_fits[f"reference-{kind}-K{factor[1]}"]
    for got in runs_of(f"sharded-{kind}-{factor}", folder, torch_42,
                       torch_24, torch_1d):
        if kind == "cd-adam":
            flip_budget(got, want)
        else:
            np.testing.assert_allclose(got["loss"], want["loss"],
                                       **CHAIN_TOL)
            np.testing.assert_allclose(got["p1"], want["p1"], **CHAIN_TOL)


def test_sharded_microbatch_equals_microbatch_1(torch_42):
    """Gradient accumulation in the sharded mode: microbatch 2 against
    microbatch 1 over the same 4 steps (JAX's tolerance for it)."""
    for r in torch_42:
        one, two = r["sharded-microbatch-1"], r["sharded-microbatch-2"]
        assert two["mode"] == "sharded-packed"
        for key in ("p0", "p1"):
            np.testing.assert_allclose(two[key], one[key], rtol=1e-4,
                                       atol=1e-6)


@pytest.mark.parametrize("name", sorted(
    n for n, c in CASES.items() if c["mode"] == "axis2d"
    and (c["K"], c["M"]) == (4, 2)))
def test_model_group_collectives(name, torch_42):
    """No model-group all-gather in the sharded-packed mode (the loss's
    sums only); the packed mode gathers the worker's blocks once a
    step."""
    c = CASES[name]
    for r in torch_42:
        coll = r[name]["collectives"]
        if c.get("sharded"):
            assert coll["model_all_gather"]["count"] == 0
            assert coll["model_sum"]["count"] > 0
        else:
            assert coll["model_all_gather"]["count"] == c["steps"]
        assert coll["exchange"]["count"] > 0


def test_sharded_loss_without_2d_optimizer_is_not_used():
    opt = make_optimizer("d-adam", 4, backend="packed", device="cpu")
    pipe = make_grad_pipeline(lambda p, b: p["x"].sum(1), opt,
                              sharded_loss=ranks.sharded_quad_loss)
    assert pipe.mode == "packed"
    tr = DecentralizedTrainer(lambda p, b: p["x"].sum(1), opt,
                              sharded_loss=ranks.sharded_quad_loss)
    assert tr.pipeline.mode == "packed"
    # a plan (tests/test_torch_plan.py) without a 2D optimizer is not used
    # either, as in JAX; on the 2D packed mode a family that is not dense
    # raises (the MoE and vision-language slices come next)
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import WorkerGroup
    from repro_torch.launch.shardings import make_plan

    plan = make_plan(get_reduced("llama3.2-1b"), (4, 2))
    assert make_grad_pipeline(lambda p, b: p["x"].sum(1), opt,
                              plan=plan).mode == "packed"
    wg = WorkerGroup(group=None, rank=0, K=4, device=torch.device("cpu"),
                     backend="gloo", M=2)
    opt2d = make_optimizer("d-adam", 4, backend="packed", comm="axis",
                           group=wg)
    assert make_grad_pipeline(lambda p, b: p["x"].sum(1), opt2d,
                              plan=plan).mode == "planned"
    with pytest.raises(NotImplementedError, match="ROADMAP queue 4.3"):
        make_grad_pipeline(lambda p, b: p["x"].sum(1), opt2d,
                           plan=make_plan(get_reduced("rwkv6-3b"), wg))


CLI = ["--device", "cpu", "--comm", "axis", "--workers", "2", "--backend",
       "packed", "--steps", "4", "--period", "2", "--seq", "16", "--batch",
       "1", "--log-every", "2", "--dist-backend", "gloo"]


@pytest.mark.parametrize("optimizer", ["d-adam", "cd-adam"])
def test_cli_model_parallel_2_matches_model_parallel_1(optimizer):
    """The CLI's run on its ranks (``launch.train._run``) at
    ``--model-parallel`` 2 (the sharding plan: each rank multiplies with
    its shards, so the products sum in another order) against 1, at f32
    compute: at the reduced configs' bf16 the two part by bf16 rounding,
    as JAX's planned and unplanned runs do (2e-4 at step 1);
    tests/test_torch_plan.py runs the CLI itself at bf16."""
    argv = CLI + ["--optimizer", optimizer]
    one = spawn(ranks.cli_f32_rank, 2, (argv,), timeout_s=SPAWN_TIMEOUT_S,
                threads=1)[0]
    two = spawn(ranks.cli_f32_rank, 4, (argv + ["--model-parallel", "2"],),
                timeout_s=SPAWN_TIMEOUT_S, threads=1)[0]
    assert two["mode"] == "planned"
    assert two["n_params"] == one["n_params"]
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-4)
    np.testing.assert_allclose(two["comm_mb"], one["comm_mb"])
    assert two["grad_evals"] == one["grad_evals"]


@pytest.mark.parametrize("flags,match", [
    (["--model-parallel", "2"], "--comm axis"),
    (["--comm", "axis", "--model-parallel", "2"], "--backend packed"),
    (["--model-parallel", "0"], "must be >= 1")])
def test_cli_model_parallel_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        train_cli.main(["--device", "cpu", "--steps", "1"] + flags)
