"""comm='axis': one worker per process over torch.distributed, against the
JAX package's comm='axis' (one controller, shard_map over a 'worker' mesh).

* Validation: the JAX package's refusals (``tests/test_comm_axis.py``
  ``TestValidation`` / ``TestMeshValidation``), in-process: no group, a
  group of another size or axis name, dense mixing, a topology without
  shift offsets, D-PSGD, CD-Adam staleness; damping, elastic resize and
  online publish accepted under a group.
* Port against JAX: the same numpy inputs (the ragged tree of
  ``tests/test_comm_axis.py``, K=4, weight decay 0.01, grads ``0.5 x +
  0.1 noise_t``) go through the port's axis runs, 4 gloo ranks spawned on
  the CPU, and through JAX's axis runs, made in a subprocess with 8
  forced host devices as ``tests/test_distributed.py`` makes them. Both
  backends of D-Adam and CD-Adam at p=2 for 4 steps; D-Adam staleness
  tau=2 with an arrival mask drawn in numpy and handed to both packages;
  overlap; the one-peer-exponential schedule; the torus. f32 within rtol
  2e-5 / atol 1e-6 (JAX's own axis-vs-stacked tolerance), int8 payloads
  and ages exactly, packed buffers element by element. The bytes per
  worker per round are the stacked path's.
* Small K: K=3 (a rank's two neighbours differ) and K=2 (one offset),
  axis against the port's stacked run.

Every group has a 60 s collective timeout and every spawn a deadline, so
a hang fails its test and not the suite.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _axis_ranks as ranks
from repro_torch.core.api import make_optimizer
from repro_torch.core.cdadam import CDAdamConfig
from repro_torch.core.dadam import DAdamConfig
from repro_torch.core.topology import Topology
from repro_torch.launch.mesh import WorkerGroup, make_worker_group, spawn

K = 4
FTOL = dict(rtol=2e-5, atol=1e-6)
SPAWN_TIMEOUT_S = 240
ADAM = dict(eta=1e-2, weight_decay=0.01)
STRAGGLE = dict(staleness=2, straggler_rate=0.3, masks="masks")


def case(kind, backend, steps=4, period=2, K=K, **opt):
    return dict(kind=kind, backend=backend, steps=steps, K=K,
                opt=dict(ADAM, period=period, **opt))


CASES = {
    **{f"{kind}-{backend}": case(kind, backend)
       for kind in ("d-adam", "cd-adam")
       for backend in ("reference", "packed")},
    **{f"d-adam-tau2-{backend}": case("d-adam", backend, period=1,
                                      **STRAGGLE)
       for backend in ("reference", "packed")},
    **{f"{kind}-overlap-{backend}": case(kind, backend, period=1,
                                         overlap=True)
       for kind in ("d-adam", "cd-adam")
       for backend in ("reference", "packed")},
    **{f"{kind}-one-peer-exp-{backend}": case(kind, backend, period=1,
                                              topology="one-peer-exp")
       for kind, backend in (("d-adam", "reference"), ("d-adam", "packed"),
                             ("cd-adam", "packed"))},
    **{f"{kind}-torus-packed": case(kind, "packed", period=1,
                                    topology="torus")
       for kind in ("d-adam", "cd-adam")},
}
STEPS = max(c["steps"] for c in CASES.values())


def write_inputs(path, k=K, seed=0):
    """The ragged tree, the noise of every step and the straggler masks
    (round r's (K, 2) arrivals of the ring), drawn in numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (k, 13, 7), "b": (k, 5), "u": (k, 3, 11, 2)}
    arrays = {}
    for prefix in ["params"] + [f"noise{t}" for t in range(STEPS)]:
        for name, shape in shapes.items():
            arrays[f"{prefix}/{name}"] = rng.standard_normal(shape).astype(
                np.float32)
    arrays["masks"] = rng.random((STEPS, k, 2)) >= 0.3
    np.savez(path, **arrays)


JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    # a larger thread pool and a longer collective wait than XLA's CPU
    # defaults (one thread a core, 40 s), so that a loaded host does not
    # abort the reference; neither changes a number
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=8 "
        "--xla_cpu_collective_call_terminate_timeout_seconds=300")
    os.environ["PJRT_NPROC"] = "32"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.core import dadam as jdadam
    from repro.core import make_optimizer
    from repro.kernels import pack as packing

    assert jax.device_count() == 8, jax.device_count()
    inputs = dict(np.load(sys.argv[1]))
    cases = json.loads(sys.argv[2])
    original_mask = jdadam._arrival_mask

    def tree(prefix):
        return {"b": jnp.asarray(inputs[prefix + "/b"]),
                "nest": {"u": jnp.asarray(inputs[prefix + "/u"])},
                "w": jnp.asarray(inputs[prefix + "/w"])}

    def dump(st):
        out = {}
        g = lambda x: np.asarray(jax.device_get(x))
        leaves = jax.tree_util.tree_leaves
        if hasattr(st, "buf"):
            out.update(buf=g(st.buf), m=g(st.m), v=g(st.v))
            if hasattr(st, "hat_buf"):
                out["hat"] = g(st.hat_buf)
                for i, h in enumerate(st.hat_nbr_bufs):
                    out[f"nbr{i}"] = g(h)
                for i, ring in enumerate(st.pending or ()):
                    out[f"ring{i}_q"] = g(ring["q"])
                    out[f"ring{i}_scale"] = g(ring["scale"])
        else:
            for name, t in (("p", st.params), ("m", st.moments.m),
                            ("v", st.moments.v)):
                for j, x in enumerate(leaves(t)):
                    out[f"{name}{j}"] = g(x)
            if hasattr(st, "hat_self"):
                for j, x in enumerate(leaves(st.hat_self)):
                    out[f"hat{j}"] = g(x)
                for i, h in enumerate(st.hat_nbrs):
                    for j, x in enumerate(leaves(h)):
                        out[f"nbr{i}_{j}"] = g(x)
        stale = getattr(st, "stale", None)
        if stale is not None:
            for i, b in enumerate(stale.bufs):
                for j, x in enumerate(leaves(b)):
                    out[f"stale{i}_{j}"] = g(x)
            out["age"] = g(stale.age)
        return out

    results = {}
    for name, c in cases.items():
        K = c["K"]
        mesh = Mesh(np.array(jax.devices()[:K]), ("worker",))
        kw = dict(c["opt"])
        masks = kw.pop("masks", None)
        if masks is not None:
            table = jnp.asarray(inputs[masks])
            jdadam._arrival_mask = (
                lambda cfg, r, K, deg, table=table:
                jdadam._local_worker_rows(table[r], cfg))
        else:
            jdadam._arrival_mask = original_mask
        backend = {"reference": "reference", "packed": "pallas"}[
            c["backend"]]
        opt = make_optimizer(c["kind"], K=K, backend=backend, comm="axis",
                             mesh=mesh, **kw)
        st = opt.init(tree("params"))
        step = jax.jit(opt.step)
        for t in range(c["steps"]):
            g = jax.tree_util.tree_map(lambda x, n: 0.5 * x + 0.1 * n,
                                       opt.params_of(st),
                                       tree(f"noise{t}"))
            if backend == "pallas":
                g = packing.pack(g, st.spec, dtype=st.buf.dtype)
            st = step(st, g)
        for key, val in dump(st).items():
            results[f"{name}|{key}"] = val
    np.savez(sys.argv[3], **results)
""")


def run_jax(inputs, cases, out):
    """JAX's comm='axis' runs of ``cases``, in a subprocess with 8 host
    devices (the main process keeps jax's one)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, str(inputs), json.dumps(cases),
         str(out)], capture_output=True, text=True, env=env,
        timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        res = {}
        for key in data.files:
            name, field = key.split("|")
            res.setdefault(name, {})[field] = data[key]
    return res


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("axis") / "inputs.npz"
    write_inputs(path)
    return path


@pytest.fixture(scope="module")
def jax_axis(inputs):
    return run_jax(inputs, CASES, inputs.parent / "jax.npz")


@pytest.fixture(scope="module")
def torch_axis(inputs):
    results = spawn(ranks.parity_rank, K, (CASES, str(inputs)),
                    timeout_s=SPAWN_TIMEOUT_S, threads=1)
    return results


def assert_dumps_close(ours: dict, theirs: dict, what: str):
    """Integers (int8 payloads, ages) exactly; floats within FTOL, element
    by element."""
    assert sorted(ours) == sorted(theirs), what
    for key in theirs:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert a.shape == b.shape, (what, key, a.shape, b.shape)
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {key}")
        else:
            np.testing.assert_allclose(a, b, **FTOL,
                                       err_msg=f"{what} {key}")


# ------------------------------ validation ----------------------------------


def fake_group(k=K, axis_name="worker"):
    """A group object for the construction-time checks, which make no
    collective call."""
    return WorkerGroup(group=None, rank=0, K=k, device=torch.device("cpu"),
                       backend="gloo", axis_name=axis_name)


class TestValidation:
    def test_axis_without_group_rejected(self):
        with pytest.raises(ValueError, match="mesh="):
            make_optimizer("d-adam", K, device="cpu", comm="axis")

    def test_group_without_axis_comm_rejected(self):
        with pytest.raises(ValueError, match="comm='axis'"):
            make_optimizer("d-adam", K, device="cpu", group=fake_group())

    def test_unknown_comm_rejected(self):
        with pytest.raises(ValueError, match="comm"):
            DAdamConfig(comm="bogus").validate()

    def test_empty_axis_name_rejected(self):
        with pytest.raises(ValueError, match="axis_name"):
            DAdamConfig(comm="axis", axis_name="").validate()

    def test_dense_mixing_under_axis_rejected(self):
        with pytest.raises(ValueError, match="dense"):
            DAdamConfig(comm="axis", mixing="dense").validate()

    def test_dpsgd_axis_rejected(self):
        with pytest.raises(ValueError, match="d-psgd"):
            make_optimizer("d-psgd", K, comm="axis", group=fake_group())

    def test_wrong_group_size_rejected(self):
        with pytest.raises(ValueError, match="size K"):
            make_optimizer("d-adam", K + 1, comm="axis", group=fake_group())

    def test_wrong_axis_name_rejected(self):
        with pytest.raises(ValueError, match="axis"):
            make_optimizer("d-adam", K, comm="axis",
                           group=fake_group(axis_name="pod"))

    def test_non_shift_topology_rejected_at_construction(self):
        W = np.full((K, K), 1.0 / K)
        no_offsets = Topology(name="dense-no-offsets", weights=W,
                              offsets=(), offset_weights=(),
                              self_weight=1.0 / K)
        with pytest.raises(ValueError, match="shift-invariant"):
            make_optimizer("d-adam", K, topology=no_offsets, comm="axis",
                           group=fake_group())

    def test_cdadam_staleness_under_axis_rejected(self):
        with pytest.raises(ValueError, match="staleness"):
            CDAdamConfig(comm="axis", staleness=1).validate()
        with pytest.raises(ValueError, match="staleness"):
            make_optimizer("cd-adam", K, comm="axis", group=fake_group(),
                           staleness=2)
        # overlap (the delay-1 ring) is wired under axis, as in JAX
        assert make_optimizer("cd-adam", K, comm="axis", group=fake_group(),
                              overlap=True).cfg.overlap

    def test_device_must_be_the_groups(self):
        opt = make_optimizer("d-adam", K, comm="axis", group=fake_group())
        assert opt.device == torch.device("cpu") and opt.group.K == K
        with pytest.raises(ValueError, match="group's"):
            make_optimizer("d-adam", K, comm="axis", group=fake_group(),
                           device="meta")

    def test_damping_resize_and_online_publish_accepted_under_axis(
            self, tmp_path, monkeypatch):
        import torch.distributed as dist

        from repro_torch.core.elastic import resize_state
        from repro_torch.serve.publish import ParamStore
        from repro_torch.train.loop import DecentralizedTrainer
        from repro_torch.train.online import train_online

        loss = lambda p, b: ((p["x"] - b) ** 2).sum(dim=1)
        axis = make_optimizer("d-adam", K, comm="axis", group=fake_group())
        # damping under axis is ported (tests/test_torch_grad_2d.py): the
        # trainer keeps the global (K,) damping state on every rank
        tr = DecentralizedTrainer(loss, axis, damping="adadamp:2")
        assert tr.pipeline.damping_chunks == 2
        assert tr.damp_state.level.shape == (1,)
        # a resize onto an axis optimizer names the old group too
        stacked = make_optimizer("d-adam", K, device="cpu")
        with pytest.raises(ValueError, match="group="):
            resize_state(stacked.init({"x": torch.zeros(K, 3)}), axis)
        # elastic resize and online publish are accepted under a group
        # (a world of one rank here; 8 ranks in
        # tests/test_torch_elastic_axis.py and test_torch_online_axis.py)
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        wg = make_worker_group(1, init_method=f"file://{tmp_path}/store",
                               rank=0, device="cpu", backend="gloo",
                               timeout_s=60)
        try:
            one = make_optimizer("d-adam", 1, comm="axis", group=wg)
            trainer = DecentralizedTrainer(loss, one)
            res = train_online(trainer, trainer.init({"x": torch.zeros(3)}),
                               iter([torch.ones(1, 3)]), 1,
                               store=ParamStore(), publish_every=1)
            assert res.published == [(1, 1)]
            state = resize_state(res.state, make_optimizer(
                "d-adam", 1, comm="axis", group=wg), group=wg)
            assert state.moments.count == 1
        finally:
            dist.destroy_process_group()

    def test_group_checks_backend_and_rank(self, monkeypatch):
        monkeypatch.delenv("RANK", raising=False)
        with pytest.raises(ValueError, match="rank"):
            make_worker_group(2, device="cpu", init_method="file:///x")
        with pytest.raises(ValueError, match="nccl needs CUDA"):
            make_worker_group(2, backend="nccl", device="cpu", rank=0,
                              init_method="file:///x")


# ---------------------------- port against JAX ------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_axis_matches_jax_axis(name, torch_axis, jax_axis):
    for rank, res in enumerate(torch_axis):
        assert_dumps_close(res[name]["dump"], jax_axis[name],
                           f"{name} rank {rank}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_axis_bytes_per_round_are_the_stacked_paths(name, torch_axis,
                                                    inputs):
    with np.load(inputs) as data:
        stacked = ranks.run_case(CASES[name], data)
    for res in torch_axis:
        assert res[name]["bytes_round_list"] == stacked["bytes_round_list"]
    # the reference D-Adam ring sends each leaf once per offset a round:
    # the accounting's bytes, to the byte
    if name == "d-adam-reference":
        rounds = CASES[name]["steps"] // CASES[name]["opt"]["period"]
        for res in torch_axis:
            assert res[name]["sent"] == (
                rounds * stacked["bytes_round_list"][0], rounds * 2 * 3)


# ------------------------------- small K ------------------------------------


SMALL = {k: {f"{kind}-{backend}": case(kind, backend, K=k)
             for kind in ("d-adam", "cd-adam")
             for backend in ("reference", "packed")}
         for k in (2, 3)}


@pytest.mark.parametrize("k", sorted(SMALL))
def test_small_k_axis_matches_stacked(k, tmp_path):
    path = tmp_path / "inputs.npz"
    write_inputs(path, k=k, seed=k)
    results = spawn(ranks.parity_rank, k, (SMALL[k], str(path)),
                    timeout_s=SPAWN_TIMEOUT_S, threads=1)
    with np.load(path) as data:
        for name, c in SMALL[k].items():
            want = ranks.run_case(c, data)["dump"]
            for rank, res in enumerate(results):
                assert_dumps_close(res[name]["dump"], want,
                                   f"K={k} {name} rank {rank}")
