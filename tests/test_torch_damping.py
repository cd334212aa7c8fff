"""Adaptive batch damping on the port against the JAX package: the policies
(``train.damping``), the damped grad pipelines, the damped trainer and the
training CLI's ``--damping``.

Inputs are made from seeds with numpy (or by the JAX package's generators
and handed across as numpy) and fed to both packages. Chunk counts,
``t``, ``at_max`` and ``evals`` must be equal; the f32 signals (``ema_loss``,
``loss0``, ``level``) within rtol 1e-6; losses within f32 rtol = atol =
2e-5 and grads and params within the optimizer-state tolerance (rtol 2e-5,
atol 2e-6), as ``tests/test_torch_train.py`` holds the undamped ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_optimizer as jax_make_optimizer
from repro.data import ctr_batch_stacked as jax_ctr_batch_stacked
from repro.data import make_ctr_task
from repro.models import deepfm as jdeepfm
from repro.train import DecentralizedTrainer as JaxTrainer
from repro.train import damping as jdamping
from repro.train.grad import make_grad_pipeline as jax_make_grad_pipeline
from repro_torch import convert
from repro_torch._tree import tree_leaves
from repro_torch.core.api import make_optimizer
from repro_torch.launch import train as train_cli
from repro_torch.models import deepfm
from repro_torch.train import damping
from repro_torch.train.grad import make_grad_pipeline
from repro_torch.train.loop import DecentralizedTrainer

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
FTOL = dict(rtol=2e-5, atol=2e-6)
SIGNAL_TOL = dict(rtol=1e-6, atol=0.0)
K, F, FPF, E, HIDDEN, B, C = 8, 4, 16, 4, (16, 16), 32, 4
TASK = make_ctr_task(seed=0, n_fields=F, features_per_field=FPF,
                     embed_dim=E)
BACKENDS = {"pallas": "packed", "reference": "reference"}
# per-worker live-chunk counts that differ between workers
MIXED_N = [1, 2, 3, 4, 4, 3, 2, 1]

# (policy, config extras): each policy with a non-default knob
POLICIES = {"adadamp": dict(max_chunks=8, ema=0.7),
            "padadamp": dict(max_chunks=6, rate=0.4),
            "geodamp": dict(max_chunks=8, factor=1.5, delay=2)}


def configs(policy, per_worker):
    kw = dict(policy=policy, per_worker=per_worker, **POLICIES[policy])
    return jdamping.DampingConfig(**kw), damping.DampingConfig(**kw)


def loss_sequence(steps, workers, seed=0):
    """A falling loss with noise and spikes, f32, one row per step."""
    rng = np.random.default_rng(seed)
    trend = np.exp(-0.15 * np.arange(steps))[:, None]
    return (2.0 * trend * (1 + 0.3 * rng.standard_normal((steps, workers)))
            ** 2 + 0.05).astype(np.float32)


def assert_states_equal(t_state, j_state):
    for name in ("t", "at_max", "evals"):
        assert int(getattr(t_state, name)) == int(getattr(j_state, name))
        assert getattr(t_state, name).dtype == torch.int32
    for name in ("ema_loss", "loss0", "level"):
        got = getattr(t_state, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(j_state, name)),
                                   **SIGNAL_TOL)


# --------------------------------- policies ---------------------------------


@pytest.mark.parametrize("per_worker", [False, True])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_update_follows_jax_over_a_loss_sequence(policy, per_worker):
    jcfg, tcfg = configs(policy, per_worker)
    workers = 3
    js = jdamping.init_damping(jcfg, workers)
    ts = damping.init_damping(tcfg, workers, "cpu")
    assert_states_equal(ts, js)
    for row in loss_sequence(16, workers):
        jn = jdamping.chunks_of(js, jcfg, workers)
        tn = damping.chunks_of(ts, tcfg, workers)
        assert tn.dtype == torch.int32
        assert tn.tolist() == np.asarray(jn).tolist()
        js = jdamping.update(js, jnp.asarray(row), jcfg)
        ts = damping.update(ts, torch.from_numpy(row), tcfg)
        assert_states_equal(ts, js)
    # the sequence took every policy off its floor
    assert int(ts.evals) > 16 * workers


class NoSync(torch.utils._python_dispatch.TorchDispatchMode):
    """Fails on a tensor's conversion to a Python number: on the card,
    a host sync."""

    BANNED = {torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.item.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        assert func not in self.BANNED, func
        return func(*args, **(kwargs or {}))


def test_update_and_the_damped_step_make_no_host_sync():
    cfg = damping.DampingConfig(policy="adadamp", max_chunks=4,
                                per_worker=True)
    state = damping.init_damping(cfg, 2, "cpu")
    with NoSync():
        for row in loss_sequence(4, 2):
            n = damping.chunks_of(state, cfg, 2)
            state = damping.update(state, torch.from_numpy(row), cfg)
    assert n.shape == (2,)
    # a whole damped packed step: counts, pipeline, optimizer, update
    tr, tstate = small_trainer(cfg, backend="packed")
    batch = next(regression_batches())
    with NoSync():
        for _ in range(3):
            tstate, loss = tr.step(tstate, batch)
    assert tstate.count == 3 and int(tr.damp_state.t) == 3


@pytest.mark.parametrize("spec", ["adadamp:8", "adadamp:4:0.5",
                                  "padadamp:4:0.5", "geodamp:8:2:50",
                                  "geo_damp:8:3", "PadaDamp", None])
def test_make_damping_parses_as_jax(spec):
    got, want = damping.make_damping(spec), jdamping.make_damping(spec)
    if spec is None:
        assert got is None and want is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert damping.make_damping(got) is got


@pytest.mark.parametrize("spec,kw", [
    ("warp:4", None), ("geodamp:0", None), (None, dict(max_chunks=2,
                                                       min_chunks=3)),
    (None, dict(ema=1.0)), (None, dict(policy="padadamp", rate=0.0)),
    (None, dict(policy="geodamp", factor=1.0)),
    (None, dict(policy="geodamp", delay=0)), (None, dict(lr_decay=0.0)),
    (None, dict(lr_decay_every=-1)), (None, dict(policy="warp"))])
def test_invalid_specs_raise_jax_messages(spec, kw):
    def message(mod):
        with pytest.raises(ValueError) as e:
            if spec is not None:
                mod.make_damping(spec)
            else:
                mod.DampingConfig(**kw)
        return str(e.value)

    assert message(damping) == message(jdamping)


@pytest.mark.parametrize("per_worker", [False, True])
def test_resize_damp_maps_signals_round_robin(per_worker):
    jcfg, tcfg = configs("adadamp", per_worker)
    js = jdamping.init_damping(jcfg, 3)
    ts = damping.init_damping(tcfg, 3, "cpu")
    for row in loss_sequence(5, 3, seed=1):
        js = jdamping.update(js, jnp.asarray(row), jcfg)
        ts = damping.update(ts, torch.from_numpy(row), tcfg)
    for new_k in (2, 5):
        assert_states_equal(damping.resize_damp(ts, tcfg, new_k),
                            jdamping.resize_damp(js, jcfg, new_k))
    if not per_worker:
        assert damping.resize_damp(ts, tcfg, 5) is ts


# ---------------------------- damped pipelines ------------------------------


def jax_params():
    """Stacked JAX DeepFM params, each worker's copy perturbed."""
    p = jdeepfm.init_deepfm(jax.random.PRNGKey(0), TASK.n_features, F, E,
                            HIDDEN)
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(
            np.broadcast_to(np.asarray(x), (K,) + x.shape)
            + 0.01 * rng.standard_normal((K,) + x.shape), jnp.float32), p)


def jax_batch(t=0, per_worker=B):
    return jax.tree_util.tree_map(
        np.asarray, jax_ctr_batch_stacked(
            TASK, jax.random.fold_in(jax.random.PRNGKey(1), t), K,
            per_worker))


def to_port(tree):
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), "cpu")


def close(a, b, **tol):
    la = [np.asarray(x.detach(), np.float32) for x in tree_leaves(a)]
    lb = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, **(tol or TOL))


def port_pipeline(backend, **kw):
    opt = make_optimizer("d-adam", K, backend=BACKENDS[backend],
                         device="cpu")
    return (opt.init(to_port(jax_params())),
            make_grad_pipeline(deepfm.deepfm_loss, opt, **kw))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_damped_pipeline_matches_jax_at_mixed_counts(backend):
    jopt = jax_make_optimizer("d-adam", K, backend=backend)
    jstate = jopt.init(jax_params())
    jpipe = jax_make_grad_pipeline(jdeepfm.deepfm_loss, jopt,
                                   damping_chunks=C)
    tstate, tpipe = port_pipeline(backend, damping_chunks=C)
    assert (tpipe.mode, tpipe.damping_chunks, tpipe.microbatch) == (
        BACKENDS[backend], C, 1)
    batch = jax_batch(3)
    jl, jg = jpipe.value_and_grad(
        jstate, jax.tree_util.tree_map(jnp.asarray, batch),
        jnp.asarray(MIXED_N, jnp.int32))
    tl, tg = tpipe.value_and_grad(
        tstate, convert.params_from_numpy(batch, "cpu"),
        torch.tensor(MIXED_N, dtype=torch.int32))
    close(tl, jl)
    close(tg, jg, **FTOL)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_all_chunks_live_equals_microbatch_to_the_bit(backend):
    state, damped = port_pipeline(backend, damping_chunks=C)
    _, plain = port_pipeline(backend, microbatch=C)
    batch = convert.params_from_numpy(jax_batch(5), "cpu")
    dl, dg = damped.value_and_grad(state, batch,
                                   torch.full((K,), C, dtype=torch.int32))
    pl, pg = plain.value_and_grad(state, batch)
    assert torch.equal(dl, pl)
    for a, b in zip(tree_leaves(dg), tree_leaves(pg)):
        assert torch.equal(a, b)


def test_one_live_chunk_is_the_first_chunk_alone():
    state, damped = port_pipeline("pallas", damping_chunks=C)
    _, plain = port_pipeline("pallas")
    batch = convert.params_from_numpy(jax_batch(6), "cpu")
    first = {k: x[:, :B // C] for k, x in batch.items()}
    dl, dg = damped.value_and_grad(state, batch,
                                   torch.ones((K,), dtype=torch.int32))
    pl, pg = plain.value_and_grad(state, first)
    assert torch.equal(dl, pl) and torch.equal(dg, pg)


def regression_loss(p, b):
    """(K,) mean squared errors of a linear map, one per worker."""
    return torch.mean((torch.bmm(b["x"], p["w"]) - b["y"]) ** 2, dim=(1, 2))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_nan_in_a_masked_chunk_stays_out(backend):
    """A NaN in worker 0's second chunk, which its count of 1 masks, must
    reach neither its loss nor its gradient (a multiply by a 0/1 mask
    would let 0 * nan through); worker 1 sees no NaN."""
    workers, chunks = 2, 2
    rng = np.random.default_rng(3)
    opt = make_optimizer("d-adam", workers, backend=BACKENDS[backend],
                         device="cpu")
    state = opt.init({"w": torch.from_numpy(
        rng.standard_normal((workers, 6, 2)).astype(np.float32))})
    x = rng.standard_normal((workers, 8, 6)).astype(np.float32)
    y = x @ np.ones((6, 2), np.float32)
    x[0, 4:] = np.nan
    pipe = make_grad_pipeline(regression_loss, opt, damping_chunks=chunks)
    losses, grads = pipe.value_and_grad(
        state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        torch.tensor([1, 2], dtype=torch.int32))
    assert bool(torch.isfinite(losses).all())
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


def f32_regression_loss(p, b):
    """``regression_loss`` with the weight read in f32."""
    return regression_loss({"w": p["w"].to(torch.float32)}, b)


def jax_regression_loss(p, b):
    """One worker's ``f32_regression_loss`` on the JAX side."""
    return jnp.mean((b["x"] @ p["w"].astype(jnp.float32) - b["y"]) ** 2)


def bf16_regression(seed=4, b=32):
    """bf16 weights (K, 64, 2) and f32 data whose products and sums are
    exact in f32 (small integers, weights in eighths), so each chunk's
    bf16 gradient is the same on both sides and only the accumulation's
    dtype can part them."""
    rng = np.random.default_rng(seed)
    w = (rng.integers(-16, 17, (K, 64, 2)) / 8).astype(np.float32)
    x = rng.integers(-3, 4, (K, b, 64)).astype(np.float32)
    y = rng.integers(-20, 21, (K, b, 2)).astype(np.float32)
    return w, {"x": x, "y": y}


@pytest.mark.parametrize("kind", ["microbatch", "damped"])
def test_bf16_params_accumulate_in_f32_as_jax(kind):
    """At bf16 params the reference pipeline returns f32 gradients and
    f32 losses equal to JAX's (whose per-worker loop adds into f32
    zeros) within 2e-5 of each leaf's largest entry; an accumulator in
    bf16 misses by up to a bf16 ulp of the sums (2**-9 of them)."""
    w, batch = bf16_regression()
    jopt = jax_make_optimizer("d-adam", K, backend="reference")
    jstate = jopt.init({"w": jnp.asarray(w).astype(jnp.bfloat16)})
    topt = make_optimizer("d-adam", K, backend="reference", device="cpu")
    tstate = topt.init({"w": torch.from_numpy(w).to(torch.bfloat16)})
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    tb = convert.params_from_numpy(batch, "cpu")
    if kind == "microbatch":
        jl, jg = jax_make_grad_pipeline(
            jax_regression_loss, jopt, microbatch=C).value_and_grad(
                jstate, jb)
        tl, tg = make_grad_pipeline(
            f32_regression_loss, topt, microbatch=C).value_and_grad(
                tstate, tb)
    else:
        jl, jg = jax_make_grad_pipeline(
            jax_regression_loss, jopt, damping_chunks=C).value_and_grad(
                jstate, jb, jnp.asarray(MIXED_N, jnp.int32))
        tl, tg = make_grad_pipeline(
            f32_regression_loss, topt, damping_chunks=C).value_and_grad(
                tstate, tb, torch.tensor(MIXED_N, dtype=torch.int32))
    assert jg["w"].dtype == jnp.float32
    assert tg["w"].dtype == torch.float32 and tl.dtype == torch.float32
    want = np.asarray(jg["w"])
    np.testing.assert_allclose(tg["w"].numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    close(tl, jl)


def test_split_micro_names_the_batch_leaf_as_jax():
    """The error names the leaf's path in ``jax.tree_util.keystr``'s form,
    as JAX's ``_split_micro`` does."""
    from repro.train.grad import _split_micro as jax_split
    from repro_torch.train.grad import _split_micro

    tree = {"inner": {"x": np.zeros((6, 3), np.float32)},
            "seq": [np.zeros((6, 2), np.float32)]}
    with pytest.raises(ValueError) as je:
        jax_split(jax.tree_util.tree_map(jnp.asarray, tree), 4, batch_dim=0)
    # the port splits the per-worker dim of stacked (K, b, ...) leaves
    stacked = jax.tree_util.tree_map(lambda a: torch.from_numpy(a[None]),
                                     tree)
    with pytest.raises(ValueError) as te:
        _split_micro(stacked, 4, 0)
    assert str(te.value) == str(je.value)
    assert str(te.value).startswith("batch leaf ['inner']['x']: ")
    with pytest.raises(ValueError, match=r"batch leaf \['seq'\]\[0\]: "):
        _split_micro({"seq": stacked["seq"]}, 4, 0)


def test_tree_paths_are_jax_keystr_paths():
    """``_tree.tree_map_with_path`` names every leaf as
    ``jax.tree_util.keystr`` does, over every node kind ``_tree`` has."""
    import collections
    from typing import NamedTuple

    from repro_torch._tree import keystr, tree_map_with_path

    class Pair(NamedTuple):
        a: int
        b: object

    tree = {"z": [1, (2, None, 3)], "a": Pair(4, {"y": 5}),
            "o": collections.OrderedDict([("q", 6), ("b", 7)])}
    got, want = [], []
    tree_map_with_path(lambda p, x: got.append((keystr(p), x)), tree)
    jax.tree_util.tree_map_with_path(
        lambda p, x: want.append((jax.tree_util.keystr(p), x)), tree)
    assert got == want


def test_damping_and_microbatch_are_not_both():
    opt = make_optimizer("d-adam", K, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        make_grad_pipeline(deepfm.deepfm_loss, opt, microbatch=2,
                           damping_chunks=4)
    with pytest.raises(ValueError, match="not both"):
        DecentralizedTrainer(deepfm.deepfm_loss, opt, microbatch=2,
                             damping="adadamp:4")
    with pytest.raises(ValueError, match="damping_chunks must be >= 1"):
        make_grad_pipeline(deepfm.deepfm_loss, opt, damping_chunks=-1)


def test_sharded_damped_path_waits_for_multi_gpu_comm():
    """The sharded damped path is the 2D layout's
    (tests/test_torch_grad_2d.py); without a 2D optimizer a sharded loss
    is not used, as in JAX, and the packed damped path runs. So is a
    sharding plan (tests/test_torch_plan.py): on the 2D packed mode it
    selects the planned damped path for the dense family, and raises for
    a family that is not dense."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import WorkerGroup
    from repro_torch.launch.shardings import make_plan

    opt = make_optimizer("d-adam", K, backend="packed", device="cpu")
    pipe = make_grad_pipeline(deepfm.deepfm_loss, opt, damping_chunks=4,
                              sharded_loss=lambda *a: 0.0)
    assert (pipe.mode, pipe.damping_chunks) == ("packed", 4)
    plan = make_plan(get_reduced("llama3.2-1b"), (K, 2))
    assert DecentralizedTrainer(deepfm.deepfm_loss, opt, damping="adadamp:4",
                                plan=plan).pipeline.mode == "packed"
    wg = WorkerGroup(group=None, rank=0, K=K, device=torch.device("cpu"),
                     backend="gloo", M=2)
    opt2d = make_optimizer("d-adam", K, backend="packed", comm="axis",
                           group=wg)
    tr = DecentralizedTrainer(deepfm.deepfm_loss, opt2d, damping="adadamp:4",
                              plan=plan)
    assert (tr.pipeline.mode, tr.pipeline.damping_chunks) == ("planned", 4)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 4.3"):
        DecentralizedTrainer(deepfm.deepfm_loss, opt2d, damping="adadamp:4",
                             plan=make_plan(get_reduced("zamba2-7b"), wg))


# --------------------------------- trainer ----------------------------------


def trajectories(backend, damping_spec, steps=6, period=2):
    """The JAX and the port trainers from one init and one set of batches,
    damped by the spec string ``damping_spec``: ``(jax trainer, jax state,
    jax log, port trainer, port state, port log)``."""
    kw = dict(eta=1e-2, period=period, topology="ring")
    p0 = jdeepfm.init_deepfm(jax.random.PRNGKey(0), TASK.n_features, F, E,
                             HIDDEN)
    batches = [jax_batch(t) for t in range(steps)]
    jtr = JaxTrainer(jdeepfm.deepfm_loss, jax_make_optimizer(
        "d-adam", K, backend=backend, **kw), damping=damping_spec)
    js, jlog = jtr.fit(jtr.init(p0), iter(
        jax.tree_util.tree_map(jnp.asarray, b) for b in batches), steps,
        log_every=1)
    ttr = DecentralizedTrainer(deepfm.deepfm_loss, make_optimizer(
        "d-adam", K, device="cpu", backend=BACKENDS[backend], **kw),
        damping=damping_spec)
    ts, tlog = ttr.fit(ttr.init(to_port(p0)), iter(
        convert.params_from_numpy(b, "cpu") for b in batches), steps,
        log_every=1)
    return jtr, js, jlog, ttr, ts, tlog


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_geodamp_trajectory_tracks_jax(backend):
    jtr, js, jlog, ttr, ts, tlog = trajectories(backend,
                                                f"geodamp:{C}:2:2")
    # counts 1, 1, 2, 2, 4, 4 a worker
    assert tlog.grad_evals == jlog.grad_evals == [
        K * c for c in (1, 2, 4, 6, 10, 14)]
    np.testing.assert_allclose(tlog.loss, jlog.loss, **TOL)
    np.testing.assert_allclose(tlog.comm_mb, jlog.comm_mb, rtol=1e-12)
    close(ttr.opt.params_of(ts), jtr.opt.params_of(js), **FTOL)
    assert_states_equal(ttr.damp_state, jtr.damp_state)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_per_worker_adadamp_trajectory_tracks_jax(backend):
    """Per-worker signals on non-IID shards: the counts part between
    workers and stay equal to JAX's, step by step. JAX runs its reference
    backend here: at these chunks of 8 examples its jitted pallas step
    parts from its own reference step at step 5 by 0.25 eta in the first
    layer (a ReLU gate its first-layer product rounds the other way, which
    Adam's normalised step turns into a whole step), while the port's two
    backends stay within 2.1e-7 of each other and of JAX's reference."""
    spec = damping.DampingConfig(policy="adadamp", max_chunks=C, ema=0.0,
                                 per_worker=True)
    jspec = jdamping.DampingConfig(**dataclasses.asdict(spec))
    steps = 6
    p0 = jdeepfm.init_deepfm(jax.random.PRNGKey(0), TASK.n_features, F, E,
                             HIDDEN)
    kw = dict(eta=1e-2, period=2, topology="ring")
    jtr = JaxTrainer(jdeepfm.deepfm_loss, jax_make_optimizer(
        "d-adam", K, backend="reference", **kw), damping=jspec)
    ttr = DecentralizedTrainer(deepfm.deepfm_loss, make_optimizer(
        "d-adam", K, device="cpu", backend=BACKENDS[backend], **kw),
        damping=spec)
    js, ts = jtr.init(p0), ttr.init(to_port(p0))
    counts = []
    for t in range(steps):
        batch = jax_batch(t)
        jn = np.asarray(jdamping.chunks_of(jtr.damp_state, jspec, K))
        tn = damping.chunks_of(ttr.damp_state, spec, K).numpy()
        np.testing.assert_array_equal(tn, jn)
        counts.append(tn.tolist())
        js, jlog = jtr.fit(js, iter([jax.tree_util.tree_map(jnp.asarray,
                                                            batch)]), 1)
        ts, tlog = ttr.fit(ts, iter([convert.params_from_numpy(batch,
                                                               "cpu")]), 1)
        np.testing.assert_allclose(tlog.loss, jlog.loss, **TOL)
        assert tlog.grad_evals == jlog.grad_evals
    assert any(len(set(c)) > 1 for c in counts), counts
    close(ttr.opt.params_of(ts), jtr.opt.params_of(js), **FTOL)
    assert_states_equal(ttr.damp_state, jtr.damp_state)


def small_trainer(damping_spec, K_=2, **kw):
    opt = make_optimizer("d-adam", K_, eta=1e-2, period=2, device="cpu",
                         **kw)
    tr = DecentralizedTrainer(regression_loss, opt, damping=damping_spec)
    return tr, tr.init({"w": torch.from_numpy(np.random.default_rng(0)
                                              .standard_normal((6, 2))
                                              .astype(np.float32) * 0.1)})


def regression_batches(K_=2, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    while True:
        x = rng.standard_normal((K_, batch, 6)).astype(np.float32)
        yield {"x": torch.from_numpy(x),
               "y": torch.from_numpy(x @ np.ones((6, 2), np.float32))}


def test_lr_decay_rebuilds_with_smaller_eta():
    """min == max chunks puts every step at the ceiling: after
    lr_decay_every such steps the trainer rebinds to opt.rebuild with the
    decayed eta (``tests/test_damping.py``'s schedule)."""
    tr, state = small_trainer(damping.DampingConfig(
        policy="geodamp", max_chunks=2, min_chunks=2, factor=2.0, delay=1,
        lr_decay=0.5, lr_decay_every=4))
    first = tr.opt
    state, _ = tr.fit(state, regression_batches(), 4, log_every=4)
    assert tr.opt.cfg.eta == pytest.approx(5e-3) and tr.opt is not first
    state, log = tr.fit(state, regression_batches(seed=1), 8, log_every=4)
    assert tr.opt.cfg.eta == pytest.approx(1.25e-3)
    assert int(tr.damp_state.at_max) == 12
    assert log.grad_evals == [2 * 2 * 4, 2 * 2 * 8]


def test_evals_continue_across_resumed_fits():
    spec = "geodamp:4:2:2"
    tr, state = small_trainer(spec)
    it = regression_batches()
    state, log = tr.fit(state, it, 3, log_every=2)
    state, log = tr.fit(state, it, 3, log_every=2, log=log)
    one, ostate = small_trainer(spec)
    _, olog = one.fit(ostate, regression_batches(), 6, log_every=1)
    # counts 1, 1, 2, 2, 4, 4 a worker
    assert olog.grad_evals == [2, 4, 8, 12, 20, 28]
    assert log.grad_evals == [4, 8, 20, 28] and log.grad_evals_total == 28
    assert int(tr.damp_state.evals) == 28
    # a fresh log counts the call's own evaluations
    state, fresh = tr.fit(state, it, 2, log_every=2)
    assert fresh.grad_evals == [16]


def test_resize_carries_per_worker_signals():
    spec = damping.DampingConfig(policy="adadamp", max_chunks=4, ema=0.0,
                                 per_worker=True)
    tr, state = small_trainer(spec, K_=4)
    state, log = tr.fit(state, regression_batches(4), 4, log_every=4)
    before = tr.damp_state
    small = make_optimizer("d-adam", 3, eta=1e-2, period=2, device="cpu")
    state = tr.resize(state, small)
    after = tr.damp_state
    assert tr.opt is small and state.params["w"].shape == (3, 6, 2)
    for name in ("ema_loss", "loss0", "level"):
        assert torch.equal(getattr(after, name), getattr(before, name)[:3])
    assert int(after.evals) == int(before.evals)
    state, log = tr.fit(state, regression_batches(3), 2, log_every=2,
                        log=log)
    assert log.grad_evals[-1] == int(tr.damp_state.evals)
    assert tr.pipeline.damping_chunks == 4


def test_trainer_damping_state_lives_on_the_optimizer_device():
    tr, _ = small_trainer("adadamp:2")
    assert all(x.device.type == "cpu" for x in tr.damp_state)
    assert tr.damp_state.level.shape == (1,)


# ------------------------------- the CLI ------------------------------------


def test_train_cli_damping_on_the_cpu(capsys):
    run = train_cli.main(["--device", "cpu", "--workers", "2", "--steps",
                          "4", "--period", "2", "--seq", "8", "--batch",
                          "2", "--backend", "packed", "--log-every", "2",
                          "--damping", "geodamp:2:2:2",
                          "--damping-per-worker"])
    out = capsys.readouterr().out
    assert ("[train] batch damping: geodamp chunks 1..2 (per-worker "
            "signal)") in out
    # counts 1, 1, 2, 2 a worker
    assert run.log.grad_evals == [4, 12] and "evals=12" in out
    assert run.trainer.damp_state.level.shape == (2,)
    assert all(np.isfinite(run.log.loss))


def test_train_cli_damping_must_divide_the_batch():
    with pytest.raises(SystemExit, match="must divide --batch 2"):
        train_cli.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                        "--damping", "adadamp:4"])
    with pytest.raises(ValueError, match="not both"):
        train_cli.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                        "--damping", "adadamp:2", "--microbatch", "2"])
