"""The port's model, grad pipeline and trainer against the JAX package's.

A small DeepFM (K=8 workers, 4 fields x 16 features, embed 4, hidden
(16, 16)) with weights carried across by ``repro_torch.convert`` and
batches made by JAX's ``ctr_batch_stacked`` and passed as numpy (random
streams do not cross packages). f32 tolerance rtol = atol = 2e-5 for
losses and logits, the optimizer-state tolerance (rtol 2e-5, atol 2e-6)
for grads and params; any other tolerance says why.
"""
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
from repro.train.grad import make_grad_pipeline as jax_make_grad_pipeline
from repro.train.metrics import auc as jax_auc
from repro_torch import convert
from repro_torch._tree import tree_leaves
from repro_torch.core.api import make_optimizer
from repro_torch.data import synthetic
from repro_torch.models import deepfm
from repro_torch.train.grad import make_grad_pipeline
from repro_torch.train.loop import DecentralizedTrainer, stack_params
from repro_torch.train.metrics import auc

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
FTOL = dict(rtol=2e-5, atol=2e-6)
K, F, FPF, E, HIDDEN, B = 8, 4, 16, 4, (16, 16), 32
TASK = make_ctr_task(seed=0, n_fields=F, features_per_field=FPF,
                     embed_dim=E)
MODELS = {"deepfm": (jdeepfm.deepfm_logits, jdeepfm.deepfm_loss,
                     deepfm.deepfm_logits, deepfm.deepfm_loss),
          "widedeep": (jdeepfm.widedeep_logits, jdeepfm.widedeep_loss,
                       deepfm.widedeep_logits, deepfm.widedeep_loss)}


def jax_params(perturb=True):
    """Stacked JAX params; each worker's copy perturbed, so a mixed-up
    worker index shows."""
    p = jdeepfm.init_deepfm(jax.random.PRNGKey(0), TASK.n_features, F, E,
                            HIDDEN)
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(
            np.broadcast_to(np.asarray(x), (K,) + x.shape)
            + (0.01 * rng.standard_normal((K,) + x.shape) if perturb
               else 0.0), jnp.float32), p)


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


@pytest.mark.parametrize("model", sorted(MODELS))
def test_logits_and_loss_match_jax(model):
    jlogits, jloss, tlogits, tloss = MODELS[model]
    jp, batch = jax_params(), jax_batch()
    tp, tb = to_port(jp), convert.params_from_numpy(batch, "cpu")
    want = jax.vmap(jlogits)(jp, jnp.asarray(batch["feat_ids"]))
    close(tlogits(tp, tb["feat_ids"]), want)
    want = jax.vmap(jloss)(jp, jax.tree_util.tree_map(jnp.asarray, batch))
    close(tloss(tp, tb), want)


def pipelines(backend, microbatch=1):
    jopt = jax_make_optimizer("d-adam", K, backend=backend)
    topt = make_optimizer("d-adam", K,
                          backend="packed" if backend == "pallas"
                          else "reference", device="cpu")
    jp = jax_params()
    return (jopt.init(jp), jax_make_grad_pipeline(
                jdeepfm.deepfm_loss, jopt, microbatch=microbatch),
            topt.init(to_port(jp)), make_grad_pipeline(
                deepfm.deepfm_loss, topt, microbatch=microbatch))


@pytest.mark.parametrize("backend", ["pallas", "reference"])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_grads_match_jax_pipeline(backend, microbatch):
    """Packed mode: the port's gradient, left in ``buf.grad`` by backward
    through unpack's views, equals the packed grads of JAX's
    ``_packed_vag`` (differentiating through ``unpack``)."""
    js, jpipe, ts, tpipe = pipelines(backend, microbatch)
    assert tpipe.mode == ("packed" if backend == "pallas" else "reference")
    batch = jax_batch(3)
    jl, jg = jpipe.value_and_grad(
        js, jax.tree_util.tree_map(jnp.asarray, batch))
    tl, tg = tpipe.value_and_grad(ts, convert.params_from_numpy(batch,
                                                                "cpu"))
    close(tl, jl)
    close(tg, jg, **FTOL)
    if backend == "pallas":
        assert tuple(tg.shape) == ts.spec.buf_shape()
        flat = tg.reshape(K, -1)
        mask = torch.zeros(flat.shape[1], dtype=torch.bool)
        for o, sz in zip(ts.spec.offsets, ts.spec.sizes):
            mask[o:o + sz] = True
        assert torch.count_nonzero(flat[:, ~mask]) == 0


def test_microbatch_must_divide_the_batch():
    _, _, ts, tpipe = pipelines("reference", microbatch=3)
    with pytest.raises(ValueError, match="nearest valid count is 4"):
        tpipe.value_and_grad(ts, convert.params_from_numpy(jax_batch(),
                                                           "cpu"))


@pytest.mark.parametrize("backend", ["pallas", "reference"])
def test_fit_trajectory_tracks_jax(backend):
    """Five steps at period 2 from the same init and batches: per-step
    losses, comm MB and consensus, and the final params."""
    steps, period = 5, 2
    kw = dict(eta=1e-2, period=period, topology="ring")
    jopt = jax_make_optimizer("d-adam", K, backend=backend, **kw)
    topt = make_optimizer("d-adam", K, device="cpu",
                          backend="packed" if backend == "pallas"
                          else "reference", **kw)
    p0 = jdeepfm.init_deepfm(jax.random.PRNGKey(0), TASK.n_features, F, E,
                             HIDDEN)
    batches = [jax_batch(t) for t in range(steps)]
    jtr = JaxTrainer(jdeepfm.deepfm_loss, jopt)
    js, jlog = jtr.fit(jtr.init(p0), iter(
        jax.tree_util.tree_map(jnp.asarray, b) for b in batches), steps,
        log_every=1)
    ttr = DecentralizedTrainer(deepfm.deepfm_loss, topt)
    ts, tlog = ttr.fit(ttr.init(to_port(p0)), iter(
        convert.params_from_numpy(b, "cpu") for b in batches), steps,
        log_every=1)
    assert tlog.step == jlog.step == [1, 2, 3, 4, 5]
    np.testing.assert_allclose(tlog.loss, jlog.loss, **TOL)
    np.testing.assert_allclose(tlog.comm_mb, jlog.comm_mb, rtol=1e-12)
    assert tlog.comm_rounds_total == jlog.comm_rounds_total == 2
    assert tlog.grad_evals == jlog.grad_evals
    # the consensus error is a sum of squared differences between
    # workers' params, each a difference of nearly equal numbers, so its
    # relative rounding error is larger than the params' own
    np.testing.assert_allclose(tlog.consensus, jlog.consensus, rtol=1e-4,
                               atol=1e-9)
    close(topt.params_of(ts), jopt.params_of(js), **FTOL)
    close(ttr.averaged_params(ts), jtr.averaged_params(js), **FTOL)
    assert ttr.comm_mb_per_round(ts) == pytest.approx(
        jtr.comm_mb_per_round(js))


def test_fit_resumes_cumulative_counters():
    opt = make_optimizer("d-adam", K, period=2, device="cpu")
    tr = DecentralizedTrainer(deepfm.deepfm_loss, opt)
    state = tr.init(to_port(jax.tree_util.tree_map(
        lambda x: x[0], jax_params(perturb=False))))
    it = (convert.params_from_numpy(jax_batch(t), "cpu") for t in range(6))
    state, log = tr.fit(state, it, 3, log_every=10)
    state, log = tr.fit(state, it, 3, log_every=10, log=log)
    assert log.step == [3, 6] and log.steps_total == 6
    # the optimizer communicated at steps 2, 4 and 6; the JAX trainer
    # counts the period from each fit call's own start and finds 2 rounds
    assert log.comm_rounds_total == 3
    assert log.comm_mb[-1] == pytest.approx(3 * tr.comm_mb_per_round(state))


def test_stack_params_with_an_injected_init():
    per = {"w": torch.ones(2, 3)}
    same = stack_params(per, 4)
    assert same["w"].shape == (4, 2, 3)
    same["w"][0] += 1     # the copies are independent of each other
    assert float(same["w"][1].sum()) == 6.0
    drawn = stack_params(per, 4, same_init=False,
                         init_fn=lambda k: {"w": torch.full((2, 3), k)})
    assert [float(x) for x in drawn["w"][:, 0, 0]] == [0.0, 1.0, 2.0, 3.0]


def test_trainer_options_not_ported_raise():
    opt = make_optimizer("d-adam", K, device="cpu")
    # plan is ported for the dense, MoE and vision-language families
    # (tests/test_torch_plan.py, tests/test_torch_plan_moe.py): a real plan
    # is accepted, and outside the 2D packed mode it changes nothing, as
    # in JAX; on that mode the ssm, hybrid and audio families raise (their
    # slices come next). sharded_loss is the 2D layout's
    # (tests/test_torch_grad_2d.py) and, without a 2D optimizer, is not
    # used, as in JAX
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import WorkerGroup
    from repro_torch.launch.shardings import make_plan

    plan = make_plan(get_reduced("llama3.2-1b"), (K, 2))
    assert DecentralizedTrainer(deepfm.deepfm_loss, opt,
                                plan=plan).pipeline.mode == "reference"
    wg = WorkerGroup(group=None, rank=0, K=K, device=torch.device("cpu"),
                     backend="gloo", M=2)
    opt2d = make_optimizer("d-adam", K, backend="packed", comm="axis",
                           group=wg)
    assert DecentralizedTrainer(deepfm.deepfm_loss, opt2d,
                                plan=plan).pipeline.mode == "planned"
    assert DecentralizedTrainer(deepfm.deepfm_loss, opt2d, plan=make_plan(
        get_reduced("phi3.5-moe-42b-a6.6b"), wg)).pipeline.mode == "planned"
    with pytest.raises(NotImplementedError, match="ROADMAP queue 4.3"):
        DecentralizedTrainer(deepfm.deepfm_loss, opt2d, plan=make_plan(
            get_reduced("rwkv6-3b"), wg))
    # recompile_limit is ported (tests/test_torch_recompile.py)
    watch = DecentralizedTrainer(deepfm.deepfm_loss, opt,
                                 recompile_limit=2).recompile_watch
    assert watch.name == "trainer.step" and watch.limit == 2
    for kw in (dict(sharded_loss=lambda *a: 0.0),
               dict(damping="adadamp:4", sharded_loss=lambda *a: 0.0)):
        assert DecentralizedTrainer(deepfm.deepfm_loss, opt,
                                    **kw).pipeline.mode == "reference"
    # damping is ported (tests/test_torch_damping.py)
    assert DecentralizedTrainer(deepfm.deepfm_loss, opt,
                                damping="adadamp:4").pipeline.damping_chunks \
        == 4
    # elastic resize is ported: the trainer rebinds to the new optimizer
    trainer = DecentralizedTrainer(deepfm.deepfm_loss, opt)
    small = make_optimizer("d-adam", K - 2, device="cpu")
    state = trainer.resize(opt.init({"w": torch.ones(K, 3)}), small)
    assert trainer.opt is small and state.params["w"].shape == (K - 2, 3)


def test_auc_matches_jax():
    rng = np.random.default_rng(0)
    scores = np.round(rng.standard_normal(500), 1)   # many ties
    labels = (rng.random(500) < 0.4).astype(np.int32)
    assert auc(scores, labels) == jax_auc(scores, labels)
    assert auc(scores, np.zeros(500)) == 0.5


def test_port_batches_have_the_non_iid_shape():
    task = synthetic.make_ctr_task(seed=0, n_fields=F,
                                   features_per_field=FPF, embed_dim=E)
    np.testing.assert_array_equal(task.teacher_embed, TASK.teacher_embed)
    teacher = synthetic.ctr_teacher(task, "cpu")
    gen = torch.Generator().manual_seed(0)
    b = synthetic.ctr_batch_stacked(teacher, gen, K, 256)
    ids, label = b["feat_ids"], b["label"]
    assert ids.shape == (K, 256, F) and ids.dtype == torch.int32
    assert label.shape == (K, 256) and set(label.unique().tolist()) <= {0, 1}
    local = ids - torch.arange(F, dtype=torch.int32) * FPF
    assert int(local.min()) >= 0 and int(local.max()) < FPF
    # worker k concentrates near position (k + 0.5) / K of every field
    pos = local.float().mean(dim=(1, 2))
    assert torch.all(pos[1:] > pos[:-1])
    one = synthetic.ctr_batch(teacher, gen, 16, worker=2, n_workers=K)
    assert one["feat_ids"].shape == (16, F)


def test_launch_runs_on_the_cpu_when_asked():
    from repro_torch.launch import deepfm_ctr

    res = deepfm_ctr.run("d-adam p=2", steps=4, n_fields=F,
                         features_per_field=FPF, hidden=HIDDEN, period=2,
                         device="cpu")
    assert np.isfinite(res.log.loss[-1]) and 0.0 <= res.auc <= 1.0
    assert res.log.comm_mb[-1] == pytest.approx(
        2 * res.trainer.comm_mb_per_round(res.state))
    assert res.state.count == 4 and res.state.buf.device.type == "cpu"
    # the example's CD-Adam row: sign-compressed gossip, one int8 per
    # parameter and one f32 scale per leaf on the wire
    res = deepfm_ctr.run("cd-adam p=2 + sign", "deepfm", "cd-adam", 4,
                         n_fields=F, features_per_field=FPF, hidden=HIDDEN,
                         period=2, gamma=0.4, compressor="sign",
                         device="cpu")
    assert np.isfinite(res.log.loss[-1]) and 0.0 <= res.auc <= 1.0
    per_worker = tree_leaves(res.trainer.opt.params_of(res.state))
    assert res.trainer.comm_mb_per_round(res.state) == pytest.approx(
        2 * sum(x[0].numel() + 4 for x in per_worker) / 1e6)
    assert res.state.count == 4 and len(res.state.hat_nbr_bufs) == 2
