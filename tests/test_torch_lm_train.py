"""LM training on the port against the JAX package: the token streams, the
stacked-loss adapter, ``remat``, the trainer and the training CLI.

* ``lm_batch`` / ``lm_batches_stacked`` on JAX's draws (handed across as
  numpy) equal JAX's tokens exactly;
* ``stacked_loss(build_model(cfg).loss)``: per-worker losses and grads
  equal to JAX's ``vmap(value_and_grad(loss))`` on the reduced llama3.2-1b
  and rwkv6-3b at f32 compute, within 2e-5 (grads: of each leaf's
  largest);
* ``remat`` "dots" and "full" give the losses and grads of "none" to the
  bit, and the backward recomputes what each policy leaves unsaved;
* three ``fit`` steps of the reduced llama, port 'packed' against JAX
  'pallas' and 'reference' against 'reference', within the tolerances of
  ``tests/test_torch_train.py::test_fit_trajectory_tracks_jax``;
* ``repro_torch.launch.train.main`` end to end on the CPU with ``--ckpt``,
  the checkpoint restored by ``repro.checkpoint``; ``--comm axis`` and
  ``--model-parallel 2`` raise, and so does ``--damping`` beside
  ``--model-parallel 2`` (the sharded damped path); ``--damping`` alone is
  ``tests/test_torch_damping.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import io as jio
from repro.configs import get_reduced as jget_reduced
from repro.core import make_optimizer as jax_make_optimizer
from repro.data import synthetic as jsynthetic
from repro.models import build_model as jbuild_model
from repro.train import DecentralizedTrainer as JaxTrainer
from repro_torch._tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.api import make_optimizer
from repro_torch.data import synthetic
from repro_torch.launch import train as train_cli
from repro_torch.models.registry import build_model
from repro_torch.train.loop import DecentralizedTrainer, stacked_loss

torch.set_num_threads(2)

K = 2
TOL = dict(rtol=2e-5, atol=2e-5)
FTOL = dict(rtol=2e-5, atol=2e-6)
ARCHS = {"llama3.2-1b": 0, "rwkv6-3b": 3}   # arch: init seed
DOT_OPS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default}


def f32_configs(arch):
    jcfg = dataclasses.replace(jget_reduced(arch).model,
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced(arch).model,
                               compute_dtype=torch.float32)
    return jcfg, tcfg


def stacked_jax_params(jcfg, seed):
    """K workers' params: one init, worker k moved by k * 1e-2 noise, so
    the adapter's per-worker slices are told apart."""
    p = jbuild_model(jcfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.stack([np.asarray(x) + k * 1e-2 * rng.standard_normal(
            x.shape).astype(np.float32) for k in range(K)]), p)


def tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def close(a, b, **tol):
    la, lb = tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x.detach().float().numpy(),
                                   np.asarray(y, np.float32), **tol)


# ------------------------------- token streams ------------------------------


def jax_draws(key, batch, seq, vocab, worker, skew):
    """JAX's ``lm_batch`` draws for one worker, as numpy."""
    k1, k2 = jax.random.split(jax.random.fold_in(key, worker))
    shape = (batch, seq + 1)
    base = jax.random.randint(k1, shape, 0, vocab)
    mask = jax.random.bernoulli(k2, 0.5 * min(skew, 1.0), shape)
    return torch.from_numpy(np.array(base)), torch.from_numpy(
        np.array(mask))


@pytest.mark.parametrize("skew", [0.0, 0.5, 2.0])
def test_lm_batches_equal_jax_on_its_draws(skew):
    key = jax.random.PRNGKey(7)
    batch, seq, vocab, workers, p = 3, 9, 101, 4, 2
    for k in range(workers):
        base, mask = jax_draws(key, batch, seq, vocab, k, skew)
        got = synthetic.lm_batch(None, batch, seq, vocab, k, workers, skew,
                                 base=base, mask=mask)
        want = jsynthetic.lm_batch(key, batch, seq, vocab, k, workers, skew)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = synthetic.lm_batches_stacked(
        None, p, workers, batch, seq, vocab, skew,
        draws=lambda t, k: jax_draws(jax.random.fold_in(key, t), batch, seq,
                                     vocab, k, skew))
    want = jsynthetic.lm_batches_stacked(key, p, workers, batch, seq, vocab,
                                         skew)
    assert got.shape == (p, workers, batch, seq + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lm_batch_from_a_generator_keeps_the_band():
    gen = torch.Generator().manual_seed(0)
    vocab, workers = 1000, 4
    toks = synthetic.lm_batches_stacked(gen, 1, workers, 64, 31, vocab, 1.0)
    assert toks.dtype == torch.int32 and toks.shape == (1, 4, 64, 32)
    assert int(toks.min()) >= 0 and int(toks.max()) < vocab
    band = vocab // workers
    for k in range(workers):
        inside = ((toks[0, k] >= k * band) & (toks[0, k] < (k + 1) * band))
        # half the tokens are moved into the band, a quarter of the rest
        # lands there by chance
        assert 0.55 < float(inside.float().mean()) < 0.70
    with pytest.raises(ValueError, match="draws"):
        synthetic.lm_batch(None, 2, 3, vocab, base=torch.zeros(2, 5),
                           mask=torch.zeros(2, 5, dtype=torch.bool))


# ---------------------------- stacked-loss adapter --------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_stacked_loss_matches_jax_per_worker_value_and_grad(arch):
    jcfg, tcfg = f32_configs(arch)
    jp = stacked_jax_params(jcfg, ARCHS[arch])
    toks = tokens((K, 2, 9), jcfg.vocab_size)
    jloss = jbuild_model(jcfg).loss
    jl, jg = jax.vmap(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, jp),
        {"tokens": jnp.asarray(toks)})
    leaves, td = tree_flatten(params_from_numpy(jp, "cpu"))
    xs = [x.requires_grad_(True) for x in leaves]
    fn = stacked_loss(build_model(tcfg).loss)
    losses = fn(tree_unflatten(td, xs), {"tokens": torch.from_numpy(toks)})
    assert losses.shape == (K,)
    grads = torch.autograd.grad(losses.sum(), xs)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jl),
                               **TOL)
    # each leaf's grads within 2e-5 of its largest: the layer norm after
    # rwkv6's embedding divides its grads by the small embedding's spread
    # (init scale 0.02), so the embedding's grads (up to 16 here) are
    # differences of nearly equal terms, exact only to that leaf's scale
    for a, b in zip(grads, jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b)
        atol = TOL["atol"] * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol)
    # the per-worker slices are views: no param was copied
    p = tree_unflatten(td, leaves)
    seen = []
    fn2 = stacked_loss(lambda q, b: (seen.append(q), torch.zeros(()))[1])
    fn2(p, {"tokens": torch.from_numpy(toks)})
    for k, q in enumerate(seen):
        for a, b in zip(tree_leaves(q), tree_leaves(p)):
            assert a.data_ptr() == b[k].data_ptr()


# ----------------------------------- remat ----------------------------------


class OpCount(TorchDispatchMode):
    """Counts the aten ops run under it: all, and the matrix products."""

    def __init__(self):
        super().__init__()
        self.total = self.dots = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.total += 1
        self.dots += func in DOT_OPS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_policies_equal_none(arch):
    """Recomputation repeats the same CPU ops: losses and grads equal to
    the bit. The backward shows each policy at work: "full" recomputes
    the layers' matrix products, "dots" only what lies between them (the
    products' outputs were saved). JAX's rwkv6 takes any policy but
    "none" as "full", and so does the port's."""
    cfg = get_reduced(arch).model
    api = build_model(cfg)
    leaves, td = tree_flatten(api.init(torch.Generator().manual_seed(0)))
    batch = {"tokens": torch.from_numpy(tokens((2, 13), cfg.vocab_size))}
    out, bwd = {}, {}
    for remat in ("none", "dots", "full"):
        xs = [x.detach().requires_grad_(True) for x in leaves]
        loss = api.loss(tree_unflatten(td, xs), batch, remat=remat)
        with OpCount() as count:
            grads = torch.autograd.grad(loss, xs)
        out[remat], bwd[remat] = (loss, grads), count
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)
    assert bwd["full"].dots > bwd["none"].dots
    assert bwd["full"].total > bwd["none"].total
    if arch == "llama3.2-1b":
        assert bwd["dots"].dots == bwd["none"].dots
        assert bwd["full"].total > bwd["dots"].total > bwd["none"].total
    else:
        assert bwd["dots"].dots == bwd["full"].dots
    with pytest.raises(ValueError, match="remat"):
        api.loss(tree_unflatten(td, leaves), batch, remat="some")


# ------------------------------ fit trajectory ------------------------------


@pytest.mark.parametrize("backend", ["pallas", "reference"])
def test_fit_trajectory_tracks_jax(backend):
    """Three steps at period 2 of the reduced llama (f32 compute) from one
    init and one set of batches: per-step losses and the final params.

    eta is 1e-4: Adam moves an element by eta * m / (sqrt(v) + tau), and
    where the gradient is itself a cancellation at f32's rounding floor
    (|g| ~ 3e-7, near tau) the two packages' roundings change that ratio
    by percents; at eta 1e-3 one element of the 262,144 in w_up ended
    3.9e-6 apart after three steps, past the atol of 2e-6."""
    jcfg, tcfg = f32_configs("llama3.2-1b")
    steps, kw = 3, dict(eta=1e-4, period=2, topology="ring")
    p0 = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    batches = [{"tokens": tokens((K, 1, 9), jcfg.vocab_size, seed=t)}
               for t in range(steps)]
    jopt = jax_make_optimizer("d-adam", K, backend=backend, **kw)
    jtr = JaxTrainer(lambda p, b: jbuild_model(jcfg).loss(p, b), jopt)
    js, jlog = jtr.fit(jtr.init(p0), iter(
        jax.tree_util.tree_map(jnp.asarray, b) for b in batches), steps,
        log_every=1)
    topt = make_optimizer("d-adam", K, device="cpu",
                          backend="packed" if backend == "pallas"
                          else "reference", **kw)
    ttr = DecentralizedTrainer(stacked_loss(build_model(tcfg).loss), topt)
    ts, tlog = ttr.fit(
        ttr.init(params_from_numpy(jax.tree_util.tree_map(np.asarray, p0),
                                   "cpu")),
        iter({"tokens": torch.from_numpy(b["tokens"])} for b in batches),
        steps, log_every=1)
    assert tlog.step == jlog.step == [1, 2, 3]
    np.testing.assert_allclose(tlog.loss, jlog.loss, **TOL)
    np.testing.assert_allclose(tlog.comm_mb, jlog.comm_mb, rtol=1e-12)
    close(topt.params_of(ts), jopt.params_of(js), **FTOL)


# ------------------------------ the training CLI ----------------------------


def test_train_cli_runs_and_its_checkpoint_loads_in_jax(tmp_path, capsys):
    path = str(tmp_path / "lm.npz")
    run = train_cli.main(["--device", "cpu", "--workers", "2", "--steps",
                          "3", "--period", "2", "--seq", "8", "--batch",
                          "1", "--backend", "packed", "--log-every", "2",
                          "--ckpt", path])
    out = capsys.readouterr().out
    assert "[train] llama3.2-1b (reduced)" in out
    assert "resident packed state: K=2" in out
    assert "final checkpoint" in out
    assert run.log.step == [2, 3] and run.state.count == 3
    assert all(np.isfinite(run.log.loss))
    jcfg = jget_reduced("llama3.2-1b").model
    jopt = jax_make_optimizer("d-adam", K, period=2, backend="pallas")
    jlike = JaxTrainer(lambda p, b: jbuild_model(jcfg).loss(p, b),
                       jopt).init(jbuild_model(jcfg).init(
                           jax.random.PRNGKey(1)))
    js, step = jio.restore(path, jlike)
    assert step == 3 and int(js.count) == 3
    np.testing.assert_array_equal(np.asarray(js.buf), run.state.buf.numpy())
    for a, b in zip(tree_leaves(run.state.params),
                    jax.tree_util.tree_leaves(js.params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("flags", [["--damping", "adadamp:2",
                                    "--model-parallel", "2"],
                                   ["--comm", "axis"],
                                   ["--model-parallel", "2"]])
def test_train_cli_options_not_ported_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        train_cli.main(["--device", "cpu", "--steps", "1"] + flags)
