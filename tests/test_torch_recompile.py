"""The recompile gate on the port (``repro_torch.analysis.recompile``)
against the JAX package's ``RecompileWatch``, on the same call sequences.

The watch counts distinct call signatures: structure, each tensor's shape,
dtype and device, each host value's type. ``DecentralizedTrainer(
recompile_limit=)`` arms one over its step, fresh at each rebind, as JAX's
trainer does; ``DecodeEngine`` keeps one a phase (its tests in
``tests/test_torch_serve.py``). Each test runs the JAX trainer or watch on
the same sequence and holds the port's count, the step it raises at and
the evaluations to JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.jaxpr_lint import RecompileError as JaxRecompileError
from repro.analysis.jaxpr_lint import RecompileWatch
from repro.core import make_optimizer as jax_make_optimizer
from repro.train import DampingConfig as JaxDampingConfig
from repro.train import DecentralizedTrainer as JaxTrainer
from repro_torch.analysis.recompile import (RecompileError, SignatureWatch,
                                            signature)
from repro_torch.core.api import make_optimizer
from repro_torch.serve import engine
from repro_torch.train.damping import DampingConfig
from repro_torch.train.loop import DecentralizedTrainer, stack_params

torch.set_num_threads(2)


def test_watch_counts_as_jax_on_shape_dtype_and_structure_churn():
    """``tests/test_static_analysis.py``'s watch sequences, on both."""
    seq = [{"a": np.ones((4,), np.float32)}, {"a": np.ones((4,), np.float32)},
           {"a": np.ones((5,), np.float32)}, {"a": np.ones((5,), np.int32)},
           {"a": np.ones((5,), np.float32), "b": np.ones((2,), np.float32)},
           ({"a": np.ones((4,), np.float32)}, 3)]
    port, ref = SignatureWatch("f", limit=1), RecompileWatch("f", limit=1)

    def arrays(fn, x):
        return jax.tree_util.tree_map(
            lambda a: fn(a) if isinstance(a, np.ndarray) else a, x)

    counts = [(port.observe(arrays(torch.from_numpy, x)),
               ref.observe(arrays(jnp.asarray, x))) for x in seq]
    assert [p for p, _ in counts] == [j for _, j in counts] == \
        [1, 1, 2, 3, 4, 5]
    with pytest.raises(RecompileError, match="distinct input signatures"):
        port.check()
    with pytest.raises(JaxRecompileError):
        ref.check()


def test_engine_keeps_its_recompile_error_and_uses_the_shared_watch():
    assert engine.RecompileError is RecompileError
    assert engine.SignatureWatch is SignatureWatch


def test_host_values_key_by_type_and_tensors_by_device():
    w = SignatureWatch(limit=4)
    assert w.observe(torch.ones(2), 1) == w.observe(torch.ones(2), 7) == 1
    assert w.observe(torch.ones(2), 1.0) == 2            # int -> float
    assert w.observe(torch.ones(2, device="meta"), 1) == 3
    assert w.observe(torch.ones(2), None) == 4           # structure


@pytest.mark.parametrize("kind", ["d-adam", "cd-adam"])
def test_the_signature_descends_into_packed_states(kind):
    """A packed state is a dataclass, which ``_tree`` keeps whole; the
    signature opens it as JAX flattens it: each buffer keys by shape,
    dtype and device, the host count by type, the specs by value."""
    kw = dict(compressor="sign") if kind == "cd-adam" else {}
    opt = make_optimizer(kind, 4, period=2, backend="packed", device="cpu",
                         **kw)
    state = opt.init(stack_params({"w": torch.ones(6, 3),
                                   "b": torch.zeros(3)}, 4))
    other = make_optimizer(kind, 4, period=2, backend="packed",
                           device="cpu", **kw).init(stack_params(
                               {"w": torch.ones(6, 4), "b": torch.zeros(3)},
                               4))
    w = SignatureWatch(limit=1)
    assert w.observe(state) == 1
    assert w.observe(dataclasses.replace(state, count=state.count + 5)) == 1
    assert w.observe(dataclasses.replace(state, m=state.m.double())) == 2
    assert w.observe(dataclasses.replace(state, spec=other.spec)) == 3
    assert w.observe(dataclasses.replace(state, buf=state.buf[:, :1])) == 4
    if kind == "cd-adam":
        assert w.observe(dataclasses.replace(
            state, hat_nbr_bufs=state.hat_nbr_bufs[:1])) == 5
    assert signature(state) != signature(state.buf)


# ------------------------------ the trainer ---------------------------------


def jax_reg_loss(p, b):
    y = b["x"] @ p["w"] + (p["b"] if "b" in p else 0.0)
    return jnp.mean((y - b["y"]) ** 2)


def port_reg_loss(p, b):
    y = b["x"] @ p["w"] + (p["b"][:, None] if "b" in p else 0.0)
    return torch.mean((y - b["y"]) ** 2, dim=(1, 2))


def reg_batches(K, shapes, seed=0):
    """numpy batches, one of each ``(batch, features)`` shape in turn."""
    rng = np.random.default_rng(seed)
    for n, f in shapes:
        x = rng.standard_normal((K, n, f)).astype(np.float32)
        yield {"x": x, "y": (x @ np.ones((f, 2), np.float32))}


def to_jax(it, seen=None):
    for b in it:
        if seen is not None:
            seen.append(b)
        yield jax.tree_util.tree_map(jnp.asarray, b)


def to_port(it, seen=None):
    for b in it:
        if seen is not None:
            seen.append(b)
        yield {k: torch.from_numpy(v) for k, v in b.items()}


def trainers(K, kind="d-adam", limit=1, damping=None, backend="reference",
             **kw):
    jopt = jax_make_optimizer(kind, K=K, eta=1e-2, period=2,
                              backend="pallas" if backend == "packed"
                              else backend, **kw)
    jtr = JaxTrainer(jax_reg_loss, jopt, recompile_limit=limit,
                     damping=damping)
    opt = make_optimizer(kind, K, eta=1e-2, period=2, backend=backend,
                         device="cpu", **kw)
    tr = DecentralizedTrainer(port_reg_loss, opt, recompile_limit=limit,
                              damping=damping if damping is None
                              or isinstance(damping, str)
                              else DampingConfig(**dataclasses.asdict(
                                  damping)))
    return jtr, tr


def test_unarmed_trainer_has_no_watch():
    jtr, tr = trainers(2, limit=None)
    assert jtr.recompile_watch is None and tr.recompile_watch is None


def test_a_batch_shape_change_raises_at_the_jax_step():
    """``tests/test_static_analysis.py``'s ``test_trainer_recompile_limit``:
    four steps at (3, 4), then a fit whose second batch is (5, 4)."""
    K = 2
    jtr, tr = trainers(K)
    params = {"w": np.ones((4, 2), np.float32)}
    jstate = jtr.init(jax.tree_util.tree_map(jnp.asarray, params))
    state = tr.init({"w": torch.from_numpy(params["w"])})
    jstate, _ = jtr.fit(jstate, to_jax(reg_batches(K, [(3, 4)] * 4)), 4,
                        log_every=2)
    state, _ = tr.fit(state, to_port(reg_batches(K, [(3, 4)] * 4)), 4,
                      log_every=2)
    jseen, seen = [], []
    with pytest.raises(JaxRecompileError):
        jtr.fit(jstate, to_jax(reg_batches(K, [(3, 4), (5, 4)]), jseen), 2,
                log_every=1)
    with pytest.raises(RecompileError, match="trainer.step"):
        tr.fit(state, to_port(reg_batches(K, [(3, 4), (5, 4)]), seen), 2,
               log_every=1)
    assert len(seen) == len(jseen) == 2
    assert len(tr.recompile_watch.signatures) == len(
        jtr.recompile_watch.signatures) == 2


@pytest.mark.parametrize("backend", ["reference", "packed"])
def test_geodamp_keeps_one_signature_across_every_level(backend):
    """``tests/test_damping.py``'s ``test_compile_once_across_levels``:
    GeoDamp walks chunk counts 1, 1, 2, 2, 4, 4, 4, 4 under limit 1."""
    K = 2
    dcfg = JaxDampingConfig(policy="geodamp", max_chunks=4, factor=2.0,
                            delay=2)
    jtr, tr = trainers(K, damping=dcfg, backend=backend)
    params = {"w": (np.random.default_rng(3).standard_normal((6, 2))
                    * 0.1).astype(np.float32)}
    jstate = jtr.init(jax.tree_util.tree_map(jnp.asarray, params))
    state = tr.init({"w": torch.from_numpy(params["w"])})
    shapes = [(8, 6)] * 8
    jstate, jlog = jtr.fit(jstate, to_jax(reg_batches(K, shapes)), 8,
                           log_every=2)
    state, log = tr.fit(state, to_port(reg_batches(K, shapes)), 8,
                        log_every=2)
    assert log.grad_evals == jlog.grad_evals
    assert log.grad_evals[-1] == 2 * (1 + 1 + 2 + 2 + 4 + 4 + 4 + 4)
    assert len(tr.recompile_watch.signatures) == len(
        jtr.recompile_watch.signatures) == 1


def test_resize_and_an_lr_decay_start_a_fresh_watch():
    """An elastic resize and each lr-decay rebind are one legitimate new
    program: both packages build a fresh watch, so a new K, or the same
    shapes after a decay, do not count against the limit."""
    params = {"w": np.full((6, 2), 0.1, np.float32)}
    jtr, tr = trainers(4)
    jstate = jtr.init(jax.tree_util.tree_map(jnp.asarray, params))
    state = tr.init({"w": torch.from_numpy(params["w"])})
    jstate, _ = jtr.fit(jstate, to_jax(reg_batches(4, [(8, 6)] * 2)), 2)
    state, _ = tr.fit(state, to_port(reg_batches(4, [(8, 6)] * 2)), 2)
    jwatch, watch = jtr.recompile_watch, tr.recompile_watch
    jstate = jtr.resize(jstate, jax_make_optimizer("d-adam", K=2, eta=1e-2,
                                                   period=2))
    state = tr.resize(state, make_optimizer("d-adam", 2, eta=1e-2,
                                            period=2, device="cpu"))
    assert jtr.recompile_watch is not jwatch and tr.recompile_watch is not \
        watch
    assert len(tr.recompile_watch.signatures) == len(
        jtr.recompile_watch.signatures) == 0
    jstate, _ = jtr.fit(jstate, to_jax(reg_batches(2, [(8, 6)] * 2)), 2)
    state, _ = tr.fit(state, to_port(reg_batches(2, [(8, 6)] * 2)), 2)
    assert len(tr.recompile_watch.signatures) == len(
        jtr.recompile_watch.signatures) == 1

    # min == max chunks: every step at the ceiling, a decay every 2 steps
    dcfg = JaxDampingConfig(policy="geodamp", max_chunks=2, min_chunks=2,
                            factor=2.0, delay=1, lr_decay=0.5,
                            lr_decay_every=2)
    jtr, tr = trainers(2, damping=dcfg)
    jstate = jtr.init(jax.tree_util.tree_map(jnp.asarray, params))
    state = tr.init({"w": torch.from_numpy(params["w"])})
    watches, jwatches = [], []
    hook = lambda step, st: watches.append(tr.recompile_watch)  # noqa: E731
    jhook = lambda step, st: jwatches.append(jtr.recompile_watch)  # noqa
    jstate, _ = jtr.fit(jstate, to_jax(reg_batches(2, [(8, 6)] * 6)), 6,
                        log_every=2, hook=jhook, hook_every=1)
    state, _ = tr.fit(state, to_port(reg_batches(2, [(8, 6)] * 6)), 6,
                      log_every=2, hook=hook, hook_every=1)
    assert tr.opt.cfg.eta == pytest.approx(jtr.opt.cfg.eta) == \
        pytest.approx(1e-2 * 0.5 ** 3)
    # a new watch at steps 2, 4 and 6 (the log points) in both
    fresh = [i for i in range(1, 6) if watches[i] is not watches[i - 1]]
    jfresh = [i for i in range(1, 6) if jwatches[i] is not jwatches[i - 1]]
    assert fresh == jfresh == [2, 4]
    assert len(tr.recompile_watch.signatures) == len(
        jtr.recompile_watch.signatures) == 0


VARIANTS = {"plain": {},
            "stale": dict(staleness=2, straggler_rate=0.3, straggler_seed=1),
            "overlap": dict(overlap=True),
            "damping": dict(damping="geodamp:4:2:1")}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("kind", ["d-adam", "cd-adam"])
@pytest.mark.parametrize("backend", ["reference", "packed"])
def test_every_stacked_layout_keeps_jaxs_signature_count(backend, kind,
                                                          variant):
    """Three periods under limit 1, on the same layout in both packages:
    the port keeps exactly JAX's count (one), its state opened down to
    the packed buffers and the payload rings."""
    K = 4
    kw = dict(VARIANTS[variant])
    if kind == "cd-adam":
        kw.update(gamma=0.4, compressor="sign")
    jtr, tr = trainers(K, kind, backend=backend, **kw)
    params = {"w": np.full((6, 2), 0.1, np.float32),
              "b": np.zeros((2,), np.float32)}
    jstate = jtr.init(jax.tree_util.tree_map(jnp.asarray, params))
    state = tr.init({k: torch.from_numpy(v) for k, v in params.items()})
    shapes = [(8, 6)] * 6
    jtr.fit(jstate, to_jax(reg_batches(K, shapes)), 6, log_every=2)
    tr.fit(state, to_port(reg_batches(K, shapes)), 6, log_every=2)
    n = len(tr.recompile_watch.signatures)
    assert n == len(jtr.recompile_watch.signatures) == 1
