"""The port's online train->serve loop (``train.online``) and its stream
(``data.stream``), on the CPU.

``train_online`` publishes from the live packed state every
``publish_every`` steps and once at the end; the publish history is held
against the JAX package's ``train_online`` on the same schedule, and
each published snapshot against ``publish_params`` of the state it came
from. ``ctr_stream`` is deterministic in ``(seed, t)``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import make_optimizer as jax_make_optimizer
from repro.data import make_ctr_task as jax_make_ctr_task
from repro.data.stream import ctr_stream as jax_ctr_stream
from repro.models import deepfm as jdeepfm
from repro.serve import ParamStore as JaxParamStore
from repro.train import DecentralizedTrainer as JaxTrainer
from repro.train import train_online as jax_train_online
from repro_torch._tree import tree_leaves
from repro_torch.core.api import make_optimizer
from repro_torch.data.stream import (ctr_stream, prefetch_to_device,
                                     step_generator)
from repro_torch.data.synthetic import (ctr_batch_stacked, ctr_teacher,
                                        make_ctr_task)
from repro_torch.models import deepfm
from repro_torch.serve import ParamStore, publish_params
from repro_torch.train.loop import DecentralizedTrainer
from repro_torch.train.online import train_online

torch.set_num_threads(2)

K, F, FPF, E, HIDDEN, B = 4, 4, 16, 4, (8,), 16


def setup(period=2):
    task = make_ctr_task(0, F, FPF, E)
    teacher = ctr_teacher(task, "cpu")
    opt = make_optimizer("d-adam", K, eta=1e-2, period=period,
                         backend="packed", device="cpu")
    trainer = DecentralizedTrainer(deepfm.deepfm_loss, opt)
    params = deepfm.init_deepfm(torch.Generator().manual_seed(0),
                                task.n_features, F, E, HIDDEN)
    return trainer, trainer.init(params), teacher


@pytest.mark.parametrize("steps,every,final,want", [
    (10, 4, True, [4, 8, 10]), (10, 4, False, [4, 8]),
    (8, 4, True, [4, 8]), (3, 5, True, [3])])
def test_publish_steps_and_versions_match_jax(steps, every, final, want):
    trainer, state, teacher = setup()
    store = ParamStore()
    res = train_online(trainer, state, ctr_stream(teacher, K, B), steps,
                       store=store, publish_every=every, final_publish=final,
                       log_every=steps)
    assert [s for s, _ in res.published] == want
    assert res.versions == list(range(1, len(want) + 1))
    assert store.version == len(want) and res.log.steps_total == steps
    # the JAX loop on the same schedule (reference backend, tiny model)
    jtask = jax_make_ctr_task(0, F, FPF, E)
    jopt = jax_make_optimizer("d-adam", K=K, eta=1e-2, period=2,
                              backend="reference")
    jtrainer = JaxTrainer(jdeepfm.deepfm_loss, jopt)
    jstate = jtrainer.init(jdeepfm.init_deepfm(
        jax.random.PRNGKey(0), jtask.n_features, F, E, HIDDEN))
    jres = jax_train_online(jtrainer, jstate, jax_ctr_stream(jtask, K, B),
                            steps, store=JaxParamStore(),
                            publish_every=every, final_publish=final,
                            log_every=steps)
    assert res.published == jres.published


def test_snapshots_are_the_live_state_at_their_step():
    """Each snapshot equals publish_params of the state at its step, and
    later training does not change a snapshot already published."""
    trainer, state, teacher = setup()
    store, seen = ParamStore(), []
    orig = store.publish

    def spy(params, **kw):
        seen.append([x.clone() for x in tree_leaves(params)])
        return orig(params, **kw)

    store.publish = spy
    res = train_online(trainer, state, ctr_stream(teacher, K, B), 6,
                       store=store, publish_every=3, mode="mean")
    assert res.versions == [1, 2]
    final = publish_params(res.state, mode="mean")
    for a, b in zip(tree_leaves(store.snapshot()[1]), tree_leaves(final)):
        assert torch.equal(a, b)
    first, last = seen
    assert any(not torch.equal(a, b) for a, b in zip(first, last))
    # worker mode, and the log carried across two calls
    res2 = train_online(trainer, res.state,
                        ctr_stream(teacher, K, B, seed=2), 4, store=store,
                        publish_every=2, mode="worker", worker=1,
                        log=res.log)
    assert [s for s, _ in res2.published] == [8, 10]
    assert res2.versions == [3, 4] and res2.log.steps_total == 10
    for a, b in zip(tree_leaves(store.snapshot()[1]),
                    tree_leaves(res2.state.params)):
        assert torch.equal(a, b[1])


def test_publish_every_validated():
    trainer, state, teacher = setup()
    with pytest.raises(ValueError, match="publish_every"):
        train_online(trainer, state, ctr_stream(teacher, K, B), 2,
                     store=ParamStore(), publish_every=0)


def test_ctr_stream_is_deterministic_in_seed_and_step():
    teacher = ctr_teacher(make_ctr_task(0, F, FPF, E), "cpu")
    a, b = ctr_stream(teacher, K, B, seed=3), ctr_stream(teacher, K, B,
                                                          seed=3)
    first = [next(a) for _ in range(3)]
    for t, batch in enumerate(first):
        again = next(b)
        direct = ctr_batch_stacked(teacher, step_generator(3, t), K, B)
        for x, y, z in zip(tree_leaves(batch), tree_leaves(again),
                           tree_leaves(direct)):
            assert torch.equal(x, y) and torch.equal(x, z)
    assert tuple(first[0]["feat_ids"].shape) == (K, B, F)
    other = next(ctr_stream(teacher, K, B, seed=4))
    assert not torch.equal(other["feat_ids"], first[0]["feat_ids"])
    assert not torch.equal(first[1]["feat_ids"], first[0]["feat_ids"])


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_keeps_order(size):
    teacher = ctr_teacher(make_ctr_task(0, F, FPF, E), "cpu")
    src = [next(ctr_stream(teacher, K, B, seed=s)) for s in range(4)]
    got = list(prefetch_to_device(iter(src), size, device="cpu"))
    assert len(got) == 4
    for x, y in zip(got, src):
        assert torch.equal(x["label"], y["label"])
    with pytest.raises(ValueError, match="size"):
        list(prefetch_to_device(iter(src), 0, device="cpu"))


def test_prefetch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device(iter([{"x": torch.zeros(1)}])))
    assert np.array_equal(
        next(prefetch_to_device(iter([{"x": torch.ones(2)}]),
                                device="cpu"))["x"].numpy(), np.ones(2))
