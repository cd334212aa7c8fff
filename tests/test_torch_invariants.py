"""The port's invariant gates (``repro_torch.analysis.invariants``) and
their sweep (``repro_torch.analysis.check``), on the CPU.

* Topology: every zoo entry and one-peer-exp schedule entry of the sweep
  gives the JAX package's ``check_topology`` report (the same rules, the
  same ``ok``, observed values within 1e-12); the flat-offset torus fails
  INV006 in both packages. JAX's sweep and jaxpr lint are not used: they
  break on jax 0.9.0 (ROADMAP §3).
* ``evaluate`` on hand-made summaries: each bound, the launches, the
  uncounted calls (none allowed); ``check_invariants`` counts the
  launches of its own run; ``WorkerGroup``'s largest single call; the
  transport functions ``launch.mesh`` marks as counting.
* Every stacked config of the sweep passes in this process, and its
  launches, with the card's dispatch stood in for by counting wrappers of
  the plain versions, are exactly ``expected_launches``.
* The axis configs and the corpus's axis items in ONE world of 8 gloo CPU
  ranks (``check.run_axis``): every config passes on every member rank,
  each corpus item fails with its rule on every rank; ``axis2d-packed``
  passes the port's spec and fails a zero-all-gather one.
"""
import dataclasses

import pytest
import torch

from repro.analysis import invariants as jinv
from repro.core.schedule import make_schedule as jmake_schedule
from repro.core.topology import make_topology as jmake_topology
from repro_torch.analysis import check
from repro_torch.analysis.invariants import (RULES, InvariantSpec,
                                             InvariantViolation,
                                             assert_invariants,
                                             check_invariants,
                                             check_schedule, check_topology,
                                             distributed_calls, evaluate)
from repro_torch.core.schedule import make_schedule
from repro_torch.core.topology import make_topology
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_adam as _adam
from repro_torch.kernels import gossip as _gossip
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv_scan as _wkv
from repro_torch.kernels import sign_compress as _sc
from repro_torch.launch import mesh
from repro_torch.launch.mesh import COLLECTIVES, WorkerGroup

torch.set_num_threads(2)

ZOO = [f"{n}-{k}" for n, k in check.TOPOLOGY_ZOO] + [
    f"one-peer-exp-8[{i}]" for i in range(3)]
STACKED = [c for c in check.sweep_configs() if not c.axis]
AXIS = [c for c in check.sweep_configs() if c.axis]


def _topologies(name: str):
    """(port, JAX) topology of a ZOO entry."""
    if name.startswith("one-peer-exp"):
        i = int(name[-2])
        return (make_schedule("one-peer-exp", 8).entries[i],
                jmake_schedule("one-peer-exp", 8).entries[i])
    kind, K = name.rsplit("-", 1)
    return make_topology(kind, int(K)), jmake_topology(kind, int(K))


def _same_report(ours, theirs):
    assert ours.name == theirs.name
    assert ours.ok == theirs.ok
    assert [(c.rule, c.desc, c.bound, c.ok) for c in ours.checks] == \
        [(c.rule, c.desc, c.bound, c.ok) for c in theirs.checks]
    for a, b in zip(ours.checks, theirs.checks):
        assert abs(a.observed - b.observed) <= 1e-12


@pytest.mark.parametrize("name", ZOO)
def test_topology_report_equals_jax(name):
    ours, theirs = _topologies(name)
    _same_report(check_topology(ours), jinv.check_topology(theirs))


def test_zoo_passes_and_schedule_reports_per_entry():
    reports = check.topology_reports()
    assert len(reports) == len(ZOO) and all(r.ok for r in reports)
    sched = check_schedule(make_schedule("one-peer-exp", 8))
    assert [r.name for r in sched] == [r.name for r in reports[-3:]]


def test_bad_torus_fails_inv006_in_both_packages():
    ours = check.corpus_bad_torus()
    bad = dataclasses.replace(jmake_topology("torus", 8),
                              name="bad-flat-torus", offsets=(1, -1, 4, -4))
    theirs = jinv.check_topology(bad)
    _same_report(ours, theirs)
    assert ours.failed_rules() == theirs.failed_rules() == ["INV006"]


# ------------------------------- evaluate -----------------------------------


def _summary(**kinds):
    """A collective_summary with the given kinds' (count, bytes, max)."""
    out = {k: {"count": 0, "bytes": 0, "max_bytes": 0} for k in COLLECTIVES}
    for k, (c, b, m) in kinds.items():
        out[k] = {"count": c, "bytes": b, "max_bytes": m}
    return out


CASES = {
    "count max": (dict(collective_counts={"exchange": 2}),
                  dict(exchange=(3, 30, 10)), "INV001"),
    "count min": (dict(min_collective_counts={"all_reduce": 1}), {},
                  "INV001"),
    "bytes": (dict(collective_bytes={"exchange": 29}),
              dict(exchange=(3, 30, 10)), "INV002"),
    "total bytes": (dict(collective_bytes={"*": 39}),
                    dict(exchange=(3, 30, 10), all_reduce=(1, 10, 10)),
                    "INV002"),
    "single": (dict(single_collective_bytes={"model_all_gather": 9}),
               dict(model_all_gather=(2, 20, 10)), "INV003"),
}


@pytest.mark.parametrize("case", CASES)
def test_evaluate_checks_each_bound(case):
    bounds, got, rule = CASES[case]
    spec = InvariantSpec(name=case, **bounds)
    assert evaluate(_summary(**got), spec).failed_rules() == [rule]
    # the same bound one step looser passes
    loose = {k: {kind: v + (-1 if "min" in k else 1) for kind, v in b.items()}
             for k, b in bounds.items()}
    assert evaluate(_summary(**got), InvariantSpec(**loose)).ok


def test_evaluate_launches_and_uncounted():
    spec = InvariantSpec(launches={"fused_adam": 2})
    assert evaluate(None, spec, {"fused_adam": 2, "gossip_mix": 0}).ok
    # a kernel the spec does not name must not launch, and a missing one
    # fails
    bad = evaluate(None, spec, {"fused_adam": 2, "gossip_mix": 1})
    assert [c.desc for c in bad.failures] == ["gossip_mix launches =="]
    assert not evaluate(None, spec, {"fused_adam": 1}).ok
    # launches=None (a run on the CPU) leaves them unchecked
    assert evaluate(None, spec, None).ok
    assert evaluate(None, InvariantSpec(), uncounted=1).failed_rules() == \
        ["INV001"]
    # the bound is 0 in every spec
    clean = evaluate(None, InvariantSpec())
    assert clean.ok and [(c.observed, c.bound) for c in clean.checks
                         if c.desc.startswith("uncounted")] == [(0, 0)]
    # no group: every kind 0, and INV004 / INV005 are never emitted
    rep = evaluate(None, InvariantSpec(collective_counts={"resize": 0}))
    assert rep.ok and set(rep.summary) == set(COLLECTIVES)
    assert not {c.rule for c in rep.checks} & {"INV004", "INV005"}
    assert "no torch meaning" in RULES["INV004"] + RULES["INV005"]


def test_assert_invariants_raises_with_the_report():
    assert assert_invariants(lambda x: x * 2, (torch.ones(8),),
                             InvariantSpec(name="elementwise")).ok
    with pytest.raises(InvariantViolation) as err:
        assert_invariants(lambda: None, (), InvariantSpec(
            name="needs-a-round", min_collective_counts={"exchange": 1}))
    assert err.value.report.failed_rules() == ["INV001"]
    assert "exchange count >=" in str(err.value)


def test_check_invariants_counts_the_launches_of_its_run():
    # the counters are not reset: a span read around the gate keeps them
    kernel = ops.KERNELS["fused_adam"]
    ops.reset_launches()
    kernel.launches = 3

    def run():
        kernel.launches += 2

    spec = InvariantSpec(launches={"fused_adam": 2})
    try:
        assert check_invariants(run, (), spec, device="cuda").ok
        assert ops.launch_counts()["fused_adam"] == 5
        assert not check_invariants(run, (), InvariantSpec(
            launches={"fused_adam": 7}), device="cuda").ok
    finally:
        ops.reset_launches()


def test_mesh_marks_its_counting_transport(monkeypatch):
    assert mesh.COUNTING == {"exchange", "all_reduce_sum", "_gather",
                             "_broadcast", "send_world", "recv_world",
                             "model_redistribute"}
    # no process group here: the watched functions stand in as no-ops
    for name in ("all_reduce", "barrier"):
        monkeypatch.setattr(torch.distributed, name, lambda *a, **k: None)
    wg = WorkerGroup(group=None, rank=0, K=1, device=torch.device("cpu"),
                     backend="gloo")
    with distributed_calls() as calls:
        mesh.all_reduce_sum(torch.ones(2), wg)
        mesh.barrier(wg)
        torch.distributed.all_reduce(torch.ones(1))
    # the counting function's call is not listed; a call from any other
    # function of mesh, or from outside it, is
    assert calls[0] == "barrier <- repro_torch.launch.mesh.barrier"
    assert calls[1].startswith("all_reduce <- ") and calls[1].endswith(
        "test_torch_invariants.test_mesh_marks_its_counting_transport")
    assert len(calls) == 2 and wg.counts["all_reduce"][0] == 1


def test_worker_group_counts_the_largest_single_call():
    wg = WorkerGroup(group=None, rank=0, K=1, device=torch.device("cpu"),
                     backend="gloo")
    for n in (5, 12, 7):
        wg.count("exchange", n)
    assert wg.collective_summary()["exchange"] == {
        "count": 3, "bytes": 24, "max_bytes": 12}
    wg.reset_counts()
    assert wg.collective_summary()["exchange"] == {
        "count": 0, "bytes": 0, "max_bytes": 0}


# --------------------------- the stacked sweep ------------------------------


@pytest.mark.parametrize("cfg", STACKED, ids=lambda c: c.name)
def test_stacked_config_passes(cfg):
    rep = check.check_config(cfg, "cpu")
    assert rep.ok, rep.format(verbose=False)
    assert all(s["count"] == 0 for s in rep.summary.values())


@pytest.fixture
def card_dispatch(monkeypatch):
    """The card's dispatch stood in for on the CPU: ``ops`` takes the
    kernel wrappers, each of which counts a launch as the CUDA wrapper
    does (the ``reduce_axis`` form two of its own) and runs the plain
    version."""
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    for mod, name in ((_adam, "fused_adam"), (_gossip, "gossip_mix"),
                      (_gossip, "gossip_adam_mix"),
                      (_gossip, "consensus_mix"), (_gossip, "payload_mix"),
                      (_sc, "sign_compress_stacked"), (_sc, "sign_compress"),
                      (_fa, "flash_attention"), (_wkv, "rwkv_scan")):
        kernel, plain = getattr(mod, name), getattr(mod, name + "_plain")

        def standin(*args, _k=kernel, _p=plain, **kw):
            if kw.get("reduce_axis") is not None:
                _sc._stacked_reduce.launches += 2
            else:
                _k.launches += 1
            return _p(*args, **kw)

        monkeypatch.setattr(mod, name, standin)
    ops.reset_launches()
    yield
    ops.reset_launches()


@pytest.mark.parametrize("cfg", STACKED, ids=lambda c: c.name)
def test_stacked_launches_are_the_expected(cfg, card_dispatch):
    trainer, state, batch = check._build(cfg, "cpu")
    spec = check.spec_for(cfg, trainer, state)
    ops.reset_launches()
    check._period(trainer, state, batch)
    rep = evaluate(None, spec, ops.launch_counts())
    assert rep.ok, rep.format(verbose=False)


# ----------------------------- the axis world -------------------------------


@pytest.fixture(scope="module")
def axis_world():
    results, corpus = check.run_axis(AXIS, "cpu", corpus=True)
    return {r.config: r for r in results}, corpus


@pytest.mark.parametrize("cfg", AXIS, ids=lambda c: c.name)
def test_axis_config_passes_on_every_rank(cfg, axis_world):
    res = axis_world[0][cfg.name]
    assert len(res.reports) == cfg.K * cfg.M
    for rep in res.reports:
        assert rep.ok, rep.format(verbose=False)
        assert rep.summary["exchange"]["count"] >= 1
        assert rep.summary["all_reduce"]["count"] == 1


def test_corpus_fails_as_expected(axis_world):
    ok, lines = check.run_corpus(axis_world[1])
    assert ok, lines
    assert len(axis_world[1]) == check.CORPUS_K
    for reports in axis_world[1]:
        for rep, (_, rule, what) in zip(reports, check.CORPUS_AXIS):
            assert rule in rep.failed_rules()
            assert any(c.desc.startswith(what) for c in rep.failures)
    # a corpus whose axis items did not run fails the gate
    assert not check.run_corpus(None)[0]


def test_axis2d_packed_gathers_once_a_step(axis_world):
    """The port's deliberate difference from JAX's axis2d spec: the packed
    2D mode all-gathers the worker's blocks once a step, so a spec of zero
    model all-gathers (JAX's) fails; the sharded-packed mode makes none."""
    zero = InvariantSpec(name="jax-axis2d",
                         collective_counts={"model_all_gather": 0})
    for rep in axis_world[0]["axis2d-packed/d-adam/plain"].reports:
        assert rep.ok
        assert rep.summary["model_all_gather"]["count"] == check.PERIOD
        assert evaluate(rep.summary, zero).failed_rules() == ["INV001"]
    for rep in axis_world[0]["axis2d/d-adam/plain"].reports:
        assert evaluate(rep.summary, zero).ok


# ------------------------------ serve and CLI -------------------------------


def test_serve_decode_makes_no_collective():
    rep = check.serve_decode_report(device="cpu")
    assert rep.ok, rep.format(verbose=False)
    assert rep.name == "serve.decode[llama3.2-1b]"


def test_cli_stacked_only_and_cuda_by_default(capsys, monkeypatch):
    assert check.main(["--device", "cpu", "--backends", "packed",
                       "--kinds", "d-adam", "--variants", "plain",
                       "--no-corpus"]) == 0
    out = capsys.readouterr().out
    assert "[ok  ] packed/d-adam/plain" in out
    assert out.strip().endswith("check_invariants: PASS")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        check.main(["--backends", "packed", "--no-corpus"])
