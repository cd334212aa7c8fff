"""``repro_torch.analysis.check``: the invariant sweep, the port of
``repro.analysis.check`` and ``scripts/check_invariants.py``.

One entry point (:func:`run`, ``python -m repro_torch.analysis.check``)
sweeps the execution configs (reference / packed / axis / axis2d and the
port's own axis2d-packed, axis2d-plan and axis2d-plan-moe × D-Adam /
CD-Adam × plain /
schedule / stale / overlap / damping) and gates one communication period of each (``period=2``:
one local step and one comm step, through ``DecentralizedTrainer.fit``,
which logs once) against :func:`spec_for`'s
:class:`~.invariants.InvariantSpec`; then the topology zoo (INV006/INV007),
the serving gate (:func:`serve_decode_report`) and a known-bug corpus
(:func:`run_corpus`) that must FAIL with the expected rule ids. The corpus
failing to fail fails the gate.

The stacked configs run in this process; every axis config (and the
corpus's axis items) runs inside ONE spawned world of :data:`WORLD` gloo
ranks, each config on a worker group over a prefix of it. There is no
jaxpr lint, HLO pass or AST pass: they read XLA artifacts, which the port
does not make.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._tree import tree_unflatten
from repro_torch.analysis.invariants import (InvariantReport, InvariantSpec,
                                             check_invariants,
                                             check_topology)
from repro_torch.kernels import pack as packing
from repro_torch.launch import mesh

# ------------------------- the sweep model/loss ------------------------------

# the JAX sweep's model: the weight leaf spans both model shards at M=2
# (rows_total == d_in through the packed tile quantum; see
# row_parallel_dot)
DIN, DOUT, B = 512, 64, 8
SEED = 7
PERIOD = 2
WORLD = 8
GROUP_TIMEOUT_S = 60
SPAWN_TIMEOUT_S = 300


def _params() -> dict:
    """The sweep model's weights from a numpy seed (randomness does not
    cross packages, so they are not the JAX sweep's draws)."""
    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((DIN, DOUT)) * 0.02).astype(np.float32)
    return {"bias": torch.zeros(DOUT), "w": torch.from_numpy(w)}


def _loss(p, batch):
    pred = batch["x"] @ p["w"] + p["bias"]
    return torch.mean((pred - batch["y"]) ** 2)


def _sharded_loss(chunks, batch, ctx):
    from repro_torch.train.grad import row_parallel_dot

    h = row_parallel_dot(batch["x"], chunks["w"], DOUT, ctx)
    pred = h + ctx.full_leaf(chunks["bias"], 0)
    return torch.mean((pred - batch["y"]) ** 2)


def _batch(K: int) -> dict:
    rng = np.random.default_rng(SEED + 1)
    return {"x": torch.from_numpy(
                rng.standard_normal((K, B, DIN)).astype(np.float32)),
            "y": torch.from_numpy(
                rng.standard_normal((K, B, DOUT)).astype(np.float32))}


# ------------------------------ sweep configs --------------------------------


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    # 'reference' | 'packed' | 'axis' | 'axis2d' | 'axis2d-packed' |
    # 'axis2d-plan' | 'axis2d-plan-moe'
    backend: str
    kind: str               # 'd-adam' | 'cd-adam'
    variant: str    # 'plain' | 'schedule' | 'stale' | 'overlap' | 'damping'
    K: int = 4
    M: int = 1

    @property
    def name(self) -> str:
        return f"{self.backend}/{self.kind}/{self.variant}"

    @property
    def axis(self) -> bool:
        return self.backend.startswith("axis")


BACKENDS = ("reference", "packed", "axis", "axis2d", "axis2d-packed",
            "axis2d-plan", "axis2d-plan-moe")
# the planned 2D configs' models and tokens: the reduced llama3.2-1b and
# the reduced phi3.5-moe under their sharding plans, 2 sequences of 16
# tokens a worker
PLAN_ARCHS = {"axis2d-plan": "llama3.2-1b",
              "axis2d-plan-moe": "phi3.5-moe-42b-a6.6b"}
PLAN_BATCH, PLAN_SEQ = 2, 16
KINDS = ("d-adam", "cd-adam")
VARIANTS = ("plain", "schedule", "stale", "overlap", "damping")


def sweep_configs(backends: Sequence[str] = BACKENDS,
                  kinds: Sequence[str] = KINDS,
                  variants: Sequence[str] = VARIANTS) -> List[SweepConfig]:
    """The JAX sweep's configs and exclusions, and the port's own three:
    ``axis2d-packed``, the 2D layout without a sharded loss, and
    ``axis2d-plan`` / ``axis2d-plan-moe``, the 2D layout under a sharding
    plan (the reduced llama3.2-1b / phi3.5-moe, ``PLAN_ARCHS``), D-Adam
    plain only."""
    out = []
    for b in backends:
        for k in kinds:
            for v in variants:
                if (b == "axis2d-packed" or b in PLAN_ARCHS) and \
                        (k, v) != ("d-adam", "plain"):
                    continue
                # config validation rejects these combinations: staleness
                # buffers are per-worker payload copies (no row-sharding,
                # so no model_parallel), and CD-Adam's per-edge delay
                # rings have no per-shard addressing under comm='axis'
                if v == "stale" and (b.startswith("axis2d")
                                     or (k == "cd-adam" and b == "axis")):
                    continue
                out.append(SweepConfig(b, k, v, M=2 if b.startswith(
                    "axis2d") else 1))
    return out


def _build(cfg: SweepConfig, device: "str | torch.device",
           group: Optional[mesh.WorkerGroup] = None):
    """(trainer, state, global batch) for one sweep config: stacked on
    ``device``, or this rank's comm='axis' trainer on ``group``."""
    from repro_torch.core.api import make_optimizer
    from repro_torch.train import DampingConfig
    from repro_torch.train.loop import DecentralizedTrainer, stacked_loss

    kw: Dict[str, Any] = dict(eta=1e-2, period=PERIOD)
    if cfg.variant == "schedule":
        kw["topology"] = "one-peer-exp"
    if cfg.variant == "stale":
        kw.update(staleness=1, straggler_rate=0.25)
    if cfg.variant == "overlap":
        kw["overlap"] = True
    extra: Dict[str, Any] = {}
    if cfg.variant == "damping":
        extra["damping"] = DampingConfig(policy="adadamp", max_chunks=2,
                                         per_worker=True)
    if cfg.backend != "reference":
        kw["backend"] = "packed"
    if cfg.axis:
        kw.update(comm="axis", group=group)
    else:
        kw["device"] = device
    if cfg.backend == "axis2d":
        extra["sharded_loss"] = _sharded_loss
    opt = make_optimizer(cfg.kind, cfg.K, **kw)
    if cfg.backend in PLAN_ARCHS:
        return _build_planned(cfg, opt, device)
    trainer = DecentralizedTrainer(stacked_loss(_loss), opt, **extra)
    return trainer, trainer.init(_params()), _batch(cfg.K)


def _build_planned(cfg: SweepConfig, opt, device):
    """A planned 2D config: its reduced arch (``PLAN_ARCHS``) under
    ``make_plan(arch, group)``, its params from a seed on the group's
    device and ``PLAN_BATCH`` x ``PLAN_SEQ`` tokens a worker."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.shardings import make_plan
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import DecentralizedTrainer, stacked_loss

    arch = get_reduced(PLAN_ARCHS[cfg.backend])
    api = build_model(arch.model)
    trainer = DecentralizedTrainer(stacked_loss(api.loss), opt,
                                   plan=make_plan(arch, opt.group))
    params = api.init(torch.Generator(device=opt.device).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, arch.model.vocab_size,
                          (cfg.K, PLAN_BATCH, PLAN_SEQ + 1))
    return (trainer, trainer.init(params),
            {"tokens": torch.from_numpy(tokens.astype(np.int64))})


def expected_launches(cfg: SweepConfig) -> Dict[str, int]:
    """The kernel launches of one period (one local and one comm step) on
    CUDA. Reference launches nothing. Stacked D-Adam on the ring runs its
    comm step as one ``gossip_adam_mix``; over a schedule it mixes with
    ``gossip_mix``, with payload buffers with ``payload_mix``. Under
    comm='axis' the mixes are torch ops, so only the Adam kernel runs.
    CD-Adam's round is one ``consensus_mix`` and one
    ``sign_compress_stacked``, two launches of its ``reduce_axis`` form
    under the 2D layout."""
    if cfg.backend == "reference":
        return {}
    out = {"fused_adam": PERIOD}
    if cfg.kind == "cd-adam":
        out["consensus_mix"] = 1
        if cfg.M > 1:
            out["sign_compress_stacked_reduce"] = 2
        else:
            out["sign_compress_stacked"] = 1
    elif not cfg.axis:
        if cfg.variant in ("plain", "damping"):
            out = {"fused_adam": PERIOD - 1, "gossip_adam_mix": 1}
        elif cfg.variant == "schedule":
            out["gossip_mix"] = 1
        else:
            out["payload_mix"] = 1
    return out


def _wire_like(opt, state) -> Any:
    """What one round's accounting is taken over: for a packed state, the
    rank's padded leaf segments (its block's chunks under the 2D layout),
    which is what the wire carries; else the params."""
    spec = getattr(state, "spec", None)
    if spec is None:
        return opt.params_of(state)
    return tree_unflatten(spec.treedef, [
        torch.empty((1, c), dtype=dt, device="meta")
        for c, dt in zip(packing.local_chunk_elems(spec), spec.dtypes)])


def period_spec(name: str, trainer, state, *, steps: int,
                launches: Optional[Dict[str, int]] = None,
                activation_bytes: int = 0) -> InvariantSpec:
    """The spec of ``steps`` steps of ``trainer.fit`` from ``state`` that
    log once (``log_every=steps``), from the port's own accounting (the
    port has no compiler that inserts collectives, so there is no slack
    for one).

    Stacked: no collective of any kind. Under comm='axis':

    * ``exchange``: at least one when the steps hold a round, none
      otherwise; the bytes at most the rounds' ``comm_bytes_round_list``
      over the padded segments the wire carries (:func:`_wire_like`); a
      single exchange at most one block, ``state.buf`` (a rank's
      ``(1, rows / M, 128)``): no path ships a second copy (a straggler's
      kept payload stays on its receiver);
    * ``all_reduce``: exactly one, the log point's, which carries the loss,
      x·x and the rank's whole block in f64 for the consensus error
      (``train/loop.py``'s ``_log_values``): at most 2 × the block's f32
      bytes + 16;
    * ``worker_all_gather``: none, but one a step of the worker's f32 loss
      under damping (the global damping state);
    * ``model_all_gather``: under the 2D layout's packed mode without a
      sharding plan exactly one a step of this rank's block, the port's
      deliberate difference from JAX's spec, which holds every 2D config
      to 0 all-gathers: the mode gathers the worker's M blocks once and
      differentiates the whole buffer, moving one worker's parameters a
      step. None with a plan (the planned mode), JAX's figure, none in
      the sharded-packed mode, as in JAX's, and none in 1D;
    * ``model_redistribute``: with a plan exactly 2 a step (the block out
      to the plan shards, the gradients back), each at most one block;
      none otherwise;
    * ``model_sum`` (2D): at most ``max(activation_bytes, 4096)`` a call,
      the loss's activation sums, JAX's bound. With a plan the count is
      exact: ``grad.plan_model_sums`` a chunk (``6 L + 3`` for the SwiGLU
      configs, ``9 L + 3`` for the reduced phi3.5-moe) times the chunks
      a step (microbatch, or damping's
      ``max_chunks``) times the steps, one for the log point's consensus,
      and one a round for CD-Adam's scales;
    * ``worker_broadcast`` and ``resize``: none;
    * no uncounted ``torch.distributed`` call, and ``launches`` exactly
      where the run is on CUDA.
    """
    from repro_torch.launch.mesh import COLLECTIVES

    opt = trainer.opt
    group = opt.group
    if group is None:
        return InvariantSpec(name=name,
                             collective_counts={k: 0 for k in COLLECTIVES},
                             launches=launches)
    period, c0 = opt.cfg.period, int(state.count)
    rounds = [c // period - 1 for c in range(c0 + 1, c0 + steps + 1)
              if c % period == 0]
    per_round = opt.comm_bytes_round_list(_wire_like(opt, state))
    block = int(state.buf.nbytes)
    damped = trainer._damping is not None
    mode = trainer.pipeline.mode
    planned = mode == "planned"
    gathers = steps if group.M > 1 and mode == "packed" else 0
    exact = {"all_reduce": 1,
             "worker_all_gather": steps if damped else 0,
             "model_all_gather": gathers, "worker_broadcast": 0,
             "resize": 0, "model_redistribute": 2 * steps if planned else 0}
    if planned:
        from repro_torch.train.grad import plan_model_sums

        plan = trainer._plan
        chunks = trainer.pipeline.damping_chunks or trainer.pipeline.microbatch
        exact["model_sum"] = (
            steps * chunks * plan_model_sums(plan, state.spec,
                                             plan.model_cfg)
            + 1 + (len(rounds) if opt.name in ("cd-adam", "cdadam") else 0))
    single = {"exchange": block, "worker_all_gather": 4,
              "model_all_gather": block, "model_redistribute": block,
              "model_sum": max(activation_bytes, 4096),
              "all_reduce": 2 * block + 16}
    return InvariantSpec(
        name=name,
        collective_counts=exact if rounds else {**exact, "exchange": 0},
        min_collective_counts={**exact, "exchange": 1 if rounds else 0},
        collective_bytes={"exchange": sum(
            per_round[r % len(per_round)] for r in rounds)},
        single_collective_bytes=single, launches=launches)


def spec_for(cfg: SweepConfig, trainer, state) -> InvariantSpec:
    """The spec one period of a sweep config must satisfy
    (:func:`period_spec` with the config's launches)."""
    act = 4 * B * DOUT
    if cfg.backend in PLAN_ARCHS:
        from repro_torch.train.grad import plan_sum_bytes

        act = plan_sum_bytes(trainer._plan.model_cfg, PLAN_BATCH, PLAN_SEQ,
                             cfg.M)
    return period_spec(cfg.name, trainer, state, steps=PERIOD,
                       launches=expected_launches(cfg),
                       activation_bytes=act)


def _period(trainer, state, batch, hook=None):
    """One period through ``fit`` (logging at its last step)."""
    return trainer.fit(state, iter([batch] * PERIOD), PERIOD,
                       log_every=PERIOD, hook=hook,
                       hook_every=PERIOD if hook else 0)


def check_config(cfg: SweepConfig, device: "str | torch.device" = "cuda",
                 group: Optional[mesh.WorkerGroup] = None
                 ) -> InvariantReport:
    """One config's period against its spec: stacked on ``device``, or
    (an axis config) on this rank's ``group``."""
    trainer, state, batch = _build(cfg, device, group)
    return check_invariants(_period, (trainer, state, batch),
                            spec_for(cfg, trainer, state), group,
                            device=device)


@dataclasses.dataclass
class ConfigResult:
    config: str
    reports: List[InvariantReport]   # one a member rank (one if stacked)

    @property
    def ok(self) -> bool:
        return bool(self.reports) and all(r.ok for r in self.reports)


# --------------------------- topology sweep ----------------------------------


def topology_reports() -> List[InvariantReport]:
    """INV006/INV007 across the zoo + the sweep's schedule entries."""
    from repro_torch.core.schedule import make_schedule
    from repro_torch.core.topology import make_topology

    reports = []
    for name, K in TOPOLOGY_ZOO:
        reports.append(check_topology(make_topology(name, K)))
    for entry in make_schedule("one-peer-exp", 8).entries:
        reports.append(check_topology(entry))
    return reports


TOPOLOGY_ZOO = (("ring", 4), ("ring", 5), ("ring", 8), ("exponential", 8),
                ("fully_connected", 6), ("torus", 8), ("torus", 9))


# ----------------------------- serve path ------------------------------------


def serve_decode_report(arch: str = "llama3.2-1b",
                        device: "str | torch.device" = "cuda"
                        ) -> InvariantReport:
    """The serving-side gate: a ``DecodeEngine`` call of the reduced
    ``arch`` (one prefill and three decode steps) makes no
    ``torch.distributed`` call and no ``WorkerGroup`` collective, and on
    CUDA launches the flash kernel once a layer (the prefill) and nothing
    else. Serving replicas are independent: a collective in the decode
    path would stall every replica on its slowest peer."""
    from repro_torch._device import resolve_device
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.models.registry import build_model
    from repro_torch.serve import DecodeEngine, ParamStore

    dev = resolve_device(device)
    cfg = get_reduced(arch).model
    store = ParamStore()
    store.publish(build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0)))
    engine = DecodeEngine(cfg, store, buckets=((4, 16),), max_new_tokens=4)
    toks = torch.zeros((4, 16), dtype=torch.int32, device=dev)
    spec = InvariantSpec(name=f"serve.decode[{arch}]",
                         collective_counts={k: 0 for k in COLLECTIVES},
                         launches={"flash_attention": cfg.n_layers})
    return check_invariants(engine.generate_batch, (toks, 4), spec,
                            device=dev)


# ---------------------------- known-bug corpus -------------------------------

CORPUS_K = 4
# (label, the rule and the check that must fail)
CORPUS_AXIS = (("gather_workers in an axis period", "INV001",
                "worker_all_gather"),
               ("a raw dist.all_reduce in an axis period", "INV001",
                "uncounted"))


def corpus_bad_torus() -> InvariantReport:
    """Torus weights with FLAT circulant offsets: ±1 wraps across row
    boundaries and mixes wrong neighbours; the typed GridShift offsets are
    the fix. INV006 must fail."""
    from repro_torch.core.topology import make_topology

    torus = make_topology("torus", 8)  # 2 x 4 grid
    bad = dataclasses.replace(torus, name="bad-flat-torus",
                              offsets=(1, -1, 4, -4))
    return check_topology(bad)


def corpus_axis_reports(group: mesh.WorkerGroup) -> List[InvariantReport]:
    """This rank's reports of the corpus's axis items, each a plain D-Adam
    period of the sweep model on ``group`` (K = CORPUS_K) gated by the
    plain period's spec, with one collective the spec forbids made in a
    hook: ``gather_workers`` of the params (a worker all-gather), and a
    raw ``dist.all_reduce`` that no ``WorkerGroup`` counts. Both must
    fail (:data:`CORPUS_AXIS`)."""
    from repro_torch.launch.shardings import gather_workers

    cfg = SweepConfig("axis", "d-adam", "plain", K=group.K)
    hooks = (lambda step, st: gather_workers(st.buf, group),
             lambda step, st: dist.all_reduce(torch.zeros(1),
                                              group=group.group))
    reports = []
    for (label, _, _), hook in zip(CORPUS_AXIS, hooks):
        trainer, state, batch = _build(cfg, group.device, group)
        spec = dataclasses.replace(spec_for(cfg, trainer, state),
                                   name=f"corpus:{label}")
        reports.append(check_invariants(
            _period, (trainer, state, batch, hook), spec, group))
    return reports


def _tripped(report: InvariantReport, rule: str, what: str) -> bool:
    return any(c.rule == rule and c.desc.startswith(what)
               for c in report.failures)


def run_corpus(axis_reports: Optional[Sequence[Sequence[InvariantReport]]]
               = None) -> Tuple[bool, List[str]]:
    """Every corpus case must trip its expected rule. ``axis_reports``:
    each member rank's :func:`corpus_axis_reports` (every rank must trip
    each). Returns (ok, log)."""
    lines: List[str] = []
    ok = True

    def expect(label: str, tripped: bool, rule: str, what: str,
               found: Sequence[str]) -> None:
        nonlocal ok
        ok = ok and tripped
        mark = "ok  " if tripped else "FAIL"
        lines.append(f"[{mark}] corpus {label}: expected {rule} on {what}, "
                     f"found {sorted(set(found))}")

    report = corpus_bad_torus()
    expect("flat-circulant torus", _tripped(report, "INV006", "max"),
           "INV006", "offsets_matrix", report.failed_rules())
    if axis_reports is None:
        ok = False
        lines.append("[FAIL] corpus axis items: not run")
    else:
        for i, (label, rule, what) in enumerate(CORPUS_AXIS):
            reps = [r[i] for r in axis_reports]
            expect(label, bool(reps) and all(
                _tripped(r, rule, what) for r in reps), rule, what,
                [f"{c.rule} {c.desc}" for r in reps for c in r.failures])
    return ok, lines


# ------------------------------ the axis world -------------------------------


def _world_rank(rank: int, init_method: str, device: str,
                configs: Sequence[SweepConfig], corpus: bool) -> dict:
    """One rank of the sweep's world: each axis config on a worker group
    over the world's first K M ranks (made once a layout, by every rank in
    one order), then the corpus's axis items. Returns the member's reports
    by config name (``None`` for a rank outside the group)."""
    groups: Dict[Tuple[int, int], mesh.WorkerGroup] = {}

    def group_for(K: int, M: int) -> mesh.WorkerGroup:
        if (K, M) not in groups:
            groups[(K, M)] = mesh.make_worker_group(
                K, model_parallel=M, init_method=init_method, rank=rank,
                device=device, backend="gloo", timeout_s=GROUP_TIMEOUT_S)
        return groups[(K, M)]

    out: Dict[str, Any] = {}
    for cfg in configs:
        g = group_for(cfg.K, cfg.M)
        out[cfg.name] = check_config(cfg, device, g) if g.member else None
    if corpus:
        g = group_for(CORPUS_K, 1)
        out["corpus"] = corpus_axis_reports(g) if g.member else None
    return out


def run_axis(configs: Sequence[SweepConfig], device: str, corpus: bool
             ) -> Tuple[List[ConfigResult], Optional[List[list]]]:
    """The axis configs (and the corpus's axis items) in one spawned world
    of WORLD gloo ranks on ``device`` (every rank on ``cuda:0`` of a
    one-card host, staged through host memory)."""
    if not configs and not corpus:
        return [], None
    ranks = mesh.spawn(_world_rank, WORLD, (device, list(configs), corpus),
                       timeout_s=SPAWN_TIMEOUT_S, threads=1)
    results = [ConfigResult(c.name, [r[c.name] for r in ranks
                                     if r[c.name] is not None])
               for c in configs]
    axis_corpus = ([r["corpus"] for r in ranks if r["corpus"] is not None]
                   if corpus else None)
    return results, axis_corpus


# ------------------------------ entry points ---------------------------------


def run(backends: Sequence[str] = BACKENDS,
        kinds: Sequence[str] = KINDS,
        variants: Sequence[str] = VARIANTS,
        *, corpus: bool = True, verbose: bool = False,
        device: "str | torch.device" = "cuda",
        log: Callable[[str], None] = print) -> bool:
    """The gate: sweep + topology zoo + serving gate + known-bug corpus.
    Returns overall pass/fail; prints per-config reports and per-rule
    counts."""
    from repro_torch._device import resolve_device

    device = str(resolve_device(device))
    configs = sweep_configs(backends, kinds, variants)
    results = [ConfigResult(c.name, [check_config(c, device)])
               for c in configs if not c.axis]
    axis_results, axis_corpus = run_axis(
        [c for c in configs if c.axis], device, corpus)
    results += axis_results

    ok = True
    rule_counts: Dict[str, int] = {}

    def tally(report: InvariantReport) -> None:
        for c in report.failures:
            rule_counts[c.rule] = rule_counts.get(c.rule, 0) + 1

    for res in results:
        ok = ok and res.ok
        log(f"[{'ok  ' if res.ok else 'FAIL'}] {res.config} "
            f"({len(res.reports)} rank{'s' * (len(res.reports) != 1)})")
        for i, report in enumerate(res.reports):
            tally(report)
            if (verbose and i == 0) or not report.ok:
                for line in report.format(verbose=verbose).splitlines()[1:]:
                    log(f"     {line}")

    zoo = topology_reports()
    zoo_ok = all(r.ok for r in zoo)
    ok = ok and zoo_ok
    for report in zoo:
        tally(report)
        if not report.ok:
            log(report.format(verbose=False))
    log(f"[{'ok  ' if zoo_ok else 'FAIL'}] topology zoo + schedule entries "
        "(INV006/INV007)")

    serve_rep = serve_decode_report(device=device)
    ok = ok and serve_rep.ok
    tally(serve_rep)
    if not serve_rep.ok or verbose:
        log(serve_rep.format(verbose=verbose))
    log(("[ok  ] " if serve_rep.ok else "[FAIL] ")
        + "serve decode: no collective, no torch.distributed call")

    if corpus:
        corpus_ok, lines = run_corpus(axis_corpus)
        ok = ok and corpus_ok
        for line in lines:
            log(line)

    if rule_counts:
        log("per-rule findings: " + ", ".join(
            f"{r}={n}" for r, n in sorted(rule_counts.items())))
    log("check_invariants: " + ("PASS" if ok else "FAIL"))
    return ok


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="The port's invariant gate: every training layout's "
                    "communication period, the topology zoo, the serving "
                    "gate and the known-bug corpus. Exits 0 iff all hold.")
    ap.add_argument("--backends", nargs="+", default=list(BACKENDS),
                    choices=BACKENDS)
    ap.add_argument("--kinds", nargs="+", default=list(KINDS), choices=KINDS)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--no-corpus", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    ok = run(args.backends, args.kinds, args.variants,
             corpus=not args.no_corpus, verbose=args.verbose,
             device=args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
