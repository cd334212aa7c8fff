"""Declarative collective, launch and topology gates (rule namespace
``INV``), the port of ``repro.analysis.invariants``.

The JAX package evaluates the compiled (partitioned) HLO of one step. The
port has no compiled program, so its gate evaluates what a run of the code
under test actually did, from three counters read around it:

* the collectives the rank's :class:`~repro_torch.launch.mesh.WorkerGroup`
  made, by kind (``collective_summary()``: count, bytes and the largest
  single call);
* the CUDA kernel launches (``kernels.ops.launch_counts()``);
* every call into ``torch.distributed``'s collective and point-to-point
  functions made while the code ran (:func:`distributed_calls`), of which
  those that no ``WorkerGroup`` counted are ``uncounted``.

::

    spec = InvariantSpec(
        name="axis-period",
        collective_counts={"model_all_gather": 0, "worker_all_gather": 0},
        min_collective_counts={"exchange": 1},
        collective_bytes={"exchange": budget},
        single_collective_bytes={"exchange": block_bytes},
        launches={"fused_adam": 2})
    assert_invariants(lambda: trainer.fit(state, batches, 2), (), spec,
                      group=group)

Rules:

=======  ====================================================
INV001   per-kind collective count bound (max and min); the port's
         exact per-kernel launch counts, and no uncounted
         ``torch.distributed`` call
INV002   per-kind collective byte budget ("*" = total)
INV003   max single-collective bytes
INV004   no torch meaning: the port runs no compiled program (JAX: while-
         loop trip counts); never emitted
INV005   no torch meaning: the port runs no compiled program (JAX: unknown
         dtypes in the HLO byte count); never emitted
INV006   mixing-matrix lowering: offsets_matrix(topo) == weights
INV007   mixing weights doubly stochastic
=======  ====================================================

The kinds are ``launch.mesh.COLLECTIVES``. Against the JAX package's five
HLO kinds: ``exchange`` is ``collective-permute``;
``model_all_gather`` and ``worker_all_gather`` are ``all-gather``;
``all_reduce`` and ``model_sum`` are ``all-reduce``;
``model_redistribute`` (the sharding plan's shards out of the packed
blocks and back) is the port's form of what GSPMD's layout changes move;
``worker_broadcast`` and ``resize`` have no HLO counterpart, and
``reduce-scatter`` and ``all-to-all`` have no port counterpart. Bytes are this rank's
contribution: what it sends, or puts into a gather or a sum.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence)

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import mesh

_NO_TORCH_MEANING = "no torch meaning: the port runs no compiled program"

RULES = {
    "INV001": "collective count out of bounds",
    "INV002": "collective byte budget exceeded",
    "INV003": "single collective larger than bound",
    "INV004": f"while-loop trip count ({_NO_TORCH_MEANING})",
    "INV005": f"unknown dtype in byte accounting ({_NO_TORCH_MEANING})",
    "INV006": "mixing-matrix lowering mismatch (offsets vs weights)",
    "INV007": "mixing weights not doubly stochastic",
}

# the torch.distributed functions :func:`distributed_calls` watches. isend
# and irecv are left out: ``P2POp`` checks its op by identity, so a
# wrapped one would break ``batch_isend_irecv``
WATCHED = ("all_reduce", "all_gather", "all_gather_into_tensor",
           "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
           "all_to_all_single", "broadcast", "reduce", "gather", "scatter",
           "send", "recv", "batch_isend_irecv", "barrier",
           "all_gather_object", "broadcast_object_list", "gather_object",
           "scatter_object_list")


@dataclasses.dataclass(frozen=True)
class InvariantSpec:
    """Bounds evaluated against one run's counters.

    Absent keys are unchecked; kinds are ``launch.mesh.COLLECTIVES``;
    ``"*"`` in ``collective_bytes`` bounds the total across kinds.
    ``launches``: exact launches by kernel name (a name absent is 0),
    checked only where the run was on CUDA (the plain versions launch
    nothing); ``None`` leaves them unchecked. Every spec allows no
    ``torch.distributed`` call that no ``WorkerGroup`` counted: the port
    has no compiler that inserts one, so there is no slack for it."""
    name: str = "step"
    collective_counts: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    min_collective_counts: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    collective_bytes: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    single_collective_bytes: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    launches: Optional[Mapping[str, int]] = None


@dataclasses.dataclass(frozen=True)
class Check:
    rule: str
    desc: str
    observed: Any
    bound: Any
    ok: bool

    def __str__(self) -> str:
        mark = "ok  " if self.ok else "FAIL"
        return (f"[{mark}] {self.rule} {self.desc}: "
                f"observed={self.observed} bound={self.bound}")


@dataclasses.dataclass
class InvariantReport:
    name: str
    checks: List[Check] = dataclasses.field(default_factory=list)
    # informational per-kind {count, bytes, max_bytes}, for printing
    summary: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    @property
    def failures(self) -> List[Check]:
        return [c for c in self.checks if not c.ok]

    def failed_rules(self) -> List[str]:
        return sorted({c.rule for c in self.failures})

    def format(self, *, verbose: bool = True) -> str:
        lines = [f"invariants[{self.name}]: "
                 + ("PASS" if self.ok else "FAIL")]
        for kind, s in self.summary.items():
            lines.append(
                f"  {kind:<19} count={s['count']:<4} "
                f"bytes={s['bytes']:<12} max_bytes={s['max_bytes']}")
        for c in self.checks:
            if verbose or not c.ok:
                lines.append(f"  {c}")
        return "\n".join(lines)


class InvariantViolation(AssertionError):
    def __init__(self, report: InvariantReport):
        self.report = report
        super().__init__(report.format(verbose=False))


# ------------------------- raw torch.distributed calls ----------------------


@contextlib.contextmanager
def distributed_calls() -> Iterator[List[str]]:
    """The uncounted ``torch.distributed`` calls of the block: every call
    of a :data:`WATCHED` function made through the ``torch.distributed``
    module while the block runs, but by the ``WorkerGroup`` transport (a
    function of ``launch.mesh`` in ``mesh.COUNTING``), as
    ``"function <- module.caller"``. The functions are wrapped on the
    module for the block and restored after it, so a caller that imported
    one by name is not seen; the wrapping is process-wide and not
    thread-safe."""
    uncounted: List[str] = []
    originals = {n: getattr(dist, n) for n in WATCHED if hasattr(dist, n)}

    def watch(name: str, fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            caller = sys._getframe(1)
            module = caller.f_globals.get("__name__")
            if module != mesh.__name__ or \
                    caller.f_code.co_name not in mesh.COUNTING:
                uncounted.append(
                    f"{name} <- {module}.{caller.f_code.co_name}")
            return fn(*args, **kwargs)
        return wrapper

    for name, fn in originals.items():
        setattr(dist, name, watch(name, fn))
    try:
        yield uncounted
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


# ------------------------------- evaluation ---------------------------------


def _zero_summary() -> Dict[str, Dict[str, int]]:
    return {k: {"count": 0, "bytes": 0, "max_bytes": 0}
            for k in mesh.COLLECTIVES}


def evaluate(summary: Optional[Mapping[str, Mapping[str, int]]],
             spec: InvariantSpec,
             launches: Optional[Mapping[str, int]] = None,
             uncounted: int = 0) -> InvariantReport:
    """The torch form of ``evaluate_hlo``: ``spec`` against a
    ``collective_summary()`` (``None``: no worker group, every kind 0),
    the launch counts of a run on CUDA (``None``: not checked) and the
    number of uncounted ``torch.distributed`` calls, which must be 0."""
    report = InvariantReport(spec.name)
    report.summary = _zero_summary()
    for kind, s in (summary or {}).items():
        report.summary[kind] = {"count": int(s["count"]),
                                "bytes": int(s["bytes"]),
                                "max_bytes": int(s["max_bytes"])}
    got = report.summary
    add = report.checks.append

    for kind, bound in spec.collective_counts.items():
        n = got[kind]["count"]
        add(Check("INV001", f"{kind} count <=", n, bound, n <= bound))
    for kind, bound in spec.min_collective_counts.items():
        n = got[kind]["count"]
        add(Check("INV001", f"{kind} count >=", n, bound, n >= bound))
    add(Check("INV001", "uncounted torch.distributed calls ==", uncounted,
              0, uncounted == 0))
    if spec.launches is not None and launches is not None:
        for name in sorted(set(spec.launches) | {
                n for n, c in launches.items() if c}):
            n, want = launches.get(name, 0), spec.launches.get(name, 0)
            add(Check("INV001", f"{name} launches ==", n, want, n == want))
    for kind, bound in spec.collective_bytes.items():
        b = (sum(s["bytes"] for s in got.values()) if kind == "*"
             else got[kind]["bytes"])
        add(Check("INV002", f"{kind} bytes <=", b, bound, b <= bound))
    for kind, bound in spec.single_collective_bytes.items():
        b = got[kind]["max_bytes"]
        add(Check("INV003", f"{kind} max single <=", b, bound, b <= bound))
    return report


def check_invariants(fn: Callable, args: Sequence[Any], spec: InvariantSpec,
                     group: Optional[mesh.WorkerGroup] = None, *,
                     device: "str | torch.device | None" = None
                     ) -> InvariantReport:
    """Reset ``group``'s counters, run ``fn(*args)`` once while
    :func:`distributed_calls` watches, and evaluate ``spec``. The launches
    are those the run added to ``ops.launch_counts()`` (which is not
    reset, so a caller may read its own span around this one), checked
    when the run was on CUDA: ``group``'s device, or ``device`` without a
    group."""
    from repro_torch.kernels import ops

    if group is not None:
        group.reset_counts()
    before = ops.launch_counts()
    with distributed_calls() as uncounted:
        fn(*args)
    after = ops.launch_counts()
    dev = torch.device(group.device if group is not None else
                       device or "cpu")
    return evaluate(None if group is None else group.collective_summary(),
                    spec, {n: after[n] - before[n] for n in after}
                    if dev.type == "cuda" else None, len(uncounted))


def assert_invariants(fn: Callable, args: Sequence[Any], spec: InvariantSpec,
                      group: Optional[mesh.WorkerGroup] = None, *,
                      device: "str | torch.device | None" = None
                      ) -> InvariantReport:
    """Run ``fn(*args)`` once and gate its counters against ``spec``
    (:func:`check_invariants`).

    Args:
      fn: the code under test, run once as it is (the port compiles
        nothing); every rank of ``group`` must run it, as any collective
        code.
      args: its arguments.
      spec: the :class:`InvariantSpec` bounds to enforce.
      group: the rank's worker group, whose counters are reset before the
        run and read after it; ``None`` for code that should make no
        ``WorkerGroup`` collective (its summary is all zeros).
      device: where a run without a group runs; the launches are checked
        on CUDA only (the plain versions launch nothing).

    Returns:
      The passing :class:`InvariantReport` (per-kind collective summary
      plus every evaluated check), for logging.

    Raises:
      InvariantViolation: any bound fails; the exception message is the
        report's failure lines and ``.report`` carries the full object.

    Example:
      >>> import torch
      >>> from repro_torch.analysis.invariants import (InvariantSpec,
      ...                                              assert_invariants)
      >>> spec = InvariantSpec(name="elementwise",
      ...                      collective_counts={"exchange": 0})
      >>> assert_invariants(lambda x: x * 2, (torch.ones(8),), spec).ok
      True
    """
    report = check_invariants(fn, args, spec, group, device=device)
    if not report.ok:
        raise InvariantViolation(report)
    return report


# --------------------------- topology invariants -----------------------------


def check_topology(topo: Any, *, atol: float = 1e-8) -> InvariantReport:
    """INV006/INV007 on one Topology: the typed-offset lowering must
    reproduce the dense mixing matrix (a flat offset list on a torus mixes
    wrong neighbours at row boundaries), and the matrix must be doubly
    stochastic."""
    from repro_torch.core import topology as topo_mod

    report = InvariantReport(f"topology:{getattr(topo, 'name', '?')}")
    W = np.asarray(topo.weights, dtype=np.float64)
    lowered = topo_mod.offsets_matrix(topo)
    diff = float(np.max(np.abs(W - lowered))) if W.size else 0.0
    report.checks.append(Check(
        "INV006", "max |offsets_matrix - weights| <=", diff, atol,
        diff <= atol))
    row = float(np.max(np.abs(W.sum(axis=1) - 1.0))) if W.size else 0.0
    col = float(np.max(np.abs(W.sum(axis=0) - 1.0))) if W.size else 0.0
    neg = float(-min(0.0, float(W.min()))) if W.size else 0.0
    report.checks.append(Check(
        "INV007", "doubly-stochastic defect <=", max(row, col, neg), atol,
        max(row, col, neg) <= atol))
    return report


def check_schedule(schedule: Any, *, atol: float = 1e-8
                   ) -> List[InvariantReport]:
    """Per-entry topology invariants of a TopologySchedule."""
    return [check_topology(e, atol=atol) for e in schedule.entries]


def assert_topology(topo: Any, *, atol: float = 1e-8) -> InvariantReport:
    report = check_topology(topo, atol=atol)
    if not report.ok:
        raise InvariantViolation(report)
    return report
