"""Public facade: build a decentralized optimizer, the port of
``repro.core.api``.

    opt = make_optimizer("d-adam", K=8, period=16, topology="ring",
                         backend="packed")          # on cuda by default
    opt = make_optimizer("cd-adam", K=8, period=16, gamma=0.4,
                         compressor="sign", backend="packed")
    opt = make_optimizer("d-adam", K=8, period=4, staleness=2,
                         straggler_rate=0.3, backend="packed")
    opt = make_optimizer("d-adam", K=8, topology="one-peer-exp",
                         overlap=True, backend="packed")
    state = opt.init(stacked_params)
    state = opt.step(state, stacked_grads)      # host-side comm-skip test
    state = opt.round(state, grad_fn, batches)  # p local steps + 1 gossip

With ``backend='packed'`` the state returned by ``opt.init`` is
packed-resident (:class:`~repro_torch.core.dadam.PackedDAdamState`,
:class:`~repro_torch.core.cdadam.PackedCDAdamState`) and
``opt.step`` accepts grads as a congruent tree or an already packed
buffer; ``opt.params_of`` gives the tree view for both backends.

With ``comm='axis'`` each worker is a process of its own (SPMD over
``torch.distributed``; ``group=`` is this rank's
``launch.mesh.WorkerGroup``, the torch form of the JAX package's
``mesh=``). ``opt.init`` takes the stacked ``(K, ...)`` params as under
``comm='stacked'`` and keeps the rank's ``(1, ...)`` slice; ``opt.step``
takes the rank's own grads and ``opt.round`` its ``(p, 1, ...)``
batches; ``opt.params_of`` gives the rank's slice and
``opt.gather_params`` all K. Every worker shift is one exchange with the
offset's peers, so only the neighbour blocks (or, for CD-Adam, the int8
signs and their scales) travel.

    group = make_worker_group(K)          # under torchrun --nproc-per-node K
    opt = make_optimizer("d-adam", K, comm="axis", group=group,
                         backend="packed")

A group made with ``model_parallel=M`` (K x M ranks) declares the 2D
worker x model layout, as the JAX package's mesh with a ``'model'`` axis
does, for ``backend='packed'``: ``cfg.model_parallel`` is M, each rank
keeps one ``(1, rows / M, 128)`` block of its worker's row-sharded
buffers, gossip crosses only the worker axis, and CD-Adam's scales are
summed over the worker's M ranks. ``opt.params_of`` then all-gathers the
worker's blocks (every rank of the model group must call it), and
``opt.sharded_value_and_grad`` is the hook of the grad pipeline's
``'sharded-packed'`` mode. Under ``backend='reference'`` a 2D group keeps
the 1D layout, the state replicated over each model group.

    group = make_worker_group(K, model_parallel=2)   # K x 2 ranks
    opt = make_optimizer("cd-adam", K, comm="axis", group=group,
                         backend="packed")
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import baselines, cdadam, dadam
from repro_torch.core.cdadam import CDAdamConfig
from repro_torch.core.compression import (Compressor, make_compressor,
                                          tree_dense_bytes, tree_wire_bytes)
from repro_torch.core.dadam import ArrivalFn, DAdamConfig
from repro_torch.core.schedule import (SCHEDULES, TopologySchedule,
                                       comm_offsets, make_schedule)
from repro_torch.core.topology import Topology, make_topology
from repro_torch.kernels import pack as packing
from repro_torch.launch.mesh import model_all_gather
from repro_torch.launch.shardings import gather_workers, take_worker

PyTree = Any


@dataclasses.dataclass(frozen=True)
class DecentralizedOptimizer:
    name: str
    topo: "Topology | TopologySchedule"
    cfg: Any
    device: torch.device
    init: Callable[[PyTree], Any]
    step: Callable[[Any, PyTree], Any]
    round: Callable[[Any, Callable, Any], Any]
    params_of: Callable[[Any], PyTree]
    # re-run make_optimizer with this optimizer's kwargs plus overrides
    rebuild: Any = None
    # CD-Adam's wire compressor; None for uncompressed gossip
    compressor: Optional[Compressor] = None
    # comm='axis': this rank's launch.mesh.WorkerGroup; None when stacked
    group: Any = None
    # the 2D layout's hook for the grad pipeline's 'sharded-packed' mode:
    # ``(local_vag, state, batch) -> (losses (1,), grads block)``, which
    # runs ``local_vag(block, batch)`` on this rank's (1, rows/M, 128)
    # block and its worker's batch; None unless cfg.model_parallel > 1
    sharded_value_and_grad: Any = None

    @property
    def K(self) -> int:
        return self.topo.K

    def gather_params(self, state: Any) -> PyTree:
        """All K workers' params, stacked ``(K, ...)``: ``params_of``
        itself under ``comm='stacked'``; under ``comm='axis'`` the ranks'
        slices gathered (every rank must call it, and gets all of them;
        under the 2D layout over both axes)."""
        params = self.params_of(state)
        if self.group is None:
            return params
        return gather_workers(params, self.group)

    def _degree(self) -> int:
        """Peers each worker exchanges with per round on a static
        topology: the shift offsets, or the weight matrix's off-diagonal
        support when mixing densely."""
        if self.topo.offsets and self.cfg.mixing != "dense":
            return len(self.topo.offsets)
        return len(self.topo.neighbors_of(0))

    def _union_exchange(self) -> bool:
        """Whether a schedule exchanges over the UNION edge set every
        round: per-edge-state consumers (CD-Adam payloads, staleness and
        overlap buffers) keep every edge's state aligned across the
        cycle."""
        return (self.compressor is not None
                or (getattr(self.cfg, "staleness", None) or 0) > 0
                or bool(getattr(self.cfg, "overlap", False)))

    def _bytes_for_degree(self, deg: int, per_worker: PyTree) -> int:
        """Wire bytes one worker sends in a round of gossip degree
        ``deg``: dense params, the compressor's payload per leaf, or (for
        ``scales='worker'``) an int8 sign per element and one f32 scale."""
        if self.compressor is None:
            return deg * tree_dense_bytes(per_worker)
        if getattr(self.cfg, "scales", "leaf") == "worker":
            n = sum(x.numel() for x in tree_leaves(per_worker))
            return deg * (n + 4)
        return deg * tree_wire_bytes(self.compressor, per_worker)

    def comm_bytes_per_round(self, params: PyTree) -> "int | float":
        """Bytes each worker sends per communication round (the paper's
        'communication cost (MB)' x-axes). For a schedule without
        per-edge state this is the cycle average; per-round accounting is
        :meth:`comm_bytes_round_list`."""
        per_worker = tree_map(lambda x: x[0], params)
        if isinstance(self.topo, TopologySchedule):
            if self._union_exchange():
                deg = len(self.topo.union_offsets())
            else:
                deg = float(np.mean([len(e.offsets)
                                     for e in self.topo.entries]))
            return self._bytes_for_degree(deg, per_worker)
        return self._bytes_for_degree(self._degree(), per_worker)

    def comm_bytes_round_list(self, params: PyTree) -> list:
        """Per-round bytes across one schedule cycle: entry ``r % len`` is
        what a worker sends in communication round ``r``. A static
        topology, and a schedule with per-edge state (which exchanges
        over the union every round), have one entry."""
        per_worker = tree_map(lambda x: x[0], params)
        if (isinstance(self.topo, TopologySchedule)
                and not self._union_exchange()):
            return [self._bytes_for_degree(len(e.offsets), per_worker)
                    for e in self.topo.entries]
        return [self.comm_bytes_per_round(params)]


def resolve_topology(topology: "str | Topology | TopologySchedule",
                     K: int) -> "Topology | TopologySchedule":
    """A string names either a static zoo graph (-> Topology) or a
    time-varying schedule family like ``one-peer-exp`` / ``rand-ring:6``
    (-> TopologySchedule); built instances pass through (K-checked)."""
    if isinstance(topology, (Topology, TopologySchedule)):
        if topology.K != K:
            raise ValueError(
                f"topology {topology.name!r} is over K={topology.K} "
                f"workers, optimizer has K={K}")
        return topology
    name = topology.partition(":")[0].replace("_", "-")
    if name in SCHEDULES:
        return make_schedule(topology, K)
    return make_topology(topology, K)


def make_optimizer(
    kind: str,
    K: int,
    *,
    topology: "str | Topology" = "ring",
    period: int = 1,
    eta: float = 1e-3,
    beta1: float = 0.9,
    beta2: float = 0.999,
    tau: float = 1e-6,
    weight_decay: float = 0.0,
    bias_correction: bool = False,
    gamma: float = 0.4,
    compressor: "str | Compressor" = "sign",
    scales: str = "leaf",
    mixing: str = "roll",
    moment_dtype: Optional[torch.dtype] = None,
    backend: str = "reference",
    comm: str = "stacked",
    group: Any = None,
    axis_name: str = "worker",
    staleness: Optional[int] = None,
    straggler_rate: float = 0.0,
    straggler_seed: int = 0,
    overlap: bool = False,
    arrival: Optional[ArrivalFn] = None,
    device: "str | torch.device | None" = None,
    **comp_kw,
) -> DecentralizedOptimizer:
    """Build a decentralized optimizer over ``K`` stacked workers.

    Args:
      kind: ``"d-adam"`` (Alg. 1), ``"cd-adam"`` (Alg. 2, compressed
        gossip with error feedback), ``"d-adam-vanilla"`` (period forced
        to 1) or the baseline ``"d-psgd"`` (reference backend only).
      K: number of workers; params enter ``opt.init`` with a leading K dim
        on every leaf.
      topology: a zoo name (``"ring"``, ``"torus"``, ``"exponential"``,
        ``"fully_connected"``), a schedule spec (``"one-peer-exp"``,
        ``"rand-ring:N"``), or a built ``Topology`` /
        ``TopologySchedule`` (K-checked).
      period: local steps per gossip round (the paper's p).
      eta, beta1, beta2, tau, weight_decay, bias_correction: Adam.
      gamma: CD-Adam's consensus step size.
      compressor: CD-Adam's wire compressor, a name of
        :mod:`repro_torch.core.compression` or a built ``Compressor``;
        ``backend="packed"`` takes ``"sign"`` only. ``**comp_kw`` goes to
        its factory.
      scales: CD-Adam's sign-scale granularity, ``"leaf"`` or ``"worker"``
        (one scale per worker; packed only).
      mixing: ``"roll"`` mixes by one shift per offset, ``"dense"`` by
        the mixing matrix.
      moment_dtype: storage dtype of the Adam moments (``torch.bfloat16``
        for big models); ``None`` keeps the param dtype. The reference
        backend computes the update in this dtype, as the JAX package's
        does; the packed kernels compute in f32 and round m and v to it.
      backend: ``"reference"`` (tree math) or ``"packed"`` (resident
        ``(K, rows, 128)`` state and the CUDA kernels).
      comm: ``"stacked"`` (all workers on one device) or ``"axis"`` (one
        worker per process; needs ``group``).
      group: ``comm="axis"``'s worker group
        (``launch.mesh.make_worker_group``): K ranks, this one's device.
        Only meaningful with ``comm="axis"``. A group of K x M ranks
        (``model_parallel=M``) selects the 2D layout for
        ``backend="packed"``. On a rank that is no member of the group
        (past K x M ranks of a larger world) the optimizer is only the new
        membership of ``core.elastic.resize_state``: its ``init``
        raises.
      axis_name: the worker axis's name; the group's must equal it.
      staleness: bounded-staleness gossip (tau rounds), with
        ``straggler_rate`` / ``straggler_seed`` modelling late payloads.
        Mutually exclusive with ``overlap``.
      overlap: delay-1 wire schedule: round r sends its payload and
        round r+1 mixes it. For CD-Adam this is bit for bit the
        ``staleness=1`` delay ring with every payload late.
      arrival: D-Adam's straggler trace, a callable ``r -> (K, deg)`` bool
        array (deg: the topology's, or the schedule's union, offsets);
        by default a CPU ``torch.Generator`` seeded by
        ``(straggler_seed, r)`` draws it. Consulted only when
        ``straggler_rate > 0``.
      device: where ``opt.init`` puts the state; ``cuda`` unless
        ``"cpu"`` is asked for; under ``comm="axis"`` the group's device,
        which a given ``device`` must equal. Raises ``RuntimeError``
        without CUDA.

    Raises:
      NotImplementedError: a kind, comm mode or option not ported yet.
      ValueError: an inconsistent combination: ``scales`` on a kind other
        than CD-Adam, a non-sign compressor on ``backend="packed"``,
        d-psgd on a kernel backend, a schedule or ``comm="axis"``,
        ``mixing="dense"`` with a schedule, with staleness / overlap or
        with ``comm="axis"``, ``staleness`` together with ``overlap``;
        ``comm="axis"`` without a group, with a group of another size or
        axis name, or over a topology without shift offsets; ``group``
        without ``comm="axis"``; CD-Adam staleness under ``comm="axis"``.
      KeyError: unknown kind, compressor or topology name.
    """
    factory_kwargs: Dict[str, Any] = dict(
        kind=kind, K=K, topology=topology, period=period, eta=eta,
        beta1=beta1, beta2=beta2, tau=tau, weight_decay=weight_decay,
        bias_correction=bias_correction, gamma=gamma, compressor=compressor,
        scales=scales, mixing=mixing, moment_dtype=moment_dtype,
        backend=backend, comm=comm, group=group, axis_name=axis_name,
        staleness=staleness, straggler_rate=straggler_rate,
        straggler_seed=straggler_seed, overlap=overlap, arrival=arrival,
        device=device, **comp_kw)
    topo = resolve_topology(topology, K)
    kind = kind.lower().replace("_", "-")
    if scales != "leaf" and kind not in ("cd-adam", "cdadam"):
        raise ValueError("scales= selects CD-Adam's compression-scale "
                         f"granularity; meaningless for {kind!r}")
    if isinstance(topo, TopologySchedule):
        if mixing == "dense":
            raise ValueError(
                "time-varying schedules run per-entry shifts over their "
                "offsets; mixing='dense' has no round-indexed form (use "
                "mixing='roll')")
        if kind in ("d-psgd", "dpsgd"):
            raise ValueError(
                "d-psgd is the static-graph baseline; time-varying "
                "schedules are wired for d-adam / cd-adam")
    adam = dict(eta=eta, beta1=beta1, beta2=beta2, tau=tau, period=period,
                weight_decay=weight_decay, bias_correction=bias_correction,
                mixing=mixing, moment_dtype=moment_dtype, backend=backend,
                comm=comm, axis_name=axis_name, group=group,
                staleness=staleness, straggler_rate=straggler_rate,
                straggler_seed=straggler_seed, overlap=overlap)
    # 2D execution is declared by the group, as JAX's by its mesh: only the
    # packed backend has a row dim to cut; under 'reference' a 2D group
    # keeps the 1D layout, the state replicated over each model group
    if comm == "axis" and backend == "packed" and group is not None \
            and group.M > 1:
        adam["model_parallel"] = group.M
    comp = None

    if kind in ("d-adam", "dadam", "d-adam-vanilla"):
        if kind == "d-adam-vanilla":
            adam["period"] = 1
        cfg = DAdamConfig(**adam)
        cfg.validate()
        init_fn = lambda p: dadam.init(p, cfg, topo)
        step = lambda s, g: dadam.step(s, g, topo, cfg, arrival)
        round_ = lambda s, fn, b: dadam.round_step(s, fn, b, topo, cfg,
                                                   arrival)

    elif kind in ("cd-adam", "cdadam"):
        comp = (compressor if isinstance(compressor, Compressor)
                else make_compressor(compressor, **comp_kw))
        if backend == "packed" and comp.name != "sign":
            raise ValueError(
                "backend='packed' runs the sign compressor's kernels; got "
                f"compressor={comp.name!r} (use backend='reference')")
        cfg = CDAdamConfig(gamma=gamma, scales=scales, **adam)
        cfg.validate()
        init_fn = lambda p: cdadam.init(p, cfg, topo, comp)
        step = lambda s, g: cdadam.step(s, g, topo, cfg, comp)
        round_ = lambda s, fn, b: cdadam.round_step(s, fn, b, topo, cfg,
                                                    comp)

    elif kind in ("d-psgd", "dpsgd"):
        if overlap:
            raise ValueError("overlap is wired for d-adam / cd-adam")
        if backend != "reference":
            raise ValueError("d-psgd has no kernel backend; "
                             "use backend='reference'")
        if comm != "stacked":
            raise ValueError("d-psgd only implements comm='stacked'")
        cfg = baselines.DPSGDConfig(eta=eta, weight_decay=weight_decay,
                                    period=period, mixing=mixing)
        init_fn = lambda p: baselines.dpsgd_init(p, cfg)
        step = lambda s, g: baselines.dpsgd_step(s, g, topo, cfg)
        round_ = None

    else:
        raise KeyError(f"unknown optimizer kind {kind!r}")
    dev = _check_axis(comm, group, axis_name, topo, device)
    two_d = getattr(cfg, "model_parallel", 1) > 1

    def init(params: PyTree):
        on = resolve_device(dev)
        if group is not None:
            if not group.member:
                raise ValueError(
                    f"global rank {group.global_rank} holds no worker of "
                    f"this group of {K} x {group.M} ranks")
            # the 2D layout packs the rank's block straight from a view
            params = take_worker(params, group.rank, K, copy=not two_d)
        return init_fn(tree_map(lambda x: x.to(on), params))

    def params_of(state):
        if two_d and hasattr(state, "spec"):
            return packing.unpack(model_all_gather(state.buf, group),
                                  state.spec)
        return state.params

    sharded_vag = None
    if two_d:
        def sharded_vag(local_vag: Callable, state: Any, batch: PyTree):
            return local_vag(state.buf, batch)

    return DecentralizedOptimizer(
        name=kind, topo=topo, cfg=cfg, device=dev, init=init, step=step,
        round=round_, params_of=params_of,
        rebuild=lambda **ov: make_optimizer(**{**factory_kwargs, **ov}),
        compressor=comp, group=group, sharded_value_and_grad=sharded_vag)


def _check_axis(comm: str, group: Any, axis_name: str,
                topo: "Topology | TopologySchedule",
                device: "str | torch.device | None") -> torch.device:
    """JAX's ``comm='axis'`` checks, at construction; returns the state's
    device: the group's under ``comm='axis'``, else ``device`` (``cuda``
    by default)."""
    if comm != "axis":
        if group is not None:
            raise ValueError("group= is only meaningful with comm='axis'")
        return resolve_device("cuda" if device is None else device)
    if group is None:
        raise ValueError(
            "comm='axis' needs group= (launch.mesh.make_worker_group: one "
            "rank a worker, the torch form of the JAX package's mesh=)")
    if group.K != topo.K:
        raise ValueError(f"comm='axis' needs a worker group of size K="
                         f"{topo.K}; the group has {group.K} ranks")
    if group.axis_name != axis_name:
        raise ValueError(f"comm='axis' needs the worker axis {axis_name!r}; "
                         f"the group's is {group.axis_name!r}")
    if topo.K > 1 and not comm_offsets(topo):
        raise ValueError(
            f"comm='axis' needs a shift-invariant topology; {topo.name!r} "
            "has no shift structure (use comm='stacked' for dense-mixing "
            "graphs)")
    if device is not None and resolve_device(device) != group.device:
        raise ValueError(f"device {device} is not the group's "
                         f"{group.device}; under comm='axis' the state "
                         "lives on the group's device")
    return group.device
