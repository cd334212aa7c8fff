"""Public facade: build a decentralized optimizer, the port of
``repro.core.api``.

    opt = make_optimizer("d-adam", K=8, period=16, topology="ring",
                         backend="packed")          # on cuda by default
    state = opt.init(stacked_params)
    state = opt.step(state, stacked_grads)      # host-side comm-skip test
    state = opt.round(state, grad_fn, batches)  # p local steps + 1 gossip

With ``backend='packed'`` the state returned by ``opt.init`` is
packed-resident (:class:`~repro_torch.core.dadam.PackedDAdamState`) and
``opt.step`` accepts grads as a congruent tree or an already packed
buffer; ``opt.params_of`` gives the tree view for both backends.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import dadam
from repro_torch.core.dadam import DAdamConfig
from repro_torch.core.topology import Topology, make_topology

PyTree = Any

# time-varying schedule families of repro.core.schedule (not ported yet)
_SCHEDULE_NAMES = ("one-peer-exponential", "one-peer-exp",
                   "randomized-rings", "rand-ring")


def tree_dense_bytes(tree: PyTree) -> int:
    """Bytes of a tree of dense tensors (``repro.core.compression``)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class DecentralizedOptimizer:
    name: str
    topo: Topology
    cfg: Any
    device: torch.device
    init: Callable[[PyTree], Any]
    step: Callable[[Any, PyTree], Any]
    round: Callable[[Any, Callable, Any], Any]
    params_of: Callable[[Any], PyTree]
    # re-run make_optimizer with this optimizer's kwargs plus overrides
    rebuild: Any = None

    @property
    def K(self) -> int:
        return self.topo.K

    def _degree(self) -> int:
        """Peers each worker exchanges with per round: the shift offsets,
        or the weight matrix's off-diagonal support when mixing densely."""
        if self.topo.offsets and self.cfg.mixing != "dense":
            return len(self.topo.offsets)
        return len(self.topo.neighbors_of(0))

    def comm_bytes_per_round(self, params: PyTree) -> int:
        """Bytes each worker sends per communication round (the paper's
        'communication cost (MB)' x-axes)."""
        per_worker = tree_map(lambda x: x[0], params)
        return self._degree() * tree_dense_bytes(per_worker)

    def comm_bytes_round_list(self, params: PyTree) -> list:
        """Per-round bytes across one schedule cycle; a static topology
        has one entry."""
        return [self.comm_bytes_per_round(params)]


def resolve_topology(topology: "str | Topology", K: int) -> Topology:
    """A zoo name becomes a :class:`Topology`; a built one passes through
    (K-checked). Time-varying schedules are not ported yet."""
    if isinstance(topology, Topology):
        if topology.K != K:
            raise ValueError(
                f"topology {topology.name!r} is over K={topology.K} "
                f"workers, optimizer has K={K}")
        return topology
    name = topology.partition(":")[0].replace("_", "-")
    if name in _SCHEDULE_NAMES:
        raise NotImplementedError(
            f"time-varying topology schedules ({topology!r}) are not ported "
            "yet (ROADMAP queue 1, item 3: topologies and schedules)")
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
    mixing: str = "roll",
    backend: str = "reference",
    comm: str = "stacked",
    staleness=None,
    overlap: bool = False,
    device: "str | torch.device" = "cuda",
) -> DecentralizedOptimizer:
    """Build a decentralized optimizer over ``K`` stacked workers.

    Args:
      kind: ``"d-adam"`` (Alg. 1) or ``"d-adam-vanilla"`` (period forced
        to 1). ``"cd-adam"``, ``"d-psgd"`` and ``"adam"`` are not ported
        yet.
      K: number of workers; params enter ``opt.init`` with a leading K dim
        on every leaf.
      topology: a zoo name (``"ring"``, ``"torus"``, ``"exponential"``,
        ``"fully_connected"``) or a built ``Topology`` (K-checked).
      period: local steps per gossip round (the paper's p).
      eta, beta1, beta2, tau, weight_decay, bias_correction: Adam.
      mixing: ``"roll"`` mixes by one shift per offset, ``"dense"`` by
        the mixing matrix.
      backend: ``"reference"`` (tree math) or ``"packed"`` (resident
        ``(K, rows, 128)`` state and the CUDA kernels).
      comm: ``"stacked"`` (all workers on one device).
      staleness, overlap: not ported yet; anything but the defaults raises.
      device: where ``opt.init`` puts the state; ``cuda`` unless
        ``"cpu"`` is asked for. Raises ``RuntimeError`` without CUDA.

    Raises:
      NotImplementedError: a kind, comm mode or option not ported yet.
      KeyError: unknown kind or topology name.
    """
    factory_kwargs: Dict[str, Any] = dict(
        kind=kind, K=K, topology=topology, period=period, eta=eta,
        beta1=beta1, beta2=beta2, tau=tau, weight_decay=weight_decay,
        bias_correction=bias_correction, mixing=mixing, backend=backend,
        comm=comm, staleness=staleness, overlap=overlap, device=device)
    dev = resolve_device(device)
    kind = kind.lower().replace("_", "-")
    if kind in ("cd-adam", "cdadam", "d-psgd", "dpsgd", "adam"):
        raise NotImplementedError(
            f"{kind!r} is not ported yet (ROADMAP queue 1, item 6: CD-Adam "
            "and baselines)")
    if kind not in ("d-adam", "dadam", "d-adam-vanilla"):
        raise KeyError(f"unknown optimizer kind {kind!r}")
    topo = resolve_topology(topology, K)
    if kind == "d-adam-vanilla":
        period = 1
    cfg = DAdamConfig(eta=eta, beta1=beta1, beta2=beta2, tau=tau,
                      period=period, weight_decay=weight_decay,
                      bias_correction=bias_correction, mixing=mixing,
                      backend=backend, comm=comm, staleness=staleness,
                      overlap=overlap)
    cfg.validate()

    def init(params: PyTree):
        on = resolve_device(dev)
        return dadam.init(tree_map(lambda x: x.to(on), params), cfg)

    return DecentralizedOptimizer(
        name=kind, topo=topo, cfg=cfg, device=dev, init=init,
        step=lambda s, g: dadam.step(s, g, topo, cfg),
        round=lambda s, fn, b: dadam.round_step(s, fn, b, topo, cfg),
        params_of=lambda s: s.params,
        rebuild=lambda **ov: make_optimizer(**{**factory_kwargs, **ov}))
