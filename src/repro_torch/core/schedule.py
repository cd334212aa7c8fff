"""Time-varying gossip topologies: a numpy-only copy of
``repro.core.schedule``, kept in the port so that it never imports the JAX
package.

A :class:`TopologySchedule` is a finite cycle of static topologies over the
SAME worker set: communication round ``r`` gossips with
``entries[r % n]``. The one-peer time-varying families (exponential graphs,
randomized rings) touch O(1) peers per round, yet the round-robin union
mixes like the dense static graph.

Every entry must be shift-invariant (carry offsets). The port's step
counter and round index are host ints, so the runtime picks round r's
entry on the host (``views[r % len(views)]``) where the JAX package
switches over traced branches.

State-carrying consumers (CD-Adam's per-offset hat copies, the staleness
buffers and delay rings) need one slot per edge that can EVER be active,
so they are built over ``union_offsets()`` and each round runs a
``union_views()`` entry: the same offset tuple everywhere, with weight 0 on
the edges the round leaves idle.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union

import numpy as np

from repro_torch.core.topology import (Offset, PermShift, Topology,
                                       _check_doubly_stochastic,
                                       make_topology, ring, spectral_gap)


@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """A cyclic round schedule of shift-invariant topologies over K
    workers. ``at(r)`` is round r's graph; ``union_offsets()`` /
    ``union_views()`` serve consumers that keep per-edge state across
    rounds."""

    name: str
    entries: Tuple[Topology, ...]

    def __post_init__(self):
        if not self.entries:
            raise ValueError("a TopologySchedule needs at least one entry")
        K = self.entries[0].K
        for e in self.entries:
            if e.K != K:
                raise ValueError(
                    f"all schedule entries must share K; got {e.K} != {K}")
            if K > 1 and not e.offsets:
                raise ValueError(
                    f"schedule entry {e.name!r} has no shift structure; "
                    "time-varying gossip runs per-entry shifts and has no "
                    "dense fallback")

    @property
    def K(self) -> int:
        return self.entries[0].K

    @property
    def n_entries(self) -> int:
        return len(self.entries)

    def at(self, r: int) -> Topology:
        """The static topology of communication round ``r``."""
        return self.entries[r % len(self.entries)]

    def union_offsets(self) -> Tuple[Offset, ...]:
        """Every offset that is active in ANY entry, first-seen order."""
        out: List[Offset] = []
        for e in self.entries:
            for s in e.offsets:
                if s not in out:
                    out.append(s)
        return tuple(out)

    @property
    def offsets(self) -> Tuple[Offset, ...]:
        """Duck-compatibility with ``Topology`` for degree and validation
        checks: the union edge set."""
        return self.union_offsets()

    def union_views(self) -> Tuple[Topology, ...]:
        """Each entry rebuilt over the union offset tuple, zero weight on
        its inactive edges, so per-edge state aligns across the cycle."""
        union = self.union_offsets()
        views = []
        for e in self.entries:
            by_off = dict(zip(e.offsets, e.offset_weights))
            views.append(Topology(
                e.name, e.weights, union,
                tuple(float(by_off.get(s, 0.0)) for s in union),
                e.self_weight))
        return tuple(views)

    @property
    def mean_weights(self) -> np.ndarray:
        """The cycle-averaged mixing matrix (summary and accounting)."""
        return np.mean([e.weights for e in self.entries], axis=0)

    @property
    def spectral_gap(self) -> float:
        return spectral_gap(self.mean_weights)


def static_schedule(topo: Topology) -> TopologySchedule:
    """A single-entry schedule: round for round the static topology."""
    return TopologySchedule(f"static[{topo.name}]", (topo,))


def one_peer_exponential(K: int) -> TopologySchedule:
    """One-peer exponential graphs: round ``i`` pairs ``k`` with
    ``k +/- 2^i (mod K)`` only, degree <= 2 per round, while the cycle's
    union is the static exponential graph."""
    if K == 1:
        return TopologySchedule("one_peer_exponential", (ring(1),))
    entries = []
    h = 1
    while h < K:
        s = h % K
        if s == (K - s) % K:          # +h and -h are the same permutation
            offs: Tuple[Offset, ...] = (s,)
            offw: Tuple[float, ...] = (2.0 / 3.0,)
        else:
            offs = (s, K - s)
            offw = (1.0 / 3.0, 1.0 / 3.0)
        sw = 1.0 / 3.0
        W = np.zeros((K, K))
        for k in range(K):
            W[k, k] += sw
            for o, w in zip(offs, offw):
                W[k, (k + o) % K] += w
        _check_doubly_stochastic(W)
        entries.append(Topology(f"one_peer_exp[{h}]", W, offs, offw, sw))
        h *= 2
    return TopologySchedule("one_peer_exponential", tuple(entries))


def randomized_rings(K: int, n_entries: int = 4,
                     seed: int = 0) -> TopologySchedule:
    """Each round is a ring over a seeded random worker permutation
    (successor and predecessor edges, weights 1/3), drawn from
    ``np.random.RandomState(seed)`` as in the JAX package, so both give the
    same permutations. The offsets are explicit :class:`PermShift`s."""
    if K == 1:
        return TopologySchedule("randomized_rings", (ring(1),))
    rs = np.random.RandomState(seed)
    entries = []
    for e in range(n_entries):
        pi = rs.permutation(K)
        succ = np.empty(K, dtype=int)
        pred = np.empty(K, dtype=int)
        for i in range(K):
            succ[pi[i]] = pi[(i + 1) % K]
            pred[pi[i]] = pi[(i - 1) % K]
        if K == 2:                    # succ == pred: one edge, weight 1/2
            offs: Tuple[Offset, ...] = (PermShift(tuple(succ.tolist())),)
            offw: Tuple[float, ...] = (0.5,)
            sw = 0.5
        else:
            offs = (PermShift(tuple(succ.tolist())),
                    PermShift(tuple(pred.tolist())))
            offw = (1.0 / 3.0, 1.0 / 3.0)
            sw = 1.0 / 3.0
        W = np.zeros((K, K))
        for k in range(K):
            W[k, k] += sw
            for off, w in zip(offs, offw):
                W[k, off.perm[k]] += w
        _check_doubly_stochastic(W)
        entries.append(Topology(f"rand_ring[{e}]", W, offs, offw, sw))
    return TopologySchedule("randomized_rings", tuple(entries))


def comm_offsets(topo: Union[Topology, TopologySchedule]
                 ) -> Tuple[Offset, ...]:
    """The edge set per-edge state must cover: a static topology's
    offsets, or a schedule's union."""
    if isinstance(topo, TopologySchedule):
        return topo.union_offsets()
    return topo.offsets


SCHEDULES = {
    "one-peer-exponential": one_peer_exponential,
    "one-peer-exp": one_peer_exponential,
    "randomized-rings": randomized_rings,
    "rand-ring": randomized_rings,
}


def make_schedule(spec: str, K: int, **kw) -> TopologySchedule:
    """A time-varying schedule from a string spec: ``"one-peer-exp"`` /
    ``"one-peer-exponential"`` (log2(K) one-peer rounds), ``"rand-ring"``
    (``"rand-ring:N"`` for N randomized ring permutations; ``seed=`` in
    ``kw``), or any static zoo name, which wraps as a single-entry
    schedule. Raises ``KeyError`` for an unknown name."""
    name, _, arg = spec.partition(":")
    name = name.replace("_", "-")
    if name in SCHEDULES:
        if arg:
            kw.setdefault("n_entries", int(arg))
        fn = SCHEDULES[name]
        if fn is one_peer_exponential:
            kw.pop("n_entries", None)
        return fn(K, **kw)
    return static_schedule(make_topology(spec, K))
