"""Gossip topologies: doubly-stochastic mixing matrices W (Definition 1).

A numpy-only copy of ``repro.core.topology``, kept in the port so that it
never imports the JAX package.

The paper requires W symmetric, doubly stochastic, with spectral gap
rho = 1 - |lambda_2| in (0, 1].  The experiments use a ring of 8 workers.

We provide the standard zoo (ring, torus, hypercube, exponential,
fully-connected) plus helpers for neighbor lists so the distributed
runtime can lower gossip as per-offset shifts (a gather over the worker
dim, or the CUDA gossip kernels' source table) instead of a dense mixing
matmul.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridShift:
    """Row-wrap-aware shift on a ``rows x cols`` grid flattened to
    ``K = rows * cols``: worker ``k`` reads ``src(k)``, the grid neighbor
    ``(r + dr, c + dc)`` with both coordinates wrapping independently.

    This is NOT a flat circulant offset — ``(r, cols-1) + (0, 1)`` wraps to
    ``(r, 0)``, not to the next row — which is exactly the torus lowering
    bug the plain-int offsets had."""

    dr: int
    dc: int
    rows: int
    cols: int

    def src(self, k):
        r, c = k // self.cols, k % self.cols
        return (((r + self.dr) % self.rows) * self.cols
                + (c + self.dc) % self.cols)


@dataclasses.dataclass(frozen=True)
class PermShift:
    """An explicit worker permutation: worker ``k`` reads ``perm[k]``.

    Used by topology schedules with no shift structure at all (randomized
    rings). ``perm`` must be a bijection of range(K)."""

    perm: Tuple[int, ...]

    def __post_init__(self):
        if sorted(self.perm) != list(range(len(self.perm))):
            raise ValueError("PermShift.perm must be a permutation of "
                             f"range({len(self.perm)})")


Offset = Union[int, GridShift, PermShift]


def offset_perm(off: Offset, K: int) -> np.ndarray:
    """The source-worker index per destination worker: ``out[k]`` is the
    worker whose value worker ``k`` reads under this offset."""
    if isinstance(off, (int, np.integer)):
        return (np.arange(K) + int(off)) % K
    if isinstance(off, GridShift):
        if off.rows * off.cols != K:
            raise ValueError(f"GridShift {off} does not cover K={K}")
        return np.array([off.src(k) for k in range(K)])
    if isinstance(off, PermShift):
        if len(off.perm) != K:
            raise ValueError(f"PermShift has {len(off.perm)} entries, "
                             f"expected K={K}")
        return np.asarray(off.perm)
    raise TypeError(f"unknown offset type {type(off).__name__}")


@dataclasses.dataclass(frozen=True)
class Topology:
    """A gossip graph over K workers.

    Attributes:
      name: human-readable id.
      weights: (K, K) symmetric doubly-stochastic mixing matrix.
      neighbors: for each worker, the list of (neighbor_rank, weight) pairs
        with neighbor != self. Self weight is ``self_weights[k]``.
      offsets: permutation offsets covering all edges with a *uniform*
        weight each: plain ints (ring-style circulant shifts,
        ``k -> (k+s) % K``), :class:`GridShift` (torus row/col wrap), or
        :class:`PermShift` (explicit permutations). Populated whenever the
        graph decomposes into uniform-weight permutations; used to lower
        gossip as rolls / gathers. ``offsets_matrix`` must equal
        ``weights`` — the zoo-wide property test pins this.
    """

    name: str
    weights: np.ndarray
    offsets: Tuple[Offset, ...]
    offset_weights: Tuple[float, ...]
    self_weight: float

    @property
    def K(self) -> int:
        return self.weights.shape[0]

    @property
    def spectral_gap(self) -> float:
        return spectral_gap(self.weights)

    def neighbors_of(self, k: int) -> List[Tuple[int, float]]:
        row = self.weights[k]
        return [(j, float(row[j])) for j in np.nonzero(row)[0] if j != k]


def offsets_matrix(topo: "Topology") -> np.ndarray:
    """The mixing matrix the shift lowering actually applies:
    ``W[k, src] += w`` for every offset. Must equal ``topo.weights`` for the
    roll/gather gossip to mix the right neighbors — the invariant the
    torus lowering violated before offsets became wrap-aware."""
    K = topo.K
    W = np.zeros((K, K))
    np.fill_diagonal(W, topo.self_weight)
    for off, w in zip(topo.offsets, topo.offset_weights):
        src = offset_perm(off, K)
        for k in range(K):
            W[k, src[k]] += w
    return W


def _check_doubly_stochastic(W: np.ndarray, atol: float = 1e-8) -> None:
    K = W.shape[0]
    assert W.shape == (K, K)
    if not np.allclose(W, W.T, atol=atol):
        raise ValueError("W must be symmetric")
    if not np.allclose(W.sum(axis=0), 1.0, atol=atol):
        raise ValueError("W columns must sum to 1")
    if not np.allclose(W.sum(axis=1), 1.0, atol=atol):
        raise ValueError("W rows must sum to 1")
    if np.any(W < -atol):
        raise ValueError("W must be non-negative")


def spectral_gap(W: np.ndarray) -> float:
    """rho = 1 - |lambda_2| (Definition 1)."""
    eig = np.linalg.eigvalsh(W)
    eig = np.sort(np.abs(eig))[::-1]
    if not np.isclose(eig[0], 1.0, atol=1e-6):
        raise ValueError(f"largest |eigenvalue| must be 1, got {eig[0]}")
    if len(eig) == 1:
        return 1.0
    return float(1.0 - eig[1])


def ring(K: int, self_weight: float | None = None) -> Topology:
    """Ring topology (the paper's experimental setup).

    Each worker mixes with its left and right neighbor. Default weights are
    the canonical 1/3-1/3-1/3 (for K >= 3).
    """
    if K <= 0:
        raise ValueError("K must be positive")
    if K == 1:
        return Topology("ring", np.ones((1, 1)), (), (), 1.0)
    if K == 2:
        W = np.array([[0.5, 0.5], [0.5, 0.5]])
        return Topology("ring", W, (1,), (0.5,), 0.5)
    sw = 1.0 / 3.0 if self_weight is None else self_weight
    nw = (1.0 - sw) / 2.0
    W = np.zeros((K, K))
    for k in range(K):
        W[k, k] = sw
        W[k, (k + 1) % K] = nw
        W[k, (k - 1) % K] = nw
    _check_doubly_stochastic(W)
    return Topology("ring", W, (1, K - 1), (nw, nw), sw)


def fully_connected(K: int) -> Topology:
    """W = (1/K) 11^T — gossip == exact averaging (rho = 1)."""
    W = np.full((K, K), 1.0 / K)
    offsets = tuple(range(1, K))
    return Topology(
        "fully_connected", W, offsets, tuple([1.0 / K] * (K - 1)), 1.0 / K
    )


def exponential(K: int) -> Topology:
    """One-peer-per-power-of-two exponential graph (static union version).

    Worker k is connected to k +/- 2^i for all 2^i < K. Well-conditioned
    (rho ~ O(1/log K)) while keeping degree log K.
    """
    if K == 1:
        return Topology("exponential", np.ones((1, 1)), (), (), 1.0)
    hops = []
    i = 1
    while i < K:
        hops.append(i)
        i *= 2
    # union of +/- hops; uniform weights over self + distinct neighbors
    offs = sorted({h % K for h in hops} | {(-h) % K for h in hops} - {0})
    deg = len(offs)
    w = 1.0 / (deg + 1)
    W = np.zeros((K, K))
    for k in range(K):
        W[k, k] = w
        for s in offs:
            W[k, (k + s) % K] += w
    _check_doubly_stochastic(W)
    return Topology("exponential", W, tuple(offs), tuple([w] * deg), w)


def torus(rows: int, cols: int) -> Topology:
    """2-D torus: 4 neighbors each, weight 1/5."""
    K = rows * cols
    W = np.zeros((K, K))
    w = 1.0 / 5.0

    def rank(r: int, c: int) -> int:
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            k = rank(r, c)
            W[k, k] = w
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                W[k, rank(r + dr, c + dc)] += w
    _check_doubly_stochastic(W)
    # The shift lowering: each of the four directed grid steps is a
    # GridShift whose column wrap stays within the row (a flat +-1
    # circulant would leak across row boundaries — the wrong-neighbor bug).
    # Degenerate extents merge: at rows == 2 the +-row steps are the SAME
    # permutation (weight 2w), at rows == 1 they are the identity and fold
    # into the self weight; likewise for cols. The offsets-implied matrix
    # therefore equals W for EVERY (rows, cols).
    merged: dict = {}
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        key = (dr % rows, dc % cols)
        merged[key] = merged.get(key, 0.0) + w
    sw = w
    offs: List[Offset] = []
    offw: List[float] = []
    for (dr, dc), wt in merged.items():
        if dr == 0 and dc == 0:
            sw += wt
        else:
            offs.append(GridShift(dr, dc, rows, cols))
            offw.append(wt)
    return Topology("torus", W, tuple(offs), tuple(offw), sw)


_REGISTRY = {
    "ring": ring,
    "fully_connected": fully_connected,
    "exponential": exponential,
}


def make_topology(name: str, K: int, **kw) -> Topology:
    """Build a static gossip graph from the zoo by name.

    Args:
      name: ``"ring"``, ``"torus"``, ``"exponential"``, or
        ``"fully_connected"``. ``"torus"`` picks the most-square
        ``rows x cols`` factorization of K and falls back to ``ring(K)``
        (with a ``RuntimeWarning``) when K only factors as ``1 x K``.
      K: number of workers.
      **kw: forwarded to the zoo constructor (e.g. ``ring(K, weight=...)``).

    Returns:
      A :class:`Topology` — symmetric doubly-stochastic ``weights``
      plus the uniform-weight permutation ``offsets`` the roll/gather
      gossip lowers through (``offsets_matrix(topo) == topo.weights``).

    Raises:
      KeyError: unknown topology name.

    Example:
      >>> topo = make_topology("ring", 8)
      >>> topo.K, sorted(topo.offsets)     # +-1 ring shifts (mod K)
      (8, [1, 7])
      >>> float(topo.weights.sum(axis=1).max())   # doubly stochastic
      1.0
      >>> 0.0 < topo.spectral_gap <= 1.0
      True
    """
    if name == "torus":
        r = int(np.sqrt(K))
        while K % r:
            r -= 1
        if r == 1 and K > 1:
            # prime (or 2): the only factorization is 1 x K, whose
            # degenerate row edges collapse into a 3/5 self-loop — a worse-
            # conditioned ring in disguise. Use the honest ring instead.
            warnings.warn(
                f"torus needs a non-trivial rows x cols factorization; "
                f"K={K} only factors as 1 x {K} (self-loop absorbs the row "
                f"edges) — falling back to ring({K})", RuntimeWarning,
                stacklevel=2)
            return ring(K)
        return torus(r, K // r)
    if name not in _REGISTRY:
        raise KeyError(f"unknown topology {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](K, **kw)


def effective_rho(topo: Topology) -> float:
    """Convenience used by convergence-bound reporting (Theorem 1)."""
    return topo.spectral_gap
