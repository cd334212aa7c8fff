"""D-Adam (Algorithm 1): decentralized Adam with periodic gossip, in PyTorch.

Per worker k and iteration t:

    m_t = b1 * m_{t-1} + (1 - b1) * g_t
    v_t = b2 * v_{t-1} + (1 - b2) * g_t ** 2
    x_{t+1/2} = x_t - eta * m_t / (sqrt(v_t) + tau)
    if (t + 1) % p == 0:   x_{t+1} = sum_j W[k, j] * x_{t+1/2}^{(j)}
    else:                  x_{t+1} = x_{t+1/2}

The port of ``repro.core.dadam``, in both comm modes:

* ``comm='stacked'``: every tree leaf carries a leading worker dim K and
  all K workers live on one device, which is the one-GPU case;
* ``comm='axis'``: one process per worker over ``torch.distributed``
  (``launch.mesh.WorkerGroup``, on ``cfg.group``). Rank r holds worker
  r's ``(1, ...)`` slice of the same state, and every worker shift is one
  point-to-point exchange with the offset's two peers
  (:func:`shift_worker`), where JAX has one ``ppermute``.

Two backends:

* ``'reference'``: the tree math of ``local_update`` and a roll (or gather)
  per graph offset for the mix;
* ``'packed'``: the counterpart of the JAX package's ``'pallas'``. Params
  and both moments stay resident in one stacked, leaf-aligned
  ``(K, rows, 128)`` buffer each (:class:`PackedDAdamState`), and the step
  runs the ``fused_adam``, ``gossip_adam_mix`` and ``gossip_mix`` kernels
  on them through :mod:`repro_torch.kernels.ops`. Under ``comm='axis'``
  the buffers are the rank's ``(1, rows, 128)`` shard: ``fused_adam``
  runs on it, and the mix is f32 torch ops over the received blocks, as
  in JAX (``gossip_mix``, ``gossip_adam_mix`` and ``payload_mix`` are
  stacked-only there).

With ``cfg.model_parallel`` = M > 1 (the 2D worker x model layout, packed
and ``comm='axis'`` only) each worker is a group of M ranks, and the
packed buffers are in the row-sharded layout (``make_spec(row_shards=M)``):
a rank holds one ``(1, rows / M, 128)`` block of each, ``fused_adam`` runs
on it, and every worker shift exchanges blocks with the ranks of the same
model index, so gossip crosses only the worker axis.

The straggler-tolerant runtime of the JAX package is here too: bounded
staleness (``cfg.staleness``, with ``straggler_rate`` / ``straggler_seed``
modelling late payloads), the delay-1 overlap schedule (``cfg.overlap``)
and time-varying topology schedules. Their payload buffers
(:class:`StaleBufs`) ride on the state; the packed rounds mix through the
``payload_mix`` kernel.

The step counter is a host int, so the communication test
``count % period == 0``, the round index, the arrival mask, the staleness
ages (kept on the host CPU) and a schedule's entry for the round are all
decided without a device sync.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._rng import step_generator
from repro_torch._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.core.schedule import TopologySchedule, comm_offsets
from repro_torch.core.topology import GridShift, Topology, offset_perm
from repro_torch.kernels import ops
from repro_torch.kernels import pack as packing
from repro_torch.kernels.fused_adam import f32
from repro_torch.kernels.gossip import MAX_FUSED_DEGREE, MAX_GOSSIP_ADAM_DEGREE
from repro_torch.kernels.pack import BLOCK_ROWS
from repro_torch.launch.mesh import exchange

PyTree = Any
# (r) -> (K, deg) bool: which neighbour payloads arrive in round r
ArrivalFn = Callable[[int], Any]

# staleness ages start "infinitely old" so the FIRST gossip round always
# takes a fresh payload (cold buffers never mix in); half of int32 max so
# age + 1 cannot overflow
COLD_AGE = 2**30


@dataclasses.dataclass(frozen=True)
class DAdamConfig:
    eta: float = 1e-3           # initial learning rate (paper's eta)
    beta1: float = 0.9
    beta2: float = 0.999
    tau: float = 1e-6           # paper's tau > 0 (denominator guard)
    period: int = 1             # p: communicate every p iterations
    weight_decay: float = 0.0   # L2 (paper: 1e-4 for CIFAR-10)
    bias_correction: bool = False  # paper's Alg. 1 has none; optional extra
    mixing: str = "roll"        # 'dense' | 'roll'
    moment_dtype: Optional[torch.dtype] = None  # e.g. torch.bfloat16 for
    #                             big models; None keeps the param dtype
    backend: str = "reference"  # 'reference' (tree math) | 'packed'
    #                             (resident (K, rows, 128) state + kernels)
    comm: str = "stacked"       # 'stacked' (all workers on one device) |
    #                             'axis' (one worker per process)
    axis_name: str = "worker"   # the worker axis's name under comm='axis'
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    #                             comm='axis': this rank's
    #                             launch.mesh.WorkerGroup
    model_parallel: int = 1     # M: ranks a worker (the 2D worker x model
    #                             layout); the packed row dim is cut M
    #                             ways and each rank steps one
    #                             (1, rows/M, 128) block
    staleness: Optional[int] = None  # straggler-tolerant gossip: mix the
    #                             last-arrived neighbour payload, at most
    #                             tau rounds old (None = synchronous;
    #                             tau=0 == synchronous bit for bit)
    straggler_rate: float = 0.0  # probability a neighbour payload misses
    #                              a round (deterministic per seed)
    straggler_seed: int = 0
    overlap: bool = False       # delay-1 wire schedule: round r sends its
    #                             payload and round r+1 mixes it

    def validate(self) -> None:
        if not 0 <= self.beta1 < 1 or not 0 <= self.beta2 < 1:
            raise ValueError("beta1/beta2 must be in [0, 1)")
        if self.tau <= 0:
            raise ValueError("tau must be > 0")
        if self.period < 1:
            raise ValueError("period p must be >= 1")
        if self.mixing not in ("dense", "roll"):
            raise ValueError(f"unknown mixing {self.mixing!r}")
        if self.backend not in ("reference", "packed"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.moment_dtype is not None and \
                not self.moment_dtype.is_floating_point:
            raise ValueError(f"moment_dtype must be a float dtype, got "
                             f"{self.moment_dtype}")
        if self.comm not in ("stacked", "axis"):
            raise ValueError(f"unknown comm {self.comm!r}")
        if self.comm == "axis":
            if not self.axis_name:
                raise ValueError("comm='axis' needs a non-empty axis_name")
            if self.mixing == "dense":
                raise ValueError(
                    "comm='axis' gossips by one exchange per graph offset "
                    "and has no dense-mixing form; use mixing='roll' "
                    "(shift-invariant topology) or comm='stacked'")
        if self.model_parallel < 1:
            raise ValueError(
                f"model_parallel must be >= 1, got {self.model_parallel}")
        if self.model_parallel > 1:
            if self.comm != "axis":
                raise ValueError(
                    "model_parallel > 1 is the 2D (worker x model) layout "
                    "and requires comm='axis'")
            if self.backend != "packed":
                raise ValueError(
                    "model_parallel > 1 cuts the packed row dim of the "
                    "resident (K, rows, 128) state and requires "
                    "backend='packed' (the reference tree layout has no "
                    "uniform row dim to cut)")
        if self.backend == "packed" and self.bias_correction:
            raise ValueError(
                "backend='packed' implements the paper's Alg. 1 update "
                "(no bias correction); use backend='reference' for "
                "bias_correction=True")
        if self.staleness is not None:
            if self.staleness < 0:
                raise ValueError(
                    f"staleness bound tau must be >= 0, got {self.staleness}")
            if self.mixing == "dense":
                raise ValueError(
                    "staleness-bounded gossip double-buffers per-offset "
                    "neighbour payloads; it requires the shift lowering "
                    "(mixing='roll')")
            if self.model_parallel > 1:
                raise ValueError(
                    "staleness buffers are per-worker payload copies and "
                    "are not row-sharded; staleness requires "
                    "model_parallel == 1")
        if not 0.0 <= self.straggler_rate < 1.0:
            raise ValueError(
                f"straggler_rate must be in [0, 1), got "
                f"{self.straggler_rate}")
        if self.straggler_rate > 0.0 and self.staleness is None:
            raise ValueError(
                "straggler_rate > 0 models delayed payload arrivals and "
                "needs a staleness bound (set staleness=tau)")
        if self.overlap:
            if self.staleness is not None:
                raise ValueError(
                    "overlap IS the staleness tau=1 wire schedule (every "
                    "payload exactly one round late); combining it with "
                    "an explicit staleness bound is ambiguous: choose one")
            if self.mixing == "dense":
                raise ValueError(
                    "overlap double-buffers per-offset neighbour payloads "
                    "and requires the shift lowering (mixing='roll')")


class AdamMoments(NamedTuple):
    m: PyTree
    v: PyTree
    count: int  # host step counter


def lazy_zeros(x: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Zeros of ``x``'s shape as one expanded scalar: what a packed init
    copies into its buffers, without a leaf-sized zero tensor."""
    return torch.zeros((), dtype=dtype or x.dtype,
                       device=x.device).expand(x.shape)


def init_moments(params: PyTree, cfg: Optional[DAdamConfig] = None,
                 lazy: bool = False) -> AdamMoments:
    """Zero m and v in ``cfg.moment_dtype``, or in each param's dtype
    (:func:`lazy_zeros` when ``lazy``: for a packed init, which copies
    them)."""
    dt = cfg.moment_dtype if cfg is not None else None
    make = lazy_zeros if lazy else (
        lambda x, d: torch.zeros_like(x, dtype=d or x.dtype))
    zeros = tree_map(lambda x: make(x, dt), params)
    return AdamMoments(m=zeros, v=tree_map(lambda z: make(z, None), zeros),
                       count=0)


def _const(x: float, dtype: torch.dtype) -> float:
    """A Python-float constant rounded to ``dtype``, as JAX rounds a weakly
    typed scalar to the dtype of the array it meets."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def local_update(params: PyTree, grads: PyTree, mom: AdamMoments,
                 cfg: DAdamConfig) -> Tuple[PyTree, AdamMoments]:
    """Lines 3-6 of Alg. 1 on trees: elementwise, stacked-K transparent.
    The update is computed in the moments' dtype, one rounding per op, as
    the JAX package's reference does: with bf16 moments the grad is cast
    to bf16, weight decay and the step are bf16 and the constants are
    rounded to bf16 (beta2 = 0.999 becomes 1.0); only the subtraction
    from the params is in their dtype. (The kernel path computes in f32.)
    """
    count = mom.count + 1
    if cfg.bias_correction:
        t = np.float32(count)
        bc1 = float(np.float32(1.0) - np.float32(cfg.beta1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(cfg.beta2) ** t)

    def upd(x, g, m, v):
        dt = m.dtype
        g = g.to(dt)
        if cfg.weight_decay:
            g = g + _const(cfg.weight_decay, dt) * x.to(dt)
        m_new = _const(cfg.beta1, dt) * m + _const(1.0 - cfg.beta1, dt) * g
        v_new = (_const(cfg.beta2, dt) * v
                 + _const(1.0 - cfg.beta2, dt) * (g * g))
        if cfg.bias_correction:
            m_hat, v_hat = m_new / bc1, v_new / bc2
        else:
            m_hat, v_hat = m_new, v_new
        step = (_const(cfg.eta, dt) * m_hat
                / (torch.sqrt(v_hat) + _const(cfg.tau, dt)))
        return x - step.to(x.dtype), m_new, v_new

    leaves, td = tree_flatten(params)
    rest = [tree_flatten(t) for t in (grads, mom.m, mom.v)]
    for _, rtd in rest:
        if rtd != td:
            raise ValueError(f"tree structures differ: {td} vs {rtd}")
    out = [upd(*xs) for xs in zip(leaves, *(r[0] for r in rest))]
    new_params, new_m, new_v = (tree_unflatten(td, [o[i] for o in out])
                                for i in range(3))
    return new_params, AdamMoments(new_m, new_v, count)


# ------------------------------- gossip ------------------------------------


def _axis(cfg: DAdamConfig):
    """The worker group under ``comm='axis'``, else ``None``."""
    return cfg.group if cfg.comm == "axis" else None


def shift_worker(x: torch.Tensor, s: Any, K: int, axis: Any = None,
                 tag: int = 0) -> torch.Tensor:
    """Worker k reads worker ``src(k)``'s value, for every offset kind: a
    plain int is the circulant ``src(k) = (k + s) % K``, a
    :class:`GridShift` the row-wrap-aware torus neighbour, a ``PermShift``
    an explicit permutation (``offset_perm``).

    ``axis=None`` (``comm='stacked'``): a roll (a roll of the worker dim
    seen as its grid, for a ``GridShift``; a gather for a permutation)
    over the leading worker dim. ``axis`` a ``launch.mesh.WorkerGroup``
    (``comm='axis'``, ``x`` this rank's block): one exchange, sending
    ``x`` to the worker that reads it and receiving ``src(rank)``'s
    block, in one ``batch_isend_irecv`` under message ``tag``. Every rank
    must make the same sequence of calls, each message of a round with a
    tag of its own, so that two offsets naming the same peer cannot
    cross."""
    if axis is not None:
        k = axis.rank
        if isinstance(s, (int, np.integer)):
            src, dst = (k + int(s)) % K, (k - int(s)) % K
        else:
            perm = np.asarray(offset_perm(s, K))
            src, dst = int(perm[k]), int(np.flatnonzero(perm == k)[0])
        return exchange(x, src, dst, axis, tag)
    if x.dim() < 1:
        return x
    if isinstance(s, (int, np.integer)):
        return torch.roll(x, -int(s), dims=0)
    if isinstance(s, GridShift):
        xg = x.reshape((s.rows, s.cols) + tuple(x.shape[1:]))
        xg = torch.roll(xg, (-s.dr, -s.dc), dims=(0, 1))
        return xg.reshape(x.shape)
    return x.index_select(0, _perm_index(s, K, x.device))


@functools.lru_cache(maxsize=256)
def _perm_index(s: Any, K: int, device: torch.device) -> torch.Tensor:
    """``offset_perm`` on ``device``, made once per offset and device."""
    return torch.as_tensor(offset_perm(s, K), device=device)


def gossip_dense(params: PyTree, W: np.ndarray) -> PyTree:
    """x^{(k)} <- sum_j W[k, j] x^{(j)} via a dense mixing einsum in f32."""
    def mix(x):
        Wt = torch.as_tensor(np.asarray(W), dtype=torch.float32,
                             device=x.device)
        return torch.einsum("kj,j...->k...", Wt,
                            x.to(torch.float32)).to(x.dtype)

    return tree_map(mix, params)


def _mix_trees(params: PyTree, nbrs, topo: Topology) -> PyTree:
    """mixed = w_self * x + sum_i w_i * nbrs[i], leaf by leaf, accumulated
    in f32: the self term first, then the neighbour trees in order."""
    def mix(x, *ns):
        acc = f32(topo.self_weight) * x.to(torch.float32)
        for w, nb in zip(topo.offset_weights, ns):
            acc = acc + f32(w) * nb.to(torch.float32)
        return acc.to(x.dtype)

    return tree_map(mix, params, *nbrs)


def _mix_received(x: torch.Tensor, nbrs, topo: Topology,
                  rows: int = 1 << 24) -> torch.Tensor:
    """:func:`_mix_trees`'s mix of one buffer with neighbour copies that
    this round received (tensors of its own), made in the first copy's
    memory: the same products and sums in the same order (the first sum,
    which is commutative, taken the other way round), equal to the bit,
    with ``rows`` elements of ``w_self * x`` at a time as the only
    temporary. An axis round then holds one received block beside its
    buffers, not three (at full width, four ranks' state on one card)."""
    acc = nbrs[0].to(torch.float32).mul_(f32(topo.offset_weights[0]))
    flat_acc, flat_x = acc.view(-1), x.reshape(-1)
    for i in range(0, flat_x.numel(), rows):
        flat_acc[i:i + rows].add_(
            f32(topo.self_weight) * flat_x[i:i + rows].to(torch.float32))
    for w, nb in zip(topo.offset_weights[1:], nbrs[1:]):
        acc.add_(nb.to(torch.float32).mul_(f32(w)))
    return acc.to(x.dtype)


def _shift_tree(params: PyTree, s: Any, K: int, axis: Any,
                tags: Iterator[int]) -> PyTree:
    """Every leaf shifted by ``s``, one message (and tag) a leaf."""
    return tree_map(lambda x: shift_worker(x, s, K, axis, next(tags)),
                    params)


def gossip_shift(params: PyTree, topo: Topology, axis: Any = None) -> PyTree:
    """mixed[k] = w_self * x[k] + sum_s w_s * x[src_s(k)], one shift per
    graph offset (an exchange under ``axis``), accumulated in f32."""
    if not topo.offsets:
        if topo.K == 1:
            return params
        raise ValueError(
            f"topology {topo.name!r} has no shift structure; use gossip_dense"
        )
    tags = itertools.count()
    return _mix_trees(params, [_shift_tree(params, s, topo.K, axis, tags)
                               for s in topo.offsets], topo)


def gossip_axis(params: PyTree, topo: Topology, axis: Any) -> PyTree:
    """``comm='axis'`` spelling of :func:`gossip_shift`: ``params`` is this
    rank's ``(1, ...)`` tree and ``axis`` its worker group."""
    if topo.K == 1:
        return params
    return gossip_shift(params, topo, axis)


def gossip(params: PyTree, topo: Topology, cfg: DAdamConfig) -> PyTree:
    """The tree path's mix: one exchange per offset under ``comm='axis'``;
    dense for ``mixing='dense'`` or graphs without shift structure, else
    one shift per offset."""
    if cfg.comm == "axis":
        return gossip_axis(params, topo, cfg.group)
    if cfg.mixing == "dense" or not topo.offsets:
        return gossip_dense(params, topo.weights)
    return gossip_shift(params, topo)


def gossip_packed(buf: torch.Tensor, topo: Topology,
                  cfg: DAdamConfig) -> torch.Tensor:
    """The mix on the resident packed buffer. Under ``comm='axis'`` (``buf``
    this rank's ``(1, rows, 128)`` shard) one exchange of the block per
    offset, accumulated in f32. Stacked: ring offsets and torus
    ``GridShift``s up to ``MAX_FUSED_DEGREE`` take the ``gossip_mix``
    kernel; ``PermShift`` offsets, dense mixing and denser graphs take the
    mixing einsum over the worker dim."""
    if topo.K == 1:
        return buf
    if cfg.comm == "axis":
        if not topo.offsets:
            raise ValueError("comm='axis' gossip needs a shift-invariant "
                             "topology")
        return _mix_received(buf, [shift_worker(buf, s, topo.K, cfg.group,
                                                i)
                                   for i, s in enumerate(topo.offsets)],
                             topo)
    fusable = all(isinstance(s, (int, np.integer, GridShift))
                  for s in topo.offsets)
    if (cfg.mixing == "dense" or not topo.offsets or not fusable
            or len(topo.offsets) > MAX_FUSED_DEGREE):
        W = torch.as_tensor(np.asarray(topo.weights), dtype=torch.float32,
                            device=buf.device)
        return torch.einsum("kj,jrc->krc", W,
                            buf.to(torch.float32)).to(buf.dtype)
    return ops.gossip_mix(buf, topo.offsets, topo.offset_weights,
                          topo.self_weight)


# -------------------- straggler-tolerant (stale) gossip ---------------------


class StaleBufs(NamedTuple):
    """Double-buffered neighbour payloads for staleness-bounded gossip.

    ``bufs[i]`` holds the payload last taken from offset i's neighbour
    (the structure of the params, or the packed buffer); ``age[k, i]``
    counts rounds since worker k last refreshed it, an int32 tensor kept
    on the host CPU, where the round's take is decided (``(1, deg)``, the
    rank's row, under ``comm='axis'``). A round mixes the buffered copy
    while it is younger than the bound tau and MUST take a fresh payload
    once ``age >= tau``, so no mixed-in value is more than tau rounds old,
    and tau=0 is the synchronous gossip bit for bit."""

    bufs: Tuple[Any, ...]
    age: torch.Tensor


def _round_index(count: int, period: int) -> int:
    """0-based communication-round index at a comm step (count = p, 2p...)."""
    return max(count // period - 1, 0)


def default_arrival(cfg: DAdamConfig, K: int, deg: int) -> ArrivalFn:
    """The arrival draw of ``cfg``: round r's ``(K, deg)`` mask comes from
    a CPU ``torch.Generator`` seeded by ``(straggler_seed, r)``, so every
    worker, the card and the CPU agree on the trace without communication.
    (The JAX package draws with threefry, which torch cannot reproduce;
    ``make_optimizer(arrival=)`` takes any other draw.)"""
    rate = float(cfg.straggler_rate)

    def arrival(r: int) -> torch.Tensor:
        gen = step_generator(cfg.straggler_seed, r)
        return torch.rand((K, deg), generator=gen) >= rate

    return arrival


def local_rows(arr, cfg: DAdamConfig):
    """A ``(K, ...)`` per-worker constant cut to this rank's ``(1, ...)``
    row under ``comm='axis'``; the whole of it under ``comm='stacked'``."""
    if cfg.comm != "axis":
        return arr
    return arr[cfg.group.rank:cfg.group.rank + 1]


def _arrival_mask(cfg: DAdamConfig, r: int, K: int, deg: int,
                  arrival: Optional[ArrivalFn] = None) -> torch.Tensor:
    """Bool on the host: which neighbour payloads arrive in round r, the
    ``(K, deg)`` mask (its rank's row under ``comm='axis'``, where every
    rank draws the whole mask and so agrees with the others). All of them
    without stragglers; else ``arrival(r)``, or the default draw of
    ``cfg``."""
    if cfg.straggler_rate <= 0.0:
        return local_rows(torch.ones((K, deg), dtype=torch.bool), cfg)
    mask = (arrival or default_arrival(cfg, K, deg))(r)
    if not isinstance(mask, torch.Tensor):
        mask = torch.from_numpy(np.array(mask, dtype=bool))
    mask = mask.to("cpu", torch.bool)
    if tuple(mask.shape) != (K, deg):
        raise ValueError(f"arrival mask of round {r} has shape "
                         f"{tuple(mask.shape)}, expected {(K, deg)}")
    return local_rows(mask, cfg)


def init_stale(params_like: PyTree, topo: "Topology | TopologySchedule",
               workers: Optional[int] = None) -> StaleBufs:
    """Cold staleness buffers over ``topo``'s (union) offsets: zero
    payloads at COLD_AGE, forcing a fresh exchange on first use. The ages
    have a row per worker held here: ``workers``, by default ``topo.K``."""
    offs = comm_offsets(topo)
    zeros = tree_map(torch.zeros_like, params_like)
    return StaleBufs(tuple(zeros for _ in offs),
                     torch.full((workers or topo.K, len(offs)), COLD_AGE,
                                dtype=torch.int32))


def select_workers(slot, option: Callable[[int], torch.Tensor]
                   ) -> torch.Tensor:
    """Worker k's value ``option(slot[k])[k]``, for a host per-worker slot
    index ``slot`` (K,). A uniform index passes that one operand through
    (no other option is even made); mixed ones stack the chosen worker
    slices, a copy of exactly those bytes."""
    slot = [int(j) for j in np.asarray(slot)]
    made = {j: option(j) for j in dict.fromkeys(slot)}
    if len(made) == 1:
        return made[slot[0]]
    return torch.stack([made[j][k] for k, j in enumerate(slot)])


def _fresh_or_kept(take, fresh: Callable[[], Any], kept: Callable[[], Any],
                   axis: Any) -> Any:
    """Per worker, the fresh payload where ``take`` is set, else the kept
    one. Stacked, the fresh shift is made only when some worker takes it;
    under ``comm='axis'`` every rank makes it, because its peer reads what
    this rank sends whatever this rank takes."""
    if axis is not None:
        f = fresh()
        return select_workers(take, lambda j: f if j else kept())
    return select_workers(take, lambda j: fresh() if j else kept())


def gossip_shift_stale(params: PyTree, stale: StaleBufs, topo: Topology,
                       cfg: DAdamConfig, r: int,
                       arrival: Optional[ArrivalFn] = None
                       ) -> Tuple[PyTree, StaleBufs]:
    """Shift gossip with a staleness bound: round r mixes, per offset, the
    freshly shifted payload when it arrives (or when the buffered copy hits
    the bound tau) and the buffered <= tau-rounds-old copy otherwise. With
    tau=0 every payload is forced fresh and the result is bit for bit
    :func:`gossip_shift`."""
    if not topo.offsets:
        return params, stale
    axis = _axis(cfg)
    tau = int(cfg.staleness)
    if tau == 0:
        return (gossip_shift(params, topo, axis),
                StaleBufs(stale.bufs, torch.zeros_like(stale.age)))
    take = _arrival_mask(cfg, r, topo.K, len(topo.offsets),
                         arrival) | (stale.age >= tau)
    new_age = torch.where(take, 0, stale.age + 1).to(torch.int32)
    tags = itertools.count()
    new_bufs = []
    for i, s in enumerate(topo.offsets):
        def pick(x, b, i=i, s=s):
            return _fresh_or_kept(
                take[:, i], lambda: shift_worker(x, s, topo.K, axis,
                                                 next(tags)),
                lambda: b.to(x.dtype), axis)

        new_bufs.append(tree_map(pick, params, stale.bufs[i]))
    return _mix_trees(params, new_bufs, topo), StaleBufs(tuple(new_bufs),
                                                         new_age)


def gossip_shift_overlap(params: PyTree, stale: StaleBufs, topo: Topology,
                         cfg: DAdamConfig) -> Tuple[PyTree, StaleBufs]:
    """Overlapped shift gossip: round r SENDS this round's neighbour
    exchange (the fresh shifts) but MIXES the payloads sent at round
    r-1, held in the buffers, a uniform delay-1 wire schedule. Cold
    buffers (first round, and after an elastic resize or a restore: ``age
    >= COLD_AGE``) fold the fresh payload instead."""
    if not topo.offsets:
        return params, stale
    axis = _axis(cfg)
    cold = stale.age >= COLD_AGE
    tags = itertools.count()
    fresh, used = [], []
    for i, s in enumerate(topo.offsets):
        f = _shift_tree(params, s, topo.K, axis, tags)
        fresh.append(f)
        used.append(tree_map(
            lambda a, b, i=i: select_workers(
                cold[:, i], lambda j: a if j else b.to(a.dtype)),
            f, stale.bufs[i]))
    return (_mix_trees(params, used, topo),
            StaleBufs(tuple(fresh), torch.zeros_like(stale.age)))


def _mix_payloads(buf: torch.Tensor, used, topo: Topology,
                  axis: Any) -> torch.Tensor:
    """The packed straggler-tolerant mix: the ``payload_mix`` kernel when
    stacked, f32 torch ops under ``comm='axis'`` (as in JAX, which mixes
    outside Pallas there)."""
    if axis is not None:
        return _mix_trees(buf, used, topo)
    return ops.payload_mix(buf, used, topo.offset_weights, topo.self_weight)


def gossip_packed_stale(buf: torch.Tensor, stale: StaleBufs, topo: Topology,
                        cfg: DAdamConfig, r: int,
                        arrival: Optional[ArrivalFn] = None
                        ) -> Tuple[torch.Tensor, StaleBufs]:
    """Staleness-bounded gossip on the resident packed buffer: the
    payload choice per worker, then the ``payload_mix`` kernel (the
    accumulation order of ``gossip_mix``, so tau=0, which runs the
    synchronous packed round, and tau>0 share their arithmetic)."""
    if not topo.offsets:
        return buf, stale
    axis = _axis(cfg)
    tau = int(cfg.staleness)
    if tau == 0:
        return (gossip_packed(buf, topo, cfg),
                StaleBufs(stale.bufs, torch.zeros_like(stale.age)))
    take = _arrival_mask(cfg, r, topo.K, len(topo.offsets),
                         arrival) | (stale.age >= tau)
    new_age = torch.where(take, 0, stale.age + 1).to(torch.int32)
    used = [_fresh_or_kept(
        take[:, i], lambda i=i, s=s: shift_worker(buf, s, topo.K, axis, i),
        lambda i=i: stale.bufs[i].to(buf.dtype), axis)
        for i, s in enumerate(topo.offsets)]
    return (_mix_payloads(buf, used, topo, axis),
            StaleBufs(tuple(used), new_age))


def gossip_packed_overlap(buf: torch.Tensor, stale: StaleBufs,
                          topo: Topology, cfg: DAdamConfig
                          ) -> Tuple[torch.Tensor, StaleBufs]:
    """Packed twin of :func:`gossip_shift_overlap`: send this round's
    shifted buffers, mix last round's (fresh on a cold start) with the
    ``payload_mix`` kernel."""
    if not topo.offsets:
        return buf, stale
    axis = _axis(cfg)
    cold = stale.age >= COLD_AGE
    fresh = [shift_worker(buf, s, topo.K, axis, i)
             for i, s in enumerate(topo.offsets)]
    used = [select_workers(cold[:, i], lambda j, i=i, f=f: f if j
                           else stale.bufs[i].to(buf.dtype))
            for i, f in enumerate(fresh)]
    return (_mix_payloads(buf, used, topo, axis),
            StaleBufs(tuple(fresh), torch.zeros_like(stale.age)))


# --------------------- round dispatch (schedule-aware) ----------------------


def round_view(topo: "Topology | TopologySchedule", r: int,
               union: bool) -> Topology:
    """Round r's topology: a static one as it is; a schedule's entry
    ``r % n``, rebuilt over the union offsets when per-edge state needs
    the same offset tuple every round. ``r`` is a host int."""
    if not isinstance(topo, TopologySchedule):
        return topo
    views = topo.union_views() if union else topo.entries
    return views[r % len(views)]


def _uses_union(stale: Optional[StaleBufs], cfg: DAdamConfig) -> bool:
    """Live payload buffers need the union edge set; without them (no
    staleness or overlap, or tau=0 where they are never read) each round
    gossips its own entry."""
    return stale is not None and (int(cfg.staleness or 0) > 0
                                  or cfg.overlap)


def _gossip_round(params: PyTree, stale: Optional[StaleBufs],
                  topo: "Topology | TopologySchedule", cfg: DAdamConfig,
                  r: int, arrival: Optional[ArrivalFn] = None
                  ) -> Tuple[PyTree, Optional[StaleBufs]]:
    """One communication round on the tree path."""
    view = round_view(topo, r, _uses_union(stale, cfg))
    if stale is None:
        return gossip(params, view, cfg), None
    if cfg.overlap:
        return gossip_shift_overlap(params, stale, view, cfg)
    return gossip_shift_stale(params, stale, view, cfg, r, arrival)


def _gossip_packed_round(buf: torch.Tensor, stale: Optional[StaleBufs],
                         topo: "Topology | TopologySchedule",
                         cfg: DAdamConfig, r: int,
                         arrival: Optional[ArrivalFn] = None
                         ) -> Tuple[torch.Tensor, Optional[StaleBufs]]:
    """Packed twin of :func:`_gossip_round`."""
    view = round_view(topo, r, _uses_union(stale, cfg))
    if stale is None:
        return gossip_packed(buf, view, cfg), None
    if cfg.overlap:
        return gossip_packed_overlap(buf, stale, view, cfg)
    return gossip_packed_stale(buf, stale, view, cfg, r, arrival)


# ------------------------------ state + step -------------------------------


class DAdamState(NamedTuple):
    params: PyTree          # stacked (K, ...)
    moments: AdamMoments
    # straggler-tolerant payload buffers (cfg.staleness / cfg.overlap);
    # stripped from checkpoints and rebuilt cold on restore
    stale: Optional[StaleBufs] = None


@dataclasses.dataclass(frozen=True)
class PackedDAdamState:
    """Resident packed D-Adam state for ``backend='packed'``.

    Params (``buf``) and both moments (``m``, ``v``) live in stacked,
    leaf-aligned ``(K, rows, 128)`` buffers across steps, so the kernels
    consume and produce them directly. Packing happens once in
    :func:`init`; the tree views (``params``, ``moments``) are views of
    the buffers, made at boundaries (eval, logging, checkpoints).
    ``stale`` holds the packed payload buffers of the straggler-tolerant
    runtime, or ``None``."""

    buf: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    count: int
    spec: packing.PackSpec
    spec_m: packing.PackSpec
    stale: Optional[StaleBufs] = None

    def with_stale(self, stale: Optional[StaleBufs]) -> "PackedDAdamState":
        return dataclasses.replace(self, stale=stale)

    def map_buffers(self, fn: Callable[[torch.Tensor, int], torch.Tensor]
                    ) -> "PackedDAdamState":
        """``fn(x, row_dim)`` applied to every packed buffer (params,
        moments, payload buffers), the rest kept: how the 2D layout cuts
        a state into its model blocks and puts it back together
        (``launch.shardings``)."""
        stale = self.stale
        if stale is not None:
            stale = StaleBufs(tuple(fn(b, 1) for b in stale.bufs), stale.age)
        return dataclasses.replace(self, buf=fn(self.buf, 1),
                                   m=fn(self.m, 1), v=fn(self.v, 1),
                                   stale=stale)

    @property
    def params(self) -> PyTree:
        return packing.unpack(self.buf, self.spec)

    @property
    def moments(self) -> AdamMoments:
        return AdamMoments(packing.unpack(self.m, self.spec_m),
                           packing.unpack(self.v, self.spec_m), self.count)

    def unpacked(self) -> DAdamState:
        """The backend-agnostic tree state, leaf for leaf a reference
        state, without the transient payload buffers."""
        return DAdamState(self.params, self.moments)

    @classmethod
    def from_unpacked(cls, state: DAdamState, *, row_shards: int = 1,
                      block: Optional[int] = None) -> "PackedDAdamState":
        """``row_shards=M`` packs into the row-sharded 2D layout (whole
        buffers; ``launch.shardings.take_model_block`` cuts a rank's
        block out), or with ``block=j`` straight into block j's."""
        spec = packing.make_spec(state.params, stacked=True,
                                 block_rows=BLOCK_ROWS, leaf_align=True,
                                 row_shards=row_shards)
        spec_m = packing.make_spec(state.moments.m, stacked=True,
                                   block_rows=BLOCK_ROWS, leaf_align=True,
                                   row_shards=row_shards)
        return cls(packing.pack(state.params, spec, block=block),
                   packing.pack(state.moments.m, spec_m, block=block),
                   packing.pack(state.moments.v, spec_m, block=block),
                   state.moments.count, spec, spec_m)


def grads_buffer(grads: Any, spec: packing.PackSpec, dtype: torch.dtype,
                 block: Optional[int] = None) -> torch.Tensor:
    """Admit gradients in either form: an already packed buffer of the
    resident shape passes through (the steady state: the grad pipeline
    differentiates through ``packing.unpack``); a tree is packed once
    here. Under the 2D layout the resident shape is one shard block,
    ``spec.block_shape()``, and a tree (the worker's whole grads) is
    packed and cut to block ``block``."""
    want = spec.block_shape() if spec.stacked else spec.buf_shape()
    if isinstance(grads, torch.Tensor):
        if tuple(grads.shape) == want:
            return grads.to(dtype)
        raise ValueError(
            f"packed grads shape {tuple(grads.shape)} != resident "
            f"buffer {want}")
    buf = packing.pack(grads, spec, dtype=dtype)
    if spec.row_shards > 1:
        rows = spec.local_rows
        buf = buf[:, block * rows:(block + 1) * rows].contiguous()
    return buf


def model_block(cfg: DAdamConfig) -> Optional[int]:
    """This rank's model index under the 2D layout, else ``None``."""
    return cfg.group.model_rank if cfg.model_parallel > 1 else None


def init(params_stacked: PyTree, cfg: DAdamConfig,
         topo: "Topology | TopologySchedule | None" = None
         ) -> "DAdamState | PackedDAdamState":
    """The state of ``params_stacked``: all K workers' under
    ``comm='stacked'``, this rank's ``(1, ...)`` slice under
    ``comm='axis'``. Under the 2D layout the packed buffers are the
    rank's block of its worker's row-sharded ones, packed straight from
    the params (no whole buffer is made). A packed init takes its zero
    moments as expanded scalars (``lazy_zeros``)."""
    cfg.validate()
    workers = 1 if cfg.comm == "axis" else None
    needs_bufs = cfg.staleness is not None or cfg.overlap
    if needs_bufs and topo is None:
        raise ValueError(
            "cfg.staleness/cfg.overlap buffer one payload per topology "
            "offset; init needs the topology (pass topo=, as "
            "make_optimizer does)")
    packed_init = cfg.backend == "packed"
    state = DAdamState(params_stacked, init_moments(params_stacked, cfg,
                                                    lazy=packed_init))
    if packed_init:
        packed = PackedDAdamState.from_unpacked(
            state, row_shards=cfg.model_parallel, block=model_block(cfg))
        if needs_bufs:
            packed = packed.with_stale(init_stale(packed.buf, topo,
                                                  workers))
        return packed
    if needs_bufs:
        state = state._replace(stale=init_stale(params_stacked, topo,
                                                workers))
    return state


def _fused_local_packed(state: PackedDAdamState, grads: Any,
                        cfg: DAdamConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   int]:
    """Alg. 1 lines 3-6 on the resident buffers: one ``fused_adam`` pass.
    Returns (params_buf, m_buf, v_buf, count)."""
    gbuf = grads_buffer(grads, state.spec, state.buf.dtype, model_block(cfg))
    po, mo, vo = ops.fused_adam(
        state.buf, gbuf, state.m, state.v,
        eta=cfg.eta, beta1=cfg.beta1, beta2=cfg.beta2, tau=cfg.tau,
        weight_decay=cfg.weight_decay)
    return po, mo, vo, state.count + 1


def _gossip_adam_eligible(topo: "Topology | TopologySchedule",
                          cfg: DAdamConfig) -> bool:
    """True when the communication step can run as the single-pass
    ``gossip_adam_mix`` kernel: a static shift-invariant topology of int
    or ``GridShift`` offsets whose degree is at most
    ``MAX_GOSSIP_ADAM_DEGREE``, mixed by shifts, with no payload buffers
    in flight."""
    if isinstance(topo, TopologySchedule):
        return False
    if cfg.comm != "stacked" or cfg.mixing == "dense":
        return False
    if cfg.staleness is not None or cfg.overlap:
        return False
    if topo.K == 1 or not topo.offsets:
        return False
    if len(topo.offsets) > MAX_GOSSIP_ADAM_DEGREE:
        return False
    return all(isinstance(s, (int, np.integer, GridShift))
               for s in topo.offsets)


def _comm_due(count: int, cfg: DAdamConfig) -> bool:
    return cfg.period == 1 or count % cfg.period == 0


def _step_packed_fused(state: PackedDAdamState, grads: Any,
                       topo: Topology, cfg: DAdamConfig
                       ) -> PackedDAdamState:
    """A communication step is one ``gossip_adam_mix`` pass (the half-step
    and the mix, the half-stepped params never stored); a local step is
    one ``fused_adam`` pass."""
    gbuf = grads_buffer(grads, state.spec, state.buf.dtype)
    count = state.count + 1
    kw = dict(eta=cfg.eta, beta1=cfg.beta1, beta2=cfg.beta2, tau=cfg.tau,
              weight_decay=cfg.weight_decay)
    if _comm_due(count, cfg):
        po, mo, vo = ops.gossip_adam_mix(
            state.buf, gbuf, state.m, state.v, topo.offsets,
            topo.offset_weights, topo.self_weight, **kw)
    else:
        po, mo, vo = ops.fused_adam(state.buf, gbuf, state.m, state.v, **kw)
    return dataclasses.replace(state, buf=po, m=mo, v=vo, count=count)


def _step_packed(state: PackedDAdamState, grads: Any,
                 topo: "Topology | TopologySchedule", cfg: DAdamConfig,
                 arrival: Optional[ArrivalFn] = None) -> PackedDAdamState:
    if _gossip_adam_eligible(topo, cfg):
        return _step_packed_fused(state, grads, topo, cfg)
    po, mo, vo, count = _fused_local_packed(state, grads, cfg)
    stale = state.stale
    if _comm_due(count, cfg):
        po, stale = _gossip_packed_round(po, stale, topo, cfg,
                                         _round_index(count, cfg.period),
                                         arrival)
    return dataclasses.replace(state, buf=po, m=mo, v=vo, count=count,
                               stale=stale)


def step(state: "DAdamState | PackedDAdamState", grads: PyTree,
         topo: "Topology | TopologySchedule", cfg: DAdamConfig,
         arrival: Optional[ArrivalFn] = None
         ) -> "DAdamState | PackedDAdamState":
    """One iteration of Alg. 1. Packed states never leave the
    ``(K, rows, 128)`` layout; ``grads`` may be a congruent tree or an
    already packed buffer. ``arrival`` replaces the default straggler
    draw (:func:`default_arrival`)."""
    if isinstance(state, PackedDAdamState):
        return _step_packed(state, grads, topo, cfg, arrival)
    half, mom = local_update(state.params, grads, state.moments, cfg)
    stale = state.stale
    if _comm_due(mom.count, cfg):
        half, stale = _gossip_round(half, stale, topo, cfg,
                                    _round_index(mom.count, cfg.period),
                                    arrival)
    return DAdamState(half, mom, stale)


def round_step(state: "DAdamState | PackedDAdamState",
               grad_fn: Callable[[Any, Any], Any], batches: Any,
               topo: "Topology | TopologySchedule", cfg: DAdamConfig,
               arrival: Optional[ArrivalFn] = None
               ) -> "DAdamState | PackedDAdamState":
    """One communication round: a local step per entry of ``batches``'
    leading dim (p of them), then one gossip.

    For packed states ``grad_fn`` receives the ``(K, rows, 128)`` params
    buffer and may return the grads as a congruent buffer or a tree."""
    leaves = tree_leaves(batches)
    p = leaves[0].shape[0]
    for t in range(p):
        batch = tree_map(lambda x, t=t: x[t], batches)
        if isinstance(state, PackedDAdamState):
            po, mo, vo, count = _fused_local_packed(
                state, grad_fn(state.buf, batch), cfg)
            state = dataclasses.replace(state, buf=po, m=mo, v=vo,
                                        count=count)
        else:
            half, mom = local_update(state.params,
                                     grad_fn(state.params, batch),
                                     state.moments, cfg)
            state = DAdamState(half, mom, state.stale)
    if isinstance(state, PackedDAdamState):
        buf, stale = _gossip_packed_round(
            state.buf, state.stale, topo, cfg,
            _round_index(state.count, cfg.period), arrival)
        return dataclasses.replace(state, buf=buf, stale=stale)
    params, stale = _gossip_round(
        state.params, state.stale, topo, cfg,
        _round_index(state.moments.count, cfg.period), arrival)
    return DAdamState(params, state.moments, stale)


def consensus_error(params_stacked: PyTree) -> torch.Tensor:
    """(1/K) sum_k ||x_k - x_bar||^2, the quantity Lemma 1 bounds."""
    def per_leaf(x):
        xf = x.to(torch.float32)
        mean = torch.mean(xf, dim=0, keepdim=True)
        return torch.sum((xf - mean) ** 2) / x.shape[0]

    return sum(per_leaf(x) for x in tree_leaves(params_stacked))


def mean_params(params_stacked: PyTree) -> PyTree:
    return tree_map(
        lambda x: torch.mean(x.to(torch.float32), dim=0).to(x.dtype),
        params_stacked)
