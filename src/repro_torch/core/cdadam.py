"""CD-Adam (Algorithm 2): D-Adam with compressed gossip and error feedback,
the port of ``repro.core.cdadam``.

At a communication round (``(t + 1) % p == 0``), worker k:

    x_{t+1}   = x_{t+1/2} + gamma * sum_j w_kj (xhat_j - xhat_k)     (8)
    q_k       = Q(x_{t+1} - xhat_k)                                  (9)
    send q_k to neighbours / receive q_j                             (10)
    xhat_j   += q_j   for j in N_k and k itself                      (11)

Every worker stores xhat copies of itself and of each neighbour, so the
mix needs no communication; only the compressed residual q travels. Worker
k receives ``q_{src_s(k)}`` through :func:`repro_torch.core.dadam
.shift_worker`, the encoded payload (int8 signs and their scales) shifted
over the stacked worker dim (``comm='stacked'``), or exchanged with the
offset's peers by the rank that holds worker k (``comm='axis'``, where
every buffer below is the rank's ``(1, ...)`` shard and the kernels run
with K = 1).

Two backends, as for D-Adam:

* ``'reference'``: tree math with any compressor of
  :mod:`repro_torch.core.compression`, encoded and decoded per worker;
* ``'packed'``: params, moments, ``xhat_self`` and one ``xhat`` per graph
  offset stay resident as ``(K, rows, 128)`` buffers
  (:class:`PackedCDAdamState`); a round is one ``consensus_mix`` kernel,
  one ``sign_compress_stacked`` call over every leaf segment (one scale
  per worker and leaf, ``scales='leaf'``, or per worker,
  ``scales='worker'``) and the neighbour-copy update in torch ops.

Under the 2D worker x model layout (``cfg.model_parallel`` = M > 1) every
packed buffer is a rank's ``(1, rows / M, 128)`` block of the row-sharded
layout: the leaf segments' row ranges are those within a block, and
``sign_compress_stacked`` sums each (worker, leaf) scale's partial sums
over the worker's M ranks (``reduce_axis``, the model group's
deterministic sum) before dividing by the leaf's global true count, so
every rank of a worker applies and sends the same scale.

An unpacked :class:`CDAdamState` stepped with ``backend='packed'`` takes
the reference round with the sign compressor, the same math.

Straggler tolerance (``cfg.staleness`` > 0 or ``cfg.overlap``) delays the
encoded payloads through per-edge delay rings (``pending``), and a
topology schedule runs each round over its union edge set. The step
counter and round index are host ints, so the communication test, the
ring slots and a schedule's entry for the round cost no device sync.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._tree import (tree_flatten, tree_leaves, tree_map,
                               tree_unflatten)
from repro_torch.core.compression import Compressor
from repro_torch.core.dadam import (AdamMoments, DAdamConfig, _axis,
                                    _comm_due, _fused_local_packed,
                                    _round_index, init_moments, lazy_zeros,
                                    local_rows, local_update, model_block,
                                    round_view, select_workers,
                                    shift_worker)
from repro_torch.launch.mesh import model_sum
from repro_torch.core.schedule import TopologySchedule, comm_offsets
from repro_torch.core.topology import Topology
from repro_torch.kernels import ops
from repro_torch.kernels import pack as packing
from repro_torch.kernels.fused_adam import f32
from repro_torch.kernels.pack import BLOCK_ROWS

PyTree = Any


@dataclasses.dataclass(frozen=True)
class CDAdamConfig(DAdamConfig):
    gamma: float = 0.4    # the paper's consensus step size
    scales: str = "leaf"  # 'leaf': one sign scale per (worker, leaf), the
    #                       reference semantics; 'worker': one scale per
    #                       worker over the whole resident buffer
    #                       (backend='packed' only)

    def validate(self) -> None:
        super().validate()
        if not 0 < self.gamma <= 1:
            raise ValueError("gamma must be in (0, 1]")
        if self.scales not in ("leaf", "worker"):
            raise ValueError(f"unknown scales {self.scales!r} "
                             "(use 'leaf' or 'worker')")
        if self.scales == "worker" and self.backend != "packed":
            raise ValueError(
                "scales='worker' is the whole-buffer compressor: one pass "
                "over the resident packed buffer; it requires "
                "backend='packed' (the reference path compresses per leaf)")
        if (self.staleness or 0) > 0 and self.comm == "axis":
            raise ValueError(
                "CD-Adam staleness delays payloads through per-edge ring "
                "buffers indexed by the static delay table; the comm='axis' "
                "form is not wired, as in the JAX package: use "
                "comm='stacked' (D-Adam supports staleness under "
                "comm='axis')")


class CDAdamState(NamedTuple):
    params: PyTree                 # x, stacked (K, ...)
    moments: AdamMoments
    hat_self: PyTree               # xhat of worker k, stacked (K, ...)
    hat_nbrs: Tuple[PyTree, ...]   # worker k's copy of xhat_{src_s(k)},
    #                                one per topology offset s
    # straggler-tolerant payload delay rings (cfg.staleness > 0 or
    # cfg.overlap): one per offset, a tuple over the param leaves of
    # encoded payloads with a T = tau + 1 slot dim at axis 1. Stripped
    # from checkpoints, rebuilt cold on restore.
    pending: Optional[Tuple[Any, ...]] = None


@dataclasses.dataclass(frozen=True)
class PackedCDAdamState:
    """Resident packed CD-Adam state for ``backend='packed'``.

    Params (``buf``), both moments, ``xhat_self`` (``hat_buf``) and one
    ``xhat`` copy per topology offset (``hat_nbr_bufs``) live in stacked,
    leaf-aligned ``(K, rows, 128)`` buffers across steps. The tree views
    are made at boundaries (eval, logging, checkpoints). ``pending``
    holds one delay ring per offset, ``{"q": (K, T, rows, 128) int8,
    "scale": (K, T, L) or (K, T) f32}``, or ``None``."""

    buf: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    count: int
    hat_buf: torch.Tensor
    hat_nbr_bufs: Tuple[torch.Tensor, ...]
    spec: packing.PackSpec
    spec_m: packing.PackSpec
    pending: Optional[Tuple[Any, ...]] = None

    def with_pending(self, pending) -> "PackedCDAdamState":
        return dataclasses.replace(self, pending=pending)

    def map_buffers(self, fn: Callable[[torch.Tensor, int], torch.Tensor]
                    ) -> "PackedCDAdamState":
        """``fn(x, row_dim)`` applied to every packed buffer (params,
        moments, hats, the delay rings' q), the rest kept (see
        ``PackedDAdamState.map_buffers``)."""
        pending = self.pending
        if pending is not None:
            pending = tuple({"q": fn(r["q"], 2), "scale": r["scale"]}
                            for r in pending)
        return dataclasses.replace(
            self, buf=fn(self.buf, 1), m=fn(self.m, 1), v=fn(self.v, 1),
            hat_buf=fn(self.hat_buf, 1),
            hat_nbr_bufs=tuple(fn(h, 1) for h in self.hat_nbr_bufs),
            pending=pending)

    @property
    def params(self) -> PyTree:
        return packing.unpack(self.buf, self.spec)

    @property
    def moments(self) -> AdamMoments:
        return AdamMoments(packing.unpack(self.m, self.spec_m),
                           packing.unpack(self.v, self.spec_m), self.count)

    @property
    def hat_self(self) -> PyTree:
        return packing.unpack(self.hat_buf, self.spec)

    @property
    def hat_nbrs(self) -> Tuple[PyTree, ...]:
        return tuple(packing.unpack(h, self.spec) for h in self.hat_nbr_bufs)

    def unpacked(self) -> CDAdamState:
        """The backend-agnostic tree state, leaf for leaf a reference
        state, without the transient delay rings."""
        return CDAdamState(self.params, self.moments, self.hat_self,
                           self.hat_nbrs)

    @classmethod
    def from_unpacked(cls, state: CDAdamState, *, row_shards: int = 1,
                      block: Optional[int] = None) -> "PackedCDAdamState":
        """``row_shards=M`` packs into the row-sharded 2D layout (whole
        buffers), or with ``block=j`` straight into block j's."""
        spec = packing.make_spec(state.params, stacked=True,
                                 block_rows=BLOCK_ROWS, leaf_align=True,
                                 row_shards=row_shards)
        spec_m = packing.make_spec(state.moments.m, stacked=True,
                                   block_rows=BLOCK_ROWS, leaf_align=True,
                                   row_shards=row_shards)

        def pk(tree, sp):
            return packing.pack(tree, sp, block=block)

        return cls(pk(state.params, spec), pk(state.moments.m, spec_m),
                   pk(state.moments.v, spec_m), state.moments.count,
                   pk(state.hat_self, spec),
                   tuple(pk(h, spec) for h in state.hat_nbrs),
                   spec, spec_m)


# ---------------- straggler-tolerant payload delay rings --------------------
#
# A CHOCO hat copy is a running SUM of residual payloads, so dropping (or
# re-applying) a payload would desync worker k's copy of its neighbour's hat
# for good. Stragglers therefore DELAY payloads, never drop them: each edge
# (k, offset i) has a static delay d <= tau, incoming encoded payloads enter
# a ring with T = tau + 1 slots, and round r applies the payload pushed at
# round r - d: in order, exactly once, at most tau rounds late.


def _wire_tau(cfg: CDAdamConfig) -> int:
    """Rounds of wire delay the rings implement: the staleness bound, or
    exactly one round under ``cfg.overlap``: overlap is the tau=1 ring with
    an all-ones delay table, which is what makes it bit for bit
    ``staleness=1`` with every payload late."""
    if cfg.overlap:
        return 1
    return int(cfg.staleness or 0)


def _payload_delays(cfg: CDAdamConfig, K: int, deg: int) -> np.ndarray:
    """Static (K, deg) per-edge delay table from ``straggler_seed``
    (``np.random.RandomState``, the JAX package's draw): a fraction
    ``straggler_rate`` of edges is persistently slow, delay uniform in
    [1, tau]; the rest deliver in the same round. Under ``cfg.overlap``
    every edge is exactly one round late."""
    if cfg.overlap:
        return np.ones((K, deg), np.int32)
    tau = _wire_tau(cfg)
    if tau == 0 or cfg.straggler_rate <= 0.0:
        return np.zeros((K, deg), np.int32)
    rs = np.random.RandomState(cfg.straggler_seed)
    slow = rs.rand(K, deg) < cfg.straggler_rate
    d = np.where(slow, rs.randint(1, tau + 1, size=(K, deg)), 0)
    return d.astype(np.int32)


def _ring_like(payload_like: Any, T: int) -> Any:
    """A cold (zero) ring: every payload leaf gains a T-slot dim at axis 1
    (axis 0 stays the worker dim). Zero payloads decode to zero residuals,
    so warm-up rounds apply no hat update: 'no message yet'."""
    return tree_map(lambda p: torch.zeros((p.shape[0], T) + tuple(p.shape[1:]),
                                          dtype=p.dtype, device=p.device),
                    payload_like)


def _ring_push(ring: Any, payload: Any, slot: int) -> Any:
    """A new ring with ``payload`` in ``slot`` (the old ring is kept)."""
    def push(rb, p):
        out = rb.clone()
        out[:, slot] = p.to(rb.dtype)
        return out

    return tree_map(push, ring, payload)


def _ring_gather(ring: Any, sel: np.ndarray) -> Any:
    """Per-worker slot read: leaf (K, T, ...) and host ``sel`` (K,) ->
    (K, ...)."""
    return tree_map(lambda rb: select_workers(sel, lambda j: rb[:, j]), ring)


def _delayed_recv(recv: Any, ring: Optional[Any], d_col: np.ndarray, r: int,
                  tau: int) -> Tuple[Any, Optional[Any]]:
    """Push this round's received payload, pop each worker's delayed
    one."""
    if ring is None:
        return recv, None
    T = tau + 1
    new_ring = _ring_push(ring, recv, r % T)
    return _ring_gather(new_ring, (r - d_col) % T), new_ring


def init(params_stacked: PyTree, cfg: CDAdamConfig,
         topo: "Topology | TopologySchedule",
         comp: Optional[Compressor] = None
         ) -> "CDAdamState | PackedCDAdamState":
    """xhat_0 = 0 for every worker and every neighbour copy (CHOCO's
    convention), one copy per offset that can ever be active (a
    schedule's union); cold delay rings when ``cfg`` delays payloads."""
    cfg.validate()
    offs = comm_offsets(topo)
    if not offs and topo.K > 1:
        raise ValueError("CD-Adam runtime requires a shift-invariant topology")
    tau = _wire_tau(cfg)
    packed_init = cfg.backend == "packed"
    zero = lazy_zeros if packed_init else torch.zeros_like
    zeros = tree_map(zero, params_stacked)
    hat_nbrs = tuple(tree_map(zero, params_stacked) for _ in offs)
    state = CDAdamState(params_stacked,
                        init_moments(params_stacked, cfg, lazy=packed_init),
                        zeros, hat_nbrs)
    if packed_init:
        packed = PackedCDAdamState.from_unpacked(
            state, row_shards=cfg.model_parallel, block=model_block(cfg))
        if tau > 0:
            K, rows = packed.buf.shape[:2]
            per_worker = (() if cfg.scales == "worker"
                          else (len(packed.spec.sizes),))
            dev = packed.buf.device
            ring = {"q": torch.zeros((K, tau + 1, rows, packing.LANE),
                                     dtype=torch.int8, device=dev),
                    "scale": torch.zeros((K, tau + 1) + per_worker,
                                         device=dev)}
            packed = packed.with_pending(tuple(ring for _ in offs))
        return packed
    if tau > 0:
        if comp is None:
            raise ValueError(
                "cfg.staleness > 0 rings buffer ENCODED payloads; the "
                "reference backend needs the compressor at init (pass "
                "comp=, as make_optimizer does)")
        payload_like = tuple(_encode_stacked(comp, z)
                             for z in tree_leaves(zeros))
        ring = _ring_like(payload_like, tau + 1)
        state = state._replace(pending=tuple(ring for _ in offs))
    return state


# ------------------------------ reference round ----------------------------


def _mix_with_hats(x_half: PyTree, hat_self: PyTree,
                   hat_nbrs: Tuple[PyTree, ...], topo: Topology,
                   cfg: CDAdamConfig) -> PyTree:
    """(8), the local mix with the stored neighbour copies."""

    def mixed(xh, hs, *hns):
        hs = hs.to(torch.float32)
        acc = torch.zeros_like(hs)
        for w, hn in zip(topo.offset_weights, hns):
            acc = acc + f32(w) * (hn.to(torch.float32) - hs)
        return (xh.to(torch.float32) + f32(cfg.gamma) * acc).to(xh.dtype)

    return tree_map(mixed, x_half, hat_self, *hat_nbrs)


def _encode_stacked(comp: Compressor, x: torch.Tensor) -> Any:
    """``comp.encode`` of each worker's slice of ``x`` (per-worker
    scales), stacked over a leading K dim."""
    per = [comp.encode(x[k]) for k in range(x.shape[0])]
    return tree_map(lambda *ps: torch.stack(ps), *per)


def _decode_stacked(comp: Compressor, payload: Any,
                    like: torch.Tensor) -> torch.Tensor:
    shape = tuple(like.shape[1:])
    return torch.stack([
        comp.decode(tree_map(lambda a, k=k: a[k], payload), shape,
                    like.dtype)
        for k in range(like.shape[0])])


def _comm_round(state_half: CDAdamState, topo: Topology, cfg: CDAdamConfig,
                comp: Compressor, r: int) -> CDAdamState:
    """Lines 8-11 of Alg. 2 on the half-step parameters, leaf by leaf."""
    x_new = _mix_with_hats(state_half.params, state_half.hat_self,
                           state_half.hat_nbrs, topo, cfg)
    xs, td = tree_flatten(x_new)
    hats = tree_leaves(state_half.hat_self)
    resid = [a - b for a, b in zip(xs, hats)]
    # (9) compress the residual against our own xhat; (11a) xhat_k += q_k
    q_enc = tuple(_encode_stacked(comp, res) for res in resid)
    new_hat_self = [h + _decode_stacked(comp, p, res).to(h.dtype)
                    for h, p, res in zip(hats, q_enc, resid)]
    # (10) + (11b) worker k receives the ENCODED payload of src_s(k) and
    # decodes it locally; with delay rings it takes the payload of round
    # r - d instead, in order, never dropped
    tau = _wire_tau(cfg)
    delays = local_rows(_payload_delays(cfg, topo.K, len(topo.offsets)), cfg)
    pending = state_half.pending
    axis, tags = _axis(cfg), itertools.count()
    new_hat_nbrs, new_pending = [], []
    for i, (s, hn) in enumerate(zip(topo.offsets, state_half.hat_nbrs)):
        recv = tuple(tree_map(lambda a: shift_worker(a, s, topo.K, axis,
                                                     next(tags)), p)
                     for p in q_enc)
        use, ring = _delayed_recv(recv, None if pending is None
                                  else pending[i], delays[:, i], r, tau)
        upd = [h + _decode_stacked(comp, u, res).to(h.dtype)
               for h, u, res in zip(tree_leaves(hn), use, resid)]
        new_hat_nbrs.append(tree_unflatten(td, upd))
        new_pending.append(ring)
    return CDAdamState(x_new, state_half.moments,
                       tree_unflatten(td, new_hat_self), tuple(new_hat_nbrs),
                       None if pending is None else tuple(new_pending))


# ------------------------------- packed round ------------------------------


@functools.lru_cache(maxsize=64)
def _rows_per_leaf(ranges: Tuple[Tuple[int, int], ...],
                   device: torch.device) -> torch.Tensor:
    return torch.tensor([r1 - r0 for r0, r1 in ranges], device=device)


def shift_payload(q_buf: torch.Tensor, scales: torch.Tensor, s: Any,
                  K: int, axis: Any = None, tag: int = 0) -> dict:
    """(10): worker k receives ``src_s(k)``'s int8 q and scales (under
    ``comm='axis'`` two messages, tags ``2 * tag`` and ``2 * tag + 1``)."""
    return {"q": shift_worker(q_buf, s, K, axis, 2 * tag),
            "scale": shift_worker(scales, s, K, axis, 2 * tag + 1)}


def apply_nbr_hat(hn: torch.Tensor, recv: dict,
                  ranges: Optional[Tuple[Tuple[int, int], ...]] = None
                  ) -> torch.Tensor:
    """(11b): ``hn + scale * q`` with the received scales (``(K,)``, or
    ``(K, L)`` spread over the leaves' row ``ranges``)."""
    q, sc = recv["q"], recv["scale"]
    if ranges is None:
        sc = sc[:, None, None]
    else:
        sc = torch.repeat_interleave(
            sc, _rows_per_leaf(ranges, q.device), dim=1,
            output_size=q.shape[1])[:, :, None]
    return hn + (sc * q.to(torch.float32)).to(hn.dtype)


def update_nbr_hats(hat_nbr_bufs: Sequence[torch.Tensor], q_buf: torch.Tensor,
                    scales: torch.Tensor, topo: Topology,
                    ranges: Optional[Tuple[Tuple[int, int], ...]] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """(10) + (11b) on the resident buffers with no delay: per offset s,
    shift the int8 ``q_buf`` and the scales by ``s`` and add
    ``scale * q`` to the neighbour copy."""
    return tuple(apply_nbr_hat(hn, shift_payload(q_buf, scales, s, topo.K),
                               ranges)
                 for s, hn in zip(topo.offsets, hat_nbr_bufs))


def _comm_round_packed(state_half: PackedCDAdamState, topo: Topology,
                       cfg: CDAdamConfig, r: int) -> PackedCDAdamState:
    """Lines 8-11 of Alg. 2 on the resident buffers: one ``consensus_mix``
    pass, one ``sign_compress_stacked`` call over every leaf segment (or
    the whole buffer for ``scales='worker'``, divided by the true element
    count), then the neighbour copies from the int8 payload, through the
    delay rings when ``cfg`` delays payloads. Under the 2D layout the
    buffers are the rank's block, the row ranges those within a block,
    and the scales' sums are summed over the worker's model group before
    the division by the global true counts."""
    spec = state_half.spec
    x_new = ops.consensus_mix(state_half.buf, state_half.hat_buf,
                              state_half.hat_nbr_bufs, topo.offset_weights,
                              cfg.gamma)
    reduce = (functools.partial(model_sum, wg=cfg.group)
              if cfg.model_parallel > 1 else None)
    if cfg.scales == "worker":
        ranges = None
        q_buf, scales, new_hat = ops.sign_compress_stacked(
            x_new, state_half.hat_buf, n_true=spec.n, reduce_axis=reduce)
    else:
        ranges = packing.leaf_row_ranges(spec)
        q_buf, scales, new_hat = ops.sign_compress_stacked(
            x_new, state_half.hat_buf, n_true=spec.sizes, row_ranges=ranges,
            reduce_axis=reduce)
    tau = _wire_tau(cfg)
    delays = local_rows(_payload_delays(cfg, topo.K, len(topo.offsets)), cfg)
    pending = state_half.pending
    new_nbrs, new_pending = [], []
    with torch.profiler.record_function("repro_torch.cdadam.nbr_hat_update"):
        for i, (s, hn) in enumerate(zip(topo.offsets,
                                        state_half.hat_nbr_bufs)):
            recv, ring = _delayed_recv(
                shift_payload(q_buf, scales, s, topo.K, _axis(cfg), i),
                None if pending is None else pending[i], delays[:, i], r,
                tau)
            new_nbrs.append(apply_nbr_hat(hn, recv, ranges))
            new_pending.append(ring)
    return dataclasses.replace(
        state_half, buf=x_new, hat_buf=new_hat, hat_nbr_bufs=tuple(new_nbrs),
        pending=None if pending is None else tuple(new_pending))


# ---------------------------------- steps ----------------------------------


def _local_packed(state: PackedCDAdamState, grads: Any,
                  cfg: CDAdamConfig) -> PackedCDAdamState:
    po, mo, vo, count = _fused_local_packed(state, grads, cfg)
    return dataclasses.replace(state, buf=po, m=mo, v=vo, count=count)


def _local_ref(state: CDAdamState, grads: PyTree,
               cfg: CDAdamConfig) -> CDAdamState:
    half, mom = local_update(state.params, grads, state.moments, cfg)
    return state._replace(params=half, moments=mom)


def _comm(state, topo: "Topology | TopologySchedule", cfg: CDAdamConfig,
          comp: Compressor, r: int):
    """Round r's compressed gossip; a schedule runs its union view of the
    round, so the per-edge hats and rings stay aligned."""
    if topo.K == 1:
        return state
    view = round_view(topo, r, union=True)
    if isinstance(state, PackedCDAdamState):
        return _comm_round_packed(state, view, cfg, r)
    return _comm_round(state, view, cfg, comp, r)


def step(state: "CDAdamState | PackedCDAdamState", grads: PyTree,
         topo: "Topology | TopologySchedule", cfg: CDAdamConfig,
         comp: Compressor) -> "CDAdamState | PackedCDAdamState":
    """One iteration of Alg. 2. Packed states never leave the
    ``(K, rows, 128)`` layout; ``grads`` may be a congruent tree or an
    already packed buffer."""
    if isinstance(state, PackedCDAdamState):
        half = _local_packed(state, grads, cfg)
        count = half.count
    else:
        half = _local_ref(state, grads, cfg)
        count = half.moments.count
    if not _comm_due(count, cfg):
        return half
    return _comm(half, topo, cfg, comp, _round_index(count, cfg.period))


def round_step(state: "CDAdamState | PackedCDAdamState",
               grad_fn: Callable[[Any, Any], Any], batches: Any,
               topo: "Topology | TopologySchedule", cfg: CDAdamConfig,
               comp: Compressor) -> "CDAdamState | PackedCDAdamState":
    """One communication round: a local step per entry of ``batches``'
    leading dim (p of them), then one compressed gossip.

    For packed states ``grad_fn`` receives the ``(K, rows, 128)`` params
    buffer and may return the grads as a congruent buffer or a tree."""
    p = tree_leaves(batches)[0].shape[0]
    for t in range(p):
        batch = tree_map(lambda x, t=t: x[t], batches)
        if isinstance(state, PackedCDAdamState):
            state = _local_packed(state, grad_fn(state.buf, batch), cfg)
        else:
            state = _local_ref(state, grad_fn(state.params, batch), cfg)
    count = (state.count if isinstance(state, PackedCDAdamState)
             else state.moments.count)
    return _comm(state, topo, cfg, comp, _round_index(count, cfg.period))
