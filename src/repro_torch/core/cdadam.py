"""CD-Adam (Algorithm 2): D-Adam with compressed gossip and error feedback,
the port of ``repro.core.cdadam`` for ``comm='stacked'``.

At a communication round (``(t + 1) % p == 0``), worker k:

    x_{t+1}   = x_{t+1/2} + gamma * sum_j w_kj (xhat_j - xhat_k)     (8)
    q_k       = Q(x_{t+1} - xhat_k)                                  (9)
    send q_k to neighbours / receive q_j                             (10)
    xhat_j   += q_j   for j in N_k and k itself                      (11)

Every worker stores xhat copies of itself and of each neighbour, so the
mix needs no communication; only the compressed residual q travels. Worker
k receives ``q_{src_s(k)}`` through :func:`repro_torch.core.dadam
.shift_worker`, the encoded payload (int8 signs and their scales) shifted
over the stacked worker dim.

Two backends, as for D-Adam:

* ``'reference'``: tree math with any compressor of
  :mod:`repro_torch.core.compression`, encoded and decoded per worker;
* ``'packed'``: params, moments, ``xhat_self`` and one ``xhat`` per graph
  offset stay resident as ``(K, rows, 128)`` buffers
  (:class:`PackedCDAdamState`); a round is one ``consensus_mix`` kernel,
  one ``sign_compress_stacked`` call over every leaf segment (one scale
  per worker and leaf, ``scales='leaf'``, or per worker,
  ``scales='worker'``) and the neighbour-copy update in torch ops.

An unpacked :class:`CDAdamState` stepped with ``backend='packed'`` takes
the reference round with the sign compressor, the same math. The step
counter is a host int, so the communication test costs no device sync.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch._tree import (tree_flatten, tree_leaves, tree_map,
                               tree_unflatten)
from repro_torch.core.compression import Compressor
from repro_torch.core.dadam import (AdamMoments, DAdamConfig, _comm_due,
                                    _fused_local_packed, init_moments,
                                    local_update, shift_worker)
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


class CDAdamState(NamedTuple):
    params: PyTree                 # x, stacked (K, ...)
    moments: AdamMoments
    hat_self: PyTree               # xhat of worker k, stacked (K, ...)
    hat_nbrs: Tuple[PyTree, ...]   # worker k's copy of xhat_{src_s(k)},
    #                                one per topology offset s


@dataclasses.dataclass(frozen=True)
class PackedCDAdamState:
    """Resident packed CD-Adam state for ``backend='packed'``.

    Params (``buf``), both moments, ``xhat_self`` (``hat_buf``) and one
    ``xhat`` copy per topology offset (``hat_nbr_bufs``) live in stacked,
    leaf-aligned ``(K, rows, 128)`` buffers across steps. The tree views
    are made at boundaries (eval, logging, checkpoints)."""

    buf: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    count: int
    hat_buf: torch.Tensor
    hat_nbr_bufs: Tuple[torch.Tensor, ...]
    spec: packing.PackSpec
    spec_m: packing.PackSpec

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
        state."""
        return CDAdamState(self.params, self.moments, self.hat_self,
                           self.hat_nbrs)

    @classmethod
    def from_unpacked(cls, state: CDAdamState) -> "PackedCDAdamState":
        spec = packing.make_spec(state.params, stacked=True,
                                 block_rows=BLOCK_ROWS, leaf_align=True)
        spec_m = packing.make_spec(state.moments.m, stacked=True,
                                   block_rows=BLOCK_ROWS, leaf_align=True)
        return cls(packing.pack(state.params, spec),
                   packing.pack(state.moments.m, spec_m),
                   packing.pack(state.moments.v, spec_m),
                   state.moments.count,
                   packing.pack(state.hat_self, spec),
                   tuple(packing.pack(h, spec) for h in state.hat_nbrs),
                   spec, spec_m)


def init(params_stacked: PyTree, cfg: CDAdamConfig, topo: Topology
         ) -> "CDAdamState | PackedCDAdamState":
    """xhat_0 = 0 for every worker and every neighbour copy (CHOCO's
    convention)."""
    cfg.validate()
    if not topo.offsets and topo.K > 1:
        raise ValueError("CD-Adam runtime requires a shift-invariant topology")
    zeros = tree_map(torch.zeros_like, params_stacked)
    hat_nbrs = tuple(tree_map(torch.zeros_like, params_stacked)
                     for _ in topo.offsets)
    state = CDAdamState(params_stacked, init_moments(params_stacked), zeros,
                        hat_nbrs)
    if cfg.backend == "packed":
        return PackedCDAdamState.from_unpacked(state)
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
                comp: Compressor) -> CDAdamState:
    """Lines 8-11 of Alg. 2 on the half-step parameters, leaf by leaf."""
    x_new = _mix_with_hats(state_half.params, state_half.hat_self,
                           state_half.hat_nbrs, topo, cfg)
    xs, td = tree_flatten(x_new)
    hats = tree_leaves(state_half.hat_self)
    resid = [a - b for a, b in zip(xs, hats)]
    # (9) compress the residual against our own xhat; (11a) xhat_k += q_k
    q_enc = [_encode_stacked(comp, r) for r in resid]
    new_hat_self = [h + _decode_stacked(comp, p, r).to(h.dtype)
                    for h, p, r in zip(hats, q_enc, resid)]
    # (10) + (11b) worker k receives the ENCODED payload of src_s(k) and
    # decodes it locally
    new_hat_nbrs = []
    for s, hn in zip(topo.offsets, state_half.hat_nbrs):
        upd = []
        for h, p, r in zip(tree_leaves(hn), q_enc, resid):
            recv = tree_map(lambda a: shift_worker(a, s, topo.K), p)
            upd.append(h + _decode_stacked(comp, recv, r).to(h.dtype))
        new_hat_nbrs.append(tree_unflatten(td, upd))
    return CDAdamState(x_new, state_half.moments,
                       tree_unflatten(td, new_hat_self), tuple(new_hat_nbrs))


# ------------------------------- packed round ------------------------------


@functools.lru_cache(maxsize=64)
def _rows_per_leaf(ranges: Tuple[Tuple[int, int], ...],
                   device: torch.device) -> torch.Tensor:
    return torch.tensor([r1 - r0 for r0, r1 in ranges], device=device)


def update_nbr_hats(hat_nbr_bufs: Sequence[torch.Tensor], q_buf: torch.Tensor,
                    scales: torch.Tensor, topo: Topology,
                    ranges: Optional[Tuple[Tuple[int, int], ...]] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """(10) + (11b) on the resident buffers: per offset s, shift the int8
    ``q_buf`` and the scales (``(K,)``, or ``(K, L)`` with the leaves'
    row ``ranges``) by ``s`` and add ``scale * q`` to the neighbour copy."""
    out: List[torch.Tensor] = []
    rows = q_buf.shape[1]
    for s, hn in zip(topo.offsets, hat_nbr_bufs):
        q_recv = shift_worker(q_buf, s, topo.K)
        sc_recv = shift_worker(scales, s, topo.K)
        if ranges is None:
            sc = sc_recv[:, None, None]
        else:
            sc = torch.repeat_interleave(
                sc_recv, _rows_per_leaf(ranges, q_buf.device), dim=1,
                output_size=rows)[:, :, None]
        out.append(hn + (sc * q_recv.to(torch.float32)).to(hn.dtype))
    return tuple(out)


def _comm_round_packed(state_half: PackedCDAdamState, topo: Topology,
                       cfg: CDAdamConfig) -> PackedCDAdamState:
    """Lines 8-11 of Alg. 2 on the resident buffers: one ``consensus_mix``
    pass, one ``sign_compress_stacked`` call over every leaf segment (or
    the whole buffer for ``scales='worker'``, divided by the true element
    count), then the neighbour copies from the int8 payload."""
    spec = state_half.spec
    x_new = ops.consensus_mix(state_half.buf, state_half.hat_buf,
                              state_half.hat_nbr_bufs, topo.offset_weights,
                              cfg.gamma)
    if cfg.scales == "worker":
        ranges = None
        q_buf, scales, new_hat = ops.sign_compress_stacked(
            x_new, state_half.hat_buf, n_true=spec.n)
    else:
        ranges = packing.leaf_row_ranges(spec)
        q_buf, scales, new_hat = ops.sign_compress_stacked(
            x_new, state_half.hat_buf, n_true=spec.sizes, row_ranges=ranges)
    with torch.profiler.record_function("repro_torch.cdadam.nbr_hat_update"):
        new_nbrs = update_nbr_hats(state_half.hat_nbr_bufs, q_buf, scales,
                                   topo, ranges)
    return dataclasses.replace(state_half, buf=x_new, hat_buf=new_hat,
                               hat_nbr_bufs=new_nbrs)


# ---------------------------------- steps ----------------------------------


def _local_packed(state: PackedCDAdamState, grads: Any,
                  cfg: CDAdamConfig) -> PackedCDAdamState:
    po, mo, vo, count = _fused_local_packed(state, grads, cfg)
    return dataclasses.replace(state, buf=po, m=mo, v=vo, count=count)


def _local_ref(state: CDAdamState, grads: PyTree,
               cfg: CDAdamConfig) -> CDAdamState:
    half, mom = local_update(state.params, grads, state.moments, cfg)
    return CDAdamState(half, mom, state.hat_self, state.hat_nbrs)


def _comm(state, topo: Topology, cfg: CDAdamConfig, comp: Compressor):
    if topo.K == 1:
        return state
    if isinstance(state, PackedCDAdamState):
        return _comm_round_packed(state, topo, cfg)
    return _comm_round(state, topo, cfg, comp)


def step(state: "CDAdamState | PackedCDAdamState", grads: PyTree,
         topo: Topology, cfg: CDAdamConfig, comp: Compressor
         ) -> "CDAdamState | PackedCDAdamState":
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
    return _comm(half, topo, cfg, comp)


def round_step(state: "CDAdamState | PackedCDAdamState",
               grad_fn: Callable[[Any, Any], Any], batches: Any,
               topo: Topology, cfg: CDAdamConfig, comp: Compressor
               ) -> "CDAdamState | PackedCDAdamState":
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
    return _comm(state, topo, cfg, comp)
