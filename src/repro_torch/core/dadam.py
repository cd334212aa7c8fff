"""D-Adam (Algorithm 1): decentralized Adam with periodic gossip, in PyTorch.

Per worker k and iteration t:

    m_t = b1 * m_{t-1} + (1 - b1) * g_t
    v_t = b2 * v_{t-1} + (1 - b2) * g_t ** 2
    x_{t+1/2} = x_t - eta * m_t / (sqrt(v_t) + tau)
    if (t + 1) % p == 0:   x_{t+1} = sum_j W[k, j] * x_{t+1/2}^{(j)}
    else:                  x_{t+1} = x_{t+1/2}

The port of ``repro.core.dadam`` for ``comm='stacked'``: every tree leaf
carries a leading worker dim K and all K workers live on one device, which
is the one-GPU case. Two backends:

* ``'reference'``: the tree math of ``local_update`` and a roll (or gather)
  per graph offset for the mix;
* ``'packed'``: the counterpart of the JAX package's ``'pallas'``. Params
  and both moments stay resident in one stacked, leaf-aligned
  ``(K, rows, 128)`` buffer each (:class:`PackedDAdamState`), and the step
  runs the ``fused_adam``, ``gossip_adam_mix`` and ``gossip_mix`` kernels
  on them through :mod:`repro_torch.kernels.ops`.

The step counter is a host int, so the communication test
``count % period == 0`` costs no device sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.core.topology import GridShift, Topology, offset_perm
from repro_torch.kernels import ops
from repro_torch.kernels import pack as packing
from repro_torch.kernels.fused_adam import f32
from repro_torch.kernels.gossip import MAX_FUSED_DEGREE, MAX_GOSSIP_ADAM_DEGREE
from repro_torch.kernels.pack import BLOCK_ROWS

PyTree = Any


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
    backend: str = "reference"  # 'reference' (tree math) | 'packed'
    #                             (resident (K, rows, 128) state + kernels)
    comm: str = "stacked"       # 'stacked' only in this port so far
    staleness: Optional[int] = None  # not ported yet
    overlap: bool = False            # not ported yet

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
        if self.comm == "axis":
            raise NotImplementedError(
                "comm='axis' (one worker per GPU over torch.distributed) is "
                "not ported yet (ROADMAP queue 1, item 10: multi-GPU comm)")
        if self.comm != "stacked":
            raise ValueError(f"unknown comm {self.comm!r}")
        if self.backend == "packed" and self.bias_correction:
            raise ValueError(
                "backend='packed' implements the paper's Alg. 1 update "
                "(no bias correction); use backend='reference' for "
                "bias_correction=True")
        if self.staleness is not None or self.overlap:
            raise NotImplementedError(
                "staleness-bounded and overlapped gossip are not ported yet "
                "(ROADMAP queue 1, item 7: async runtime)")


class AdamMoments(NamedTuple):
    m: PyTree
    v: PyTree
    count: int  # host step counter


def init_moments(params: PyTree) -> AdamMoments:
    zeros = tree_map(torch.zeros_like, params)
    return AdamMoments(m=zeros, v=tree_map(torch.zeros_like, zeros),
                       count=0)


def local_update(params: PyTree, grads: PyTree, mom: AdamMoments,
                 cfg: DAdamConfig) -> Tuple[PyTree, AdamMoments]:
    """Lines 3-6 of Alg. 1 on trees: elementwise, stacked-K transparent."""
    count = mom.count + 1
    b1, b2 = f32(cfg.beta1), f32(cfg.beta2)
    omb1, omb2 = f32(1.0 - cfg.beta1), f32(1.0 - cfg.beta2)
    if cfg.bias_correction:
        t = np.float32(count)
        bc1 = float(np.float32(1.0) - np.float32(cfg.beta1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(cfg.beta2) ** t)

    def upd(x, g, m, v):
        g = g.to(m.dtype)
        if cfg.weight_decay:
            g = g + f32(cfg.weight_decay) * x.to(m.dtype)
        m_new = b1 * m + omb1 * g
        v_new = b2 * v + omb2 * (g * g)
        if cfg.bias_correction:
            m_hat, v_hat = m_new / bc1, v_new / bc2
        else:
            m_hat, v_hat = m_new, v_new
        step = f32(cfg.eta) * m_hat / (torch.sqrt(v_hat) + f32(cfg.tau))
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


def shift_worker(x: torch.Tensor, s: Any, K: int) -> torch.Tensor:
    """Worker k reads worker ``src(k)``'s value over the leading worker
    dim: a plain int is the circulant ``(k + s) % K`` (a roll), a
    :class:`GridShift` the row-wrap-aware torus neighbour (a roll of the
    worker dim seen as its grid), a ``PermShift`` an explicit gather."""
    if x.dim() < 1:
        return x
    if isinstance(s, (int, np.integer)):
        return torch.roll(x, -int(s), dims=0)
    if isinstance(s, GridShift):
        xg = x.reshape((s.rows, s.cols) + tuple(x.shape[1:]))
        xg = torch.roll(xg, (-s.dr, -s.dc), dims=(0, 1))
        return xg.reshape(x.shape)
    idx = torch.as_tensor(offset_perm(s, K), device=x.device)
    return x.index_select(0, idx)


def gossip_dense(params: PyTree, W: np.ndarray) -> PyTree:
    """x^{(k)} <- sum_j W[k, j] x^{(j)} via a dense mixing einsum in f32."""
    def mix(x):
        Wt = torch.as_tensor(np.asarray(W), dtype=torch.float32,
                             device=x.device)
        return torch.einsum("kj,j...->k...", Wt,
                            x.to(torch.float32)).to(x.dtype)

    return tree_map(mix, params)


def gossip_shift(params: PyTree, topo: Topology) -> PyTree:
    """mixed[k] = w_self * x[k] + sum_s w_s * x[src_s(k)], one shift per
    graph offset, accumulated in f32."""
    if not topo.offsets:
        if topo.K == 1:
            return params
        raise ValueError(
            f"topology {topo.name!r} has no shift structure; use gossip_dense"
        )

    def mix(x):
        acc = f32(topo.self_weight) * x.to(torch.float32)
        for s, w in zip(topo.offsets, topo.offset_weights):
            acc = acc + f32(w) * shift_worker(x, s, topo.K).to(torch.float32)
        return acc.to(x.dtype)

    return tree_map(mix, params)


def gossip(params: PyTree, topo: Topology, cfg: DAdamConfig) -> PyTree:
    """The tree path's mix: dense for ``mixing='dense'`` or graphs without
    shift structure, else one shift per offset."""
    if cfg.mixing == "dense" or not topo.offsets:
        return gossip_dense(params, topo.weights)
    return gossip_shift(params, topo)


def gossip_packed(buf: torch.Tensor, topo: Topology,
                  cfg: DAdamConfig) -> torch.Tensor:
    """The mix on the resident packed buffer. Ring offsets and torus
    ``GridShift``s up to ``MAX_FUSED_DEGREE`` take the ``gossip_mix``
    kernel; ``PermShift`` offsets, dense mixing and denser graphs take the
    mixing einsum over the worker dim."""
    if topo.K == 1:
        return buf
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


# ------------------------------ state + step -------------------------------


class DAdamState(NamedTuple):
    params: PyTree          # stacked (K, ...)
    moments: AdamMoments


@dataclasses.dataclass(frozen=True)
class PackedDAdamState:
    """Resident packed D-Adam state for ``backend='packed'``.

    Params (``buf``) and both moments (``m``, ``v``) live in stacked,
    leaf-aligned ``(K, rows, 128)`` buffers across steps, so the kernels
    consume and produce them directly. Packing happens once in
    :func:`init`; the tree views (``params``, ``moments``) are views of
    the buffers, made at boundaries (eval, logging, checkpoints)."""

    buf: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    count: int
    spec: packing.PackSpec
    spec_m: packing.PackSpec

    @property
    def params(self) -> PyTree:
        return packing.unpack(self.buf, self.spec)

    @property
    def moments(self) -> AdamMoments:
        return AdamMoments(packing.unpack(self.m, self.spec_m),
                           packing.unpack(self.v, self.spec_m), self.count)

    def unpacked(self) -> DAdamState:
        """The backend-agnostic tree state, leaf for leaf a reference
        state."""
        return DAdamState(self.params, self.moments)

    @classmethod
    def from_unpacked(cls, state: DAdamState) -> "PackedDAdamState":
        spec = packing.make_spec(state.params, stacked=True,
                                 block_rows=BLOCK_ROWS, leaf_align=True)
        spec_m = packing.make_spec(state.moments.m, stacked=True,
                                   block_rows=BLOCK_ROWS, leaf_align=True)
        return cls(packing.pack(state.params, spec),
                   packing.pack(state.moments.m, spec_m),
                   packing.pack(state.moments.v, spec_m),
                   state.moments.count, spec, spec_m)


def grads_buffer(grads: Any, spec: packing.PackSpec,
                 dtype: torch.dtype) -> torch.Tensor:
    """Admit gradients in either form: an already packed ``(K, rows, 128)``
    buffer passes through (the steady state: the grad pipeline
    differentiates through ``packing.unpack``); a tree is packed once
    here."""
    want = spec.buf_shape()
    if isinstance(grads, torch.Tensor):
        if tuple(grads.shape) == want:
            return grads.to(dtype)
        raise ValueError(
            f"packed grads shape {tuple(grads.shape)} != resident "
            f"buffer {want}")
    return packing.pack(grads, spec, dtype=dtype)


def init(params_stacked: PyTree, cfg: DAdamConfig
         ) -> "DAdamState | PackedDAdamState":
    cfg.validate()
    state = DAdamState(params_stacked, init_moments(params_stacked))
    if cfg.backend == "packed":
        return PackedDAdamState.from_unpacked(state)
    return state


def _fused_local_packed(state: PackedDAdamState, grads: Any,
                        cfg: DAdamConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   int]:
    """Alg. 1 lines 3-6 on the resident buffers: one ``fused_adam`` pass.
    Returns (params_buf, m_buf, v_buf, count)."""
    gbuf = grads_buffer(grads, state.spec, state.buf.dtype)
    po, mo, vo = ops.fused_adam(
        state.buf, gbuf, state.m, state.v,
        eta=cfg.eta, beta1=cfg.beta1, beta2=cfg.beta2, tau=cfg.tau,
        weight_decay=cfg.weight_decay)
    return po, mo, vo, state.count + 1


def _gossip_adam_eligible(topo: Topology, cfg: DAdamConfig) -> bool:
    """True when the communication step can run as the single-pass
    ``gossip_adam_mix`` kernel: a shift-invariant topology of int or
    ``GridShift`` offsets whose degree is at most
    ``MAX_GOSSIP_ADAM_DEGREE``, mixed by shifts."""
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
    return PackedDAdamState(po, mo, vo, count, state.spec, state.spec_m)


def _step_packed(state: PackedDAdamState, grads: Any, topo: Topology,
                 cfg: DAdamConfig) -> PackedDAdamState:
    if _gossip_adam_eligible(topo, cfg):
        return _step_packed_fused(state, grads, topo, cfg)
    po, mo, vo, count = _fused_local_packed(state, grads, cfg)
    if _comm_due(count, cfg):
        po = gossip_packed(po, topo, cfg)
    return PackedDAdamState(po, mo, vo, count, state.spec, state.spec_m)


def step(state: "DAdamState | PackedDAdamState", grads: PyTree,
         topo: Topology, cfg: DAdamConfig
         ) -> "DAdamState | PackedDAdamState":
    """One iteration of Alg. 1. Packed states never leave the
    ``(K, rows, 128)`` layout; ``grads`` may be a congruent tree or an
    already packed buffer."""
    if isinstance(state, PackedDAdamState):
        return _step_packed(state, grads, topo, cfg)
    half, mom = local_update(state.params, grads, state.moments, cfg)
    if _comm_due(mom.count, cfg):
        half = gossip(half, topo, cfg)
    return DAdamState(half, mom)


def round_step(state: "DAdamState | PackedDAdamState",
               grad_fn: Callable[[Any, Any], Any], batches: Any,
               topo: Topology, cfg: DAdamConfig
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
            state = PackedDAdamState(po, mo, vo, count, state.spec,
                                     state.spec_m)
        else:
            half, mom = local_update(state.params,
                                     grad_fn(state.params, batch),
                                     state.moments, cfg)
            state = DAdamState(half, mom)
    if isinstance(state, PackedDAdamState):
        return dataclasses.replace(state,
                                   buf=gossip_packed(state.buf, topo, cfg))
    return DAdamState(gossip(state.params, topo, cfg), state.moments)


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
