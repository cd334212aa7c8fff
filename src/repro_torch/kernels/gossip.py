"""Gossip over the resident packed state: CUDA kernel wrappers and plain
versions.

``gossip_mix`` replaces ``src/repro/kernels/gossip.py:gossip_mix``
(``_mix_kernel``, ``pallas_call`` at line 124)::

    out[k] = w_self * x[k] + sum_j w_j * x[src_j(k)]

accumulated in f32, the self term first, then the offsets in order.

``gossip_adam_mix`` replaces ``src/repro/kernels/gossip.py:gossip_adam_mix``
(``_gossip_adam_kernel``, ``pallas_call`` at line 258): the Adam half-step
of worker k and of each source worker, each rounded to p's dtype, mixed as
above; returns (mixed p, worker k's own m, v). p and g are f32 or bf16, m
and v f32 or bf16 (computed in f32, rounded to their dtype at the store).
It agrees with the two-pass ``fused_adam`` -> ``gossip_mix`` sequence
within f32 rounding; it is not held to be bit for bit equal.

``consensus_mix`` replaces ``src/repro/kernels/gossip.py:consensus_mix``
(``_consensus_kernel``, ``pallas_call`` at line 307), CD-Adam's line 8::

    out = x + gamma * sum_s w_s * (hat_nbr_s - hat_self)

with ``acc = 0`` and the offsets added in order, as the TPU kernel does.
The neighbour copies are already aligned to the destination worker, so
every operand is read at the same index.

``payload_mix`` replaces ``src/repro/kernels/gossip.py:payload_mix``
(``_mix_kernel`` with identity index maps, ``pallas_call`` at line 161),
the mix of D-Adam's staleness-bounded and overlapped rounds::

    out[k] = w_self * x[k] + sum_i w_i * payloads[i][k]

in ``gossip_mix``'s order, the self term first, then the payloads in
order. Each payload already holds, for every destination worker, the
neighbour value the round chose (fresh or buffered), so every operand is
read at the same index.

Every buffer of a call shares one dtype, f32 or bf16 (the parameter
buffer's: a model's ``param_dtype``); the sums run in f32 and round once to
that dtype at the store, as the TPU kernels' ``.astype`` does. All four
are bound by bytes on the H100; ``csrc/gossip.cu`` says what the design
reads against the least it must. ``src_j(k)`` comes from a
``(deg, K)`` int32 table built once per topology from
:func:`~repro_torch.core.topology.offset_perm`, so ring offsets and torus
``GridShift`` offsets take one path. ``kernels.ops`` picks the kernel for
CUDA tensors and the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.topology import GridShift, offset_perm
from repro_torch.kernels import _build
from repro_torch.kernels.fused_adam import (adam_consts, adam_half_step_plain,
                                            check_adam_cuda, check_param_cuda,
                                            f32)
from repro_torch.kernels.pack import LANE

# the shared-memory source table of gossip_mix holds this many offsets
# (denser graphs take the einsum in core.dadam.gossip_packed); one
# payload_mix launch takes this many payloads, and more chain launches
# through an f32 accumulator
MAX_FUSED_DEGREE = 32
# gossip_adam_mix reads 4 * (deg + 1) operand buffers per output; denser
# graphs take the two-pass sequence
MAX_GOSSIP_ADAM_DEGREE = 8
# consensus_mix takes its neighbour-copy pointers by value in a table of
# this many entries
MAX_CONSENSUS_DEGREE = 32

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check_buf(x: torch.Tensor) -> int:
    if x.dim() != 3 or x.shape[-1] != LANE:
        raise ValueError(f"expected a stacked (K, rows, {LANE}) packed "
                         f"buffer; got shape {tuple(x.shape)}")
    return x.shape[0]


def _offsets(offsets, offset_weights) -> Tuple[tuple, Tuple[float, ...]]:
    offs = tuple(s if isinstance(s, GridShift) else int(s) for s in offsets)
    weights = tuple(float(w) for w in offset_weights)
    if len(offs) != len(weights):
        raise ValueError("offsets and offset_weights must align")
    return offs, weights


@functools.lru_cache(maxsize=64)
def mix_table(offsets: tuple, offset_weights: Tuple[float, ...],
              self_weight: float, K: int, device: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(src, weights)`` on ``device``: ``src[j, k]`` is the worker whose
    value worker k reads under offset j (int32, ``(deg, K)``);
    ``weights`` is ``(self_weight, *offset_weights)`` in f32. Built once
    per topology and device."""
    src = np.stack([offset_perm(s, K) for s in offsets]) if offsets \
        else np.zeros((0, K))
    w = np.asarray((self_weight,) + tuple(offset_weights), np.float32)
    return (torch.as_tensor(src.astype(np.int32), device=device),
            torch.as_tensor(w, device=device))


def gossip_mix_plain(x: torch.Tensor, offsets: Sequence,
                     offset_weights: Sequence[float],
                     self_weight: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`gossip_mix`, op by op."""
    K = _check_buf(x)
    offs, weights = _offsets(offsets, offset_weights)
    if not offs:
        return x
    src, _ = mix_table(offs, weights, float(self_weight), K, x.device)
    acc = f32(self_weight) * x.to(torch.float32)
    for j, w in enumerate(weights):
        acc = acc + f32(w) * x.index_select(0, src[j]).to(torch.float32)
    return acc.to(x.dtype)


def gossip_adam_mix_plain(p, g, m, v, offsets: Sequence,
                          offset_weights: Sequence[float],
                          self_weight: float, *, eta: float,
                          beta1: float = 0.9, beta2: float = 0.999,
                          tau: float = 1e-6,
                          weight_decay: float = 0.0) -> Tensors3:
    """Plain PyTorch version of :func:`gossip_adam_mix`, op by op: every
    worker's half-step, rounded to p's dtype, then the mix in f32."""
    K = _check_gossip_adam(p, g, m, v, offsets, offset_weights)
    offs, weights = _offsets(offsets, offset_weights)
    src, _ = mix_table(offs, weights, float(self_weight), K, p.device)
    po, mo, vo = adam_half_step_plain(p, g, m, v, eta=eta, beta1=beta1,
                                      beta2=beta2, tau=tau,
                                      weight_decay=weight_decay)
    half = po.to(p.dtype).to(torch.float32)
    acc = f32(self_weight) * half
    for j, w in enumerate(weights):
        acc = acc + f32(w) * half.index_select(0, src[j])
    return acc.to(p.dtype), mo.to(m.dtype), vo.to(v.dtype)


def _check_consensus(x, hat_self, hat_nbrs, offset_weights
                     ) -> Tuple[tuple, Tuple[float, ...]]:
    _check_buf(x)
    hat_nbrs = tuple(hat_nbrs)
    weights = tuple(float(w) for w in offset_weights)
    if len(hat_nbrs) != len(weights):
        raise ValueError("hat_nbrs and offset_weights must align")
    for h in (hat_self,) + hat_nbrs:
        if h.shape != x.shape:
            raise ValueError(f"hat buffer shape {tuple(h.shape)} != x "
                             f"{tuple(x.shape)}")
    return hat_nbrs, weights


def consensus_mix_plain(x: torch.Tensor, hat_self: torch.Tensor,
                        hat_nbrs: Sequence[torch.Tensor],
                        offset_weights: Sequence[float],
                        gamma: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`consensus_mix`, op by op."""
    hat_nbrs, weights = _check_consensus(x, hat_self, hat_nbrs,
                                         offset_weights)
    if not hat_nbrs:
        return x
    hs = hat_self.to(torch.float32)
    acc = torch.zeros_like(hs)
    for w, hn in zip(weights, hat_nbrs):
        acc = acc + f32(w) * (hn.to(torch.float32) - hs)
    return (x.to(torch.float32) + f32(gamma) * acc).to(x.dtype)


def _check_payloads(x, payloads, offset_weights
                    ) -> Tuple[tuple, Tuple[float, ...]]:
    _check_buf(x)
    payloads = tuple(payloads)
    weights = tuple(float(w) for w in offset_weights)
    if len(payloads) != len(weights):
        raise ValueError("payloads and offset_weights must align")
    for p in payloads:
        if p.shape != x.shape:
            raise ValueError(f"payload shape {tuple(p.shape)} != x "
                             f"{tuple(x.shape)}")
    return payloads, weights


def payload_mix_plain(x: torch.Tensor, payloads: Sequence[torch.Tensor],
                      offset_weights: Sequence[float],
                      self_weight: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`payload_mix`, op by op."""
    payloads, weights = _check_payloads(x, payloads, offset_weights)
    if not payloads:
        return x
    acc = f32(self_weight) * x.to(torch.float32)
    for w, p in zip(weights, payloads):
        acc = acc + f32(w) * p.to(torch.float32)
    return acc.to(x.dtype)


def _check_gossip_adam(p, g, m, v, offsets, offset_weights) -> int:
    K = _check_buf(p)
    for name, b in (("g", g), ("m", m), ("v", v)):
        if b.shape != p.shape:
            raise ValueError(f"{name} shape {tuple(b.shape)} != p "
                             f"{tuple(p.shape)}")
    deg = len(tuple(offsets))
    if deg == 0:
        raise ValueError("gossip_adam_mix needs at least one offset; "
                         "offset-free topologies have no mix to fuse "
                         "(use fused_adam)")
    if deg > MAX_GOSSIP_ADAM_DEGREE:
        raise ValueError(
            f"degree {deg} > MAX_GOSSIP_ADAM_DEGREE="
            f"{MAX_GOSSIP_ADAM_DEGREE}; the dispatcher should take the "
            "two-pass sequence for denser graphs")
    if len(tuple(offset_weights)) != deg:
        raise ValueError("offsets and offset_weights must align")
    return K


def _check_aligned(*ts: torch.Tensor) -> None:
    """gossip_adam_mix moves groups of four elements."""
    if any(t.data_ptr() % (4 * t.element_size()) for t in ts):
        raise ValueError("gossip_adam_mix loads four elements at a time "
                         "and needs buffers aligned to that: 16 bytes for "
                         "f32, 8 for bf16")


def _check_aligned16(*ts: torch.Tensor) -> None:
    """gossip_mix, payload_mix and consensus_mix move 16-byte vectors (4
    f32 or 8 bf16 elements)."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the gossip mixes load 16-byte vectors and need "
                         "16-byte aligned buffers")


# the C entries' parameters, by entry (pointers as c_void_p); each ends in
# the element widths (the buffer's, then gossip_adam_mix's moments') and
# the stream
ARGTYPES = {
    "gossip_mix": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "gossip_adam_mix": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
    + [ctypes.c_longlong] + [ctypes.c_float] * 7 + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
    "consensus_mix": [ctypes.c_void_p] * 5
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
       ctypes.c_void_p],
    "payload_mix": [ctypes.c_void_p] * 3 + [ctypes.c_int]
    + [ctypes.c_void_p] * 2
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
       ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(_build.load("gossip"), name)
    fn.argtypes = ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def gossip_mix(x: torch.Tensor, offsets: Sequence,
               offset_weights: Sequence[float],
               self_weight: float) -> torch.Tensor:
    """Launch the CUDA mix on a contiguous f32 or bf16 ``(K, rows, 128)``
    CUDA buffer; the output is a new tensor."""
    K = _check_buf(x)
    offs, weights = _offsets(offsets, offset_weights)
    if not offs:
        return x
    if len(offs) > MAX_FUSED_DEGREE:
        raise ValueError(f"degree {len(offs)} > MAX_FUSED_DEGREE="
                         f"{MAX_FUSED_DEGREE}; take the einsum")
    check_param_cuda(x)
    src, w = mix_table(offs, weights, float(self_weight), K, x.device)
    out = torch.empty_like(x)
    _check_aligned16(x, out)
    status = _build.launch(_entry("gossip_mix"), x.device,
                           x.data_ptr(), out.data_ptr(),
                           src.data_ptr(), w.data_ptr(), K, len(offs),
                           x[0].numel(), x.element_size())
    _build.check(status, "gossip_mix")
    gossip_mix.launches += 1
    return out


def gossip_adam_mix(p, g, m, v, offsets: Sequence,
                    offset_weights: Sequence[float], self_weight: float, *,
                    eta: float, beta1: float = 0.9, beta2: float = 0.999,
                    tau: float = 1e-6, weight_decay: float = 0.0
                    ) -> Tensors3:
    """Launch the fused Adam half-step + mix on contiguous
    ``(K, rows, 128)`` CUDA buffers: p and g f32 or bf16, m and v f32 or
    bf16 (computed in f32, each half-step rounded to p's dtype before the
    mix, each output rounded to its dtype at the store); the outputs are
    new tensors."""
    K = _check_gossip_adam(p, g, m, v, offsets, offset_weights)
    offs, weights = _offsets(offsets, offset_weights)
    check_adam_cuda(p, g, m, v)
    src, w = mix_table(offs, weights, float(self_weight), K, p.device)
    po, mo, vo = (torch.empty_like(p), torch.empty_like(m),
                  torch.empty_like(v))
    _check_aligned(p, g, m, v, po, mo, vo)
    status = _build.launch(_entry("gossip_adam_mix"), p.device,
                           p.data_ptr(), g.data_ptr(),
                           m.data_ptr(), v.data_ptr(), po.data_ptr(),
                           mo.data_ptr(), vo.data_ptr(), src.data_ptr(),
                           w.data_ptr(), K, len(offs), p[0].numel(),
                           *adam_consts(eta, beta1, beta2, tau, weight_decay),
                           p.element_size(), m.element_size())
    _build.check(status, "gossip_adam_mix")
    gossip_adam_mix.launches += 1
    return po, mo, vo


def consensus_mix(x: torch.Tensor, hat_self: torch.Tensor,
                  hat_nbrs: Sequence[torch.Tensor],
                  offset_weights: Sequence[float],
                  gamma: float) -> torch.Tensor:
    """Launch the CUDA consensus update on contiguous ``(K, rows, 128)``
    CUDA buffers, all f32 or all bf16; the output is a new tensor."""
    hat_nbrs, weights = _check_consensus(x, hat_self, hat_nbrs,
                                         offset_weights)
    if not hat_nbrs:
        return x
    if len(hat_nbrs) > MAX_CONSENSUS_DEGREE:
        raise ValueError(f"degree {len(hat_nbrs)} > MAX_CONSENSUS_DEGREE="
                         f"{MAX_CONSENSUS_DEGREE}")
    check_param_cuda(x, hat_self, *hat_nbrs)
    out = torch.empty_like(x)
    _check_aligned16(x, hat_self, out, *hat_nbrs)
    deg = len(hat_nbrs)
    # the neighbour pointers and weights go by value, in a host array the
    # C entry copies into the kernel's parameter block
    ptrs = (ctypes.c_void_p * deg)(*(h.data_ptr() for h in hat_nbrs))
    w = (ctypes.c_float * deg)(*(f32(v) for v in weights))
    status = _build.launch(_entry("consensus_mix"), x.device,
                           x.data_ptr(), hat_self.data_ptr(),
                           out.data_ptr(), ctypes.addressof(ptrs),
                           ctypes.addressof(w), deg, x.numel(), f32(gamma),
                           x.element_size())
    _build.check(status, "consensus_mix")
    consensus_mix.launches += 1
    return out


def payload_mix(x: torch.Tensor, payloads: Sequence[torch.Tensor],
                offset_weights: Sequence[float],
                self_weight: float) -> torch.Tensor:
    """Launch the CUDA payload mix on contiguous ``(K, rows, 128)``
    CUDA buffers, all f32 or all bf16; the output is a new tensor. One
    launch takes at most ``MAX_FUSED_DEGREE`` payloads; past that the
    launches chain, each going on from the previous one's f32 sum (an f32
    scratch buffer) with the next payloads, so the sum runs in the plain
    version's order, rounds to the buffer's dtype once, and stays equal to
    the plain version to the bit."""
    payloads, weights = _check_payloads(x, payloads, offset_weights)
    if not payloads:
        return x
    check_param_cuda(x, *payloads)
    _check_aligned16(x, *payloads)
    pay = _entry("payload_mix")
    acc = None
    for i in range(0, len(payloads), MAX_FUSED_DEGREE):
        chunk = payloads[i:i + MAX_FUSED_DEGREE]
        last = i + MAX_FUSED_DEGREE >= len(payloads)
        out = (torch.empty_like(x) if last else
               torch.empty(x.shape, dtype=torch.float32, device=x.device))
        _check_aligned16(out)
        # the payload pointers and weights go by value, in a host array
        # the C entry copies into the kernel's parameter block
        ptrs = (ctypes.c_void_p * len(chunk))(*(p.data_ptr() for p in chunk))
        w = (ctypes.c_float * len(chunk))(
            *(f32(v) for v in weights[i:i + MAX_FUSED_DEGREE]))
        status = _build.launch(pay, x.device, x.data_ptr(),
                               None if acc is None else acc.data_ptr(),
                               out.data_ptr(), int(not last),
                               ctypes.addressof(ptrs), ctypes.addressof(w),
                               len(chunk), x.numel(), f32(self_weight),
                               x.element_size())
        _build.check(status, "payload_mix")
        payload_mix.launches += 1
        acc = out
    return out


gossip_mix.launches = 0
gossip_adam_mix.launches = 0
consensus_mix.launches = 0
payload_mix.launches = 0
