"""The fused D-Adam local step: CUDA kernel wrapper and plain version.

Replaces the TPU kernel ``src/repro/kernels/fused_adam.py:fused_adam``
(``_adam_kernel``, ``pallas_call`` at line 66): Alg. 1 lines 4-6, no bias
correction, in one pass that reads p, g, m, v and writes p, m, v. p and g
are f32; m and v are f32 or bf16 (``make_optimizer(moment_dtype=)``), the
step computed in f32 and the moments rounded to their dtype at the store,
as the TPU kernel does.

On the H100 the kernel (``csrc/fused_adam.cu``) is bound by those bytes:
28 an element, 20 with bf16 moments. It runs a persistent grid that deals
whole tiles of the 16-byte-aligned body round robin through a ring of
shared-memory stages, filled by bulk copies (TMA) and emptied by bulk
stores; the unaligned head and the ragged tail run as scalars in the same
launch. Like the kernel it replaced, it moves those bytes at about 87% of
the card's data-sheet rate.

The host path matters beside a short kernel: on the hosts of NVIDIA H100
80GB HBM3 cards it takes 16-27 µs a call (``scripts/fused_adam_ab.py
--host``), against ~0.11 ms of device time on one rank's ``comm='axis'``
shard; the three output allocations are 5-11 µs of it and the ``ctypes``
call with its launch 4-8. So :func:`fused_adam` reads each operand's attributes
once, caches the constants as one ``ctypes`` struct per hyperparameter
set (:func:`adam_consts` is cached too), derives the head / body plan
(:func:`plan`) from the pointers it passes, and calls the C entry with 12
arguments.

:func:`fused_adam` counts each launch in ``fused_adam.launches``;
:func:`fused_adam_plain` repeats the kernel's arithmetic one torch op at a
time. ``kernels.ops.fused_adam`` picks between them by the tensors'
device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def f32(x: float) -> float:
    """``x`` rounded to f32, as JAX rounds a Python-float constant."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=64)
def adam_consts(eta, beta1, beta2, tau, weight_decay) -> Tuple[float, ...]:
    """(eta, b1, 1-b1, b2, 1-b2, tau, wd) as f32 values; 1-b1 and 1-b2 are
    taken in double on the host and then rounded. Cached: a pure function
    of its five floats, called on every launch."""
    return (f32(eta), f32(beta1), f32(1.0 - beta1), f32(beta2),
            f32(1.0 - beta2), f32(tau), f32(weight_decay))


def adam_half_step_plain(p, g, m, v, *, eta, beta1, beta2, tau,
                         weight_decay) -> Tensors3:
    """The half-step in f32, with the TPU kernel's op order. Returns f32
    (p, m, v); the callers round to the operands' dtypes."""
    e, b1, omb1, b2, omb2, t, wd = adam_consts(eta, beta1, beta2, tau,
                                               weight_decay)
    g = g.to(torch.float32)
    pf = p.to(torch.float32)
    if weight_decay:
        g = g + wd * pf
    m = b1 * m.to(torch.float32) + omb1 * g
    v = b2 * v.to(torch.float32) + omb2 * g * g
    if tau == 0.0:
        step = e * m * torch.rsqrt(v + f32(1e-30))
    else:
        step = e * m / (torch.sqrt(v) + t)
    return pf - step, m, v


def fused_adam_plain(p, g, m, v, *, eta: float, beta1: float = 0.9,
                     beta2: float = 0.999, tau: float = 1e-6,
                     weight_decay: float = 0.0) -> Tensors3:
    """Plain PyTorch version of the kernel, any shape and float dtype."""
    po, mo, vo = adam_half_step_plain(p, g, m, v, eta=eta, beta1=beta1,
                                      beta2=beta2, tau=tau,
                                      weight_decay=weight_decay)
    return po.to(p.dtype), mo.to(m.dtype), vo.to(v.dtype)


# the moment dtypes the kernels take, by the C entry's suffix
MOMENT_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16m"}
_F32 = torch.float32


class AdamConsts(ctypes.Structure):
    """``adam_math.cuh``'s ``struct AdamConsts``: seven f32 fields."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "eta", "beta1", "one_minus_beta1", "beta2", "one_minus_beta2", "tau",
        "weight_decay")]


@functools.lru_cache(maxsize=64)
def _consts_arg(eta, beta1, beta2, tau, weight_decay):
    """The constants as a struct in host memory and its address, which the
    C entry takes (it copies the struct into the launch)."""
    c = AdamConsts(*adam_consts(eta, beta1, beta2, tau, weight_decay))
    return c, ctypes.addressof(c)


# the C entries' parameters: p, g, m, v, po, mo, vo, n, head, body, the
# constants' address, the stream
ENTRY_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 3
                  + [ctypes.c_void_p] * 2)


# fused_adam_grid(device, moment_bytes)
GRID_ARGTYPES = [ctypes.c_int, ctypes.c_int]
# elements of each operand a stage of the kernel's ring holds (kTile)
TILE = 2048


@functools.lru_cache(maxsize=None)
def grid_blocks(device: torch.device, moment_dtype: torch.dtype) -> int:
    """The most blocks a launch on ``device`` runs (resident blocks an
    SM at the kernel's shared memory, times the SM count); a shorter body
    takes one block a tile."""
    fn = _build.load("fused_adam").fused_adam_grid
    fn.argtypes = GRID_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        got = fn(device.index, torch.finfo(moment_dtype).bits // 8)
    if got <= 0:
        raise RuntimeError(f"fused_adam_grid failed with cudaError_t "
                           f"{-got}")
    return got


@functools.lru_cache(maxsize=None)
def _entry(moment_dtype: torch.dtype):
    fn = getattr(_build.load("fused_adam"),
                 "fused_adam_f32" + MOMENT_DTYPES[moment_dtype])
    fn.argtypes = ENTRY_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def plan(n: int, moment_size: int, p: int, g: int, m: int, v: int,
         po: int, mo: int, vo: int) -> Tuple[int, int]:
    """(head, body) of a call over ``n`` elements whose seven operands
    start at the given addresses (p, g, po f32; m, v, mo, vo of
    ``moment_size`` bytes): elements ``[head, head + body)`` move in
    16-byte vectors, the rest as scalars. ``body`` is a multiple of 16
    bytes of the narrowest operand (the quantum: 4 elements with f32
    moments, 8 with bf16 ones), and when it is not 0 every address advanced
    by ``head`` elements is 16-byte aligned; ``head`` is the least such
    offset, below one quantum. Where no offset aligns all seven (operands
    misaligned by different amounts) the whole call is scalar: ``(n,
    0)``."""
    quantum = 16 // moment_size
    if not (p | g | m | v | po | mo | vo) & 15:
        return 0, n - n % quantum
    for head in range(min(quantum, n)):
        if (not (p + 4 * head) & 15 and not (g + 4 * head) & 15
                and not (po + 4 * head) & 15
                and all(not (a + moment_size * head) & 15
                        for a in (m, v, mo, vo))):
            return head, (n - head) - (n - head) % quantum
    return n, 0


def check_f32_cuda(*ts: torch.Tensor) -> None:
    """The kernels of this slice take contiguous f32 CUDA tensors of one
    shape on one device."""
    first = ts[0]
    for t in ts:
        if not t.is_cuda:
            raise ValueError("the CUDA kernel needs CUDA tensors; CPU "
                             "tensors take the plain version (kernels.ops)")
        if t.dtype != torch.float32:
            raise ValueError(f"the CUDA kernels take f32 operands in this "
                             f"slice; got {t.dtype}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"operand {tuple(t.shape)} on {t.device} does "
                             f"not match {tuple(first.shape)} on "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels need contiguous operands")


def check_adam_cuda(p, g, m, v) -> torch.dtype:
    """The Adam kernels take contiguous CUDA tensors of one shape on one
    device: f32 p and g, and m and v both f32 or both bf16. Returns the
    moment dtype; raises on any other combination."""
    check_f32_cuda(p, g)
    if m.dtype != v.dtype or m.dtype not in MOMENT_DTYPES:
        raise ValueError(f"the Adam kernels take f32 or bf16 moments of "
                         f"one dtype; got m {m.dtype}, v {v.dtype}")
    for t in (m, v):
        if not t.is_cuda or t.shape != p.shape or t.device != p.device:
            raise ValueError(f"moment {tuple(t.shape)} on {t.device} does "
                             f"not match {tuple(p.shape)} on {p.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels need contiguous operands")
    return m.dtype


def fused_adam(p, g, m, v, *, eta: float, beta1: float = 0.9,
               beta2: float = 0.999, tau: float = 1e-6,
               weight_decay: float = 0.0) -> Tensors3:
    """Launch the CUDA kernel on CUDA tensors of any one shape: f32 p and
    g, f32 or bf16 m and v (computed in f32, rounded to their dtype at the
    store); the outputs are new tensors. Raises on anything the kernel
    does not take (``check_adam_cuda``'s errors)."""
    # each operand's attributes read once (dtypes are singletons, and
    # get_device is the device's index without a device object);
    # check_adam_cuda names the fault
    index, shape, mdt = p.get_device(), p.shape, m.dtype
    if not (p.is_cuda and p.dtype is _F32 and g.dtype is _F32
            and v.dtype is mdt and mdt in MOMENT_DTYPES
            and g.get_device() == index and m.get_device() == index
            and v.get_device() == index and g.shape == shape
            and m.shape == shape and v.shape == shape
            and p.is_contiguous() and g.is_contiguous()
            and m.is_contiguous() and v.is_contiguous()):
        check_adam_cuda(p, g, m, v)
    po, mo, vo = (torch.empty_like(p), torch.empty_like(m),
                  torch.empty_like(v))
    n = p.numel()
    if not n:
        return po, mo, vo
    ptrs = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            po.data_ptr(), mo.data_ptr(), vo.data_ptr())
    head, body = plan(n, m.element_size(), *ptrs)
    status = _build.launch_index(
        _entry(mdt), index, *ptrs, n, head, body,
        _consts_arg(eta, beta1, beta2, tau, weight_decay)[1])
    if status:
        _build.check(status, "fused_adam")
    fused_adam.launches += 1
    return po, mo, vo


fused_adam.launches = 0
