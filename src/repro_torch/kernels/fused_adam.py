"""The fused D-Adam local step: CUDA kernel wrapper and plain version.

Replaces the TPU kernel ``src/repro/kernels/fused_adam.py:fused_adam``
(``_adam_kernel``, ``pallas_call`` at line 66): Alg. 1 lines 4-6, no bias
correction, in one pass that reads p, g, m, v and writes p, m, v. p and g
share the parameter buffer's dtype, f32 or bf16 (a model's
``param_dtype``); m and v are f32 or bf16 (``make_optimizer(
moment_dtype=)``). The step is computed in f32 and each output rounded to
its dtype at the store, as the TPU kernel does.

On the H100 the kernel (``csrc/fused_adam.cu``) is bound by those bytes:
3 of the parameter dtype and 4 of the moment dtype an element, 28 at f32 /
f32, 14 at bf16 / bf16. It runs a persistent grid that deals
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
(:func:`plan`) from the pointers it passes, and calls the one C entry
with 14 arguments, the element widths among them.

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


# the parameter-buffer dtypes the kernels of the packed path take, and the
# moment dtypes; each C entry takes the element widths and picks its
# template instance
PARAM_DTYPES = (torch.float32, torch.bfloat16)
MOMENT_DTYPES = (torch.float32, torch.bfloat16)


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


# fused_adam(p, g, m, v, po, mo, vo, n, head, body, the constants'
# address, param_bytes, moment_bytes, the stream)
ENTRY_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 3
                  + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


# fused_adam_grid(device, param_bytes, moment_bytes)
GRID_ARGTYPES = [ctypes.c_int] * 3
# elements of each operand a stage of the kernel's ring holds (kTile)
TILE = 2048


@functools.lru_cache(maxsize=None)
def grid_blocks(device: torch.device, moment_dtype: torch.dtype,
                param_dtype: torch.dtype = torch.float32) -> int:
    """The most blocks a launch on ``device`` runs (resident blocks an
    SM at the kernel's shared memory, times the SM count); a shorter body
    takes one block a tile."""
    fn = _build.load("fused_adam").fused_adam_grid
    fn.argtypes = GRID_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        got = fn(device.index, torch.finfo(param_dtype).bits // 8,
                 torch.finfo(moment_dtype).bits // 8)
    if got <= 0:
        raise RuntimeError(f"fused_adam_grid failed with cudaError_t "
                           f"{-got}")
    return got


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("fused_adam").fused_adam
    fn.argtypes = ENTRY_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def plan(n: int, moment_size: int, p: int, g: int, m: int, v: int,
         po: int, mo: int, vo: int, param_size: int = 4) -> Tuple[int, int]:
    """(head, body) of a call over ``n`` elements whose seven operands
    start at the given addresses (p, g, po of ``param_size`` bytes; m, v,
    mo, vo of ``moment_size``): elements ``[head, head + body)`` move in
    16-byte vectors, the rest as scalars. ``body`` is a multiple of 16
    bytes of the narrowest operand (the quantum: 4 elements when both are
    f32, else 8), and when it is not 0 every address advanced by ``head``
    elements is 16-byte aligned; ``head`` is the least such offset, below
    one quantum. Where no offset aligns all seven (operands misaligned by
    different amounts) the whole call is scalar: ``(n, 0)``."""
    quantum = 16 // min(param_size, moment_size)
    if not (p | g | m | v | po | mo | vo) & 15:
        return 0, n - n % quantum
    for head in range(min(quantum, n)):
        if (all(not (a + param_size * head) & 15 for a in (p, g, po))
                and all(not (a + moment_size * head) & 15
                        for a in (m, v, mo, vo))):
            return head, (n - head) - (n - head) % quantum
    return n, 0


def check_param_cuda(*ts: torch.Tensor) -> torch.dtype:
    """The packed path's kernels take contiguous CUDA tensors of one
    shape on one device for their parameter-side operands (the buffer,
    the gradient, payloads, hats), all f32 or all bf16. Returns that
    dtype; raises naming the fault on anything else."""
    first = ts[0]
    for t in ts:
        if not t.is_cuda:
            raise ValueError("the CUDA kernel needs CUDA tensors; CPU "
                             "tensors take the plain version (kernels.ops)")
        if t.dtype not in PARAM_DTYPES:
            raise ValueError(f"the CUDA kernels take f32 or bf16 parameter "
                             f"buffers; got {t.dtype}")
        if t.dtype != first.dtype:
            raise ValueError(f"the parameter-side operands of one call "
                             f"share one dtype; got {first.dtype} and "
                             f"{t.dtype}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"operand {tuple(t.shape)} on {t.device} does "
                             f"not match {tuple(first.shape)} on "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels need contiguous operands")
    return first.dtype


def check_adam_cuda(p, g, m, v) -> None:
    """The Adam kernels take contiguous CUDA tensors of one shape on one
    device: p and g both f32 or both bf16, and m and v both f32 or both
    bf16. Raises on any other combination."""
    check_param_cuda(p, g)
    if m.dtype != v.dtype or m.dtype not in MOMENT_DTYPES:
        raise ValueError(f"the Adam kernels take f32 or bf16 moments of "
                         f"one dtype; got m {m.dtype}, v {v.dtype}")
    for t in (m, v):
        if not t.is_cuda or t.shape != p.shape or t.device != p.device:
            raise ValueError(f"moment {tuple(t.shape)} on {t.device} does "
                             f"not match {tuple(p.shape)} on {p.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels need contiguous operands")


def fused_adam(p, g, m, v, *, eta: float, beta1: float = 0.9,
               beta2: float = 0.999, tau: float = 1e-6,
               weight_decay: float = 0.0) -> Tensors3:
    """Launch the CUDA kernel on CUDA tensors of any one shape: p and g
    f32 or bf16, m and v f32 or bf16 (computed in f32, each output rounded
    to its dtype at the store); the outputs are new tensors. Raises on
    anything the kernel does not take (``check_adam_cuda``'s errors)."""
    # each operand's attributes read once (dtypes are singletons, and
    # get_device is the device's index without a device object);
    # check_adam_cuda names the fault
    index, shape, pdt, mdt = p.get_device(), p.shape, p.dtype, m.dtype
    if not (p.is_cuda and pdt in PARAM_DTYPES and g.dtype is pdt
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
    psize, msize = p.element_size(), m.element_size()
    head, body = plan(n, msize, *ptrs, psize)
    status = _build.launch_index(
        _entry(), index, *ptrs, n, head, body,
        _consts_arg(eta, beta1, beta2, tau, weight_decay)[1], psize, msize)
    if status:
        _build.check(status, "fused_adam")
    fused_adam.launches += 1
    return po, mo, vo


fused_adam.launches = 0
