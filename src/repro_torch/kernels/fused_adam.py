"""The fused D-Adam local step: CUDA kernel wrapper and plain version.

Replaces the TPU kernel ``src/repro/kernels/fused_adam.py:fused_adam``
(``_adam_kernel``, ``pallas_call`` at line 66): Alg. 1 lines 4-6, no bias
correction, in one pass that reads p, g, m, v and writes p, m, v. p and g
are f32; m and v are f32 or bf16 (``make_optimizer(moment_dtype=)``), the
step computed in f32 and the moments rounded to their dtype at the store,
as the TPU kernel does. On the H100 it is bound by those bytes (28 per
element, 20 with bf16 moments); the kernel (``csrc/fused_adam.cu``)
streams them once, four elements a thread.

:func:`fused_adam` launches the kernel and counts each launch in
``fused_adam.launches``; :func:`fused_adam_plain` repeats the kernel's
arithmetic one torch op at a time. ``kernels.ops.fused_adam`` picks
between them by the tensors' device.
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


def adam_consts(eta, beta1, beta2, tau, weight_decay) -> Tuple[float, ...]:
    """(eta, b1, 1-b1, b2, 1-b2, tau, wd) as f32 values; 1-b1 and 1-b2 are
    taken in double on the host and then rounded."""
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


@functools.lru_cache(maxsize=None)
def _entry(moment_dtype: torch.dtype):
    fn = getattr(_build.load("fused_adam"),
                 "fused_adam_f32" + MOMENT_DTYPES[moment_dtype])
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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
    does not take."""
    mdt = check_adam_cuda(p, g, m, v)
    po, mo, vo = (torch.empty_like(p), torch.empty_like(m),
                  torch.empty_like(v))
    ts = (p, g, m, v, po, mo, vo)
    # four elements per load or store: 16 bytes of f32, 8 of bf16
    vec = int(all(t.data_ptr() % (4 * t.element_size()) == 0 for t in ts))
    status = _build.launch(_entry(mdt), p.device,
                           *(t.data_ptr() for t in ts), p.numel(), vec,
                           *adam_consts(eta, beta1, beta2, tau, weight_decay))
    _build.check(status, "fused_adam")
    fused_adam.launches += 1
    return po, mo, vo


fused_adam.launches = 0
