"""The RWKV6 WKV recurrence: CUDA kernel wrapper and plain version.

Replaces the TPU kernel ``src/repro/kernels/rwkv_scan.py: rwkv_scan``
(``_wkv_kernel``, ``pallas_call`` at line 78). Per (batch row, head), with
the ``(D, D)`` state S (key x value) and every operand in f32::

    kv  = k_t (x) v_t
    y_t = r_t . (S + u (.)_rows kv)
    S   = w_t (.)_rows S + kv

r, k, v and w ``(B, S, H, D)``; u ``(H, D)``; state ``(B, H, D, D)``.
Returns ``(y (B, S, H, D) f32, final state (B, H, D, D) f32)``. Splitting a
sequence into two calls that carry the state gives the result of one.

:func:`rwkv_scan` launches ``csrc/rwkv_scan.cu`` (r, k, v in f32 or bf16,
w and the state f32, D in 32 / 64 / 128; it reads r, k, v and w through
their strides) and counts each launch in ``rwkv_scan.launches``;
:func:`rwkv_scan_plain` is the loop of ``repro.kernels.ref.rwkv_scan_ref``
in torch ops. ``kernels.ops`` picks between them by the operands' device.
The TPU kernel's ``chunk`` (the length of its sequential grid step) has no
counterpart: the CUDA kernel runs the whole sequence in one block per
(batch row, head). Neither version has a backward: the TPU kernel has none
either.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                 ) -> Tuple[int, int, int, int]:
    """``(B, S, H, D)``; raises ``ValueError`` on shapes that do not
    match."""
    if r.dim() != 4:
        raise ValueError(f"rwkv_scan takes r, k, v, w (B, S, H, D); got r "
                         f"{tuple(r.shape)}")
    B, S, H, D = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if tuple(t.shape) != (B, S, H, D):
            raise ValueError(f"{name} {tuple(t.shape)} does not match r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (H, D):
        raise ValueError(f"u {tuple(u.shape)} is not (H, D) = {(H, D)}")
    if tuple(state.shape) != (B, H, D, D):
        raise ValueError(f"state {tuple(state.shape)} is not (B, H, D, D) "
                         f"= {(B, H, D, D)}")
    return B, S, H, D


def rwkv_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the sequential loop in f32, as
    ``repro.kernels.ref.rwkv_scan_ref`` writes it."""
    B, S, H, D = check_shapes(r, k, v, w, u, state)
    r, k, v, w = (t.to(torch.float32) for t in (r, k, v, w))
    u = u.to(torch.float32)[None, :, :, None]
    st = state.to(torch.float32)
    if S == 0:
        return r.new_empty((B, 0, H, D)), st.clone()
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], st + u * kv))
        st = w[:, t, :, :, None] * st + kv
    return torch.stack(ys, dim=1), st


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("rwkv_scan").rwkv_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 13 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors: r, k, v of one dtype (f32
    or bf16), w and the state f32, u f32 or bf16 (cast to f32 here), with
    a unit-stride head dim of 32, 64 or 128. Returns a new contiguous y
    and a new final state. Raises on anything the kernel does not take."""
    B, S, H, D = check_shapes(r, k, v, w, u, state)
    for t in (r, k, v, w, u, state):
        if not t.is_cuda or t.device != r.device:
            raise ValueError("the CUDA kernel needs every operand on one "
                             "CUDA device; CPU tensors take the plain "
                             "version (kernels.ops)")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"rwkv_scan takes r, k, v as f32 or bf16 of one "
                         f"dtype; got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or state.dtype != torch.float32:
        raise ValueError(f"rwkv_scan takes w and the state in f32; got "
                         f"{w.dtype}, {state.dtype}")
    if u.dtype not in _DTYPES:
        raise ValueError(f"rwkv_scan takes u as f32 or bf16; got {u.dtype}")
    if any(t.stride(-1) != 1 for t in (r, k, v, w, u)):
        raise ValueError("rwkv_scan needs a unit-stride head dim")
    if D not in HEAD_DIMS:
        raise ValueError(f"rwkv_scan has kernels for head dims {HEAD_DIMS}; "
                         f"got {D}")
    u = u.to(torch.float32)
    state = state.contiguous()
    y = torch.empty((B, S, H, D), dtype=torch.float32, device=r.device)
    final = torch.empty_like(state)
    strides = [s for t in (r, k, v, w) for s in t.stride()[:3]]
    status = _build.launch(_entry(), r.device, r.data_ptr(), k.data_ptr(),
                           v.data_ptr(), w.data_ptr(), u.data_ptr(),
                           state.data_ptr(), y.data_ptr(), final.data_ptr(),
                           _DTYPES[r.dtype], B, S, H, D, *strides,
                           u.stride(0))
    _build.check(status, "rwkv_scan")
    rwkv_scan.launches += 1
    return y, final


rwkv_scan.launches = 0
