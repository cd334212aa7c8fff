"""GQA flash attention for prefill: CUDA kernel wrapper and plain version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:
flash_attention`` (``_flash_kernel``, ``pallas_call`` at line 114)::

    s   = (q . k) * scale        f32, scale = 1/sqrt(D) rounded to f32
    s   = ok ? s : -1e30         causal: k <= q; window w > 0: q - k < w
    out = softmax(s) @ v         f32 accumulation, cast to q's dtype

q ``(B, S, Hq, D)``, k and v ``(B, T, Hk, D)``; query head h reads kv
head ``h // (Hq // Hk)``; query and key positions both count from 0 (no
offset, so with S != T row i is causal against key i).

A row with no valid key at all (window > 0 and ``S >= T + window``) would
get an output that depends on how the TPU kernel tiles the keys; both
versions here raise ``ValueError`` for such shapes instead.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` and counts
each launch in ``flash_attention.launches``. Both dtypes take head dims
32 / 64 / 96 / 112 / 128 and run on the tensor cores: bf16 operands go to
the ``wgmma`` kernel, which loads them with TMA; f32 operands to the
3xTF32 kernel (each product split as hi·hi + hi·lo + lo·hi of TF32
halves, ``mma.sync``), which loads them with 16-byte ``cp.async``. Either
copy needs 16-byte-aligned bases and (batch, seq, head) strides: the
wrapper raises on anything else (no copy, no fallback). Both read the
operands through their strides.
:func:`flash_attention_plain` materialises the f32 scores, as
``repro.kernels.ref.flash_attention_ref`` does. ``kernels.ops`` picks
between them by the operands' device. Neither has a backward: the TPU
kernel has none either.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_adam import f32

NEG_INF = -1e30
# the kernels' instances per operand dtype
HEAD_DIMS = {torch.float32: (32, 64, 96, 112, 128),
             torch.bfloat16: (32, 64, 96, 112, 128)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bytes: the rule of both kernels' copies (a TMA tensor map's base and
# strides; a 16-byte cp.async's source address)
COPY_ALIGN = 16


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 window: int = 0) -> Tuple[int, int, int, int, int, int]:
    """``(B, S, Hq, D, T, Hk)``; raises ``ValueError`` on shapes the
    function is not defined for, rows without a valid key included."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B, S, Hq, D) and k, v "
                         f"(B, T, Hk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    _, T, Hk, _ = k.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if T < 1 or Hk < 1 or Hq % Hk:
        raise ValueError(f"need T >= 1 and Hq ({Hq}) a multiple of Hk "
                         f"({Hk})")
    if window and window > 0 and S >= T + window:
        raise ValueError(
            f"with window {window}, query rows from T + window - 1 = "
            f"{T + window - 1} on (S = {S}) have no valid key; their output "
            "would depend on the TPU kernel's tiling")
    return B, S, Hq, D, T, Hk


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Plain PyTorch version: f32 scores masked with -1e30, softmax, then
    the product with v; the result in q's dtype."""
    B, S, Hq, D, T, Hk = check_shapes(q, k, v, window=window)
    G = Hq // Hk
    qg = q.reshape(B, S, Hk, G, D).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qg,
                     k.to(torch.float32)) * f32(1.0 / math.sqrt(D))
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window and window > 0:
        ok = ok & (q_pos - k_pos < window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return out.reshape(B, S, Hq, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_aligned(t: torch.Tensor) -> None:
    """Raise ``ValueError`` unless an operand's base and (batch, seq, head)
    strides are multiples of 16 bytes, as the kernels' copies need."""
    how = "TMA" if t.dtype == torch.bfloat16 else "16-byte cp.async"
    if t.data_ptr() % COPY_ALIGN:
        raise ValueError(f"flash_attention ({t.dtype}) loads its operands "
                         f"with {how}, which needs a {COPY_ALIGN}-byte-"
                         f"aligned base; got a view at "
                         f"{t.data_ptr() % COPY_ALIGN} bytes past one")
    if any(st * t.element_size() % COPY_ALIGN for st in t.stride()[:3]):
        raise ValueError(f"flash_attention ({t.dtype}) loads its operands "
                         f"with {how}, which needs strides that are "
                         f"multiples of {COPY_ALIGN} bytes; got strides "
                         f"{tuple(t.stride())}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors of one dtype, f32 or bf16,
    with D in 32 / 64 / 96 / 112 / 128, a unit-stride head dim and
    16-byte-aligned bases and (batch, seq, head) strides. Returns a new
    contiguous ``(B, S, Hq, D)`` tensor. Raises on anything the kernel
    does not take."""
    B, S, Hq, D, T, Hk = check_shapes(q, k, v, window=window)
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("the CUDA kernel needs q, k and v on one CUDA "
                             "device; CPU tensors take the plain version "
                             "(kernels.ops)")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash_attention takes f32 or bf16 operands "
                             f"of one dtype; got {q.dtype}, {k.dtype}, "
                             f"{v.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("flash_attention needs a unit-stride head dim")
    if D not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash_attention has {q.dtype} kernels for head "
                         f"dims {HEAD_DIMS[q.dtype]}; got {D}")
    for t in (q, k, v):
        _check_aligned(t)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    status = _build.launch(_entry(), q.device, q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], B,
                           S, T, Hq, Hk, D, *strides, int(causal),
                           int(window or 0), f32(1.0 / math.sqrt(D)))
    _build.check(status, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
