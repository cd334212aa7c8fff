"""CHOCO error-feedback sign compression: CUDA kernel wrappers and plain
versions.

CD-Adam's communication round compresses the residual ``d = x - hat`` to
``q = int8 sign(d)`` with one f32 scale ``sum|d| / n_true`` per worker and
segment, and applies ``hat += scale * sign(d)`` locally.

``sign_compress_stacked`` replaces ``src/repro/kernels/sign_compress.py:
sign_compress_stacked`` (``_absmean_stacked_kernel``, ``pallas_call`` at
line 174, and ``_apply_stacked_kernel``, line 192). The JAX package calls
it once per leaf on the leaf's row slice of the resident buffer
(``cdadam.py:522-532``); the port's ``row_ranges`` option serves all leaves
in one call from a table of segments and writes ``(K, L)`` scales, so no
slice is copied. Without ``row_ranges`` it is the JAX function: one scale
per worker over the whole worker, divided by ``n_true``.

``sign_compress`` replaces ``sign_compress.py:sign_compress`` (``pallas_call``
at lines 65 and 78): one scale over a whole tensor, divided by its element
count. It is the K = 1, one-segment case of the same CUDA code.

The CUDA code (``csrc/sign_compress.cu``) splits every segment into tiles
of ``TILE`` elements. One kernel writes each tile's ``sum|d|`` without
atomics, a second sums each segment's tiles in order and divides by the
true count, and a third writes ``q`` and the new ``hat``. The scale is the
same from run to run; it differs from the plain version's ``torch.sum`` by
the order of the sum only. ``sign(d)`` is ``(d > 0) - (d < 0)``: zero,
including the buffer's zero padding, maps to zero in ``q`` and in ``hat``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_adam import check_f32_cuda, f32
from repro_torch.kernels.pack import BLOCK_ROWS, LANE

# elements per tile of the reduction: one leaf-aligned block of the
# resident layout
TILE = BLOCK_ROWS * LANE

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Bounds = Tuple[Tuple[int, int], ...]


def _layout(x: torch.Tensor, hat: torch.Tensor, n_true, row_ranges,
            reduce_axis) -> Tuple[int, int, Bounds, Tuple[int, ...]]:
    """``(K, n, bounds, n_trues)``: per-worker element bounds of each
    segment and its true element count."""
    if reduce_axis is not None:
        raise NotImplementedError(
            "reduce_axis (the 2D worker x model mesh psum of the scale "
            "partials) is not ported yet (ROADMAP queue 1, item 10: "
            "multi-GPU comm)")
    if x.dim() < 1:
        raise ValueError("stacked sign compress needs a leading worker dim")
    if hat.shape != x.shape:
        raise ValueError(f"hat shape {tuple(hat.shape)} != x "
                         f"{tuple(x.shape)}")
    K = x.shape[0]
    n = x.numel() // max(K, 1)
    if row_ranges is None:
        bounds: Bounds = ((0, n),)
        n_trues = (n if n_true is None else int(n_true),)
    else:
        if x.dim() != 3 or x.shape[-1] != LANE:
            raise ValueError(f"row_ranges needs a stacked (K, rows, {LANE}) "
                             f"buffer; got shape {tuple(x.shape)}")
        ranges = tuple((int(a), int(b)) for a, b in row_ranges)
        ends = (0,) + tuple(b for _, b in ranges)
        if (not ranges or any(a != e or b < a for (a, b), e
                              in zip(ranges, ends))
                or ends[-1] != x.shape[1]):
            raise ValueError(f"row_ranges {ranges} must cover rows "
                             f"[0, {x.shape[1]}) in order, without gaps")
        if n_true is None:
            n_true = [None] * len(ranges)
        if len(n_true) != len(ranges):
            raise ValueError("n_true needs one entry per row range")
        bounds = tuple((a * LANE, b * LANE) for a, b in ranges)
        n_trues = tuple(int(t) if t is not None else (b - a) * LANE
                        for t, (a, b) in zip(n_true, ranges))
    for (a, b), t in zip(bounds, n_trues):
        if b > a and not 0 < t <= b - a:
            raise ValueError(f"n_true={t} out of range (0, {b - a}]")
    return K, n, bounds, n_trues


def _zeros(x, hat, K: int, L: Optional[int]) -> Tensors3:
    shape = (K,) if L is None else (K, L)
    return (torch.zeros(x.shape, dtype=torch.int8, device=x.device),
            torch.zeros(shape, dtype=torch.float32, device=x.device), hat)


def sign_compress_stacked_plain(x: torch.Tensor, hat: torch.Tensor, *,
                                n_true=None, row_ranges=None,
                                reduce_axis=None) -> Tensors3:
    """Plain PyTorch version of :func:`sign_compress_stacked`, op by op."""
    K, n, bounds, n_trues = _layout(x, hat, n_true, row_ranges, reduce_axis)
    L = None if row_ranges is None else len(bounds)
    if n == 0 or K == 0:
        return _zeros(x, hat, K, L)
    hf = hat.reshape(K, n).to(torch.float32)
    d = x.reshape(K, n).to(torch.float32) - hf
    absd = torch.abs(d)
    sums = torch.stack([absd[:, a:b].sum(dim=1) for a, b in bounds], dim=1)
    div = torch.tensor([f32(max(t, 1)) for t in n_trues],
                       dtype=torch.float32, device=x.device)
    scale = sums / div                                     # (K, L)
    sgn = (d > 0).to(torch.float32) - (d < 0).to(torch.float32)
    lengths = torch.tensor([b - a for a, b in bounds], device=x.device)
    scale_el = torch.repeat_interleave(scale, lengths, dim=1, output_size=n)
    hat_new = (hf + scale_el * sgn).to(hat.dtype)
    return (sgn.to(torch.int8).reshape(x.shape),
            scale[:, 0] if L is None else scale,
            hat_new.reshape(hat.shape))


def sign_compress_plain(x: torch.Tensor, hat: torch.Tensor) -> Tensors3:
    """Plain PyTorch version of :func:`sign_compress`."""
    q, scale, hat_new = sign_compress_stacked_plain(x.reshape(1, -1),
                                                    hat.reshape(1, -1))
    return q.reshape(x.shape), scale[0], hat_new.reshape(hat.shape)


@functools.lru_cache(maxsize=64)
def tile_table(bounds: Bounds, n_trues: Tuple[int, ...],
               device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Device tables of the tiles: ``(start, end)`` int64 element bounds
    within a worker, the segment of each tile (int32), each segment's first
    tile (int32, L + 1 entries) and the segments' true counts (f32; 1 for
    an empty segment, whose sum is 0). Built once per layout and device."""
    start, end, seg, first = [], [], [], [0]
    for s, (a, b) in enumerate(bounds):
        for t0 in range(a, b, TILE):
            start.append(t0)
            end.append(min(t0 + TILE, b))
            seg.append(s)
        first.append(len(start))
    div = [f32(max(t, 1)) for t in n_trues]
    return (torch.tensor(start, dtype=torch.int64, device=device),
            torch.tensor(end, dtype=torch.int64, device=device),
            torch.tensor(seg, dtype=torch.int32, device=device),
            torch.tensor(first, dtype=torch.int32, device=device),
            torch.tensor(div, dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("sign_compress").sign_compress_f32
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, hat: torch.Tensor, K: int, n: int,
            bounds: Bounds, n_trues: Tuple[int, ...]) -> Tensors3:
    """Run the CUDA kernels on ``x``, ``hat`` viewed as ``(K, n)``; returns
    (q shaped like x, scales (K, L), hat_new shaped like hat)."""
    check_f32_cuda(x, hat)
    start, end, seg, first, div = tile_table(bounds, n_trues, x.device)
    T, L = start.numel(), len(bounds)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    hat_new = torch.empty_like(hat)
    scales = torch.empty((K, L), dtype=torch.float32, device=x.device)
    partials = torch.empty((K, max(T, 1)), dtype=torch.float32,
                           device=x.device)
    # 16-byte accesses when every tile of every worker starts aligned
    vec = int((K == 1 or n % 4 == 0) and all(a % 4 == 0 for a, _ in bounds)
              and all(t.data_ptr() % 16 == 0 for t in (x, hat, q, hat_new)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _entry()(x.data_ptr(), hat.data_ptr(), q.data_ptr(),
                          hat_new.data_ptr(), scales.data_ptr(),
                          partials.data_ptr(), start.data_ptr(),
                          end.data_ptr(), seg.data_ptr(), first.data_ptr(),
                          div.data_ptr(), K, T, L, n, vec, stream)
    _build.check(status, "sign_compress")
    return q, scales, hat_new


def sign_compress_stacked(x: torch.Tensor, hat: torch.Tensor, *,
                          n_true=None, row_ranges=None,
                          reduce_axis=None) -> Tensors3:
    """Per-worker sign compression of a contiguous f32 CUDA tensor
    ``(K, ...)``.

    Returns ``(q int8 [x.shape], scale f32, hat_new [hat.shape])``. Without
    ``row_ranges``, ``scale`` is ``(K,)``: the sum over worker k's
    elements divided by ``n_true`` (default: all of them), the JAX
    signature. With ``row_ranges`` (one ``(row_start, row_end)`` per
    segment of a ``(K, rows, 128)`` buffer, covering its rows in order)
    and ``n_true`` one true count per segment, ``scale`` is ``(K, L)``.
    One call launches the kernels once, whatever the segment count."""
    K, n, bounds, n_trues = _layout(x, hat, n_true, row_ranges, reduce_axis)
    if n == 0 or K == 0:
        return _zeros(x, hat, K, None if row_ranges is None else len(bounds))
    q, scales, hat_new = _launch(x, hat, K, n, bounds, n_trues)
    sign_compress_stacked.launches += 1
    return q, scales[:, 0] if row_ranges is None else scales, hat_new


def sign_compress(x: torch.Tensor, hat: torch.Tensor) -> Tensors3:
    """One scale over the whole contiguous f32 CUDA tensor: returns
    ``(q int8 [x.shape], scale f32 [], hat_new [hat.shape])``."""
    if hat.shape != x.shape:
        raise ValueError(f"hat shape {tuple(hat.shape)} != x "
                         f"{tuple(x.shape)}")
    n = x.numel()
    if n == 0:
        return (torch.zeros(x.shape, dtype=torch.int8, device=x.device),
                torch.zeros((), dtype=torch.float32, device=x.device), hat)
    q, scales, hat_new = _launch(x, hat, 1, n, ((0, n),), (n,))
    sign_compress.launches += 1
    return q, scales.reshape(()), hat_new


sign_compress_stacked.launches = 0
sign_compress.launches = 0
