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

``reduce_axis`` is the 2D worker x model layout's form (JAX's
``reduce_axis=`` names the model mesh axis and ``psum``s the scale's
partial sums over it, ``sign_compress.py:187-188``): here it is the model
group's sum, a callable that takes the ``(K, L)`` f32 sums of this shard
and returns their sum over the M shards of the worker in a fixed order
(``functools.partial(launch.mesh.model_sum, wg=group)``), the same bits
on every rank. ``x`` is then one shard's block of each segment and
``n_true`` the segments' GLOBAL true counts, which may exceed the block's
slots. The CUDA code runs as two launches of the same kernel
(:func:`_stacked_reduce`): the first walks the A items and
writes q and the per-segment sums, the host sums them over the group and
divides by ``n_true``, and the second walks the B items with those
scales. Every rank of a worker then applies, and sends, the same scale.
The plain version takes the same split.

The CUDA code (``csrc/sign_compress.cu``) is one persistent launch that
walks a list of work items built here (:func:`schedule`): each segment is
cut into tiles of at most ``TILE`` elements, and each tile is an A item
(the first pass: write ``q``, sum ``|d|`` into the tile's partial) and a B
item (the second pass: ``hat += scale * q``, once the segment's scale is
known). The A item that completes a segment sums its partials in a fixed
order and divides by the true count, so the scale is the same from run to
run; it differs from the plain version's ``torch.sum`` by the order of the
sum only. ``sign(d)`` is ``(d > 0) - (d < 0)``: zero, including the
buffer's zero padding, maps to zero in ``q`` and in ``hat``.

``x`` and ``hat`` share one dtype, f32 or bf16 (the parameter buffer's,
as CD-Adam's hats take the parameters' dtype): ``d``, ``|d|`` and the
sums are f32 over the widened values, ``scale`` is f32, and ``hat_new``
is rounded once to that dtype at the store, as the TPU kernel's
``.astype``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_adam import check_param_cuda, f32
from repro_torch.kernels.pack import LANE

# elements per work item: four sweeps of the kernel's 256 threads x 4
# float4 loads; a leaf-aligned block of the resident layout (BLOCK_ROWS x
# LANE) is two tiles
TILE = 16384
# a segment's B items start this many grids' worth of items after its last
# A item: about the time the last A item takes to finish, and its scale to
# be summed, while the grid streams other tiles
LAG_GRIDS = 2

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Bounds = Tuple[Tuple[int, int], ...]


def _layout(x: torch.Tensor, hat: torch.Tensor, n_true, row_ranges,
            reduce_axis) -> Tuple[int, int, Bounds, Tuple[int, ...]]:
    """``(K, n, bounds, n_trues)``: per-worker element bounds of each
    segment and its true element count (the global one, which may exceed
    the segment's slots, with ``reduce_axis``)."""
    if reduce_axis is not None and not callable(reduce_axis):
        raise TypeError("reduce_axis is the model group's sum, a callable "
                        "(launch.mesh.model_sum with its group bound); got "
                        f"{type(reduce_axis).__name__}")
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
        if b > a and not 0 < t <= (b - a if reduce_axis is None
                                   else float("inf")):
            raise ValueError(f"n_true={t} out of range (0, {b - a}]")
    return K, n, bounds, n_trues


def _zeros(x, hat, K: int, L: Optional[int]) -> Tensors3:
    shape = (K,) if L is None else (K, L)
    return (torch.zeros(x.shape, dtype=torch.int8, device=x.device),
            torch.zeros(shape, dtype=torch.float32, device=x.device), hat)


def sign_compress_stacked_plain(x: torch.Tensor, hat: torch.Tensor, *,
                                n_true=None, row_ranges=None,
                                reduce_axis=None) -> Tensors3:
    """Plain PyTorch version of :func:`sign_compress_stacked`, op by op;
    with ``reduce_axis`` the sums go through it before the division, as
    the kernel's two launches do."""
    K, n, bounds, n_trues = _layout(x, hat, n_true, row_ranges, reduce_axis)
    L = None if row_ranges is None else len(bounds)
    if n == 0 or K == 0:
        return _zeros(x, hat, K, L)
    hf = hat.reshape(K, n).to(torch.float32)
    d = x.reshape(K, n).to(torch.float32) - hf
    absd = torch.abs(d)
    sums = torch.stack([absd[:, a:b].sum(dim=1) for a, b in bounds], dim=1)
    if reduce_axis is not None:
        sums = reduce_axis(sums)
    scale = sums / _divisors(n_trues, x.device)            # (K, L)
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


class Schedule(NamedTuple):
    """The tiles of one layout and the kernel's work list.

    Tile ``t`` covers elements ``[tile_start[t], tile_end[t])`` of every
    worker and lies in segment ``tile_seg[t]``; segment ``s`` holds tiles
    ``seg_first[s]:seg_first[s + 1]``, which is also the count its
    counter must reach before its scale is taken. ``items[i]`` is
    ``((k * T + t) << 1) | p``: pass ``p`` (0 = A, the first pass; 1 = B,
    the second) of tile ``t`` of worker ``k``."""
    tile_start: Tuple[int, ...]
    tile_end: Tuple[int, ...]
    tile_seg: Tuple[int, ...]
    seg_first: Tuple[int, ...]
    items: Tuple[int, ...]


def schedule(bounds: Bounds, K: int, lag: int) -> Schedule:
    """Cut each segment of ``bounds`` into tiles of at most ``TILE``
    elements and order the work items of K workers.

    Workers come in order, and each worker's segments in order, with their
    A items in ascending tile order. A segment's B items come together, in
    descending tile order (the tiles read last in the first pass are read
    first in the second), at least ``lag`` items after its last A item, or
    as soon as no A item is left to put between them. Every A item of a
    segment thus precedes every B item of it, which keeps the kernel free of
    deadlock: blocks take items in list order and an A item never waits."""
    start, end, seg, first = [], [], [], [0]
    for s, (a, b) in enumerate(bounds):
        for t0 in range(a, b, TILE):
            start.append(t0)
            end.append(min(t0 + TILE, b))
            seg.append(s)
        first.append(len(start))
    T = len(start)
    if K * T >= 1 << 30:
        raise ValueError(f"{K} workers x {T} tiles overflow the int32 work "
                         f"items")
    a_items = [(k, s, t) for k in range(K) for s in range(len(bounds))
               for t in range(first[s], first[s + 1])]
    items = []
    ready = collections.deque()    # (k, s, position its B items wait for)
    at = 0
    while at < len(a_items) or ready:
        if ready and (at == len(a_items) or len(items) >= ready[0][2]):
            k, s, _ = ready.popleft()
            items.extend(((k * T + t) << 1) | 1
                         for t in reversed(range(first[s], first[s + 1])))
            continue
        k, s, t = a_items[at]
        at += 1
        items.append((k * T + t) << 1)
        if t == first[s + 1] - 1:
            ready.append((k, s, len(items) + lag))
    return Schedule(tuple(start), tuple(end), tuple(seg), tuple(first),
                    tuple(items))


def split_items(sch: Schedule, K: int) -> Tuple[int, ...]:
    """The work list of the two-launch (``reduce_axis``) form: every A
    item, workers and segments in order, then every B item in the same
    order; the first launch walks the first half, the second the
    other."""
    T = len(sch.tile_start)
    a = tuple((k * T + t) << 1 for k in range(K) for t in range(T))
    return a + tuple(i | 1 for i in a)


def _divisors(n_trues: Tuple[int, ...], device) -> torch.Tensor:
    """The f32 true counts, 1 for an empty segment (whose sum is 0)."""
    return torch.tensor([f32(max(t, 1)) for t in n_trues],
                        dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=64)
def device_tables(bounds: Bounds, n_trues: Tuple[int, ...], K: int,
                  device: torch.device, grid: int,
                  split: bool = False) -> Tuple:
    """``(tile_start, tile_end, tile_seg, seg_first, n_true, items)`` on
    ``device`` for K workers and a grid of ``grid`` blocks (the B items lag
    ``LAG_GRIDS * grid`` items; with ``split`` the list is
    :func:`split_items`'), with ``T`` and ``n_items``: built once per
    layout, device and grid. ``n_true`` is f32, 1 for an empty segment
    (whose sum is 0)."""
    sch = schedule(bounds, K, LAG_GRIDS * grid)
    items = split_items(sch, K) if split else sch.items
    tabs = (torch.tensor(sch.tile_start, dtype=torch.int64, device=device),
            torch.tensor(sch.tile_end, dtype=torch.int64, device=device),
            torch.tensor(sch.tile_seg, dtype=torch.int32, device=device),
            torch.tensor(sch.seg_first, dtype=torch.int32, device=device),
            _divisors(n_trues, device),
            torch.tensor(items, dtype=torch.int32, device=device))
    return tabs, len(sch.tile_start), len(items)


# the C entries' parameters: sign_compress (its last but one the buffers'
# element width) and sign_compress_grid(device, the element width)
ENTRY_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                  + [ctypes.c_longlong] + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])
GRID_ARGTYPES = [ctypes.c_int] * 2


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("sign_compress")
    lib.sign_compress.argtypes = ENTRY_ARGTYPES
    lib.sign_compress.restype = ctypes.c_int
    lib.sign_compress_grid.argtypes = GRID_ARGTYPES
    lib.sign_compress_grid.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def grid_blocks(device: torch.device,
                dtype: torch.dtype = torch.float32) -> int:
    """The persistent grid on ``device`` for ``dtype`` buffers: resident
    blocks per SM (by the kernel's occupancy) times the SM count."""
    with torch.cuda.device(device):
        got = _lib().sign_compress_grid(device.index,
                                        torch.finfo(dtype).bits // 8)
    if got <= 0:
        raise RuntimeError(f"sign_compress_grid failed with cudaError_t "
                           f"{-got}")
    return got


def _launch(x: torch.Tensor, hat: torch.Tensor, K: int, n: int,
            bounds: Bounds, n_trues: Tuple[int, ...],
            reduce_axis=None) -> Tensors3:
    """Run the CUDA kernel on ``x``, ``hat`` viewed as ``(K, n)``; returns
    (q shaped like x, scales (K, L), hat_new shaped like hat). Without
    ``reduce_axis`` one launch; with it two (phases 1 and 2), the sums of
    the first summed over the model group and divided by ``n_trues`` on
    the device between them."""
    dt = check_param_cuda(x, hat)
    grid = grid_blocks(x.device, dt)
    split = reduce_axis is not None
    tabs, T, n_items = device_tables(bounds, n_trues, K, x.device, grid,
                                     split)
    L = len(bounds)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    hat_new = torch.empty_like(hat)
    # scales (K, L), partials (K, T), then 1 + K * L counters
    scratch = torch.empty(2 * K * L + K * T + 1, dtype=torch.float32,
                          device=x.device)
    at = scratch.data_ptr()
    # four-element accesses when every tile of every worker starts
    # aligned (16 bytes of f32, 8 of bf16; the pointers 16-byte aligned)
    vec = int((K == 1 or n % 4 == 0) and all(a % 4 == 0 for a, _ in bounds)
              and all(t.data_ptr() % 16 == 0 for t in (x, hat, q, hat_new)))
    ptrs = [t.data_ptr() for t in tabs]
    entry = _lib().sign_compress

    def run(scales: int, items: int, count: int, phase: int) -> None:
        status = _build.launch(
            entry, x.device, x.data_ptr(),
            hat.data_ptr(), q.data_ptr(), hat_new.data_ptr(), scales,
            at + 4 * K * L, at + 4 * (K * L + K * T), *ptrs[:5], items,
            count, K, T, L, n, vec, grid, phase, x.element_size())
        _build.check(status, "sign_compress")

    if not split:
        run(at, ptrs[5], n_items, 0)
        return q, scratch[:K * L].view(K, L), hat_new
    half = n_items // 2
    run(at, ptrs[5], half, 1)
    _stacked_reduce.launches += 1
    sums = reduce_axis(scratch[:K * L].view(K, L))
    scales = (sums.to(x.device) / tabs[4]).contiguous()
    run(scales.data_ptr(), ptrs[5] + 4 * half, half, 2)
    _stacked_reduce.launches += 1
    return q, scales, hat_new


def sign_compress_stacked(x: torch.Tensor, hat: torch.Tensor, *,
                          n_true=None, row_ranges=None,
                          reduce_axis=None) -> Tensors3:
    """Per-worker sign compression of a contiguous f32 or bf16 CUDA
    tensor ``(K, ...)`` (``hat`` of the same dtype).

    Returns ``(q int8 [x.shape], scale f32, hat_new [hat.shape])``. Without
    ``row_ranges``, ``scale`` is ``(K,)``: the sum over worker k's
    elements divided by ``n_true`` (default: all of them), the JAX
    signature. With ``row_ranges`` (one ``(row_start, row_end)`` per
    segment of a ``(K, rows, 128)`` buffer, covering its rows in order)
    and ``n_true`` one true count per segment, ``scale`` is ``(K, L)``.
    One call launches the kernel once, whatever the segment count; with
    ``reduce_axis`` (the model group's sum) it is
    :func:`_stacked_reduce`'s two launches."""
    if reduce_axis is not None:
        return _stacked_reduce(x, hat, n_true=n_true, row_ranges=row_ranges,
                               reduce_axis=reduce_axis)
    K, n, bounds, n_trues = _layout(x, hat, n_true, row_ranges, None)
    if n == 0 or K == 0:
        return _zeros(x, hat, K, None if row_ranges is None else len(bounds))
    q, scales, hat_new = _launch(x, hat, K, n, bounds, n_trues)
    sign_compress_stacked.launches += 1
    return q, scales[:, 0] if row_ranges is None else scales, hat_new


def _stacked_reduce(x: torch.Tensor, hat: torch.Tensor, *, n_true=None,
                    row_ranges=None, reduce_axis) -> Tensors3:
    """:func:`sign_compress_stacked` on one model shard's block under the
    2D layout: the sums of ``|x - hat|`` over each segment's slots of this
    block are summed over the model group by ``reduce_axis`` and divided
    by the segments' global true counts ``n_true``. Two launches of the
    kernel, each counted (under ``sign_compress_stacked_reduce`` in
    :func:`repro_torch.kernels.ops.launch_counts`)."""
    K, n, bounds, n_trues = _layout(x, hat, n_true, row_ranges, reduce_axis)
    if n == 0 or K == 0:
        return _zeros(x, hat, K, None if row_ranges is None else len(bounds))
    q, scales, hat_new = _launch(x, hat, K, n, bounds, n_trues, reduce_axis)
    return q, scales[:, 0] if row_ranges is None else scales, hat_new


def sign_compress(x: torch.Tensor, hat: torch.Tensor) -> Tensors3:
    """One scale over the whole contiguous f32 or bf16 CUDA tensor
    (``hat`` of the same dtype): returns
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
_stacked_reduce.launches = 0
sign_compress.launches = 0
