"""Streaming batches for online training and serving, the port of
``repro.data.stream``.

``ctr_stream`` is the endless non-IID CTR stream the online train->serve
loop draws from, deterministic in ``(seed, step)``: step ``t`` is
``ctr_batch_stacked`` under ``_rng.step_generator(seed, t)`` (JAX folds
``t`` into a key; the bits differ, the rule is the same).
``prefetch_to_device`` keeps ``size`` batches in flight: on CUDA each
host batch is pinned and copied with ``non_blocking``, so the copies
overlap the compute on the current batch; on the CPU it is plain
iteration.
"""
from __future__ import annotations

import collections
from typing import Any, Iterator

import torch

from repro_torch._device import resolve_device
from repro_torch._rng import step_generator
from repro_torch._tree import tree_map
from repro_torch.data.synthetic import CTRTeacher, ctr_batch_stacked

PyTree = Any


def ctr_stream(teacher: CTRTeacher, K: int, per_worker: int, *,
               seed: int = 1, skew: float = 0.5) -> Iterator[PyTree]:
    """Endless stacked non-IID CTR batches on the teacher's device; step
    ``t`` depends on ``(seed, t)`` alone, whatever the prefetch depth."""
    dev = teacher.embed.device
    t = 0
    while True:
        yield ctr_batch_stacked(teacher, step_generator(seed, t, dev), K,
                                per_worker, skew)
        t += 1


def prefetch_to_device(it: Iterator[PyTree], size: int = 2, *,
                       device: "str | torch.device" = "cuda"
                       ) -> Iterator[PyTree]:
    """Wrap a batch iterator with a transfer window of ``size`` batches
    (2: one in use, one in flight) to ``device``. JAX's ``sharding=`` /
    ``placer=`` belong to the worker mesh, not ported yet (ROADMAP queue
    1: multi-GPU comm)."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)

    def one(x: torch.Tensor) -> torch.Tensor:
        if dev.type == "cuda" and x.device.type == "cpu":
            return x.pin_memory().to(dev, non_blocking=True)
        return x.to(dev)

    def put(batch: PyTree) -> PyTree:
        return tree_map(one, batch)

    window: collections.deque = collections.deque()
    it = iter(it)
    for batch in it:
        window.append(put(batch))
        if len(window) == size:
            break
    while window:
        batch = window.popleft()
        nxt = next(it, None)
        if nxt is not None:
            window.append(put(nxt))
        yield batch
