"""LR schedules, the port of ``repro.optim.schedules`` (the paper divides
eta by 10 at fixed epochs on CIFAR)."""
from __future__ import annotations

from typing import Callable, Sequence


def step_decay(base: float, boundaries: Sequence[int],
               factor: float = 0.1) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        lr = base
        for b in boundaries:
            if step >= b:
                lr *= factor
        return lr
    return schedule


def constant(base: float) -> Callable[[int], float]:
    return lambda step: base
