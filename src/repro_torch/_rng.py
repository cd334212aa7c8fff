"""Per-step random streams, seeded by ``(seed, t)``.

JAX folds a step into a key (``fold_in``); the port seeds one
``torch.Generator`` per step. The two words are mixed by numpy's
``SeedSequence`` into one 32-bit seed: the CPU generator keeps only the
low 32 bits of a seed, so ``(seed << 32) | t`` would drop ``seed``.
"""
from __future__ import annotations

import numpy as np
import torch


def step_seed(seed: int, t: int) -> int:
    """The 32-bit seed of step ``t`` of the stream ``seed``."""
    words = [int(seed) & 0xFFFFFFFF, int(t) & 0xFFFFFFFF]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint32)[0])


def step_generator(seed: int, t: int,
                   device: "str | torch.device" = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by ``(seed, t)``."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, t))
