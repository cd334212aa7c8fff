"""Reference (centralized) Adam, the port of ``repro.optim.adam``: the
oracle the K=1 identity tests pin D-Adam against, written without
``repro_torch.core`` so that a bug the two share cannot hide. The paper's
update: no bias correction, ``sqrt(v) + tau`` in the denominator.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch._tree import tree_map

PyTree = Any


class RefAdamState(NamedTuple):
    m: PyTree
    v: PyTree


def init(params: PyTree) -> RefAdamState:
    return RefAdamState(tree_map(torch.zeros_like, params),
                        tree_map(torch.zeros_like, params))


def step(params: PyTree, grads: PyTree, state: RefAdamState, *,
         eta: float, beta1: float = 0.9, beta2: float = 0.999,
         tau: float = 1e-6) -> Tuple[PyTree, RefAdamState]:
    new_m = tree_map(lambda m, g: beta1 * m + (1 - beta1) * g, state.m,
                     grads)
    new_v = tree_map(lambda v, g: beta2 * v + (1 - beta2) * g * g, state.v,
                     grads)
    new_p = tree_map(lambda x, m, v: x - eta * m / (torch.sqrt(v) + tau),
                     params, new_m, new_v)
    return new_p, RefAdamState(new_m, new_v)
