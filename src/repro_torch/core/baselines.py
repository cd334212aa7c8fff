"""The paper's baselines, the port of ``repro.core.baselines``.

* D-PSGD [15]: decentralized SGD with gossip averaging, the non-adaptive
  predecessor: ``x_{t+1/2} = x_t - eta * (momentum * v + g_t)``, then the
  D-Adam mix every ``period`` steps.
* C-Adam: centralized Adam, one parameter copy stepped with the
  all-reduced mean gradient (K = 1 Adam).

D-Adam-vanilla is Alg. 1 with p = 1 and needs no code of its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.core import dadam
from repro_torch.core.dadam import DAdamConfig
from repro_torch.core.topology import Topology
from repro_torch.kernels.fused_adam import f32

PyTree = Any


@dataclasses.dataclass(frozen=True)
class DPSGDConfig:
    eta: float = 1e-2
    momentum: float = 0.0
    weight_decay: float = 0.0
    period: int = 1
    mixing: str = "roll"


class DPSGDState(NamedTuple):
    params: PyTree
    velocity: PyTree
    count: int  # host step counter


def dpsgd_init(params_stacked: PyTree, cfg: DPSGDConfig) -> DPSGDState:
    return DPSGDState(params_stacked,
                      tree_map(torch.zeros_like, params_stacked), 0)


def dpsgd_step(state: DPSGDState, grads: PyTree, topo: Topology,
               cfg: DPSGDConfig) -> DPSGDState:
    count = state.count + 1

    def upd(x, v, g):
        g = g.to(x.dtype)
        if cfg.weight_decay:
            g = g + f32(cfg.weight_decay) * x
        v_new = f32(cfg.momentum) * v + g
        return x - f32(cfg.eta) * v_new, v_new

    xs, td = tree_flatten(state.params)
    vs, _ = tree_flatten(state.velocity)
    gs, _ = tree_flatten(grads)
    out = [upd(x, v, g) for x, v, g in zip(xs, vs, gs)]
    half = tree_unflatten(td, [o[0] for o in out])
    vel = tree_unflatten(td, [o[1] for o in out])
    if cfg.period == 1 or count % cfg.period == 0:
        half = dadam.gossip(half, topo,
                            DAdamConfig(mixing=cfg.mixing, period=cfg.period))
    return DPSGDState(half, vel, count)


class CAdamState(NamedTuple):
    params: PyTree            # a single copy (no worker dim)
    moments: dadam.AdamMoments


def cadam_init(params: PyTree, cfg: DAdamConfig) -> CAdamState:
    return CAdamState(params, dadam.init_moments(params))


def cadam_step(state: CAdamState, mean_grads: PyTree,
               cfg: DAdamConfig) -> CAdamState:
    """Centralized Adam on the all-reduced mean gradient."""
    new_params, mom = dadam.local_update(state.params, mean_grads,
                                         state.moments, cfg)
    return CAdamState(new_params, mom)
