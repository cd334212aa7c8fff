"""Elastic worker membership: resize a live optimizer state to a new K,
the port of ``repro.core.elastic``.

Serverless workers join and leave mid-run. ``resize_state`` takes the
current optimizer state (either backend) and a freshly built optimizer for
the new world size / topology, and carries the surviving workers'
parameters and Adam moments across the membership change:

- **shrink** (workers leave): the trailing worker slots are dropped; their
  consensus mass is already mixed into the survivors by earlier rounds.
- **grow** (workers join), ``strategy="clone"``: new slots bootstrap from
  existing workers round-robin (``slot k -> slot k % K_old``).
- **grow**, ``strategy="mean"``: new slots start at the current consensus
  mean.

Everything topology-shaped is rebuilt for the NEW topology: CD-Adam hats
restart at zero and straggler-comm buffers restart COLD via
``checkpoint.io.place_like``, which also repacks into the new optimizer's
resident layout and device. The Adam step ``count`` is kept.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import dadam

PyTree = Any

STRATEGIES = ("clone", "mean")


def _resize_leaf(x: torch.Tensor, K_new: int, strategy: str) -> torch.Tensor:
    K_old = int(x.shape[0])
    if K_new == K_old:
        return x
    if K_new < K_old:
        return x[:K_new]
    if strategy == "clone":
        extra = x[torch.arange(K_old, K_new, device=x.device) % K_old]
    else:  # "mean"
        mean = torch.mean(x.to(torch.float32), dim=0, keepdim=True)
        extra = mean.expand((K_new - K_old,) + tuple(x.shape[1:])).to(x.dtype)
    return torch.cat([x, extra], dim=0)


def _resize_tree(tree: PyTree, K_new: int, strategy: str) -> PyTree:
    return tree_map(lambda x: _resize_leaf(x, K_new, strategy), tree)


def resize_state(state: Any, opt_new: Any, *,
                 strategy: str = "clone") -> Any:
    """Carry ``state`` (D-Adam / CD-Adam, either backend) over to
    ``opt_new``'s world size, topology, backend and device.

    ``opt_new`` is a ``DecentralizedOptimizer`` built for the NEW
    membership. Params and Adam moments are resized along the worker axis
    per ``strategy``; the step count survives; hats and straggler buffers
    restart."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, "
                         f"got {strategy!r}")
    K_new = int(opt_new.topo.K)
    portable = ckpt_io._to_portable(state)
    K_old = int(tree_leaves(portable.params)[0].shape[0])
    if K_old < 1 or K_new < 1:
        raise ValueError("world sizes must be >= 1")

    params = _resize_tree(portable.params, K_new, strategy)
    m = _resize_tree(portable.moments.m, K_new, strategy)
    v = _resize_tree(portable.moments.v, K_new, strategy)

    # a fresh init of the new optimizer supplies every topology-shaped
    # piece (zero hats over the new union edge set, packed layout, cold
    # comm buffers); the surviving params and moments are grafted into its
    # portable form and place_like adapts backend and device
    like = opt_new.init(params)
    moments = dadam.AdamMoments(m=m, v=v, count=portable.moments.count)
    portable_new = ckpt_io._to_portable(like)._replace(params=params,
                                                       moments=moments)
    return ckpt_io.place_like(portable_new, like)
