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

Under ``comm='axis'`` a membership change is ranks that leave and join a
process group: the old and the new worker groups are two prefixes of one
world (``launch.mesh.make_worker_group``), and every rank of the world
calls ``resize_state`` with its old group. The old group all-gathers its
workers' params and moments (over the model group first, under the 2D
layout), each old rank resizes that stacked form as the stacked path
does, and global rank 0 sends each joiner its new worker's slices; a
member of the new group keeps its worker's slice (its model block under
the 2D layout, repacked to the new group's ``row_shards``). So every
member holds, equal to the bit, its slice of the stacked resize of the
gathered state. The bytes are counted under the group's ``"resize"``
collectives.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch._tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import dadam
from repro_torch.launch.mesh import WorkerGroup, recv_world, send_world
from repro_torch.launch.shardings import gather_workers, take_worker

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


def resize_state(state: Any, opt_new: Any, *, strategy: str = "clone",
                 group: Optional[WorkerGroup] = None) -> Any:
    """Carry ``state`` (D-Adam / CD-Adam, either backend) over to
    ``opt_new``'s world size, topology, backend and device.

    ``opt_new`` is a ``DecentralizedOptimizer`` built for the NEW
    membership. Params and Adam moments are resized along the worker axis
    per ``strategy``; the step count survives; hats and straggler buffers
    restart.

    Under ``comm='axis'`` (``opt_new`` built on the new worker group,
    ``group`` this rank's old one, both over one world) it is a collective
    over the world, which every rank calls: a rank that holds a worker
    before and after passes its state and gets its new worker's; a leaver
    (a member of ``group`` only) passes its state and gets ``None``; a
    joiner (a member of the new group only) passes ``None`` and gets its
    state; a rank outside both gets ``None``. Raises ``ValueError`` when
    only one of the two groups is given, or when a rank's ``state`` does
    not match its membership of ``group``."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, "
                         f"got {strategy!r}")
    if (opt_new.group is None) != (group is None):
        raise ValueError(
            "under comm='axis' resize_state needs both the new optimizer's "
            "group and the old one (group=); stacked states take neither")
    if group is not None:
        return _resize_axis(state, opt_new, strategy, group)
    K_new = int(opt_new.topo.K)
    portable = ckpt_io._to_portable(state)
    K_old = int(tree_leaves(portable.params)[0].shape[0])
    if K_old < 1 or K_new < 1:
        raise ValueError("world sizes must be >= 1")

    params = _resize_tree(portable.params, K_new, strategy)
    m = _resize_tree(portable.moments.m, K_new, strategy)
    v = _resize_tree(portable.moments.v, K_new, strategy)
    return _graft(opt_new, params, m, v, portable.moments.count)


def _graft(opt_new: Any, params: PyTree, m: PyTree, v: PyTree,
           count: int, group: Optional[WorkerGroup] = None) -> Any:
    """``opt_new``'s state for the stacked (K_new, ...) ``params`` and
    moments: a fresh init of the new optimizer supplies every
    topology-shaped piece (zero hats over the new union edge set, packed
    layout, cold comm buffers); the params and moments (this rank's worker
    slice of them under ``comm='axis'``) are grafted into its portable form
    and ``place_like`` adapts backend, layout and device."""
    like = opt_new.init(params)
    if group is not None:
        params, m, v = (take_worker(t, group.rank, group.K)
                        for t in (params, m, v))
    moments = dadam.AdamMoments(m=m, v=v, count=count)
    portable_new = ckpt_io._to_portable(like, group)._replace(
        params=params, moments=moments)
    return ckpt_io.place_like(portable_new, like, group)


def _resize_axis(state: Any, opt_new: Any, strategy: str,
                 old: WorkerGroup) -> Any:
    new = opt_new.group
    if old.member != (state is not None):
        raise ValueError(
            f"global rank {old.global_rank}: a member of the old group "
            "passes its state, any other rank None")
    K_new = int(opt_new.topo.K)
    n_old, n_new = old.K * old.M, new.K * new.M
    resized = None
    if old.member:
        portable = ckpt_io._to_portable(state, old)
        # the K_old workers' params and moments on every old rank (each
        # model index gathers over its worker group); hats and comm
        # buffers restart, so they do not travel
        carried = (portable.params, portable.moments.m, portable.moments.v)
        full = gather_workers(carried, old, kind="resize")
        resized = tuple(_resize_tree(t, K_new, strategy) for t in full)
        count = portable.moments.count
    if n_new > n_old:
        # the joiners learn the layout, then take their worker's slices
        # from global rank 0, which every group's first worker holds
        meta = None
        if old.global_rank == 0:
            leaves, treedef = tree_flatten(take_worker(resized, 0, K_new))
            meta = (treedef, [(tuple(x.shape), x.dtype) for x in leaves],
                    count)
        box = [meta]
        dist.broadcast_object_list(box, src=0)
        treedef, layout, count = box[0]
        if old.global_rank == 0:
            for dst in range(n_old, n_new):
                for x in tree_leaves(take_worker(resized, dst // new.M,
                                                 K_new)):
                    send_world(x, dst, old)
        elif not old.member and new.member:
            mine = [recv_world(torch.empty(shape, dtype=dt,
                                           device=new.device), 0, old)
                    for shape, dt in layout]
            # a stacked stand-in: opt_new.init keeps worker new.rank's row
            resized = tree_map(
                lambda x: x.expand((K_new,) + tuple(x.shape[1:])),
                tree_unflatten(treedef, mine))
    if not new.member:
        return None
    return _graft(opt_new, *resized, count, new)
