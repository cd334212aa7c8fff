"""Decentralized training loop, the port of ``repro.train.loop``.

Couples a per-worker loss to a DecentralizedOptimizer: stacks K parameter
replicas, computes the per-worker gradients through the grad pipeline,
steps the optimizer and tracks loss, consensus and communication cost.
Runs eagerly; the only host syncs are at log points. Adaptive batch
damping (``train.damping``) rides along: its state is updated on the
device after every step.

Under ``comm='axis'`` (an optimizer built with a worker group) every rank
runs the same ``fit`` on the same global stacked batches and steps its own
worker on its slice of them; the log's loss and consensus are the K
workers' (one all-reduce per logged step), so every rank's ``TrainLog``
is the stacked run's. Under the 2D worker x model layout the M ranks of a
worker take the same slice of the batch and count once: the loss enters
the log once per worker, and the consensus sums run over the workers of
each model index and then over the model group. The damping state is
global, as in the JAX package: every rank keeps the ``(K,)`` state and
updates it from the K workers' all-gathered losses, and each rank masks
its own chunks with its worker's count.

An elastic resize under ``comm='axis'`` (``resize``) is a collective over
the world, which every rank makes with its old group: members of the new
group get their worker's state, the damping state resized as the stacked
trainer resizes it (a joiner's from global rank 0, so every member holds
the same bits), and the trainer rebinds to the new optimizer; a leaver's
trainer rebinds too and holds no state until it joins again.
``share_log`` then gives every member the first rank's ``TrainLog``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch._tree import (tree_flatten, tree_leaves, tree_map,
                               tree_unflatten)
from repro_torch.analysis.recompile import SignatureWatch
from repro_torch.core.api import DecentralizedOptimizer
from repro_torch.core.dadam import consensus_error, mean_params
from repro_torch.kernels import pack as packing
from repro_torch.launch.mesh import (WorkerGroup, all_gather_workers,
                                     all_reduce_sum, broadcast_first,
                                     model_sum)
from repro_torch.launch.shardings import take_worker
from repro_torch.train import damping as damping_mod
from repro_torch.train.damping import DampingConfig, DampingState
from repro_torch.train.grad import make_grad_pipeline

PyTree = Any


def stack_params(params: PyTree, K: int, *, same_init: bool = True,
                 init_fn: Optional[Callable[[int], PyTree]] = None
                 ) -> PyTree:
    """Replicate ``params`` across a leading worker dim, or, with
    ``same_init=False``, stack ``init_fn(k)`` for k in range(K) (the
    caller's init callable holds its own randomness)."""
    if same_init or init_fn is None:
        return tree_map(
            lambda x: x.unsqueeze(0).expand((K,) + tuple(x.shape)).clone(),
            params)
    per = [init_fn(k) for k in range(K)]
    return tree_map(lambda *xs: torch.stack(xs), *per)


def stacked_loss(loss: Callable[[PyTree, PyTree], torch.Tensor]
                 ) -> Callable[[PyTree, PyTree], torch.Tensor]:
    """Adapt a per-worker loss, ``loss(params, batch) -> scalar``
    (``build_model(cfg).loss``, the function the JAX trainer vmaps over
    the workers), to the trainer's ``(params_stacked, batch_stacked) ->
    (K,)``: the loss runs once per worker on that worker's slices of the
    stacked leaves. The slices are views (``unbind``), so no param is
    copied; in the backward each leaf's per-worker gradients are stacked
    once into one leaf-sized tensor (a per-worker ``x[k]`` would
    zero-fill a leaf-sized tensor per worker). Keywords (a sharding
    plan's ``shard=``) pass through to ``loss``."""

    def fn(params: PyTree, batch: PyTree, **kw) -> torch.Tensor:
        leaves, td = tree_flatten(params)
        bleaves, btd = tree_flatten(batch)
        per_p = [x.unbind(0) for x in leaves]
        per_b = [x.unbind(0) for x in bleaves]
        K = len(per_p[0])
        return torch.stack([
            loss(tree_unflatten(td, [x[k] for x in per_p]),
                 tree_unflatten(btd, [x[k] for x in per_b]), **kw)
            for k in range(K)])

    return fn


@dataclasses.dataclass
class TrainLog:
    """Training log. The list fields are one entry per log point; the
    ``*_total`` scalars are cumulative counters carried ACROSS ``fit``
    calls (pass the same log back in to continue it)."""

    step: List[int] = dataclasses.field(default_factory=list)
    loss: List[float] = dataclasses.field(default_factory=list)
    consensus: List[float] = dataclasses.field(default_factory=list)
    comm_mb: List[float] = dataclasses.field(default_factory=list)
    wall_s: List[float] = dataclasses.field(default_factory=list)
    # cumulative worker-chunk gradient evaluations
    grad_evals: List[int] = dataclasses.field(default_factory=list)
    steps_total: int = 0
    comm_rounds_total: int = 0
    comm_mb_total: float = 0.0
    wall_s_total: float = 0.0
    grad_evals_total: int = 0


class DecentralizedTrainer:
    """Stacked-K decentralized trainer.

    ``loss_fn(params_stacked, batch_stacked) -> (K,)`` per-worker losses;
    every batch leaf carries a leading K dim. Gradients come from the grad
    pipeline: stacked trees for reference states, packed buffers for
    packed states (``train.grad``). ``microbatch`` > 1 turns on gradient
    accumulation.

    ``damping``: adaptive batch damping, a ``train.damping.DampingConfig``
    or a spec string (``'adadamp:8'``, ``'geodamp:8:2:50'``; see
    ``make_damping``). The pipeline then evaluates ``max_chunks`` chunks a
    step and masks each worker's chunks past the policy's current count;
    the damping state (``damp_state``: loss EMA, level, eval counter)
    lives on the optimizer's device, is updated after every step without
    a host sync, and survives ``resize`` and lr-decay rebuilds. Exclusive
    with ``microbatch`` > 1. Once every worker sits at ``max_chunks``,
    ``lr_decay`` / ``lr_decay_every`` decay eta through ``opt.rebuild``,
    checked at log points. Under ``comm='axis'`` the damping state is
    the same ``(K,)`` state on every rank (see the module's docstring).

    ``sharded_loss``: the model-parallel loss of the 2D layout's
    ``'sharded-packed'`` grad pipeline, ``(chunks, batch, ctx) ->
    scalar`` (``train.grad``); without a 2D optimizer it is not used.
    ``recompile_limit``: the JAX trainer's recompile gate. Each
    rebind (construction, ``resize``, an lr-decay rebuild) makes a fresh
    ``analysis.recompile.SignatureWatch`` named ``"trainer.step"``
    (``recompile_watch``, ``None`` when the option is not given), and
    ``fit`` observes each step's ``(state, batch)``, or ``(state,
    damp_state, batch)`` when damped, and raises ``RecompileError`` past
    the limit: damping levels keep one signature, a batch-shape change
    does not. ``plan``: a ``launch.shardings.make_plan`` plan; on the 2D
    layout's packed mode it selects the grad pipeline's ``'planned'`` mode
    (each rank of a worker's model group multiplies with its plan shard of
    every matrix; the dense family, its loss taking ``shard=``), and
    elsewhere it changes nothing. ``resize`` keeps it, over the new
    group.
    """

    def __init__(self, loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
                 opt: DecentralizedOptimizer, *, microbatch: int = 1,
                 sharded_loss: Optional[Callable] = None, plan: Any = None,
                 recompile_limit: Optional[int] = None,
                 damping: "None | str | DampingConfig" = None):
        self.loss_fn = loss_fn
        self._microbatch = microbatch
        self._sharded_loss = sharded_loss
        self._plan = plan
        self._damping = damping_mod.make_damping(damping)
        if self._damping is not None and microbatch > 1:
            raise ValueError(
                "damping owns the accumulation loop (max_chunks IS the "
                "chunk count); pass damping= OR microbatch=, not both")
        self.damp_state: Optional[DampingState] = None
        self._lr_decays = 0
        self._recompile_limit = recompile_limit
        self.recompile_watch: Optional[SignatureWatch] = None
        self._build(opt)

    def _build(self, opt: DecentralizedOptimizer) -> None:
        """(Re)bind the trainer to an optimizer and its grad pipeline: at
        construction, on an elastic resize and on a damping lr decay. The
        damping state is made once and kept across rebinds; the recompile
        watch is made fresh at each, since each is one legitimate new
        program shape."""
        self.opt = opt
        dcfg = self._damping
        self.pipeline = make_grad_pipeline(
            self.loss_fn, opt, microbatch=self._microbatch,
            sharded_loss=self._sharded_loss, plan=self._plan,
            damping_chunks=dcfg.max_chunks if dcfg is not None else 0)
        self._mb_rounds: Optional[List[float]] = None
        if dcfg is not None and self.damp_state is None:
            self.damp_state = damping_mod.init_damping(dcfg, opt.K,
                                                       opt.device)
        if self._recompile_limit is not None:
            self.recompile_watch = SignatureWatch("trainer.step",
                                                  self._recompile_limit)

    def init(self, params: PyTree) -> Any:
        """Stack one worker's ``params`` K times and build the optimizer
        state on the optimizer's device. Under ``comm='axis'`` the K
        copies are one expanded view (a rank keeps one worker's, and
        under the 2D layout only its block), so no rank holds K copies."""
        if self.opt.group is not None:
            K = self.opt.K
            return self.opt.init(tree_map(
                lambda x: x.unsqueeze(0).expand((K,) + tuple(x.shape)),
                params))
        return self.opt.init(stack_params(params, self.opt.K))

    def resize(self, state: Any, new_opt: DecentralizedOptimizer, *,
               strategy: str = "clone",
               group: Optional[WorkerGroup] = None) -> Any:
        """Elastic membership change: carry ``state`` over to ``new_opt``
        (built for the new K / topology) and rebind the trainer, its grad
        pipeline and its comm accounting to it. Params and Adam moments
        survive per ``strategy`` ("clone" bootstraps joiners from live
        workers round-robin, "mean" from the consensus mean); hats and
        straggler buffers restart cold. Per-worker damping signals follow
        the workers round-robin; the eval counter and the ceiling clock
        carry through. The eager port has no compile to redo.

        Under ``comm='axis'`` every rank of the world calls it
        (``core.elastic.resize_state``): ``group`` is this rank's old
        group, the trainer's own by default (a joiner whose trainer was
        built on ``new_opt`` passes the group it had, and ``state=None``).
        Members of ``new_opt``'s group get their state and the same
        damping state, global rank 0's; other ranks get ``None``."""
        from repro_torch.core.elastic import resize_state

        new = new_opt.group
        old = group if group is not None else self.opt.group
        new_state = resize_state(state, new_opt, strategy=strategy,
                                 group=old)
        dcfg = self._damping
        if dcfg is not None:
            if old is None or old.member:
                damp = damping_mod.resize_damp(self.damp_state, dcfg,
                                               new_opt.K)
            else:
                damp = damping_mod.init_damping(dcfg, new_opt.K,
                                                new_opt.device)
            if new is not None and new.member:
                damp = DampingState(*(broadcast_first(x, new)
                                      for x in damp))
            self.damp_state = damp
        if self._plan is not None and new is not None:
            self._plan = self._plan.for_group(new)
        self._build(new_opt)
        return new_state

    def share_log(self, log: Optional[TrainLog]) -> TrainLog:
        """Under ``comm='axis'`` global rank 0's ``log`` on every member
        of the trainer's group (a collective over the group; a joiner
        passes ``None`` or whatever it holds), so that ``fit`` goes on
        with the same counters on every rank after a resize. Stacked: the
        log itself (a new one for ``None``)."""
        group = self.opt.group
        if group is None:
            return log or TrainLog()
        box = [log]
        dist.broadcast_object_list(box, src=0, group=group.group)
        return box[0] or TrainLog()

    def _params_like(self, state) -> PyTree:
        """The params' shapes and dtypes for the byte accounting: of a
        packed state, empty tensors made from its spec (no collective
        under the 2D layout); else the params."""
        spec = getattr(state, "spec", None)
        if spec is None:
            return self.opt.params_of(state)
        return tree_unflatten(spec.treedef, [
            torch.empty(shape, dtype=dt, device="meta")
            for shape, dt in zip(spec.shapes, spec.dtypes)])

    def comm_mb_per_round(self, state) -> float:
        return self.opt.comm_bytes_per_round(self._params_like(state)) / 1e6

    def _round_mb(self, state, round_index: int) -> float:
        if self._mb_rounds is None:
            self._mb_rounds = [
                b / 1e6 for b in self.opt.comm_bytes_round_list(
                    self._params_like(state))]
        return self._mb_rounds[round_index % len(self._mb_rounds)]

    def _place_batch(self, batch: PyTree) -> PyTree:
        """The batch on the optimizer's device; under ``comm='axis'`` the
        rank's ``(1, ...)`` slice of the global stacked batch."""
        group = self.opt.group
        if group is not None:
            batch = take_worker(batch, group.rank, group.K)
        return tree_map(lambda x: x.to(self.opt.device), batch)

    def _local_x(self, state, head: int = 0,
                 device: "torch.device | None" = None) -> torch.Tensor:
        """This rank's params, flat in f64 after ``head`` free slots, on
        ``device`` (the params' by default): its worker's, or under the 2D
        layout its block's leaf chunks without their padding. Each leaf is
        written into one buffer, so no other f64 copy is made."""
        spec = getattr(state, "spec", None)
        if getattr(self.opt.cfg, "model_parallel", 1) == 1 or spec is None:
            leaves = tree_leaves(self.opt.params_of(state))
        else:
            m = self.opt.group.model_rank
            chunks = tree_leaves(packing.unpack_local(state.buf, spec))
            leaves = [c[:, :max(0, min(c.shape[1], sz - m * c.shape[1]))]
                      for c, sz in zip(chunks, spec.sizes)]
        out = torch.empty(head + sum(t.numel() for t in leaves),
                          dtype=torch.float64,
                          device=device or leaves[0].device)
        at = head
        for t in leaves:
            out[at:at + t.numel()].copy_(t.reshape(-1))
            at += t.numel()
        return out

    def _log_values(self, loss: torch.Tensor, state) -> Tuple[float, float]:
        """The logged mean loss over the K workers and their consensus
        error. Under ``comm='axis'`` both come from one f64 all-reduce,
        over the workers of this rank's model index, of
        ``[loss_k, ||x_k||^2, x_k]``: the mean loss, and
        ``(sum_k ||x_k||^2 - ||sum_k x_k||^2 / K) / K``, which is
        ``consensus_error``'s ``(1/K) sum_k ||x_k - x_bar||^2`` (floored at
        0, where equal workers leave a rounding's worth below it). Under
        the 2D layout x is the block's part of each worker's params, and
        the M parts of the consensus are summed over the model group; the
        loss, the same on every rank of a worker, enters once. A
        host-staged group builds the f64 vector in host memory: the card
        holds no f64 copy of the params (at full width one would not fit
        beside the two states a ``fit`` call holds)."""
        group = self.opt.group
        if group is None:
            return float(loss), float(consensus_error(
                self.opt.params_of(state)))
        vec = self._local_x(state, head=2, device=torch.device("cpu")
                            if group.host_staged else None)
        x = vec[2:]
        vec[0] = loss.reshape(())
        vec[1] = torch.dot(x, x)
        total = all_reduce_sum(vec, group)
        K = group.K
        s2, sx = total[1], total[2:]
        part = (s2 - torch.dot(sx, sx) / K).reshape(1)
        if getattr(self.opt.cfg, "model_parallel", 1) > 1:
            part = model_sum(part, group)
        return float(total[0]) / K, max(float(part) / K, 0.0)

    def step(self, state, batch) -> Tuple[Any, torch.Tensor]:
        """One optimizer step; returns the new state and the mean loss
        over workers (a device scalar, not synced). With damping, the
        step takes the counts of ``damp_state`` and replaces it by the
        updated state."""
        dcfg = self._damping
        if dcfg is None:
            losses, grads = self.pipeline.value_and_grad(state, batch)
            return self.opt.step(state, grads), torch.mean(losses)
        n = damping_mod.chunks_of(self.damp_state, dcfg, self.opt.K)
        group = self.opt.group
        if group is not None:
            n = n[group.rank:group.rank + 1]
        losses, grads = self.pipeline.value_and_grad(state, batch, n)
        state = self.opt.step(state, grads)
        every = losses if group is None else all_gather_workers(losses,
                                                                group)
        self.damp_state = damping_mod.update(self.damp_state, every, dcfg)
        return state, torch.mean(losses)

    def _maybe_decay_lr(self) -> None:
        """Damping's hand-off back to the step size: once every worker
        sits at ``max_chunks``, decay eta by ``lr_decay`` per
        ``lr_decay_every`` steps spent at the ceiling. Checked at log
        points (the check reads ``at_max`` on the host); each decay
        rebinds to ``opt.rebuild(eta=...)``."""
        dcfg = self._damping
        if (dcfg is None or not dcfg.lr_decay_every
                or getattr(self.opt, "rebuild", None) is None):
            return
        due = int(self.damp_state.at_max) // dcfg.lr_decay_every
        if due > self._lr_decays:
            factor = dcfg.lr_decay ** (due - self._lr_decays)
            self._lr_decays = due
            self._build(self.opt.rebuild(
                eta=float(self.opt.cfg.eta) * factor))

    def fit(self, state, batch_iter: Iterator[PyTree], steps: int, *,
            log_every: int = 50, log: Optional[TrainLog] = None,
            hook: Optional[Callable[[int, Any], None]] = None,
            hook_every: int = 0) -> Tuple[Any, TrainLog]:
        """Run ``steps`` optimizer steps, logging every ``log_every``.

        Pass the previous call's ``log`` back in to continue its
        cumulative counters. ``hook(global_step, state)`` runs every
        ``hook_every`` steps on the host, between steps. Communication MB
        are counted on the host at every step whose cumulative number is a
        multiple of the period; only log points read device values. With
        damping the gradient evaluations come from ``damp_state.evals``."""
        log = log or TrainLog()
        comm_rounds = log.comm_rounds_total
        comm_mb = log.comm_mb_total
        step0 = log.steps_total
        damped = self._damping is not None
        # the counter at the start, kept on the device (no sync here)
        evals0 = self.damp_state.evals if damped else None
        evals_per_step = self.opt.K * self.pipeline.microbatch
        t0 = time.perf_counter()
        for t in range(steps):
            batch = self._place_batch(next(batch_iter))
            watch = self.recompile_watch
            if watch is not None:
                watch.observe(*((state, self.damp_state, batch) if damped
                                else (state, batch)))
                watch.check()
            state, loss = self.step(state, batch)
            # the optimizer communicates when its cumulative step count
            # is a multiple of the period, also across resumed fits
            if (step0 + t + 1) % self.opt.cfg.period == 0:
                comm_mb += self._round_mb(state, comm_rounds)
                comm_rounds += 1
            if hook is not None and hook_every > 0 \
                    and (t + 1) % hook_every == 0:
                hook(step0 + t + 1, state)
            if (t + 1) % log_every == 0 or t == steps - 1:
                if damped:
                    evals = log.grad_evals_total + int(
                        self.damp_state.evals - evals0)
                else:
                    evals = log.grad_evals_total + (t + 1) * evals_per_step
                loss_v, consensus_v = self._log_values(loss, state)
                log.step.append(step0 + t + 1)
                log.loss.append(loss_v)
                log.consensus.append(consensus_v)
                log.comm_mb.append(comm_mb)
                log.wall_s.append(log.wall_s_total
                                  + time.perf_counter() - t0)
                log.grad_evals.append(evals)
                self._maybe_decay_lr()
        log.steps_total = step0 + steps
        log.comm_rounds_total = comm_rounds
        log.comm_mb_total = comm_mb
        log.wall_s_total += time.perf_counter() - t0
        if steps:
            log.grad_evals_total = (log.grad_evals[-1] if damped else
                                    log.grad_evals_total
                                    + steps * evals_per_step)
        return state, log

    def averaged_params(self, state) -> PyTree:
        """The mean over the K workers (all-reduced over the workers of
        this rank's model index under ``comm='axis'``; under the 2D layout
        from the worker's params gathered over its model group, so each
        worker counts once)."""
        params = self.opt.params_of(state)
        group = self.opt.group
        if group is None:
            return mean_params(params)
        return tree_map(lambda x: (all_reduce_sum(
            x[0].to(torch.float32), group) / group.K).to(x.dtype), params)
