"""Decentralized training loop, the port of ``repro.train.loop``.

Couples a per-worker loss to a DecentralizedOptimizer: stacks K parameter
replicas, computes the per-worker gradients through the grad pipeline,
steps the optimizer and tracks loss, consensus and communication cost.
Runs eagerly; the only host syncs are at log points. Adaptive batch
damping (``train.damping``) rides along: its state is updated on the
device after every step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch

from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.core.api import DecentralizedOptimizer
from repro_torch.core.dadam import consensus_error, mean_params
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
    zero-fill a leaf-sized tensor per worker)."""

    def fn(params: PyTree, batch: PyTree) -> torch.Tensor:
        leaves, td = tree_flatten(params)
        bleaves, btd = tree_flatten(batch)
        per_p = [x.unbind(0) for x in leaves]
        per_b = [x.unbind(0) for x in bleaves]
        K = len(per_p[0])
        return torch.stack([
            loss(tree_unflatten(td, [x[k] for x in per_p]),
                 tree_unflatten(btd, [x[k] for x in per_b]))
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
    checked at log points.

    ``sharded_loss``, ``plan`` and ``recompile_limit`` are not ported yet
    and raise ``NotImplementedError`` when given.
    """

    def __init__(self, loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
                 opt: DecentralizedOptimizer, *, microbatch: int = 1,
                 sharded_loss: Optional[Callable] = None, plan: Any = None,
                 recompile_limit: Optional[int] = None,
                 damping: "None | str | DampingConfig" = None):
        if recompile_limit is not None:
            raise NotImplementedError(
                "recompile_limit guards jit recompiles, which the eager port "
                "does not have yet (ROADMAP queue 1: tooling)")
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
        self._build(opt)

    def _build(self, opt: DecentralizedOptimizer) -> None:
        """(Re)bind the trainer to an optimizer and its grad pipeline: at
        construction, on an elastic resize and on a damping lr decay. The
        damping state is made once and kept across rebinds."""
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

    def init(self, params: PyTree) -> Any:
        """Stack one worker's ``params`` K times and build the optimizer
        state on the optimizer's device."""
        return self.opt.init(stack_params(params, self.opt.K))

    def resize(self, state: Any, new_opt: DecentralizedOptimizer, *,
               strategy: str = "clone") -> Any:
        """Elastic membership change: carry ``state`` over to ``new_opt``
        (built for the new K / topology) and rebind the trainer, its grad
        pipeline and its comm accounting to it. Params and Adam moments
        survive per ``strategy`` ("clone" bootstraps joiners from live
        workers round-robin, "mean" from the consensus mean); hats and
        straggler buffers restart cold. Per-worker damping signals follow
        the workers round-robin; the eval counter and the ceiling clock
        carry through. The eager port has no compile to redo."""
        from repro_torch.core.elastic import resize_state

        new_state = resize_state(state, new_opt, strategy=strategy)
        if self._damping is not None:
            self.damp_state = damping_mod.resize_damp(
                self.damp_state, self._damping, new_opt.K)
        self._build(new_opt)
        return new_state

    def comm_mb_per_round(self, state) -> float:
        return self.opt.comm_bytes_per_round(
            self.opt.params_of(state)) / 1e6

    def _round_mb(self, state, round_index: int) -> float:
        if self._mb_rounds is None:
            params = self.opt.params_of(state)
            self._mb_rounds = [
                b / 1e6 for b in self.opt.comm_bytes_round_list(params)]
        return self._mb_rounds[round_index % len(self._mb_rounds)]

    def _place_batch(self, batch: PyTree) -> PyTree:
        return tree_map(lambda x: x.to(self.opt.device), batch)

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
        losses, grads = self.pipeline.value_and_grad(state, batch, n)
        state = self.opt.step(state, grads)
        self.damp_state = damping_mod.update(self.damp_state, losses, dcfg)
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
            state, loss = self.step(state,
                                    self._place_batch(next(batch_iter)))
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
                log.step.append(step0 + t + 1)
                log.loss.append(float(loss))
                log.consensus.append(
                    float(consensus_error(self.opt.params_of(state))))
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
        return mean_params(self.opt.params_of(state))
