"""Adaptive batch damping, the port of ``repro.train.damping``: map the
running loss to a gradient-accumulation count.

The paper adapts the step size to the data; damping extends that to the
*batch size* in the AdaDamp / PadaDamp / GeoDamp style: the effective batch
grows as the loss falls, so early steps stay cheap (few gradient
evaluations) and late steps stay low-variance. The knob is the number of
accumulation **chunks** the grad pipeline consumes per step:

* ``adadamp``: chunks proportional to ``initial_loss / running_loss``,
  monotone non-decreasing (a loss spike never shrinks the batch);
* ``padadamp``: linear growth ``min_chunks + rate * t``;
* ``geodamp``: geometric growth ``min_chunks * factor ** (t // delay)``.

The damped pipeline (``train.grad``) evaluates all ``max_chunks`` chunks
every step and masks, per worker, the chunks past the current count: one
fixed launch sequence per step whatever the level, and the count never
has to reach the host. Chunks past the count add nothing to the sums and
cost no evaluation in ``DampingState.evals``; the loss and the gradient
divide by the live count.

``per_worker=True`` keeps one signal per worker (under non-IID skew each
worker's gradient variance differs, so its batch should too): the state
is then a ``(K,)`` vector. Once every worker sits at ``max_chunks``,
``lr_decay`` / ``lr_decay_every`` hand adaptivity back to the step size
(``DecentralizedTrainer`` decays eta once per ``lr_decay_every`` steps at
the ceiling).

The state is a NamedTuple of tensors on the optimizer's device, with the
JAX package's dtypes, and :func:`update` computes in f32 at the JAX
package's rounding points without a host sync.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device

_POLICIES = ("adadamp", "padadamp", "geodamp")


def _f32(x: float) -> float:
    """``x`` rounded to f32, as JAX rounds a Python-float operand of an f32
    array."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class DampingConfig:
    """Damping policy config (hashable).

    Attributes:
      policy: ``'adadamp'`` | ``'padadamp'`` | ``'geodamp'``.
      max_chunks: accumulation-chunk ceiling, the pipeline's chunk count;
        the per-worker batch dim must be divisible by it.
      min_chunks: floor (the starting batch), >= 1.
      ema: loss-EMA decay for the adadamp signal (0 = instantaneous).
      per_worker: one damping signal per worker (non-IID skew) instead of
        one global mean-loss signal.
      rate: padadamp chunks gained per step.
      factor, delay: geodamp multiplies the count by ``factor`` every
        ``delay`` steps.
      lr_decay, lr_decay_every: once ALL workers sit at ``max_chunks``,
        decay eta by ``lr_decay`` for every ``lr_decay_every`` steps
        spent at the ceiling (0 disables; needs ``opt.rebuild``).
    """

    policy: str = "adadamp"
    max_chunks: int = 4
    min_chunks: int = 1
    ema: float = 0.9
    per_worker: bool = False
    rate: float = 0.25
    factor: float = 2.0
    delay: int = 100
    lr_decay: float = 0.5
    lr_decay_every: int = 0

    def __post_init__(self) -> None:
        if self.policy not in _POLICIES:
            raise ValueError(f"unknown damping policy {self.policy!r} "
                             f"(use one of {list(_POLICIES)})")
        if not 1 <= self.min_chunks <= self.max_chunks:
            raise ValueError(
                f"need 1 <= min_chunks <= max_chunks, got "
                f"min_chunks={self.min_chunks} max_chunks={self.max_chunks}")
        if not 0.0 <= self.ema < 1.0:
            raise ValueError(f"ema must be in [0, 1), got {self.ema}")
        if self.policy == "padadamp" and self.rate <= 0:
            raise ValueError("padadamp needs rate > 0 (chunks per step)")
        if self.policy == "geodamp" and (self.factor <= 1.0
                                         or self.delay < 1):
            raise ValueError("geodamp needs factor > 1 and delay >= 1, "
                             f"got factor={self.factor} delay={self.delay}")
        if not 0.0 < self.lr_decay <= 1.0:
            raise ValueError(f"lr_decay must be in (0, 1], "
                             f"got {self.lr_decay}")
        if self.lr_decay_every < 0:
            raise ValueError("lr_decay_every must be >= 0 (0 disables)")


class DampingState(NamedTuple):
    """The damping state, tensors on one device. ``S`` = K when
    ``per_worker`` else 1."""

    ema_loss: torch.Tensor   # (S,) f32 running loss signal
    loss0: torch.Tensor      # (S,) f32 seed loss (first observed)
    t: torch.Tensor          # ()  i32 update count
    level: torch.Tensor      # (S,) f32 continuous chunk level
    at_max: torch.Tensor     # ()  i32 steps with every worker at the ceiling
    evals: torch.Tensor      # ()  i32 cumulative worker-chunk gradient evals


def init_damping(cfg: DampingConfig, K: int,
                 device: "str | torch.device" = "cuda") -> DampingState:
    """Fresh damping state for ``K`` workers at the ``min_chunks`` floor,
    on ``device`` (the optimizer's)."""
    dev = resolve_device(device)
    S = K if cfg.per_worker else 1

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return DampingState(
        ema_loss=zeros((S,), torch.float32),
        loss0=zeros((S,), torch.float32),
        t=zeros((), torch.int32),
        level=torch.full((S,), float(cfg.min_chunks), dtype=torch.float32,
                         device=dev),
        at_max=zeros((), torch.int32),
        evals=zeros((), torch.int32))


def chunks_of(state: DampingState, cfg: DampingConfig,
              K: int) -> torch.Tensor:
    """Per-worker accumulation-chunk counts for the NEXT step: ``(K,)``
    int32 in ``[min_chunks, max_chunks]`` (broadcast from the global
    signal when ``per_worker=False``), on the state's device."""
    n = torch.clamp(torch.ceil(state.level), float(cfg.min_chunks),
                    float(cfg.max_chunks)).to(torch.int32)
    return n.expand(K)


def update(state: DampingState, losses: torch.Tensor,
           cfg: DampingConfig) -> DampingState:
    """Fold one step's per-worker losses ``(K,)`` into the damping state.

    The first call seeds ``loss0`` and the EMA; the adadamp level is
    monotone non-decreasing. ``evals`` accrues the chunks the step just
    consumed (the counts of the state BEFORE this update) and ``at_max``
    the steps spent with every worker at the ceiling (the trainer's
    lr-decay trigger). Device ops only: no host sync."""
    K = losses.shape[0]
    losses = losses.to(torch.float32)
    sig = losses if cfg.per_worker else torch.mean(losses, 0, keepdim=True)
    first = state.t == 0
    ema = torch.where(first, sig, _f32(cfg.ema) * state.ema_loss
                      + _f32(1.0 - cfg.ema) * sig)
    loss0 = torch.where(first, sig, state.loss0)
    t1 = state.t + 1
    if cfg.policy == "adadamp":
        lvl = cfg.min_chunks * loss0 / torch.clamp_min(ema, _f32(1e-12))
        lvl = torch.maximum(state.level, lvl)
    elif cfg.policy == "padadamp":
        grown = cfg.min_chunks + _f32(cfg.rate) * t1.to(torch.float32)
        lvl = grown.expand(state.level.shape).clone()
    else:  # geodamp
        steps = torch.div(t1, cfg.delay, rounding_mode="floor")
        lvl = torch.full_like(state.level, float(cfg.min_chunks)) \
            * torch.pow(_f32(cfg.factor), steps.to(torch.float32))
    lvl = torch.clamp(lvl, float(cfg.min_chunks), float(cfg.max_chunks))
    n_used = chunks_of(state, cfg, K)  # chunks THIS step consumed
    return DampingState(
        ema_loss=ema, loss0=loss0, t=t1, level=lvl,
        at_max=state.at_max + torch.all(
            n_used >= cfg.max_chunks).to(torch.int32),
        evals=state.evals + torch.sum(n_used, dtype=torch.int32))


def resize_damp(state: DampingState, cfg: DampingConfig,
                new_K: int) -> DampingState:
    """Carry damping state across an elastic membership change: global
    signals pass through; per-worker signals map onto the new worker set
    round-robin (joiners inherit a live worker's signal, as
    ``elastic.resize_state``'s 'clone' strategy does)."""
    if not cfg.per_worker:
        return state
    S = state.level.shape[0]
    idx = torch.arange(new_K, device=state.level.device) % S
    return state._replace(ema_loss=state.ema_loss[idx],
                          loss0=state.loss0[idx], level=state.level[idx])


def make_damping(spec: Union[None, str, DampingConfig]
                 ) -> Optional[DampingConfig]:
    """Parse a damping spec: a built config passes through, ``None``
    disables, and a string is ``'policy:max_chunks[:extra...]'``:

    * ``'adadamp:MAX[:EMA]'``
    * ``'padadamp:MAX[:RATE]'``
    * ``'geodamp:MAX[:FACTOR[:DELAY]]'``
    """
    if spec is None or isinstance(spec, DampingConfig):
        return spec
    parts = spec.split(":")
    policy = parts[0].lower().replace("_", "-").replace("-", "")
    if policy not in _POLICIES:
        raise ValueError(f"unknown damping policy {parts[0]!r} "
                         f"(use one of {list(_POLICIES)})")
    kw: dict = {"policy": policy}
    if len(parts) > 1:
        kw["max_chunks"] = int(parts[1])
    extras = parts[2:]
    if extras:
        if policy == "adadamp":
            kw["ema"] = float(extras[0])
        elif policy == "padadamp":
            kw["rate"] = float(extras[0])
        else:
            kw["factor"] = float(extras[0])
            if len(extras) > 1:
                kw["delay"] = int(extras[1])
    return DampingConfig(**kw)
