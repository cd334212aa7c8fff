"""Continuous train->serve loop, the port of ``repro.train.online``:
stream in, versioned params out.

Interleaves :class:`~repro_torch.train.loop.DecentralizedTrainer` steps on
a (non-IID) stream with periodic lock-free publishes into a
``serve.publish.ParamStore``: the trainer owns the packed state, serving
readers decode against the store's latest complete snapshot, and a
publish is an unpack-once decode of the resident buffer plus a pointer
swap.

    store = ParamStore()
    result = train_online(trainer, state, stream, steps=500, store=store,
                          publish_every=50, mode="mean")
    version, params = store.snapshot()      # serving side, any time
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List, Optional, Tuple

from repro_torch.serve.publish import ParamStore, publish_params
from repro_torch.train.loop import DecentralizedTrainer, TrainLog

PyTree = Any


@dataclasses.dataclass
class OnlineResult:
    """What one online run produced: the final state, the (continued)
    train log, and the ``(global_step, version)`` publish history."""
    state: Any
    log: TrainLog
    published: List[Tuple[int, int]]

    @property
    def versions(self) -> List[int]:
        return [v for _, v in self.published]


def train_online(trainer: DecentralizedTrainer, state: Any,
                 stream: Iterator[PyTree], steps: int, *,
                 store: ParamStore, publish_every: int,
                 mode: str = "mean", worker: int = 0,
                 like: Optional[PyTree] = None,
                 final_publish: bool = True,
                 log_every: int = 50,
                 log: Optional[TrainLog] = None) -> OnlineResult:
    """Run ``steps`` trainer steps on ``stream``, publishing every
    ``publish_every`` steps (and once at the end unless the last step
    already published, or ``final_publish`` is off).

    The publish is :func:`~repro_torch.serve.publish.publish_params` on the
    live optimizer state (``mode="worker"``: worker ``worker``'s row
    block; ``"mean"``: the packed-domain consensus mean), pushed into
    ``store`` behind its version counter. Pass ``result.log`` back in as
    ``log=`` to continue the counters across calls."""
    if publish_every <= 0:
        raise ValueError(
            f"publish_every must be >= 1, got {publish_every}")
    published: List[Tuple[int, int]] = []

    def hook(global_step: int, live_state: Any) -> None:
        params = publish_params(live_state, mode=mode, worker=worker,
                                like=like)
        published.append((global_step, store.publish(params)))

    state, log = trainer.fit(state, stream, steps, log_every=log_every,
                             log=log, hook=hook, hook_every=publish_every)
    if final_publish and (not published
                          or published[-1][0] != log.steps_total):
        hook(log.steps_total, state)
    return OnlineResult(state=state, log=log, published=published)
