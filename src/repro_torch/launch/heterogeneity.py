"""Theorem 1's sigma^2 term under system heterogeneity, on the port: the
counterpart of ``benchmarks/heterogeneity.py``, with the same scenarios
and one ``JSON {...}`` record line.

* ``skew``: consensus error (Lemma 1's quantity) and loss at non-IID skew
  0, 0.5 and 0.9;
* ``straggler``: staleness-bounded gossip with straggling edges, (tau,
  rate) = (2, 0.3) and (4, 0.5), seed 1;
* ``schedule``: the static ring against the one-peer-exponential
  schedule;
* ``churn``: elastic membership, K 8 -> 6 (``clone``) -> 8 (``mean``),
  training on through both resizes.

    PYTHONPATH=src python -m repro_torch.launch.heterogeneity [--steps 120]

DeepFM (8 fields x 32 features, hidden 64-64) on the synthetic CTR task,
K=8, D-Adam at eta 1e-3 and p=4, 32 examples per worker per step. Runs
the packed backend on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Iterator

import torch

from repro_torch._device import resolve_device
from repro_torch.core.api import make_optimizer
from repro_torch.data.synthetic import (ctr_batch_stacked, ctr_teacher,
                                        make_ctr_task)
from repro_torch.models.deepfm import deepfm_loss, init_deepfm
from repro_torch.train.loop import DecentralizedTrainer

K = 8
N_FIELDS, FEATURES_PER_FIELD, EMBED, HIDDEN, BATCH = 8, 32, 10, (64, 64), 32
OPT = dict(eta=1e-3, period=4)


def emit(name: str, derived) -> None:
    """The benchmarks' CSV row: name, us_per_call (0: not timed), value."""
    print(f"{name},0.0,{derived}", flush=True)


class Scenario:
    """One device, task and backend shared by every run of the record."""

    def __init__(self, device: "str | torch.device", backend: str):
        self.device = resolve_device(device)
        self.backend = backend
        task = make_ctr_task(seed=0, n_fields=N_FIELDS,
                             features_per_field=FEATURES_PER_FIELD,
                             embed_dim=EMBED)
        self.teacher = ctr_teacher(task, self.device)
        self.params = init_deepfm(
            torch.Generator(device=self.device).manual_seed(0),
            task.n_features, task.n_fields, EMBED, HIDDEN)

    def batches(self, k: int, skew: float, seed: int = 5) -> Iterator[Any]:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        while True:
            yield ctr_batch_stacked(self.teacher, gen, k, BATCH, skew=skew)

    def optimizer(self, k: int, **opt_kw):
        return make_optimizer("d-adam", K=k, backend=self.backend,
                              device=self.device, **OPT, **opt_kw)

    def run(self, steps: int, *, skew: float, **opt_kw):
        trainer = DecentralizedTrainer(deepfm_loss,
                                       self.optimizer(K, **opt_kw))
        _, log = trainer.fit(trainer.init(self.params),
                             self.batches(K, skew), steps, log_every=steps)
        return log.loss[-1], log.consensus[-1]

    def churn(self, steps: int, *, skew: float = 0.5) -> Dict[str, Any]:
        """K -> K-2 -> K with training in between."""
        third = max(steps // 3, 1)
        trainer = DecentralizedTrainer(deepfm_loss, self.optimizer(K))
        state, log = trainer.fit(trainer.init(self.params),
                                 self.batches(K, skew), third,
                                 log_every=third)
        loss_before = log.loss[-1]
        state = trainer.resize(state, self.optimizer(K - 2))
        state, log = trainer.fit(state, self.batches(K - 2, skew, seed=6),
                                 third, log_every=third)
        state = trainer.resize(state, self.optimizer(K), strategy="mean")
        rest = steps - 2 * third
        state, log = trainer.fit(state, self.batches(K, skew, seed=7), rest,
                                 log_every=max(rest, 1), log=log)
        return {"loss_before": loss_before, "loss_after": log.loss[-1],
                "consensus_after": log.consensus[-1],
                "workers_after": trainer.opt.K}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="packed",
                    choices=["packed", "reference"])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sc = Scenario(args.device, args.backend)
    steps = args.steps
    records = []

    for skew in (0.0, 0.5, 0.9):
        loss, cons = sc.run(steps, skew=skew)
        emit(f"heterogeneity/skew{skew:g}_loss", f"{loss:.4f}")
        emit(f"heterogeneity/skew{skew:g}_consensus", f"{cons:.3e}")
        records.append({"scenario": "skew", "skew": skew, "loss": loss,
                        "consensus": cons})

    for tau, rate in ((2, 0.3), (4, 0.5)):
        loss, cons = sc.run(steps, skew=0.5, staleness=tau,
                            straggler_rate=rate, straggler_seed=1)
        emit(f"heterogeneity/straggler_tau{tau}_rate{rate:g}_consensus",
             f"{cons:.3e}")
        records.append({"scenario": "straggler", "staleness": tau,
                        "straggler_rate": rate, "loss": loss,
                        "consensus": cons})

    for topo in ("ring", "one-peer-exponential"):
        loss, cons = sc.run(steps, skew=0.5, topology=topo)
        emit(f"heterogeneity/schedule_{topo}_consensus", f"{cons:.3e}")
        records.append({"scenario": "schedule", "topology": topo,
                        "loss": loss, "consensus": cons})

    churn = sc.churn(steps)
    emit("heterogeneity/churn_loss_after", f"{churn['loss_after']:.4f}")
    records.append({"scenario": "churn", **churn})

    record = {
        "benchmark": "heterogeneity",
        "torch_version": torch.__version__,
        "device": (torch.cuda.get_device_name(sc.device)
                   if sc.device.type == "cuda" else "cpu"),
        "backend": args.backend,
        "workers": K,
        "steps": steps,
        "records": records,
    }
    print("JSON " + json.dumps(record), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
