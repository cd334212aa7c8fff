"""Quickstart: decentralized Adam (the paper's Alg. 1) on the port, the port
of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart
    PYTHONPATH=src python -m repro_torch.launch.quickstart --steps 20 \
        --device cpu

Trains an 8-worker ring on the synthetic non-IID CTR task with DeepFM (8
fields x 32 features, embedding 10, hidden (64, 64)): D-Adam at eta 1e-3,
gossip every p=4 steps, 32 examples a worker a step; prints loss,
consensus and communication MB every 20 steps, then the averaged model's
weight count. Runs on ``cuda`` unless ``--device cpu`` is given, on the
JAX example's default ``reference`` backend (``--backend packed`` runs the
resident state and the CUDA kernels). The params come from a torch
generator seeded 0 and the batches from one seeded 1 on the device (the
JAX example's keys; the draws are torch's, not JAX's). ``--steps``
defaults to ``$QUICKSTART_STEPS`` or 100, as the example's. Returns the
``TrainLog`` and the averaged params.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Iterator, List, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves
from repro_torch.core.api import make_optimizer
from repro_torch.data.synthetic import (CTRTeacher, ctr_batch_stacked,
                                        ctr_teacher, make_ctr_task)
from repro_torch.models.deepfm import deepfm_loss, init_deepfm
from repro_torch.train.loop import DecentralizedTrainer, TrainLog

K = 8   # workers in a ring, as in the paper's experiments
PARAM_SEED, BATCH_SEED = 0, 1


def batches(teacher: CTRTeacher, per_worker: int = 32) -> Iterator[Any]:
    """Each worker draws from its own skewed distribution."""
    gen = torch.Generator(device=teacher.embed.device).manual_seed(
        BATCH_SEED)
    while True:
        yield ctr_batch_stacked(teacher, gen, K, per_worker)


def main(argv: Optional[List[str]] = None) -> Tuple[TrainLog, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int,
                    default=int(os.environ.get("QUICKSTART_STEPS", "100")))
    ap.add_argument("--backend", default="reference",
                    choices=("reference", "packed"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    task = make_ctr_task(seed=0, n_fields=8, features_per_field=32)
    teacher = ctr_teacher(task, dev)
    opt = make_optimizer("d-adam", K=K, eta=1e-3, period=4,
                         topology="ring", backend=args.backend, device=dev)
    trainer = DecentralizedTrainer(lambda p, b: deepfm_loss(p, b), opt)
    params = init_deepfm(torch.Generator(device=dev).manual_seed(
        PARAM_SEED), task.n_features, task.n_fields, hidden=(64, 64))
    state = trainer.init(params)

    state, log = trainer.fit(state, batches(teacher), steps=args.steps,
                             log_every=20)
    for s, l, c, mb in zip(log.step, log.loss, log.consensus, log.comm_mb):
        print(f"step {s:4d}  loss {l:.4f}  consensus {c:.2e}  "
              f"comm {mb:.1f} MB", flush=True)
    averaged = trainer.averaged_params(state)
    print("final averaged-model params ready:",
          sum(x.numel() for x in tree_leaves(averaged)), "weights",
          flush=True)
    return log, averaged


if __name__ == "__main__":
    main()
