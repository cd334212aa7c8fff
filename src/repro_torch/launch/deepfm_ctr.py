"""The paper's experiment on the port: DeepFM / Wide&Deep CTR training with
D-Adam vs CD-Adam vs D-Adam-vanilla vs D-PSGD, reporting train loss, test
AUC and communication MB (the quantities of Figs. 1-6). The counterpart of
``examples/deepfm_ctr.py``'s rows on a K=8 ring: D-Adam vanilla p=1, p=4
and p=16, CD-Adam p=16 with the sign compressor (gamma 0.4), and D-PSGD.

    PYTHONPATH=src python -m repro_torch.launch.deepfm_ctr [--steps 200]

Runs the packed backend on ``cuda`` unless ``--device cpu`` is given;
D-PSGD has no kernel backend and runs the reference one.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.core.api import make_optimizer, resolve_topology
from repro_torch.core.schedule import TopologySchedule
from repro_torch.data.synthetic import (CTRTeacher, ctr_batch_stacked,
                                        ctr_teacher, make_ctr_task)
from repro_torch.models.deepfm import (deepfm_logits, deepfm_loss,
                                       init_deepfm, init_widedeep,
                                       widedeep_logits, widedeep_loss)
from repro_torch.train.loop import DecentralizedTrainer, TrainLog
from repro_torch.train.metrics import auc

K = 8
MODELS = {
    "deepfm": (init_deepfm, deepfm_loss, deepfm_logits),
    "widedeep": (init_widedeep, widedeep_loss, widedeep_logits),
}


@dataclasses.dataclass
class RunResult:
    trainer: DecentralizedTrainer
    state: Any
    log: TrainLog
    auc: float
    teacher: CTRTeacher
    batches: Iterator[Any]     # the training stream, positioned after fit


def batch_stream(teacher: CTRTeacher, per_worker: int,
                 seed: int = 1) -> Iterator[Any]:
    gen = torch.Generator(device=teacher.embed.device).manual_seed(seed)
    while True:
        yield ctr_batch_stacked(teacher, gen, K, per_worker)


def heldout_auc(teacher: CTRTeacher, params: Any,
                logits_fn: Callable, per_worker: int = 512) -> float:
    """AUC of the consensus-mean ``params`` on a held-out batch of
    ``per_worker`` examples from each worker's distribution."""
    gen = torch.Generator(device=teacher.embed.device).manual_seed(99)
    test = ctr_batch_stacked(teacher, gen, K, per_worker)
    ids = test["feat_ids"].reshape(1, -1, teacher.n_fields)
    one = tree_map(lambda x: x[None], params)
    with torch.no_grad():
        scores = logits_fn(one, ids)[0]
    return auc(scores.cpu().numpy(), test["label"].reshape(-1).cpu().numpy())


def run(name: str = "d-adam p=4", model: str = "deepfm",
        kind: str = "d-adam", steps: int = 200, *, n_fields: int = 8,
        features_per_field: int = 32, embed_dim: int = 10,
        hidden: Tuple[int, ...] = (64, 64), per_worker: int = 32,
        backend: str = "packed", device: "str | torch.device" = "cuda",
        topology: Any = "ring", log_every: Optional[int] = None,
        hook: Optional[Callable[[int, Any], None]] = None,
        hook_every: int = 0, **opt_kw) -> RunResult:
    """Train one row of the comparison and print its loss, AUC and comm
    MB. The defaults are the example's sizes (8 fields x 32 features,
    hidden (64, 64)); the paper's widths are 39 fields x 25,000 features,
    embedding 10 and hidden (400, 400, 400). ``topology`` is a zoo name, a
    schedule spec (``"one-peer-exp"``) or a built one. ``log_every``
    defaults to logging the last step only; ``hook``/``hook_every`` go to
    ``fit``."""
    dev = resolve_device(device)
    task = make_ctr_task(seed=0, n_fields=n_fields,
                         features_per_field=features_per_field,
                         embed_dim=embed_dim)
    teacher = ctr_teacher(task, dev)
    init_fn, loss_fn, logits_fn = MODELS[model]
    opt = make_optimizer(kind, K=K, eta=1e-3, topology=topology,
                         backend=backend, device=dev, **opt_kw)
    trainer = DecentralizedTrainer(loss_fn, opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_fn(gen, task.n_features, task.n_fields, embed_dim, hidden)
    state = trainer.init(params)
    batches = batch_stream(teacher, per_worker)
    state, log = trainer.fit(state, batches, steps,
                             log_every=log_every or steps,
                             hook=hook, hook_every=hook_every)
    a = heldout_auc(teacher, trainer.averaged_params(state), logits_fn)
    print(f"{name:28s} loss={log.loss[-1]:.4f} AUC={a:.4f} "
          f"comm={log.comm_mb[-1]:8.1f} MB", flush=True)
    return RunResult(trainer, state, log, a, teacher, batches)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--model", default="deepfm", choices=sorted(MODELS))
    ap.add_argument("--backend", default="packed",
                    choices=["packed", "reference"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--topology", default="ring",
                    help="a zoo name or a schedule spec (one-peer-exp, "
                         "rand-ring:N)")
    args = ap.parse_args(argv)
    print(f"== {args.model} on synthetic Criteo-style CTR, {K} workers, "
          f"topology={args.topology}, backend={args.backend} on "
          f"{args.device} ==")
    kw = dict(backend=args.backend, device=args.device,
              topology=args.topology)
    run("d-adam-vanilla (p=1)", args.model, "d-adam", args.steps, period=1,
        **kw)
    for p in (4, 16):
        run(f"d-adam p={p}", args.model, "d-adam", args.steps, period=p,
            **kw)
    run("cd-adam p=16 + sign", args.model, "cd-adam", args.steps,
        period=16, gamma=0.4, compressor="sign", **kw)
    if not isinstance(resolve_topology(args.topology, K), TopologySchedule):
        # d-psgd is the static-graph baseline: no schedules
        run("d-psgd (non-adaptive)", args.model, "d-psgd", args.steps,
            **{**kw, "backend": "reference"})


if __name__ == "__main__":
    main()
