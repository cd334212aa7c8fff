"""Online train->serve, end to end: D-Adam on the streaming non-IID CTR task
with periodic lock-free publishes, scored live from the store; the port of
``examples/online_serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.online_serve [--steps 60]
    PYTHONPATH=src python -m repro_torch.launch.online_serve --device cpu

K=8 workers on a ring train DeepFM (8 fields x 32 features, hidden
(64, 64)) with packed D-Adam (eta 1e-3, p=4; the JAX example's
``pallas`` backend): the resident ``(K, rows, 128)`` state and the CUDA
kernels, ``fused_adam`` on local steps and ``gossip_adam_mix`` on
communication steps (their plain versions on ``--device cpu``). Every
``--publish-every`` steps the consensus mean is decoded straight from the
packed buffer and swapped into a ParamStore; the serving side scores a
held-out batch (512 examples a worker, from a generator seeded 99)
against the latest version. The stream is ``ctr_stream`` (seed 1, 32
examples a worker) behind ``prefetch_to_device``; the params come from a
generator seeded 0. Prints the example's two lines and returns the
``OnlineResult`` and the AUC.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.core.api import make_optimizer
from repro_torch.data.stream import ctr_stream, prefetch_to_device
from repro_torch.data.synthetic import (ctr_batch_stacked, ctr_teacher,
                                        make_ctr_task)
from repro_torch.models.deepfm import (deepfm_logits, deepfm_loss,
                                       init_deepfm)
from repro_torch.serve import ParamStore
from repro_torch.train.loop import DecentralizedTrainer
from repro_torch.train.metrics import auc
from repro_torch.train.online import OnlineResult, train_online

K = 8
PARAM_SEED, STREAM_SEED, TEST_SEED = 0, 1, 99


def main(argv: Optional[List[str]] = None) -> Tuple[OnlineResult, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--publish-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    task = make_ctr_task(seed=0, n_fields=8, features_per_field=32)
    teacher = ctr_teacher(task, dev)
    opt = make_optimizer("d-adam", K=K, eta=1e-3, period=4,
                         backend="packed", device=dev)
    trainer = DecentralizedTrainer(lambda p, b: deepfm_loss(p, b), opt)
    params = init_deepfm(torch.Generator(device=dev).manual_seed(
        PARAM_SEED), task.n_features, task.n_fields, hidden=(64, 64))
    state = trainer.init(params)

    test = ctr_batch_stacked(
        teacher, torch.Generator(device=dev).manual_seed(TEST_SEED), K, 512)
    flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), test)

    store = ParamStore()
    stream = prefetch_to_device(ctr_stream(teacher, K, 32,
                                           seed=STREAM_SEED), device=dev)
    result = train_online(trainer, state, stream, args.steps, store=store,
                          publish_every=args.publish_every, mode="mean",
                          log_every=args.steps)

    version, served = store.snapshot()
    one = tree_map(lambda x: x[None], served)
    with torch.no_grad():
        scores = deepfm_logits(one, flat["feat_ids"][None])[0]
    a = auc(scores.cpu().numpy(), flat["label"].cpu().numpy())
    print(f"published versions: {result.versions} "
          f"(at steps {[s for s, _ in result.published]})", flush=True)
    print(f"serving v{version}: loss={result.log.loss[-1]:.4f} AUC={a:.4f}",
          flush=True)
    return result, a


if __name__ == "__main__":
    main()
