"""End-to-end driver: decentralized training of a transformer LM, the port
of ``examples/decentralized_lm.py``.

    PYTHONPATH=src python -m repro_torch.launch.decentralized_lm --steps 200
    PYTHONPATH=src python -m repro_torch.launch.decentralized_lm \
        --preset 7m --steps 8 --log-every 4 --device cpu

The default preset trains a ~7M-parameter llama-style model (tied
embeddings) across 4 workers stacked on one device; ``--preset 100m``
selects the ~100M configuration. Runs on ``cuda`` unless ``--device cpu``
is given. The optimizer runs on the ``packed`` backend (the resident
``(K, rows, 128)`` state and the CUDA kernels: ``fused_adam`` on the
local steps, ``gossip_adam_mix`` on the communication steps; their plain
versions on CPU tensors), where the JAX example takes its default
``reference`` backend (the same update in plain ops). The batches come
from a torch generator seeded 3 on the device (the JAX example folds the
step into ``PRNGKey(3)``; the draws are torch's, not JAX's). Prints the JAX
example's lines, one per ``--log-every`` steps (50 there), and returns the
``TrainLog``.
"""
from __future__ import annotations

import argparse
import time
from typing import Iterator, List, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import make_optimizer
from repro_torch.data.synthetic import lm_batch
from repro_torch.models.registry import build_model
from repro_torch.train.loop import (DecentralizedTrainer, TrainLog,
                                    stacked_loss)

PRESETS = {
    "7m": ModelConfig(arch_id="lm7m", family="dense", n_layers=4,
                      d_model=256, n_heads=8, n_kv_heads=4, d_ff=688,
                      vocab_size=2048, tie_embeddings=True),
    "100m": ModelConfig(arch_id="lm100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                        vocab_size=32768, tie_embeddings=True),
}
# the JAX example's seeds: params from 0, batches from 3
PARAM_SEED, BATCH_SEED = 0, 3


def batches(cfg: ModelConfig, K: int, batch: int, seq: int,
            device: torch.device) -> Iterator[dict]:
    """``{"tokens": (K, batch, seq + 1)}`` per step, skew 0.5."""
    gen = torch.Generator(device=device).manual_seed(BATCH_SEED)
    while True:
        yield {"tokens": torch.stack([
            lm_batch(gen, batch, seq, cfg.vocab_size, k, K, skew=0.5)
            for k in range(K)])}


def main(argv: Optional[List[str]] = None) -> TrainLog:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="7m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="d-adam")
    ap.add_argument("--period", type=int, default=4)
    ap.add_argument("--eta", type=float, default=1e-3,
                    help="Adam's step (the JAX example's fixed 1e-3)")
    ap.add_argument("--log-every", type=int, default=50,
                    help="steps per fit call and log line")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    api = build_model(cfg)
    K = args.workers
    opt = make_optimizer(args.optimizer, K=K, eta=args.eta,
                         period=args.period, backend="packed", device=dev)
    trainer = DecentralizedTrainer(stacked_loss(api.loss), opt)
    params = api.init(torch.Generator(device=dev).manual_seed(PARAM_SEED))
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"model {cfg.arch_id}: {n / 1e6:.1f}M params, K={K} workers, "
          f"{args.optimizer} p={args.period}", flush=True)
    state = trainer.init(params)
    del params

    t0 = time.perf_counter()
    done = 0
    log = None
    it = batches(cfg, K, args.batch, args.seq, dev)
    while done < args.steps:
        chunk = min(args.log_every, args.steps - done)
        state, log = trainer.fit(state, it, chunk, log_every=chunk, log=log)
        done += chunk
        print(f"step {done:4d}  loss {log.loss[-1]:.4f}  "
              f"consensus {log.consensus[-1]:.2e}  "
              f"comm {log.comm_mb_total:.1f} MB  "
              f"({(time.perf_counter() - t0) / done * 1e3:.0f} ms/step)",
              flush=True)
    return log


if __name__ == "__main__":
    main()
