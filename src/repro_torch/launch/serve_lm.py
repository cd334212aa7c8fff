"""Serving example: batched bucket decode through the DecodeEngine with a
lock-free ParamStore hot-swap mid-stream, the port of
``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu \
        --new-tokens 4

Serves the reduced llama3.2-1b from a ParamStore (weights drawn from a
torch generator seeded 0) through the buckets (1, 16) and (4, 16): five
prompts of lengths 16, 9, 16, 12 and 16 (tokens from a generator seeded
1) are grouped by length and right-padded into their bucket, whose
rewind step makes the padding leave the output unchanged. A second
publish (weights from seed 2) swaps the served params between two calls
without rebuilding anything; the second call serves version 2. Prefill
attention runs the CUDA flash kernel on ``cuda`` (the default; ``--device
cpu`` runs its plain version). ``--new-tokens`` defaults to
``$SERVE_NEW_TOKENS`` or 16, as the example's. Prints the example's two
lines and returns the engine, the store, the prompts and both calls'
outputs.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_reduced
from repro_torch.models.registry import build_model
from repro_torch.serve import DecodeEngine, ParamStore

ARCH = "llama3.2-1b"
BUCKETS = ((1, 16), (4, 16))
LENGTHS = (16, 9, 16, 12, 16)
PARAM_SEEDS, PROMPT_SEED = (0, 2), 1


@dataclasses.dataclass
class ServeResult:
    engine: DecodeEngine
    store: ParamStore
    prompts: List[torch.Tensor]
    outs: List[List[torch.Tensor]]   # per call, one (n_new,) per prompt


def prompts_of(vocab: int, device: torch.device) -> List[torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(PROMPT_SEED)
    return [torch.randint(0, vocab, (L,), generator=gen, device=device,
                          dtype=torch.int32) for L in LENGTHS]


def main(argv: Optional[List[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--new-tokens", type=int,
                    default=int(os.environ.get("SERVE_NEW_TOKENS", "16")))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n_new = args.new_tokens

    dev = resolve_device(args.device)
    cfg = get_reduced(ARCH).model
    api = build_model(cfg)
    store = ParamStore()
    store.publish(api.init(torch.Generator(device=dev).manual_seed(
        PARAM_SEEDS[0])))
    engine = DecodeEngine(cfg, store, buckets=BUCKETS,
                          max_new_tokens=max(n_new, 4))
    prompts = prompts_of(cfg.vocab_size, dev)

    t0 = time.perf_counter()
    first = engine.generate(prompts, n_new)
    dt = time.perf_counter() - t0
    tokens = sum(o.numel() for o in first)
    print(f"v{engine.last_version}: {len(prompts)} prompts "
          f"(lens {[int(p.numel()) for p in prompts]}) -> {tokens} tokens "
          f"in {dt:.2f}s ({tokens / dt:.0f} tok/s)", flush=True)

    # hot-swap: the very next call serves the new params, through the same
    # buckets, with no reader stall
    store.publish(api.init(torch.Generator(device=dev).manual_seed(
        PARAM_SEEDS[1])))
    t0 = time.perf_counter()
    second = engine.generate(prompts, n_new)
    dt = time.perf_counter() - t0
    print(f"v{engine.last_version}: re-served after hot-swap in {dt:.2f}s "
          f"(compiles: {engine.compile_counts})", flush=True)
    assert engine.last_version == 2
    return ServeResult(engine, store, prompts, [first, second])


if __name__ == "__main__":
    main()
