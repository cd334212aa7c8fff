"""Training driver of the port: decentralized D-Adam / CD-Adam training of
a registered LM architecture, the port of ``repro.launch.train`` with its
flags and prints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --workers 2 --steps 8 --optimizer d-adam --period 4 --backend packed

Runs on ``cuda`` unless ``--device cpu`` is given. The reduced config is
the default; ``--full`` takes the published widths (llama3.2-1b at K=2 is
9.89 GB per f32 buffer of the packed state). ``--backend packed`` is the
JAX package's ``pallas``: the resident ``(K, rows, 128)`` state and the
CUDA kernels. The per-worker loss is ``build_model(cfg).loss`` run once
per worker on views of the stacked params (``train.loop.stacked_loss``),
through sdpa's naive or chunked path, the RWKV scan and the chunked SSD
scan: the flash and WKV kernels have no backward, as the TPU kernels have
none. ``--damping``
grows the gradient-accumulation chunk count as the loss falls
(``train.damping``): every step evaluates all of its ``max_chunks`` chunks
and masks each worker's chunks past its count. Checkpoints go through
``repro_torch.checkpoint`` in the JAX package's format.

``--comm axis`` runs one process per worker over ``torch.distributed``
(``launch.mesh``): under ``torchrun --nproc-per-node K`` each process is
one rank; without torchrun, ``--workers K`` spawns the K ranks itself
(over a ``file://`` store, gloo on the loopback interface). The ranks
draw the same global batches, each steps its own worker on its slice, and
rank 0 prints the log (global loss and consensus) and writes the
checkpoint. ``--dist-backend`` takes ``nccl`` (one card per rank) or
``gloo`` (the CPU, or ranks sharing a card, staged through host memory);
by default nccl when every rank has a card of its own.

``--model-parallel M`` (with ``--comm axis --backend packed``) is the 2D
worker x model layout: each of the K workers is a group of M ranks, each
holding one ``(1, rows / M, 128)`` block of its worker's row-sharded
state; gossip crosses only the worker axis and CD-Adam's scales are
summed over the M ranks. As the JAX CLI does, it builds the arch's
sharding plan (``launch.shardings.make_plan(arch, group, mode='axis')``):
each step a rank moves its block out to its plan shard of every matrix,
computes the worker's loss and gradient multiplying with its shards
(``train.grad``'s planned mode), and moves the gradient back into its
block; no rank holds the worker's whole buffer. The plan runs the dense,
MoE (router and experts cut by the plan, the routing the same on every
rank) and vision-language (the projector cut, the patches the same on
every rank of a worker) families; the ssm, hybrid and audio families
raise ``NotImplementedError``. Without torchrun
``--workers K`` spawns K x M ranks; under torchrun it takes K x M of
them. Rank (w, 0) of each worker counts toward the log, and global rank
0 prints it.

    PYTHONPATH=src python -m repro_torch.launch.train --comm axis \
        --workers 2 --device cpu --steps 4 --period 2 --seq 16 --batch 1
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --comm axis --workers 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --comm axis \
        --workers 2 --model-parallel 2 --backend packed --device cpu \
        --steps 4 --period 2 --seq 16 --batch 1

Memory: the packed step is out of place (the Adam kernels write new
buffers), and a ``fit`` call keeps the state it was handed alive until it
returns. At full width with f32 moments (seven 9.89 GB buffers in the Adam
step of llama3.2-1b at K=2) one more state does not fit on an 80 GB card,
so such a run takes ``--log-every 1``: one step per ``fit`` call.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Any, Iterator, List, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves
from repro_torch.checkpoint.io import save
from repro_torch.configs import get_arch, get_reduced, list_archs
from repro_torch.core.api import make_optimizer
from repro_torch.launch.mesh import DEFAULT_TIMEOUT_S, make_worker_group, spawn
from repro_torch.launch.shardings import make_plan
from repro_torch.data.synthetic import lm_batch
from repro_torch.models.registry import build_model, family_extras
from repro_torch.train.damping import make_damping
from repro_torch.train.loop import (DecentralizedTrainer, TrainLog,
                                    stacked_loss)

# the seeds of the JAX driver: params from 0, batches from 42
PARAM_SEED, BATCH_SEED = 0, 42


@dataclasses.dataclass
class TrainRun:
    """What :func:`main` ran. When ``--comm axis`` spawned its ranks, the
    caller gets rank 0's ``log`` and ``n_params`` only (the other fields
    ``None``): the trainer and state lived in the ranks."""

    trainer: Optional[DecentralizedTrainer]
    state: Any
    log: TrainLog
    batches: Optional[Iterator[Any]]  # the training stream, after fit
    n_params: int              # per worker


def make_batch_iter(cfg, K: int, per_worker: int, seq: int, skew: float,
                    device: torch.device) -> Iterator[Any]:
    """``{"tokens": (K, per_worker, seq + 1)}`` per step, every worker's
    ``lm_batch`` drawn from one generator on ``device`` seeded
    ``BATCH_SEED`` (the JAX driver folds the step into PRNGKey(42); the
    draws are torch's, not JAX's). As in JAX, the vlm family's batch adds
    ``patches`` (K, per_worker, n_patches, 1024) and the audio family's
    ``audio_embeds`` (K, per_worker, n_audio_ctx, d_model), N(0, 1) f32
    from the same generator; the others take tokens only."""
    gen = torch.Generator(device=device).manual_seed(BATCH_SEED)
    while True:
        batch = {"tokens": torch.stack([
            lm_batch(gen, per_worker, seq, cfg.vocab_size, k, K, skew)
            for k in range(K)])}
        for name, x in family_extras(cfg, K * per_worker, gen).items():
            batch[name] = x.reshape((K, per_worker) + tuple(x.shape[1:]))
        yield batch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--full", action="store_true",
                    help="full config (the published widths)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2, help="per worker")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--optimizer", default="d-adam",
                    choices=["d-adam", "cd-adam", "d-psgd"])
    ap.add_argument("--period", type=int, default=4)
    ap.add_argument("--compressor", default="sign")
    ap.add_argument("--gamma", type=float, default=0.4)
    ap.add_argument("--eta", type=float, default=1e-3)
    ap.add_argument("--topology", default="ring",
                    help="static graph (ring/torus/full/...) or a "
                         "time-varying schedule spec: "
                         "'one-peer-exponential', 'randomized-rings:N'")
    ap.add_argument("--staleness", type=int, default=None,
                    help="straggler tolerance tau: gossip may consume "
                         "payloads up to tau rounds old before blocking "
                         "on a fresh exchange (0 = synchronous semantics "
                         "with the buffers wired in)")
    ap.add_argument("--straggler-rate", type=float, default=0.0,
                    help="simulated straggler probability per edge per "
                         "round (requires --staleness >= 1)")
    ap.add_argument("--straggler-seed", type=int, default=0)
    ap.add_argument("--overlap", action="store_true",
                    help="delay-1 wire schedule: round r's exchange is "
                         "folded in at round r+1; mutually exclusive with "
                         "--staleness")
    ap.add_argument("--backend", default="reference",
                    choices=["reference", "packed"],
                    help="optimizer backend (packed = the resident "
                         "(K, rows, 128) state and the CUDA kernels; their "
                         "plain versions on the CPU)")
    ap.add_argument("--comm", default="stacked",
                    choices=["stacked", "axis"],
                    help="'stacked' runs every worker on one device; "
                         "'axis' runs one process per worker over "
                         "torch.distributed (under torchrun, or spawned "
                         "by --workers)")
    ap.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="--comm axis's process-group backend (the torch "
                         "form of the JAX CLI's device choice): nccl "
                         "needs a card per rank; gloo runs on the CPU and "
                         "on shared cards, through host memory. Default: "
                         "nccl when every rank has a card of its own")
    ap.add_argument("--dist-timeout", type=float, default=DEFAULT_TIMEOUT_S,
                    help="seconds before a --comm axis collective fails")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="with --comm axis --backend packed: ranks per "
                         "worker M (the 2D worker x model layout; the "
                         "packed state's row dim is cut M ways, gossip "
                         "still crosses only the worker axis): K x M "
                         "ranks in all")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches per step "
                         "(must divide --batch)")
    ap.add_argument("--damping", default="",
                    help="adaptive batch damping policy spec: "
                         "'adadamp:MAX[:EMA]', 'padadamp:MAX[:RATE]' or "
                         "'geodamp:MAX[:FACTOR[:DELAY]]': grows the "
                         "gradient-accumulation chunk count as the loss "
                         "falls (MAX must divide --batch); every step runs "
                         "all MAX chunks and masks those past a worker's "
                         "count. Mutually exclusive with --microbatch > 1")
    ap.add_argument("--damping-per-worker", action="store_true",
                    help="one damping signal per worker (non-IID shards) "
                         "instead of the global mean-loss signal")
    ap.add_argument("--damping-lr-decay", type=float, default=0.5,
                    help="eta decay factor applied once the batch hits "
                         "the damping ceiling (with --damping-lr-decay-"
                         "every > 0)")
    ap.add_argument("--damping-lr-decay-every", type=int, default=0,
                    help="decay eta every N steps spent with every "
                         "worker at max_chunks (0 = off)")
    ap.add_argument("--skew", type=float, default=0.5,
                    help="non-IID-ness of worker shards")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10,
                    help="steps per log line; each is one fit call, "
                         "which keeps the state it was handed until it "
                         "returns: at full width on one card take 1")
    ap.add_argument("--device", default="cuda")
    return ap


def check_args(args: argparse.Namespace) -> None:
    """The JAX CLI's refusals of ``--model-parallel`` without the 2D
    layout's needs."""
    if args.model_parallel < 1:
        raise SystemExit("--model-parallel must be >= 1")
    if args.model_parallel > 1 and args.comm != "axis":
        raise SystemExit("--model-parallel > 1 requires --comm axis "
                         "(the 2D worker x model layout)")
    if args.model_parallel > 1 and args.backend != "packed":
        raise SystemExit("--model-parallel > 1 requires --backend packed "
                         "(it cuts the packed row dim)")


def main(argv: Optional[List[str]] = None) -> TrainRun:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    check_args(args)
    if args.comm == "axis" and "WORLD_SIZE" not in os.environ:
        # no torchrun: this process spawns the K x M ranks and waits for
        # them; the ranks share the host's cores
        ranks = args.workers * args.model_parallel
        logs = spawn(_axis_rank, ranks, (argv,), timeout_s=None,
                     threads=max(1, (os.cpu_count() or 1) // ranks))
        log, n_params = logs[0]
        return TrainRun(None, None, log, None, n_params)
    return _run(args)


def _axis_rank(rank: int, init_method: str, argv: List[str]):
    run = _run(parser().parse_args(argv), init_method=init_method)
    return run.log, run.n_params


def _run(args: argparse.Namespace,
         init_method: Optional[str] = None) -> TrainRun:
    group = None
    if args.comm == "axis":
        group = make_worker_group(args.workers, backend=args.dist_backend,
                                  init_method=init_method,
                                  device=args.device,
                                  timeout_s=args.dist_timeout,
                                  model_parallel=args.model_parallel)
        if not group.member:
            raise ValueError(
                f"global rank {group.global_rank} is past the {args.workers}"
                f" x {args.model_parallel} ranks the run uses: start it on "
                f"{args.workers * args.model_parallel} ranks")
        dev = group.device
    else:
        dev = resolve_device(args.device)
    # under --comm axis global rank 0 prints for the group
    say = print if group is None or group.global_rank == 0 else (
        lambda *a, **k: None)
    arch = get_arch(args.arch) if args.full else get_reduced(args.arch)
    cfg = arch.model
    api = build_model(cfg)
    opt = make_optimizer(args.optimizer, K=args.workers, eta=args.eta,
                         period=args.period, topology=args.topology,
                         gamma=args.gamma, compressor=args.compressor,
                         backend=args.backend, comm=args.comm,
                         group=group, staleness=args.staleness,
                         straggler_rate=args.straggler_rate,
                         straggler_seed=args.straggler_seed,
                         overlap=args.overlap, device=dev)
    damping = None
    if args.damping:
        damping = dataclasses.replace(
            make_damping(args.damping),
            per_worker=args.damping_per_worker,
            lr_decay=args.damping_lr_decay,
            lr_decay_every=args.damping_lr_decay_every)
        if args.batch % damping.max_chunks:
            raise SystemExit(
                f"--damping max_chunks {damping.max_chunks} must divide "
                f"--batch {args.batch}")
    # the 2D layout: the arch's sharding plan over the worker group, as
    # the JAX CLI threads make_plan(arch, mesh, mode='axis') into its loss
    plan = (make_plan(arch, group, mode="axis")
            if args.model_parallel > 1 else None)
    trainer = DecentralizedTrainer(stacked_loss(api.loss), opt,
                                   microbatch=args.microbatch,
                                   damping=damping, plan=plan)
    params = api.init(torch.Generator(device=dev).manual_seed(PARAM_SEED))
    n_params = sum(x.numel() for x in tree_leaves(params))
    state = trainer.init(params)
    del params    # the stacked state holds every worker's copy
    say(f"[train] {args.arch} ({'full' if args.full else 'reduced'}) "
          f"N={n_params/1e6:.1f}M x {args.workers} workers "
          f"opt={args.optimizer} p={args.period} "
          f"topo={args.topology} backend={args.backend} comm={args.comm}"
          + (" overlap" if args.overlap else ""), flush=True)
    if group is not None:
        say(f"[train] worker group: {args.workers} workers x {group.M} "
            f"rank(s), on {dev}; gossip = one exchange per graph offset "
            f"({group.transport})", flush=True)
        if group.M > 1:
            say(f"[train] 2D execution: each worker = {group.M}-rank "
                f"model group ({args.workers * group.M} ranks); packed "
                f"rows cut {group.M} ways, one (1, rows/{group.M}, 128) "
                f"block a rank; compression scales summed over the model "
                f"group; sharding plan: each rank multiplies with its "
                f"1/{group.M} of every matrix", flush=True)
    if args.backend == "packed":
        # packed-resident state: params + moments live in the stacked
        # (K, rows, 128) kernel layout across steps; grads come back packed
        # through unpack's backward, and checkpoints are stored in the
        # portable (backend-agnostic) form
        spec = state.spec
        say(f"[train] resident packed state: K={spec.k} "
              f"rows={spec.rows} ({spec.rows * 128 / 1e6:.2f}M slots/"
              f"worker, {spec.n / 1e6:.2f}M live; "
              f"{(spec.rows * 128 - spec.n) / max(spec.rows * 128, 1):.1%} "
              f"tile padding)", flush=True)
    if damping is not None:
        say(f"[train] batch damping: {damping.policy} chunks "
              f"{damping.min_chunks}..{damping.max_chunks} "
              f"({'per-worker' if damping.per_worker else 'global'} "
              f"signal); every step runs all {damping.max_chunks} chunks, "
              f"masked past each worker's count", flush=True)

    it = make_batch_iter(cfg, args.workers, args.batch, args.seq, args.skew,
                         dev)
    meta = {"arch": args.arch, "optimizer": args.optimizer}
    t0 = time.perf_counter()
    done = 0
    log = None
    while done < args.steps:
        n = min(args.log_every, args.steps - done)
        # the log CONTINUES across fit calls: comm MB, wall time and grad
        # evals are cumulative, and the comm rounds stay aligned
        state, log = trainer.fit(state, it, n, log_every=n, log=log)
        done += n
        say(f"[train] step {done:5d} loss={log.loss[-1]:.4f} "
              f"consensus={log.consensus[-1]:.3e} "
              f"comm={log.comm_mb[-1]:.1f}MB "
              f"evals={log.grad_evals[-1]} "
              f"({(time.perf_counter() - t0) / done * 1e3:.0f} ms/step)",
              flush=True)
        if args.ckpt and args.ckpt_every and done % args.ckpt_every == 0:
            save(args.ckpt, state, step=done, meta=meta, group=group)
            say(f"[train] checkpointed -> {args.ckpt}", flush=True)
    if args.ckpt:
        save(args.ckpt, state, step=done, meta=meta, group=group)
        say(f"[train] final checkpoint -> {args.ckpt}", flush=True)
    return TrainRun(trainer, state, log, it, n_params)


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
