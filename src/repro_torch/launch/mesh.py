"""Worker groups for ``comm='axis'``, the port of ``repro.launch.mesh``'s
``make_worker_mesh``.

The JAX package runs ``comm='axis'`` as one controller driving
``shard_map`` over a ``'worker'`` mesh axis (and, for the 2D layout, a
``'model'`` axis). Here every rank is a process of its own, SPMD over
``torch.distributed``. With ``model_parallel=M`` (1 by default) the K
workers are K groups of M ranks: global rank ``r = w M + m`` is model
index m of worker w, the row-major device order of
``jax.make_mesh((K, M))``. Each rank holds its worker's ``(1, ...)``
slice of the stacked state, and under the 2D layout one
``(1, rows / M, 128)`` block of its packed buffers. A rank takes its graph
neighbours' blocks by point-to-point messages with the ranks of the same
model index (:func:`exchange`, called by ``core.dadam.shift_worker`` once
per graph offset, where JAX has one ``ppermute`` over the worker axis),
and reaches the other ranks of its worker through the model-group
collectives: :func:`model_all_gather`, :func:`model_sum`, a sum whose
order is the model index, so that every rank of a group holds the same
bits, and :func:`model_redistribute`, the point-to-point exchange that
moves a sharding plan's shards out of the packed blocks and back.

The group may be a prefix of a larger world: ``make_worker_group(K,
model_parallel=M)`` over a world of at least K M ranks takes global ranks
``0 .. K M - 1`` (a ``dist.new_group`` of its own when the world is
larger), and a rank past them gets a :class:`WorkerGroup` that is not a
:attr:`~WorkerGroup.member`: it holds no worker and takes part only in
the collectives that change membership (``core.elastic.resize_state``).
Every rank of the world makes every group, with the same arguments, in the
same order, since each ``dist.new_group`` is collective over the world;
elastic membership is a new group over another prefix of the same world.

Transport, by the group's backend:

* ``nccl``: CUDA tensors go to the wire directly. NCCL needs one card per
  rank: it refuses two ranks on one GPU.
* ``gloo``: its point-to-point ops take host tensors only. A CUDA tensor
  is copied to a host buffer, exchanged, and copied back
  (:attr:`WorkerGroup.host_staged`). On one card this is the only form a
  group of more than one rank can take.

Every message travels as the bytes of its tensor (a ``uint8`` view), so
any dtype crosses and arrives equal to the bit.

Not ported: ``PEAK_FLOPS``, ``HBM_BW``, ``ICI_BW`` (TPU v5e figures;
the H100's are ``analysis.roofline.H100_SXM``), ``make_production_mesh``
(256- and 512-chip TPU meshes), ``make_host_mesh`` and ``n_chips``, which
no port caller needs.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

WORKER_AXIS = "worker"   # the comm='axis' worker axis name, as in JAX
DEFAULT_TIMEOUT_S = 300.0
# the collectives a WorkerGroup counts, by kind (collective_summary)
COLLECTIVES = ("exchange", "model_all_gather", "model_sum",
               "model_redistribute", "worker_all_gather",
               "worker_broadcast", "all_reduce", "resize")
# the names of the functions below whose torch.distributed calls a
# WorkerGroup counts (on the sending rank): analysis.invariants takes
# every other torch.distributed call for an uncounted one
COUNTING: set = set()


def _counting(fn: Callable) -> Callable:
    COUNTING.add(fn.__name__)
    return fn


@dataclasses.dataclass
class WorkerGroup:
    """One rank's view of the worker group: the process group, this
    rank's worker index ``rank`` (w), the worker count K, the device that
    holds this worker's state, and the backend. With ``M`` > 1 (the 2D
    layout) the rank is model index ``model_rank`` (m) of worker w, at
    global rank ``global_rank`` = w M + m; ``model_group`` is the process
    group of worker w's M ranks (None when M is 1) and ``worker_group``
    that of the K ranks of model index m (the whole group when M is 1).
    A rank of the world at or past K M is no :attr:`member`: its
    ``rank`` is ``global_rank // M`` (>= K) and it holds no group handle.

    ``counts`` holds ``[calls, bytes, max_bytes]`` of every collective by
    kind (:data:`COLLECTIVES`, :meth:`collective_summary`), the bytes
    being this rank's contribution and ``max_bytes`` that of its largest
    single call; ``bytes_sent`` and ``messages`` are :func:`exchange`'s,
    what this rank put on the wire."""

    group: Any
    rank: int
    K: int
    device: torch.device
    backend: str
    axis_name: str = WORKER_AXIS
    M: int = 1
    model_rank: int = 0
    model_group: Any = None
    worker_group: Any = None
    counts: dict = dataclasses.field(
        default_factory=lambda: {k: [0, 0, 0] for k in COLLECTIVES})

    @property
    def global_rank(self) -> int:
        return self.rank * self.M + self.model_rank

    @property
    def member(self) -> bool:
        """Whether this rank holds a worker of the group (its global rank
        is below K M)."""
        return self.rank < self.K

    @property
    def bytes_sent(self) -> int:
        return self.counts["exchange"][1]

    @property
    def messages(self) -> int:
        return self.counts["exchange"][0]

    def count(self, kind: str, nbytes: int) -> None:
        c = self.counts[kind]
        c[0] += 1
        c[1] += int(nbytes)
        c[2] = max(c[2], int(nbytes))

    def reset_counts(self) -> None:
        for c in self.counts.values():
            c[:] = [0, 0, 0]

    def collective_summary(self) -> dict:
        """``{kind: {"count", "bytes", "max_bytes"}}`` of the collectives
        this rank made since the last :meth:`reset_counts`: the port's
        form of the JAX package's ``analysis.hlo.collective_summary``,
        which ``analysis.invariants.evaluate`` gates."""
        return {k: {"count": c, "bytes": b, "max_bytes": m}
                for k, (c, b, m) in self.counts.items()}

    @property
    def host_staged(self) -> bool:
        """True when every message goes through host memory: a gloo group
        whose workers live on a CUDA device."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def transport(self) -> str:
        return (f"{self.backend}, host-staged" if self.host_staged
                else self.backend)


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def _local_world(workers: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", workers))


def rank_device(device: "str | torch.device", rank: int,
                workers: int) -> torch.device:
    """The device of rank ``rank``: ``cpu`` when asked; for CUDA,
    ``cuda:LOCAL_RANK`` when the host has a card for each of its ranks,
    else the ranks share the cards round robin (``cuda:0`` for every rank
    on a one-card machine)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is not None:
        return dev
    return torch.device("cuda", _local_rank(rank)
                        % torch.cuda.device_count())


def default_backend(device: torch.device, workers: int) -> str:
    """``nccl`` for CUDA with a card for each rank of the host, ``gloo``
    otherwise (the CPU, or ranks that share a card)."""
    if device.type == "cuda" and \
            torch.cuda.device_count() >= _local_world(workers):
        return "nccl"
    return "gloo"


def make_worker_group(workers: int, *, backend: Optional[str] = None,
                      init_method: Optional[str] = None,
                      rank: Optional[int] = None,
                      device: "str | torch.device" = "cuda",
                      timeout_s: float = DEFAULT_TIMEOUT_S,
                      axis_name: str = WORKER_AXIS,
                      model_parallel: int = 1) -> WorkerGroup:
    """Open (or join) the world and return this rank's
    :class:`WorkerGroup` of ``workers`` x ``model_parallel`` ranks: global
    ranks ``0 .. K M - 1`` of a world of at least K M.

    Without ``init_method`` the world forms from the environment
    ``torchrun`` sets (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``); with one (``file://...`` or
    ``tcp://localhost:<port>``) the rank comes from ``rank`` or
    ``$RANK``, and the world's size from ``$WORLD_SIZE`` (K M when it is
    not set). A world that is already initialised is joined as it is.
    ``backend`` defaults to :func:`default_backend`; every collective
    fails after ``timeout_s``. With ``model_parallel=M`` > 1 global rank
    r is model index ``r % M`` of worker ``r // M``.

    Every rank of the world must call it, with the same arguments and in
    the same order as every other rank: when the world is larger than K M
    the group is a ``dist.new_group`` of its own, and under M > 1 every
    rank creates the K model groups and the M worker groups, in that
    order. A rank at or past K M gets a group that is not a
    :attr:`~WorkerGroup.member`.

    Raises ``ValueError`` when the world has fewer than ``workers`` x
    ``model_parallel`` ranks, or when ``nccl`` is asked for on the CPU or
    for ranks sharing a card."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got "
                         f"{model_parallel}")
    M = model_parallel
    workers_total = workers * M
    if not dist.is_initialized():
        if rank is None:
            if "RANK" not in os.environ:
                raise ValueError(
                    "make_worker_group needs the rank: run under torchrun, "
                    "or pass rank= (or set $RANK) with init_method=")
            rank = int(os.environ["RANK"])
        world_size = int(os.environ.get("WORLD_SIZE", workers_total))
        dev = rank_device(device, rank, world_size)
        backend = backend or default_backend(dev, world_size)
        _check_backend(backend, dev, world_size)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    else:
        rank = dist.get_rank()
        dev = rank_device(device, rank, dist.get_world_size())
        backend = dist.get_backend()
        _check_backend(backend, dev, dist.get_world_size())
    world = dist.get_world_size()
    if world < workers_total:
        raise ValueError(
            f"the process group has {world} ranks; comm='axis' with "
            f"{workers} workers x model_parallel {M} needs at least "
            f"{workers_total}")
    timeout = datetime.timedelta(seconds=timeout_s)
    member = rank < workers_total
    group = dist.group.WORLD
    if world > workers_total:
        # collective over the world: every rank creates it
        group = dist.new_group(list(range(workers_total)), timeout=timeout)
    wg = WorkerGroup(group=group if member else None, rank=rank // M,
                     K=workers, device=dev, backend=backend,
                     axis_name=axis_name, M=M, model_rank=rank % M,
                     worker_group=group if member else None)
    if M > 1:
        wg.worker_group = None
        # every rank creates every subgroup, in one order
        for w in range(workers):
            g = dist.new_group([w * M + m for m in range(M)],
                               timeout=timeout)
            if member and w == wg.rank:
                wg.model_group = g
        for m in range(M):
            g = dist.new_group([w * M + m for w in range(workers)],
                               timeout=timeout)
            if member and m == wg.model_rank:
                wg.worker_group = g
    return wg


def _check_backend(backend: str, dev: torch.device, workers: int) -> None:
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl needs CUDA devices; use gloo on the CPU")
        if torch.cuda.device_count() < _local_world(workers):
            raise ValueError(
                f"nccl needs one card per rank; this host has "
                f"{torch.cuda.device_count()} for {_local_world(workers)} "
                "ranks (use gloo, which stages through host memory)")


# ------------------------------ transport -----------------------------------


def _wire(x: torch.Tensor, wg: WorkerGroup) -> torch.Tensor:
    """The bytes of ``x`` as a flat uint8 tensor where the backend takes
    them: on the host for a host-staged group, else where ``x`` lies."""
    flat = x.detach().contiguous().reshape(-1)
    if wg.host_staged:
        flat = flat.cpu()
    return flat.view(torch.uint8)


def _unwire(buf: torch.Tensor, like: torch.Tensor,
            shape: Sequence[int]) -> torch.Tensor:
    out = buf.view(like.dtype).reshape(tuple(shape))
    return out.to(like.device)


@_counting
def exchange(x: torch.Tensor, src: int, dst: int, wg: WorkerGroup,
             tag: int = 0) -> torch.Tensor:
    """Send ``x`` to worker ``dst`` and return the tensor worker ``src``
    sends (of ``x``'s shape and dtype), both in one ``batch_isend_irecv``;
    every rank of the group must call it with its own peers and the same
    ``tag``. Under the 2D layout the peers are the ranks of this rank's
    model index (global ranks ``src M + m`` and ``dst M + m``), so each
    model column ships its own block. With ``src == dst == rank`` it
    returns a copy of ``x``. The peers are global ranks, which name the
    right processes because the group is the world's first K M ranks
    (worker w's rank of model index m is global rank ``w M + m``).

    The branch on the backend: a host-staged group (gloo, CUDA state)
    copies ``x`` to a host buffer, exchanges host buffers and copies the
    received one to ``x``'s device; nccl and gloo on the CPU exchange
    ``x``'s own device buffers."""
    if src == wg.rank and dst == wg.rank:
        return x.clone()
    send = _wire(x, wg)
    recv = torch.empty_like(send)
    m = wg.model_rank
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst * wg.M + m, wg.group, tag),
        dist.P2POp(dist.irecv, recv, src * wg.M + m, wg.group, tag)])
    for req in reqs:
        req.wait()
    wg.count("exchange", send.numel())
    return _unwire(recv, x, x.shape)


@_counting
def all_reduce_sum(x: torch.Tensor, wg: WorkerGroup) -> torch.Tensor:
    """The sum of ``x`` (a new tensor on ``x``'s device) over the K
    workers of this rank's model index (every rank when M is 1), staged
    through host memory for a host-staged group. The backend picks the
    order of the sum: for values that need not agree to the bit (the
    log). A host-staged group reduces a host copy of ``x``, so the card
    holds no second one during the call."""
    buf = x.detach().cpu() if wg.host_staged else x.detach().clone()
    dist.all_reduce(buf, group=wg.worker_group)
    wg.count("all_reduce", buf.numel() * buf.element_size())
    return buf.to(x.device)


@_counting
def _gather(x: torch.Tensor, wg: WorkerGroup, n: int, group: Any,
            kind: str) -> list:
    send = _wire(x, wg)
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    wg.count(kind, send.numel())
    return [_unwire(p, x, x.shape) for p in parts]


def all_gather_workers(x: torch.Tensor, wg: WorkerGroup,
                       kind: str = "worker_all_gather") -> torch.Tensor:
    """The K workers' ``x`` (from the ranks of this rank's model index)
    concatenated along dim 0 in worker order, equal to the bit (every
    rank gets all of them; each rank's ``x`` must have the same shape and
    dtype). Counted under ``kind``."""
    return torch.cat(_gather(x, wg, wg.K, wg.worker_group, kind), dim=0)


@_counting
def _broadcast(x: torch.Tensor, src: int, group: Any, wg: WorkerGroup,
               kind: str) -> torch.Tensor:
    buf = _wire(x, wg).clone()
    dist.broadcast(buf, src=src, group=group)
    if wg.global_rank == src:
        wg.count(kind, buf.numel())
    return _unwire(buf, x, x.shape)


def worker_broadcast(x: torch.Tensor, worker: int,
                     wg: WorkerGroup) -> torch.Tensor:
    """Worker ``worker``'s ``x`` (its rank of this rank's model index) on
    every rank of this model index, equal to the bit; every such rank
    passes a tensor of the same shape and dtype."""
    return _broadcast(x, worker * wg.M + wg.model_rank, wg.worker_group,
                      wg, "worker_broadcast")


def broadcast_first(x: torch.Tensor, wg: WorkerGroup,
                    kind: str = "resize") -> torch.Tensor:
    """Global rank 0's ``x`` on every rank of the group, equal to the bit
    (every member passes a tensor of the same shape and dtype)."""
    return _broadcast(x, 0, wg.group, wg, kind)


@_counting
def send_world(x: torch.Tensor, dst: int, wg: WorkerGroup,
               kind: str = "resize") -> None:
    """Send ``x``'s bytes to global rank ``dst`` of the world (which need
    not be in ``wg``: a rank joining another group), counted under
    ``kind``; ``dst`` takes them with :func:`recv_world`."""
    send = _wire(x, wg)
    dist.send(send, dst)
    wg.count(kind, send.numel())


@_counting
def recv_world(like: torch.Tensor, src: int, wg: WorkerGroup
               ) -> torch.Tensor:
    """The tensor global rank ``src`` sends with :func:`send_world`, of
    ``like``'s shape, dtype and device."""
    recv = torch.empty_like(_wire(like, wg))
    dist.recv(recv, src)
    return _unwire(recv, like, like.shape)


def model_all_gather(x: torch.Tensor, wg: WorkerGroup,
                     dim: int = 1) -> torch.Tensor:
    """The M blocks ``x`` of this rank's worker concatenated along ``dim``
    in model-index order, equal to the bit, on every rank of the model
    group: a ``(1, rows / M, 128)`` block becomes the worker's
    ``(1, rows, 128)`` buffer. ``x`` itself when M is 1."""
    if wg.M == 1:
        return x
    return torch.cat(_gather(x, wg, wg.M, wg.model_group,
                             "model_all_gather"), dim=dim)


def model_sum(x: torch.Tensor, wg: WorkerGroup) -> torch.Tensor:
    """The sum of ``x`` over the M ranks of this rank's worker, added in
    model-index order after one all-gather, so that every rank of the
    group holds the same bits (``dist.all_reduce`` leaves the order to the
    backend). ``x`` itself when M is 1."""
    if wg.M == 1:
        return x
    parts = _gather(x, wg, wg.M, wg.model_group, "model_sum")
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


@_counting
def model_redistribute(sends: Dict[int, torch.Tensor],
                       sizes: Dict[int, int],
                       wg: WorkerGroup) -> Dict[int, torch.Tensor]:
    """Send ``sends[k]`` (a flat tensor) to model index k of this rank's
    worker and return what each such peer k sends here, ``sizes[k]``
    elements of the same dtype, flat, on the sends' device: all of it in
    one ``batch_isend_irecv`` over the model group (host-staged for a
    host-staged group). Every rank of the group calls it with its own
    peers; a pair whose message is empty exchanges nothing. Counted as
    one ``model_redistribute`` call of the bytes this rank sends. The
    sharding plan's exchange of a rank's packed block for its plan shards
    and back (``launch.shardings.Redistribution``)."""
    if wg.M == 1 or not sends:
        return {}
    like = next(iter(sends.values()))
    ops, recvs, nbytes = [], {}, 0
    for k in sorted(sends):
        if k == wg.model_rank:
            raise ValueError("model_redistribute sends nothing to itself")
        peer = wg.rank * wg.M + k
        send = _wire(sends[k], wg)
        n = int(sizes[k]) * like.element_size()
        if send.numel():
            ops.append(dist.P2POp(dist.isend, send, peer, wg.group))
            nbytes += send.numel()
        if n:
            recvs[k] = torch.empty(n, dtype=torch.uint8, device=send.device)
            ops.append(dist.P2POp(dist.irecv, recvs[k], peer, wg.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    wg.count("model_redistribute", nbytes)
    out = {k: like.new_empty(0) for k in sends}
    out.update({k: _unwire(r, like, (r.numel() // like.element_size(),))
                for k, r in recvs.items()})
    return out


def barrier(wg: WorkerGroup) -> None:
    dist.barrier(group=wg.group)


# ------------------------- spawning the ranks -------------------------------


def _rank_main(fn: Callable, rank: int, workers: int, init_method: str,
               args: tuple, results: Any, threads: Optional[int]) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(workers),
                      LOCAL_WORLD_SIZE=str(workers))
    # one host: gloo on the loopback interface, whatever the host name
    # resolves to
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        results.put((rank, True, fn(rank, init_method, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, workers: int, args: tuple = (), *,
          timeout_s: Optional[float] = DEFAULT_TIMEOUT_S,
          threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, init_method, *args)`` in ``workers`` new processes
    (the ``spawn`` start method), the world of ``workers`` ranks, and
    return their results in rank order; worker groups over a prefix of
    it come from :func:`make_worker_group`.
    ``init_method`` is a ``file://`` store in a fresh temporary directory,
    for :func:`make_worker_group`; ``$RANK``, ``$LOCAL_RANK``,
    ``$WORLD_SIZE`` and ``$LOCAL_WORLD_SIZE`` are set as ``torchrun``
    sets them, and gloo uses the loopback interface. ``fn`` and its
    results must pickle; ``threads`` sets each rank's torch threads.

    Raises ``RuntimeError`` with the rank's traceback when a rank fails or
    dies, and ``TimeoutError`` when the ranks have not all returned after
    ``timeout_s`` (``None``: no deadline; a rank stuck in a collective
    still fails at its group's timeout); either way every rank is stopped
    first."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_group_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, workers, init_method, args,
                                   results, threads))
                 for r in range(workers)]
        for p in procs:
            p.start()
        try:
            out = _collect(procs, results, workers, timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)
    return [out[r] for r in range(workers)]


def _collect(procs, results, workers: int,
             timeout_s: Optional[float]) -> dict:
    """Drain the ranks' results (before any join); fail on the first
    error, on a rank that died without one, or at the deadline."""
    out = {}
    deadline = (math.inf if timeout_s is None
                else time.monotonic() + timeout_s)
    while len(out) < workers:
        try:
            rank, ok, val = results.get(timeout=1.0)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in out and p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(
                    f"rank {dead[0]} died with exit code "
                    f"{procs[dead[0]].exitcode} before returning")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(set(range(workers)) - set(out))} did "
                    f"not return within {timeout_s} s")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{val}")
        out[rank] = val
    return out
