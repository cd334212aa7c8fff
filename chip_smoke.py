#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``src/repro_torch`` (never ``jax`` or ``repro``) on ``cuda:0`` in
phases, each printing one JSON line; a failing phase raises, and the
script exits non-zero without the final ``ok`` line:

1. env: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: compiles ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a);
3. kernels: each CUDA kernel against its plain PyTorch version at the main
   path's shape, the resident ``(8, 89344, 128)`` f32 state of full-width
   DeepFM on a K=8 ring (``sign_compress_stacked`` over DeepFM's 11 leaf
   segments and over the whole buffer; ``sign_compress`` over one
   worker's 11,202,602 elements), with CUDA-event times (median of 20
   after warm-up) beside the least time the card's memory rate allows;
   then the CD-Adam neighbour-copy update, plain torch ops, timed alone;
4. slice, once per path: the paper's experiment through the user's entry
   points, ``launch.deepfm_ctr.run`` (DeepFM 39 fields x 25,000 features,
   embed 10, MLP 400-400-400, K=8 ring, packed, p=4, 512 examples per
   worker, 20 ``fit`` steps) then one ``opt.round`` of p=4: D-Adam, then
   CD-Adam with the sign compressor (gamma 0.4). The launch counters are
   zeroed just before each path and read just after: every kernel of the
   path must have run, and exactly as often as the schedule says; a
   profile of one communication period follows each;
5. card vs CPU: three steps (p=3) of each path from one init and one set
   of batches on the card (kernels) and on the CPU (plain versions) must
   agree.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without CUDA it exits 2 at once.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
K = 8
SHAPE = (K, 89344, 128)          # the resident buffer of full-width DeepFM
FULL = dict(n_fields=39, features_per_field=25_000, embed_dim=10,
            hidden=(400, 400, 400), per_worker=512)
ETA = 1e-3
REPS = 20
# A kernel and its plain version run the same f32 operations in the same
# order (the kernels are built without FMA contraction), so they agree to
# the last bit but for rsqrtf's approximation, which the main path
# (tau > 0) does not reach.
KERNEL_TOL = dict(rtol=1e-6, atol=1e-6)
# Card against CPU: after the first step (same params, same batch) the
# only differences are summation orders (cuBLAS against the CPU BLAS, the
# card's embedding backward accumulating with atomics), far inside the
# repo's optimizer-state tolerance. From the second step on they are not
# rounding-sized: a parameter difference of ~3e-8 flips the ReLU gate of
# the pre-activations that lie that close to zero (many, at this init
# and Adam's sign-like first step), which moves some gradients by percents,
# and Adam's normalised step turns that into parameter differences of a
# fraction of eta in a small share of the elements (measured on the H100:
# 0.023% of the elements, at most 0.11 eta, after 3 steps). So after step
# 3 the losses must agree to the tolerance, and the parameters outside it
# must be few (<= 1%) and each within eta; a fault of the port (a wrong
# leaf, worker or neighbour) breaks step 1 or whole leaves.
CARD_CPU_TOL = dict(rtol=2e-5, atol=2e-6)
CARD_CPU_MAX_SHARE = 0.01
# the H100 SXM's data-sheet memory rate (bytes/s) and f32 rate outside
# the tensor cores (operations/s), at its full 700 W power limit
MEM_RATE = 3.35e12
F32_RATE = 67e12
# The sign-compression scale is a sum: the kernel adds tiles and then a
# fixed tree, the plain version calls torch.sum, so the two differ by the
# order of the sum. q must be equal; hat moves by scale * sign and may
# differ by that scale error on top of KERNEL_TOL.
SCALE_RTOL = 1e-5
BIT_EQUAL = dict(rtol=0.0, atol=0.0)
GAMMA = 0.4
# per-worker bytes of full-width DeepFM on the wire per round, ring (two
# neighbours): D-Adam sends the f32 params, CD-Adam an int8 sign per
# parameter and one f32 scale per leaf (11 leaves)
PARAMS = 11_202_602
WIRE_BYTES = {"d-adam": 2 * 4 * PARAMS, "cd-adam": 2 * (PARAMS + 11 * 4)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(got, want, tol, what: str):
    """Max abs and rel error of ``got`` against ``want``; raises past
    ``|got - want| <= atol + rtol * |want|``."""
    max_abs = max_rel = 0.0
    for a, b in zip(got, want):
        d = (a.double() - b.double()).abs()
        max_abs = max(max_abs, float(d.max()))
        max_rel = max(max_rel, float((d / b.double().abs().clamp_min(
            1e-30)).max()))
        bad = int((d > tol["atol"] + tol["rtol"] * b.double().abs()).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} elements outside {tol}; "
                                 f"max abs err {max_abs:.3g}")
    return max_abs, max_rel


def compare_compressed(got, want, what: str):
    """q equal, scales within SCALE_RTOL, hat within KERNEL_TOL plus the
    scale error. Returns the max abs error over the three and the scales'
    max rel error (a hat element that is 0 in one version and a rounding
    of 0 in the other has no meaningful relative error)."""
    q, scale, hat = got
    if not torch.equal(q, want[0]):
        raise AssertionError(f"{what}: q differs in "
                             f"{int((q != want[0]).sum())} elements")
    errs = [compare([scale], [want[1]], dict(rtol=SCALE_RTOL, atol=0.0),
                    f"{what} scale")]
    slack = float(want[1].abs().max()) * SCALE_RTOL
    errs.append(compare([hat], [want[2]],
                        dict(rtol=KERNEL_TOL["rtol"],
                             atol=KERNEL_TOL["atol"] + slack), f"{what} hat"))
    return max(e[0] for e in errs), errs[0][1]


def full_width_spec():
    """The resident layout of full-width DeepFM over K workers (shapes
    only: the stacked tree is made on the meta device)."""
    from repro_torch._tree import tree_map
    from repro_torch.kernels import pack as packing
    from repro_torch.models.deepfm import init_deepfm

    one = init_deepfm(torch.Generator().manual_seed(0),
                      FULL["n_fields"] * FULL["features_per_field"],
                      FULL["n_fields"], FULL["embed_dim"], FULL["hidden"])
    stacked = tree_map(lambda x: torch.empty((K,) + tuple(x.shape),
                                             device="meta"), one)
    spec = packing.make_spec(stacked, stacked=True,
                             block_rows=packing.BLOCK_ROWS, leaf_align=True)
    if spec.buf_shape() != SHAPE or spec.n != PARAMS:
        raise AssertionError(f"layout {spec.buf_shape()}, {spec.n} params")
    return spec


def phase_env():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit({"phase": "env", "nvidia_smi": smi, "device": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return name, smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build()
    seconds = time.perf_counter() - t0
    # ptxas names each entry function (mangled: "<length><name>_kernel")
    # before its resource line
    regs = {}
    for name, lib in libs.items():
        log = (lib.parent / f"lib{name}.log").read_text()
        entry = "?"
        for ln in log.splitlines():
            found = re.search(r"entry function '.*?\d+([a-z_]+_kernel)E", ln)
            if found:
                entry = found.group(1)
            elif "Used" in ln:
                regs[f"{name}:{entry}"] = ln.split("ptxas info    : ")[-1]
    emit({"phase": "build", "seconds": round(seconds, 3),
          "libs": {n: str(p.relative_to(ROOT)) for n, p in libs.items()},
          "ptxas": regs})


def phase_kernels():
    """Each kernel against its plain version on the card at the main
    path's shape; returns the kernel records without launch counts."""
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import fused_adam as fa
    from repro_torch.kernels import gossip as gk
    from repro_torch.kernels import pack as packing
    from repro_torch.kernels import sign_compress as sc

    gen = torch.Generator(device="cuda").manual_seed(0)
    p = torch.randn(SHAPE, generator=gen, device="cuda")
    g = torch.randn(SHAPE, generator=gen, device="cuda") * 0.1
    m = torch.randn(SHAPE, generator=gen, device="cuda") * 0.01
    v = torch.rand(SHAPE, generator=gen, device="cuda") * 0.01
    # CD-Adam's operands: x, hat_self and the ring's two neighbour copies,
    # zero in the layout's padding as on the main path
    spec = full_width_spec()
    ranges = packing.leaf_row_ranges(spec)
    true = torch.zeros(spec.padded, dtype=torch.bool, device="cuda")
    for o, sz in zip(spec.offsets, spec.sizes):
        true[o:o + sz] = True
    true = true.reshape(1, *SHAPE[1:])
    x, hs, hn1, hn2 = (torch.randn(SHAPE, generator=gen, device="cuda")
                       * true for _ in range(4))
    xs = torch.randn(PARAMS, generator=gen, device="cuda")
    hs1 = torch.randn(PARAMS, generator=gen, device="cuda")
    topo = make_topology("ring", K)
    mix = (topo.offsets, topo.offset_weights, topo.self_weight)
    deg = len(topo.offsets)
    adam = dict(eta=ETA, beta1=0.9, beta2=0.999, tau=1e-6, weight_decay=0.0)
    W = torch.as_tensor(topo.weights, dtype=torch.float32, device="cuda")
    buf_bytes = p.numel() * p.element_size()
    n = p.numel()
    # f32 operations per element: Adam half-step 12 (3 for m, 4 for v, 4
    # for the step incl. sqrt and division, 1 for p); mix 1 + 2 per offset
    cases = [
        dict(name="fused_adam", source="src/repro_torch/csrc/fused_adam.cu",
             replaces="src/repro/kernels/fused_adam.py:66",
             kernel=lambda: fa.fused_adam(p, g, m, v, **adam),
             plain=lambda: fa.fused_adam_plain(p, g, m, v, **adam),
             library=None, bytes=7 * buf_bytes, ops=12 * n),
        dict(name="gossip_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:124",
             kernel=lambda: (gk.gossip_mix(p, *mix),),
             plain=lambda: (gk.gossip_mix_plain(p, *mix),),
             library=lambda: torch.einsum("kj,jrc->krc", W, p),
             bytes=2 * buf_bytes, ops=(1 + 2 * deg) * n),
        dict(name="gossip_adam_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:258",
             kernel=lambda: gk.gossip_adam_mix(p, g, m, v, *mix, **adam),
             plain=lambda: gk.gossip_adam_mix_plain(p, g, m, v, *mix,
                                                    **adam),
             library=None, bytes=7 * buf_bytes,
             ops=((deg + 1) * 12 + 1 + 2 * deg) * n),
        # consensus: per offset a subtraction, a product and a sum, then
        # gamma's product and the sum with x
        dict(name="consensus_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:307",
             kernel=lambda: (gk.consensus_mix(x, hs, (hn1, hn2),
                                              topo.offset_weights, GAMMA),),
             plain=lambda: (gk.consensus_mix_plain(
                 x, hs, (hn1, hn2), topo.offset_weights, GAMMA),),
             tol=BIT_EQUAL, library=None, bytes=(3 + deg) * buf_bytes,
             ops=(2 + 3 * deg) * n),
        # sign compress: read x and hat, write hat and the int8 q (13 bytes
        # an element); d, |d|, the sum, sign (two compares and a
        # subtraction), scale * sign and the sum with hat
        dict(name="sign_compress_stacked",
             source="src/repro_torch/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:174",
             kernel=lambda: sc.sign_compress_stacked(
                 x, hs, n_true=spec.sizes, row_ranges=ranges),
             plain=lambda: sc.sign_compress_stacked_plain(
                 x, hs, n_true=spec.sizes, row_ranges=ranges),
             compressed=True, library=None, bytes=13 * n, ops=8 * n,
             variant="scales='leaf': DeepFM's 11 leaf segments, (K, 11) "
                     "scales"),
        dict(name="sign_compress_stacked",
             source="src/repro_torch/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:174",
             kernel=lambda: sc.sign_compress_stacked(x, hs, n_true=spec.n),
             plain=lambda: sc.sign_compress_stacked_plain(x, hs,
                                                          n_true=spec.n),
             compressed=True, library=None, bytes=13 * n, ops=8 * n,
             variant="scales='worker': one segment, (K,) scales"),
        dict(name="sign_compress",
             source="src/repro_torch/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:65",
             kernel=lambda: sc.sign_compress(xs, hs1),
             plain=lambda: sc.sign_compress_plain(xs, hs1),
             compressed=True, library=None, bytes=13 * PARAMS,
             ops=8 * PARAMS,
             variant="one worker's 11,202,602 elements, flat"),
    ]
    records = []
    for c in cases:
        got = c["kernel"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        tol = c.get("tol", KERNEL_TOL)
        if c.get("compressed"):
            tol = {"q": "equal", "scale_rtol": SCALE_RTOL,
                   "hat": f"{KERNEL_TOL} + max scale * {SCALE_RTOL}"}
            max_abs, max_rel = compare_compressed(got, want, c["name"])
        else:
            max_abs, max_rel = compare(got, want, tol, c["name"])
        del got, want
        ms = median_ms(c["kernel"])
        plain_ms = median_ms(c["plain"])
        library_ms = (median_ms(c["library"])
                      if c["library"] is not None else None)
        t_bytes = c["bytes"] / MEM_RATE * 1e3
        t_ops = c["ops"] / F32_RATE * 1e3
        rec = {"name": c["name"], "route": "cuda", "source": c["source"],
               "replaces": c["replaces"], "launches": None,
               "max_abs_err": max_abs, "max_rel_err": max_rel,
               "tol": tol, "ms": ms, "kernel_ms": ms,
               "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": c["bytes"], "library_ms": library_ms,
               "library": ("torch.einsum('kj,jrc->krc', W, x)"
                           if c["library"] is not None else
                           "none: no single PyTorch call computes this "
                           "update")}
        if "variant" in c:
            rec["variant"] = c["variant"]
        emit({"phase": "kernel", **rec})
        records.append(rec)

    # CD-Adam's neighbour-copy update is plain torch ops on the main path
    # (no kernel of its own): shift q and the (K, 11) scales per offset,
    # spread the scales over the leaves' rows, multiply and add
    from repro_torch.core.cdadam import update_nbr_hats
    q, scales, _ = sc.sign_compress_stacked(x, hs, n_true=spec.sizes,
                                            row_ranges=ranges)
    nbr_ms = median_ms(lambda: update_nbr_hats((hn1, hn2), q, scales, topo,
                                               ranges))
    # each neighbour copy is read and written once, q read once per offset
    nbr_bytes = deg * (2 * buf_bytes + n)
    emit({"phase": "torch_ops", "name": "cdadam.update_nbr_hats",
          "ms": nbr_ms, "bound_ms": nbr_bytes / MEM_RATE * 1e3,
          "bytes": nbr_bytes, "offsets": deg})
    return records


SCHEDULES = {
    # steps 20 at p=4 then one opt.round of p=4. D-Adam: the local steps
    # take fused_adam, each comm step one gossip_adam_mix, the round's mix
    # gossip_mix. CD-Adam: every step takes fused_adam, each comm round
    # one consensus_mix and one sign_compress_stacked (all 11 leaves).
    "d-adam": {"fused_adam": 19, "gossip_adam_mix": 5, "gossip_mix": 1},
    "cd-adam": {"fused_adam": 24, "consensus_mix": 6,
                "sign_compress_stacked": 6},
}


def phase_slice(kind: str, **opt_kw):
    """The paper's experiment at full width through the entry points,
    with the launch counters zeroed just before and read just after; then
    a few more steps, timed one by one, and a profile of one period."""
    from repro_torch._tree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch import deepfm_ctr

    period, steps, timed = 4, 20, 8
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = deepfm_ctr.run(f"{kind} p={period}, paper width", "deepfm", kind,
                         steps, backend="packed", device=DEVICE,
                         period=period, log_every=1, **opt_kw, **FULL)
    trainer, opt = res.trainer, res.trainer.opt
    round_batches = [next(res.batches) for _ in range(period)]
    batches = tree_map(lambda *xs: torch.stack(xs), *round_batches)

    def grad_fn(buf, batch):
        state = dataclasses.replace(res.state, buf=buf)
        return trainer.pipeline.value_and_grad(state, batch)[1]

    state = opt.round(res.state, grad_fn, batches)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {name: SCHEDULES[kind].get(name, 0) for name in launches}
    if launches != want:
        raise AssertionError(f"{kind}: launches {launches} != schedule "
                             f"{want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = res.log.loss
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{kind}: non-finite loss in {losses}")
    # init and batches come from fixed seeds, so the sequence is the same
    # in every run on this card
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{kind}: loss did not fall: {losses}")
    if not bool(torch.isfinite(state.buf).all()):
        raise AssertionError(f"{kind}: non-finite params after opt.round")
    wire = opt.comm_bytes_per_round(opt.params_of(state))
    if wire != WIRE_BYTES[kind]:
        raise AssertionError(f"{kind}: {wire} bytes per round, expected "
                             f"{WIRE_BYTES[kind]}")
    auc_after_round = deepfm_ctr.heldout_auc(
        res.teacher, trainer.averaged_params(state),
        deepfm_ctr.MODELS["deepfm"][2])

    # step times: a synchronised stamp after each of a few more steps,
    # which log only at their end (after the last stamp)
    stamps = []

    def hook(step, st):
        torch.cuda.synchronize()
        stamps.append((st.count, time.perf_counter()))

    torch.cuda.synchronize()
    stamps.append((state.count, time.perf_counter()))
    state, _ = trainer.fit(state, res.batches, timed, log_every=timed,
                           hook=hook, hook_every=1)
    dts = [((c, (t - t0) * 1e3)) for (_, t0), (c, t) in
           zip(stamps, stamps[1:])]
    emit({"phase": "slice", "kind": kind,
          "config": {"K": K, "topology": "ring", "period": period,
                     "steps": steps, **opt_kw, **FULL,
                     "hidden": list(FULL["hidden"])},
          "buffer_shape": list(state.buf.shape),
          "params_per_worker": state.spec.n,
          "losses": losses,
          "step_ms_median": statistics.median(d for _, d in dts),
          "local_step_ms_median": statistics.median(
              d for c, d in dts if c % period),
          "comm_step_ms_median": statistics.median(
              d for c, d in dts if c % period == 0),
          "timed_steps": timed,
          "auc_after_fit": res.auc, "auc_after_round": auc_after_round,
          "comm_mb_fit": res.log.comm_mb[-1],
          "comm_mb_per_round": trainer.comm_mb_per_round(state),
          "comm_bytes_per_round": wire,
          "consensus": res.log.consensus[-1],
          "peak_mem_gb": peak_gb, "launches": launches})
    phase_profile(kind, trainer, state, [next(res.batches)
                                         for _ in range(period)])
    return launches


def phase_profile(kind, trainer, state, batches):
    """Device time by kernel over one communication period of steps, the
    device's busy share of the window's wall time, and the device time of
    the port's named ranges (``repro_torch.*``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, _ = trainer.step(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, ranges = [], {}
    for e in prof.key_averages():
        if e.key.startswith("repro_torch."):
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            got = ranges.setdefault(e.key, {"device_ms": 0.0, "calls": 0})
            got["device_ms"] = max(got["device_ms"], total / 1e3)
            got["calls"] = max(got["calls"], e.count)
            continue
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3, e.count, e.key[:90]))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    emit({"phase": "profile", "kind": kind, "steps": len(batches),
          "wall_ms": wall_ms, "device_ms": device_ms,
          "busy_share": device_ms / wall_ms if wall_ms else None,
          "ranges": ranges,
          "top": [{"kernel": k, "ms": ms, "calls": n}
                  for ms, n, k in rows[:16]]})


def state_tensors(state):
    """The resident buffers of a packed state, by name, on the CPU."""
    out = {n: getattr(state, n).cpu() for n in ("buf", "m", "v")}
    if hasattr(state, "hat_buf"):
        out["hat_buf"] = state.hat_buf.cpu()
        for i, h in enumerate(state.hat_nbr_bufs):
            out[f"hat_nbr_bufs[{i}]"] = h.cpu()
    return out


def step3_check(name, a, b):
    """Step 3 against the CPU: few elements outside the tolerance, each
    within eta. A hat element is ``scale * sign(x - hat)``: where the
    parameter lies within the card-CPU difference of the old hat, the sign
    may flip between the two; such flips are counted (and may be no more
    than the share allowed), not held to eta."""
    d = (a.double() - b.double()).abs()
    outside = d > CARD_CPU_TOL["atol"] + CARD_CPU_TOL["rtol"] * b.double().abs()
    flips = (outside & (torch.sign(a) != torch.sign(b))
             if name.startswith("hat") else torch.zeros_like(outside))
    rest = d[~flips]
    rec = {"max_abs_err": float(rest.max()) if rest.numel() else 0.0,
           "share_outside": float(outside.double().mean()),
           "sign_flips": int(flips.sum()),
           "share_flipped": float(flips.double().mean())}
    if (rec["share_outside"] > CARD_CPU_MAX_SHARE
            or rec["max_abs_err"] > ETA):
        raise AssertionError(f"step 3 {name}: {rec} past share "
                             f"{CARD_CPU_MAX_SHARE} / max {ETA}")
    return rec


def phase_card_vs_cpu(kind: str, **opt_kw):
    """Three steps (period 3: two fused_adam steps, then a communication
    step) from one init and one set of batches, on the card and on the
    CPU."""
    from repro_torch.core.api import make_optimizer
    from repro_torch.data.synthetic import (ctr_batch_stacked, ctr_teacher,
                                            make_ctr_task)
    from repro_torch.models.deepfm import deepfm_loss, init_deepfm
    from repro_torch.train.loop import DecentralizedTrainer

    task = make_ctr_task(seed=0, n_fields=FULL["n_fields"],
                         features_per_field=FULL["features_per_field"],
                         embed_dim=FULL["embed_dim"])
    teacher = ctr_teacher(task, "cpu")
    params = init_deepfm(torch.Generator().manual_seed(0), task.n_features,
                         task.n_fields, FULL["embed_dim"], FULL["hidden"])
    gen = torch.Generator().manual_seed(1)
    batches = [ctr_batch_stacked(teacher, gen, K, FULL["per_worker"])
               for _ in range(3)]
    out = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        opt = make_optimizer(kind, K, eta=ETA, period=3, topology="ring",
                             backend="packed", device=dev, **opt_kw)
        tr = DecentralizedTrainer(deepfm_loss, opt)
        it = iter(batches)
        state, log = tr.fit(tr.init(params), it, 1, log_every=1)
        first = state_tensors(state)
        state, log = tr.fit(state, it, 2, log_every=1, log=log)
        out[dev] = (first, state_tensors(state), log.loss,
                    time.perf_counter() - t0)
        del opt, tr, state
        torch.cuda.empty_cache()
    (c1, c3, closs, ct), (h1, h3, hloss, ht) = out[DEVICE], out["cpu"]
    step1 = {n: compare([c1[n]], [h1[n]], CARD_CPU_TOL, f"step 1 {n}")[0]
             for n in c1}
    loss_err = compare([torch.tensor(closs)], [torch.tensor(hloss)],
                       CARD_CPU_TOL, "losses")[0]
    step3 = {n: step3_check(n, c3[n], h3[n]) for n in c3}
    emit({"phase": "card_vs_cpu", "kind": kind, "steps": 3, "period": 3,
          "losses_card": closs, "losses_cpu": hloss, "loss_max_abs_err":
          loss_err, "step1_max_abs_err": step1, "step3": step3,
          "tol": CARD_CPU_TOL, "max_share_outside": CARD_CPU_MAX_SHARE,
          "seconds_card": ct, "seconds_cpu": ht})


def main() -> int:
    card, smi = phase_env()
    phase_build()
    records = phase_kernels()
    cd_adam = dict(gamma=GAMMA, compressor="sign")
    by_path = {"d-adam": phase_slice("d-adam"),
               "cd-adam": phase_slice("cd-adam", **cd_adam)}
    phase_card_vs_cpu("d-adam")
    phase_card_vs_cpu("cd-adam", **cd_adam)
    for rec in records:
        rec["launches_by_path"] = {k: c[rec["name"]]
                                   for k, c in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
