#!/usr/bin/env python
"""The A/B that chose ``fused_adam``'s design, on one NVIDIA GPU.

Times the kept kernel (``src/repro_torch/csrc/fused_adam.cu``: a ring of
bulk copies into shared memory, as the package builds it) beside
variants built from sources with the flags of
``repro_torch.kernels._build``: the register-only design
(``scripts/fused_adam_regs.cu``: 8 elements a thread, all loads issued
before the math, streaming hints), and the kept source and that one with
a constant or a cache hint replaced (``DESIGNS``). Every design is called
the same way: the wrapper's ``plan`` and cached constants, outputs made
once, so only the kernels differ. At the full-width DeepFM buffer ``(8,
89344, 128)`` f32, one ``comm='axis'`` rank's shard ``(1, 89344, 128)``,
the DeepFM buffer with bf16 moments and (``--lm``) llama3.2-1b's ``(2,
9655040, 128)`` f32 state it holds each design's outputs to the plain
version to the bit (not at the LM shape: seven buffers of 9.9 GB leave no
room for it), then times them in turns, in order and back: CUDA events
around REPS back-to-back calls, per call. Back to back, the host's
enqueue hides behind the card's work, so this is the kernel's device time
and the gaps between launches; chip_smoke.py's ``--parent`` gives the
profiler's device time of the kept kernel and the parent's. One JSON
line per case, then the card as ``nvidia-smi`` names it.

With ``--parent DIR`` (an earlier tree, unpacked with ``git archive``)
its ``csrc/fused_adam.cu`` joins as design "P", built the same way and
called through its own C interface (an entry per moment dtype,
``fused_adam_f32`` and ``fused_adam_f32_bf16m``, without the element
widths).
With ``--host`` it times the launch paths instead (``host_times``), the
parent's wrapper among them with ``--parent``.

    python scripts/fused_adam_ab.py [--lm] [--host] [--parent build/parent]
"""
import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_adam as fa  # noqa: E402

KEPT = _build.CSRC / "fused_adam.cu"
REGS = ROOT / "scripts" / "fused_adam_regs.cu"
ADAM = dict(eta=1e-3, beta1=0.9, beta2=0.999, tau=1e-6, weight_decay=0.0)
CASES = (("deepfm f32", (8, 89344, 128), torch.float32),
         ("shard K=1 f32", (1, 89344, 128), torch.float32),
         ("deepfm bf16 m and v", (8, 89344, 128), torch.bfloat16))
LM_CASE = ("lm f32", (2, 9655040, 128), torch.float32)
# streaming stores become plain ones
PLAIN_STORES = (r"__stcs\((.+?), (\w+)\);", r"*\1 = \2;")
# name: (what it is, its source (None: the package's own build), the
# regex substitutions made in that source)
DESIGNS = {
    "A": ("bulk-copy ring: bulk loads and stores, kTile 2048, 3 stages, "
          "evict-normal (kept)", None, ()),
    "A-1024x4": ("A with kTile 1024, 4 stages", KEPT,
                 ((r"kTile = 2048;", "kTile = 1024;"),
                  (r"kStages = 3;", "kStages = 4;"))),
    "A-first": ("A with an evict-first policy", KEPT,
                ((r"L2::evict_normal", "L2::evict_first"),)),
    "A-grid2": ("A with twice the resident blocks in its grid", KEPT,
                ((r"\*blocks = \(sms", "*blocks = 2 * (sms"),)),
    "B": ("register-only: 8 elements a thread, ld/st.global.cs", REGS, ()),
    "B-normal": ("B with __ldg loads and plain stores", REGS,
                 ((r"__ldcs\(", "__ldg("), PLAIN_STORES)),
}
REPS = 20
# --host: HOST_BATCHES rounds of HOST_CALLS calls at HOST_N elements
HOST_N = 128
HOST_CALLS = 1000
HOST_BATCHES = 10


# the parent's entries: p, g, m, v, po, mo, vo, n, head, body, the
# constants' address, the stream
PARENT_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 2)


def build_variants():
    """nvcc every design with a source into build/ (gitignored), all at
    once; returns {name: (library, ptxas lines)}."""
    out = _build.BUILD_ROOT / "fused_adam_ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, source, subs) in DESIGNS.items():
        if source is None:
            continue
        text = source.read_text()
        for pattern, repl in subs:
            text, hits = re.subn(pattern, repl, text)
            if not hits:
                raise RuntimeError(f"{name}: {pattern!r} not in {source}")
        src = out / f"{name}.cu"
        src.write_text(text)
        lib = out / f"lib{name}.so"
        include = source.parent if name == "P" else _build.CSRC
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(include),
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        built[name] = (ctypes.CDLL(str(lib)), ptxas_lines(log))
    return built


def ptxas_lines(log: str) -> list:
    return [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
            if "Used" in ln]


def entry(lib, design, moment_dtype):
    """The design's C entry for f32 params and ``moment_dtype``
    moments."""
    if design == "P":
        fn = getattr(lib, "fused_adam_f32" + (
            "_bf16m" if moment_dtype is torch.bfloat16 else ""))
        fn.argtypes = PARENT_ARGTYPES
    else:
        fn = lib.fused_adam
        fn.argtypes = fa.ENTRY_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def caller(design, fn, ins, outs):
    """One launch of ``fn`` on ``ins`` into ``outs``, everything but the
    call itself worked out beforehand."""
    p, g, m, v = ins
    ptrs = tuple(t.data_ptr() for t in (p, g, m, v, *outs))
    n = p.numel()
    head, body = fa.plan(n, m.element_size(), *ptrs)
    args = (head, body, fa._consts_arg(*ADAM.values())[1])
    if design != "P":
        args += (p.element_size(), m.element_size())
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        status = fn(*ptrs, n, *args, stream)
        if status:
            raise RuntimeError(f"launch failed: cudaError_t {status}")
    return call


def events_ms(call, reps: int) -> float:
    """CUDA events around ``reps`` back-to-back calls, per call."""
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_case(name, shape, mdt, fns, reps):
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = torch.randn(shape, generator=gen, device="cuda")
    g = torch.randn(shape, generator=gen, device="cuda") * 0.1
    m = (torch.randn(shape, generator=gen, device="cuda") * 0.01).to(mdt)
    v = (torch.rand(shape, generator=gen, device="cuda") * 0.01).to(mdt)
    outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
    n = p.numel()
    rec = {"case": name, "shape": list(shape), "moments": str(mdt),
           "bytes": n * (3 * 4 + 4 * m.element_size()),
           "plan": fa.plan(n, m.element_size(), *(
               t.data_ptr() for t in (p, g, m, v, *outs)))}
    calls = {d: caller(d, fns[d][mdt], (p, g, m, v), outs) for d in fns}
    if name != LM_CASE[0]:
        want = fa.fused_adam_plain(p, g, m, v, **ADAM)
        for d, call in calls.items():
            call()
            torch.cuda.synchronize()
            rec[f"{d}_bit_equal"] = all(torch.equal(a, b)
                                        for a, b in zip(outs, want))
            rec[f"{d}_max_abs_err"] = max(
                float((a.double() - b.double()).abs().max())
                for a, b in zip(outs, want))
        del want
    turns = {d: [] for d in calls}
    for d in list(calls) + list(calls)[::-1]:
        turns[d].append(events_ms(calls[d], reps))
    for d, (label, _, _) in DESIGNS.items():
        rec[d] = {"design": label, "turns": turns[d],
                  "ms": statistics.median(turns[d])}
    print(json.dumps(rec), flush=True)
    del p, g, m, v, outs, calls
    torch.cuda.empty_cache()


def parent_module(parent: str):
    """The parent tree's ``kernels/fused_adam.py`` loaded beside this
    tree's, as ``parent_fused_adam``: while it runs, its own ``_build``
    (which builds the parent's sources in the parent's tree) stands in
    for ``repro_torch.kernels._build``."""
    import importlib.util

    import repro_torch.kernels as kernels

    src = Path(parent).resolve() / "src" / "repro_torch" / "kernels"

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    own = kernels._build
    kernels._build = sys.modules["repro_torch.kernels._build"] = load(
        "parent_build", src / "_build.py")
    try:
        return load("parent_fused_adam", src / "fused_adam.py")
    finally:
        kernels._build = sys.modules["repro_torch.kernels._build"] = own


def host_times(parent):
    """The launch path alone: HOST_BATCHES rounds, each a batch of
    HOST_CALLS back-to-back calls at HOST_N elements of every candidate
    in turn (the card synchronised around each batch), wall µs a call:
    the wrapper, the parent's wrapper, ``torch._fused_adam_``, and two
    parts of the wrapper alone: its three output allocations and its C
    entry called with every argument worked out beforehand. The rest of
    the wrapper is its Python checks, plan and cached constants."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    p, g, m, v = (torch.rand(HOST_N, generator=gen, device="cuda") * 0.01
                  for _ in range(4))
    outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
    step = torch.tensor(1e7, device="cuda")
    cands = {
        "wrapper": lambda: fa.fused_adam(p, g, m, v, **ADAM),
        "torch._fused_adam_": lambda: torch._fused_adam_(
            [p], [g], [m], [v], [], [step], lr=ADAM["eta"],
            beta1=ADAM["beta1"], beta2=ADAM["beta2"],
            weight_decay=ADAM["weight_decay"], eps=ADAM["tau"],
            amsgrad=False, maximize=False),
        "three empty_like": lambda: (torch.empty_like(p),
                                     torch.empty_like(m),
                                     torch.empty_like(v)),
        "C entry alone": caller("A", fa._entry(),
                                (p, g, m, v), outs)}
    if parent:
        pfa = parent_module(parent)
        cands["parent's wrapper"] = lambda: pfa.fused_adam(p, g, m, v,
                                                           **ADAM)
    times = {name: [] for name in cands}
    for r in range(HOST_BATCHES):
        names = list(cands)
        for name in names[r % len(names):] + names[:r % len(names)]:
            fn = cands[name]
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
    return {"host_n": HOST_N, "calls": HOST_CALLS, "batches": {
        name: {"median_us": statistics.median(t), "min_us": min(t),
               "us": t} for name, t in times.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree whose "
                    "csrc/fused_adam.cu joins as design P")
    ap.add_argument("--lm", action="store_true",
                    help="also time llama3.2-1b's (2, 9655040, 128) state "
                         "(69 GB of buffers)")
    ap.add_argument("--host", action="store_true",
                    help="time the launch paths instead (host_times)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_adam_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.host:
        print(json.dumps(host_times(args.parent)), flush=True)
        print(nvidia_smi(), flush=True)
        return 0
    if args.parent:
        DESIGNS["P"] = ("the parent's kernel", Path(args.parent).resolve()
                        / "src" / "repro_torch" / "csrc" / "fused_adam.cu",
                        ())
    built = build_variants()
    kept = _build.load("fused_adam")
    kept_log = (_build.build()["fused_adam"].parent
                / "libfused_adam.log").read_text()
    built["A"] = (kept, ptxas_lines(kept_log))
    fns = {d: {t: entry(built[d][0], d, t) for t in fa.MOMENT_DTYPES}
           for d in DESIGNS}
    print(json.dumps({"ptxas": {d: built[d][1] for d in DESIGNS}}),
          flush=True)
    for name, shape, mdt in CASES + ((LM_CASE,) if args.lm else ()):
        run_case(name, shape, mdt, fns, 5 if name == LM_CASE[0] else REPS)
    print(nvidia_smi(), flush=True)
    return 0


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
