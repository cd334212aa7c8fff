"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<digest>/lib<name>.so``, a
shared library with a plain C interface that the kernel modules load with
``ctypes``. ``<digest>`` hashes the sources, headers and flags, so an edit
rebuilds and an unchanged checkout reuses what it built. The sources are
compiled in parallel, one ``nvcc`` per source, at first use; nothing is
built or loaded when a module is imported. A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("fused_adam", "gossip", "sign_compress", "flash_attention",
           "rwkv_scan")

# sm_90a keeps Hopper-only instructions open to later kernels. No fast
# math: the kernels' sqrt and division stay IEEE, and FMA contraction is
# off so each product and sum rounds as in the plain PyTorch versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600


def nvcc_path() -> str:
    """``nvcc`` on the PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``). Raises ``RuntimeError`` when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME "
        f"({home}); the CUDA kernels of repro_torch are built from "
        f"{CSRC} at first use and need the CUDA toolkit")


def digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(names: Iterable[str] = SOURCES,
          root: Path = BUILD_ROOT) -> Dict[str, Path]:
    """Build the named sources that are not built yet and return
    ``{name: path of the .so}``. The compiler's resource report
    (``-Xptxas -v``) is kept beside each library as ``lib<name>.log``."""
    out_dir = Path(root) / digest()
    libs = {n: out_dir / f"lib{n}.so" for n in names}
    todo = [n for n, p in libs.items() if not p.is_file()]
    if not todo:
        return libs
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out_dir / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failures = []
    for n, (tmp, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failures.append(f"{n}: nvcc timed out after {BUILD_TIMEOUT_S} s")
            continue
        (out_dir / f"lib{n}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        # atomic: a concurrent build sees a whole library or none
        os.replace(tmp, libs[n])
    if failures:
        raise RuntimeError("building the CUDA kernels failed:\n"
                           + "\n".join(failures))
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed, every source at once) and load ``lib<name>.so``."""
    return ctypes.CDLL(str(build()[name]))


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")


def launch(entry, device: torch.device, *args) -> int:
    """Call the C entry point with ``args`` and then the current stream of
    ``device``, with ``device`` current. It switches the current device
    only when another one is current, and reads the raw stream handle
    (``torch.cuda.current_stream`` builds a Stream object): both cost more
    host time than a short kernel takes on the card."""
    if device.index == torch.cuda.current_device():
        return entry(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return entry(*args, torch.cuda.current_stream().cuda_stream)
