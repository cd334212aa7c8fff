"""The host side of the port's CUDA ``fused_adam``, on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``); what its
wrapper works out on the host is held here: the f32 constants against
the ones JAX's kernel multiplies by, the ``ctypes`` argument types against
the C prototypes (a pointer passed as a 32-bit int would be cut), those of
the packed path's other kernels (``gossip.cu``, ``sign_compress.cu``) with
them, and the head / body / tail plan against a brute-force split.
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.kernels import fused_adam as tfa
from repro_torch.kernels import gossip as tgossip
from repro_torch.kernels import sign_compress as tsc

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"

ADAM_VARIANTS = {"plain": dict(tau=1e-6, weight_decay=0.0),
                 "weight_decay": dict(tau=1e-6, weight_decay=0.1),
                 "tau0": dict(tau=0.0, weight_decay=0.0)}
BETAS = {"default": dict(beta1=0.9, beta2=0.999),
         "0.95/0.98": dict(beta1=0.95, beta2=0.98)}


@pytest.mark.parametrize("betas", sorted(BETAS))
@pytest.mark.parametrize("variant", sorted(ADAM_VARIANTS))
def test_adam_consts_are_the_f32_values_jax_multiplies_by(variant, betas):
    """JAX's kernel takes Python-float closure constants, rounded to f32
    where they meet f32 arrays; 1 - beta is taken in double first."""
    hp = dict(eta=1e-3, **BETAS[betas], **ADAM_VARIANTS[variant])
    b1, b2 = hp["beta1"], hp["beta2"]
    want = [np.asarray(jnp.asarray(x, jnp.float32)) for x in (
        hp["eta"], b1, 1.0 - b1, b2, 1.0 - b2, hp["tau"],
        hp["weight_decay"])]
    got = tfa.adam_consts(hp["eta"], b1, b2, hp["tau"], hp["weight_decay"])
    assert [np.float32(x).tobytes() for x in got] == [
        w.tobytes() for w in want]
    # the struct the C entry reads holds the same bits
    struct, addr = tfa._consts_arg(hp["eta"], b1, b2, hp["tau"],
                                   hp["weight_decay"])
    assert addr == ctypes.addressof(struct)
    assert bytes(struct) == b"".join(w.tobytes() for w in want)
    assert tfa.adam_consts(hp["eta"], b1, b2, hp["tau"],
                           hp["weight_decay"]) is got


C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


def c_prototypes(path: Path) -> dict:
    """``{name: [ctypes type of each parameter]}`` of the ``extern "C"``
    functions of a CUDA source: a pointer is ``c_void_p``."""
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                   path.read_text()):
        types = []
        for param in params.split(","):
            decl = " ".join(param.split())
            if "*" in decl:
                types.append(ctypes.c_void_p)
            else:
                base = re.sub(r"\s*\w+$", "", decl.replace("const ", ""))
                types.append(C_TYPES[base])
        out[name] = types
    return out


FUSED_ADAM_CU = "src/repro_torch/csrc/fused_adam.cu"
# {(source, C entry): the argtypes its wrapper sets}: every entry of the
# packed path's sources, one a kernel (it takes the element widths), and
# the register-only design that scripts/fused_adam_ab.py calls as the kept
# kernel is called
ENTRIES = {
    (FUSED_ADAM_CU, "fused_adam"): tfa.ENTRY_ARGTYPES,
    (FUSED_ADAM_CU, "fused_adam_grid"): tfa.GRID_ARGTYPES,
    **{("src/repro_torch/csrc/gossip.cu", name): argtypes
       for name, argtypes in tgossip.ARGTYPES.items()},
    ("src/repro_torch/csrc/sign_compress.cu", "sign_compress"):
        tsc.ENTRY_ARGTYPES,
    ("src/repro_torch/csrc/sign_compress.cu", "sign_compress_grid"):
        tsc.GRID_ARGTYPES,
    ("scripts/fused_adam_regs.cu", "fused_adam"): tfa.ENTRY_ARGTYPES}


@pytest.mark.parametrize("source,name", sorted(ENTRIES))
def test_fused_adam_argtypes_match_the_c_prototypes(source, name):
    """The entry's parameters are the argtypes its wrapper sets, and the
    source has no entry that no wrapper loads."""
    protos = c_prototypes(ROOT / source)
    assert protos[name] == ENTRIES[source, name]
    if source.startswith("src/"):
        assert sorted(protos) == sorted(n for s, n in ENTRIES if s == source)


def test_tile_is_the_kernels():
    found = re.search(r"constexpr int kTile = (\d+);",
                      (CSRC / "fused_adam.cu").read_text())
    assert int(found.group(1)) == tfa.TILE


def brute_force_split(n, quantum, aligned):
    """The split that moves the most elements in 16-byte vectors, found
    by trying every start: ``aligned[h]`` says whether every operand is
    16-byte aligned at element h; from an aligned start as many whole
    quanta as fit. Returns (most, the first start that reaches it)."""
    heads = np.flatnonzero(aligned[:n + 1])
    bodies = (n - heads) // quantum * quantum
    if not len(heads) or bodies.max() == 0:
        return 0, None
    return int(bodies.max()), int(heads[np.argmax(bodies)])


# element offsets of the inputs and the outputs (p, g, m, v; po, mo, vo)
# from 16-byte boundaries, and the moments' bytes
@pytest.mark.parametrize("out_offset", range(4))
@pytest.mark.parametrize("in_offset", range(4))
@pytest.mark.parametrize("moment_size", [4, 2])
def test_plan_matches_a_brute_force_split(moment_size, in_offset,
                                          out_offset):
    quantum = 16 // moment_size
    base = 1 << 40
    sizes = (4, 4, moment_size, moment_size, 4, moment_size, moment_size)
    offsets = (in_offset,) * 4 + (out_offset,) * 3
    # operands 4 KiB apart, each `offset` elements past its boundary
    addrs = [(base + 4096 * k + off * size, size)
             for k, (off, size) in enumerate(zip(offsets, sizes))]
    elems = np.arange(601)
    aligned = np.all([(a + size * elems) % 16 == 0 for a, size in addrs],
                     axis=0)
    for n in range(601):
        head, body = tfa.plan(n, moment_size, *(a for a, _ in addrs))
        most, first = brute_force_split(n, quantum, aligned)
        assert 0 <= head and 0 <= body and head + body <= n
        assert body % quantum == 0
        assert body == most, (n, head, body, most)
        if body:
            assert head == first and head < quantum
