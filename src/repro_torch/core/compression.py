"""delta-contraction compression operators (Definition 2), the port of
``repro.core.compression``.

A compressor Q satisfies  ||x - Q(x)||^2 <= (1 - delta) ||x||^2  with
delta in (0, 1]. The paper's experiments use the (scaled) sign operator.

Each operator comes in two forms:

* ``apply(x) -> Q(x)``: the operator CD-Adam's update uses;
* ``encode(x) -> payload`` / ``decode(payload, shape, dtype) -> Q(x)``: the
  wire format. Payload tensors use narrow dtypes (int8 sign bits, top-k
  value/index pairs), which is what ``wire_bytes`` counts.

``randk`` draws its coordinates from a seeded ``torch.Generator`` unless it
is given an ``indices(d) -> LongTensor`` callable: torch cannot reproduce
``jax.random``'s draw, so a parity test passes the JAX draw in through it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.kernels.fused_adam import f32

Payload = Any  # a tensor or a dict of tensors


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A delta-contraction operator with an explicit wire format."""

    name: str
    apply: Callable[[torch.Tensor], torch.Tensor]
    encode: Callable[[torch.Tensor], Payload]
    decode: Callable[[Payload, Tuple[int, ...], torch.dtype], torch.Tensor]
    # lower bound on delta for a d-dim input
    delta_bound: Callable[[int], float]
    # bytes on the wire for a given (shape, dtype)
    wire_bytes: Callable[[Tuple[int, ...], torch.dtype], int]

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x), tuple(x.shape), x.dtype)


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _k_of(fraction: float) -> Callable[[int], int]:
    if not 0.0 < fraction <= 1.0:
        raise ValueError("fraction must be in (0, 1]")
    return lambda d: max(1, int(round(d * fraction)))


def _scatter_decode(p, shape, dtype) -> torch.Tensor:
    out = torch.zeros(math.prod(shape), dtype=dtype,
                      device=p["values"].device)
    out[p["indices"].long()] = p["values"].to(dtype)
    return out.reshape(shape)


def identity() -> Compressor:
    """delta = 1: CD-Adam degenerates towards D-Adam."""
    return Compressor(
        name="identity",
        apply=lambda x: x,
        encode=lambda x: x,
        decode=lambda p, shape, dtype: p.to(dtype).reshape(shape),
        delta_bound=lambda d: 1.0,
        wire_bytes=_nbytes,
    )


def _l1_scale(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x)) / f32(x.numel())


def sign() -> Compressor:
    """Scaled sign: Q(x) = (||x||_1 / d) * sign(x); wire: an int8 sign per
    element and one f32 scale."""
    def _encode(x):
        return {"bits": torch.sign(x).to(torch.int8),
                "scale": _l1_scale(x).to(torch.float32)}

    def _decode(p, shape, dtype):
        return (p["scale"] * p["bits"].to(torch.float32)).to(dtype).reshape(
            shape)

    return Compressor(
        name="sign",
        apply=lambda x: (_l1_scale(x) * torch.sign(x)).to(x.dtype),
        encode=_encode,
        decode=_decode,
        delta_bound=lambda d: 1.0 / max(d, 1),
        wire_bytes=lambda shape, dtype: math.prod(shape) * 1 + 4,
    )


def topk(fraction: float = 1.0 / 16.0) -> Compressor:
    """Keep the k largest-magnitude coordinates; wire: k values and k int32
    indices."""
    _k = _k_of(fraction)

    def _encode(x):
        flat = x.reshape(-1)
        idx = torch.topk(torch.abs(flat), _k(flat.numel())).indices
        return {"values": flat[idx], "indices": idx.to(torch.int32)}

    return Compressor(
        name=f"topk{fraction:g}",
        apply=lambda x: _scatter_decode(_encode(x), tuple(x.shape), x.dtype),
        encode=_encode,
        decode=_scatter_decode,
        delta_bound=lambda d: _k(d) / max(d, 1),
        wire_bytes=lambda shape, dtype: _k(math.prod(shape))
        * (dtype.itemsize + 4),
    )


def randk(fraction: float = 1.0 / 16.0, seed: int = 0,
          indices: Optional[Callable[[int], torch.Tensor]] = None
          ) -> Compressor:
    """Keep k coordinates drawn once per size: ``indices(d)`` when given,
    else the first k of a ``torch.randperm`` seeded with ``seed``."""
    _k = _k_of(fraction)

    def _idx(d: int, device) -> torch.Tensor:
        if indices is not None:
            return torch.as_tensor(indices(d)).to(device, torch.int32)
        gen = torch.Generator().manual_seed(seed)
        return torch.randperm(d, generator=gen)[:_k(d)].to(device,
                                                           torch.int32)

    def _encode(x):
        flat = x.reshape(-1)
        idx = _idx(flat.numel(), flat.device)
        return {"values": flat[idx.long()], "indices": idx}

    return Compressor(
        name=f"randk{fraction:g}",
        apply=lambda x: _scatter_decode(_encode(x), tuple(x.shape), x.dtype),
        encode=_encode,
        decode=_scatter_decode,
        delta_bound=lambda d: _k(d) / max(d, 1),
        wire_bytes=lambda shape, dtype: _k(math.prod(shape))
        * (dtype.itemsize + 4),
    )


def quantize(levels: int = 16) -> Compressor:
    """Deterministic rounding to ``levels`` steps of max|x|; wire: int8
    levels and one f32 scale."""
    if not 2 <= levels <= 127:
        raise ValueError("levels must be in [2, 127]")

    def _encode(x):
        scale = (torch.max(torch.abs(x)) + f32(1e-30)).to(torch.float32)
        q = torch.round(x.to(torch.float32) / scale * levels).to(torch.int8)
        return {"q": q, "scale": scale}

    def _decode(p, shape, dtype):
        return (p["q"].to(torch.float32) * p["scale"] / levels).to(
            dtype).reshape(shape)

    def _delta(d: int) -> float:
        rel = 1.0 / (2.0 * levels)
        return max(1e-6, 1.0 - d * rel * rel)  # conservative for small d

    return Compressor(
        name=f"q{levels}",
        apply=lambda x: _decode(_encode(x), tuple(x.shape), x.dtype),
        encode=_encode,
        decode=_decode,
        delta_bound=_delta,
        wire_bytes=lambda shape, dtype: math.prod(shape) * 1 + 4,
    )


_REGISTRY: Dict[str, Callable[..., Compressor]] = {
    "identity": identity,
    "sign": sign,
    "topk": topk,
    "randk": randk,
    "quantize": quantize,
}


def make_compressor(name: str, **kw) -> Compressor:
    if name not in _REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)


# ------------------------------ tree helpers -------------------------------


def tree_apply(comp: Compressor, tree) -> Any:
    """Q applied leaf-wise to a parameter tree."""
    return tree_map(comp.apply, tree)


def tree_wire_bytes(comp: Compressor, tree) -> int:
    return sum(comp.wire_bytes(tuple(l.shape), l.dtype)
               for l in tree_leaves(tree))


def tree_dense_bytes(tree) -> int:
    return sum(_nbytes(tuple(l.shape), l.dtype) for l in tree_leaves(tree))
