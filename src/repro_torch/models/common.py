"""Shared model building blocks, the port of ``repro.models.common``:
initializers, norms, RoPE, activations and the LM loss.

Pure functions over explicit parameter trees (dicts of tensors). Every
init draws from a ``torch.Generator`` on the generator's device, at the
JAX package's scales; the numbers are not JAX's bits (parity tests carry
JAX's params across as numpy arrays). The rounding points are JAX's:
statistics and RoPE in f32, the hidden tensor in its compute dtype.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch._tree import tree_flatten, tree_map, tree_unflatten

PyTree = Any
REMAT = ("none", "dots", "full")
# the matrix products at dispatch: what JAX's checkpoint_dots saves
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    """The selective-recompute policy of ``remat="dots"``: keep the output
    of every matrix product, recompute everything else in the backward."""
    if op in _DOT_OPS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def layer_views(layers: PyTree) -> List[PyTree]:
    """Every layer's params from the stacked ``layers`` tree: views of the
    stack, one ``unbind`` per leaf. In the backward each leaf's per-layer
    gradients are stacked once; indexing ``x[i]`` layer by layer would
    zero-fill a gradient of the whole stack's size for every layer and
    add them all up."""
    leaves, td = tree_flatten(layers)
    per = [x.unbind(0) for x in leaves]
    return [tree_unflatten(td, [x[i] for x in per])
            for i in range(len(per[0]))]


def stack_layers(n: int, make: Callable[[], PyTree]) -> PyTree:
    """``n`` draws of ``make()`` (one layer's params) stacked on a leading
    dim, as JAX's vmapped init lays them out; written into the stack one
    at a time, so the stack is never held twice."""
    first = make()
    out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    for i in range(n):
        one = first if i == 0 else make()
        tree_map(lambda dst, src: dst[i].copy_(src), out, one)
    return out


def check_remat(remat: str) -> None:
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")


def remat_call(fn: Callable, remat: str, *args):
    """``fn(*args)`` under the activation-checkpoint policy ``remat``, the
    port of the JAX models' ``jax.checkpoint`` around the layer: "none"
    saves every activation the backward needs, "full" saves only the
    inputs and recomputes the layer in the backward, "dots" saves the
    matrix products' outputs and recomputes the rest (JAX's
    ``checkpoint_policies.checkpoint_dots``). Without grad it is a plain
    call."""
    check_remat(remat)
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


# ------------------------------- init --------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, scale: Optional[float] = None
               ) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device,
                        dtype=torch.float32) * 0.02).to(dtype)


# ------------------------------- norms -------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Statistics in f32; ``inv`` is cast to the compute dtype and
    ``(x * inv) * w`` is computed in that dtype, as JAX does."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1,
                     keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x * inv) * weight.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x - mu.to(x.dtype)) * inv * weight.to(x.dtype) \
        + bias.to(x.dtype)


# -------------------------------- RoPE --------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device: "str | torch.device" = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` of ``positions * freqs`` in f32, shaped (..., S, 1,
    head_dim/2): what :func:`apply_rope` computes at these positions for
    every tensor, so one pair serves q and k of every layer."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    return (torch.cos(angles)[..., :, None, :],
            torch.sin(angles)[..., :, None, :])


def rotate(x: torch.Tensor, tables: Tuple[torch.Tensor, torch.Tensor]
           ) -> torch.Tensor:
    """RoPE of x (..., seq, heads, head_dim) by precomputed tables, in f32
    and cast back to x's dtype."""
    cos, sin = tables
    dt = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dt)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Computed in
    f32 and cast back to x's dtype."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


def sinusoidal_positions(n_ctx: int, d: int,
                         device: "str | torch.device" = "cpu"
                         ) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings, (n_ctx, d) f32: sines of
    the first ``d // 2`` frequencies, then their cosines."""
    pos = torch.arange(n_ctx, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * dim / max(d // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------------ activations ---------------------------------


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SiLU in f32, cast to the gate's dtype, then the product."""
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.to(torch.float32), approximate="tanh").to(x.dtype)


# ------------------------------- losses -------------------------------------


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE. logits (..., S, V), labels (..., S) int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
