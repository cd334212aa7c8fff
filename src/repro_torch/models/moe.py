"""Mixture-of-Experts FFN with top-k routing and grouped capacity dispatch,
the port of ``repro.models.moe``.

GShard-style, as in JAX: the N = B*S tokens are split into G groups of g
(g shrinks from ``group_size`` until it divides N); each group dispatches
independently into per-expert buffers of capacity
``C = min(max(4, int(g*k*capacity_factor/E)), g)`` through one-hot
einsums, so every shape is static and a (token, choice) pair past its
expert's capacity is dropped. Routing returns the Switch-style auxiliary
load-balance loss.

JAX's rounding points: the router runs in f32 (``x.astype(f32) @
router``), the one-hot dispatch and combine tensors and the expert einsums
in the hidden's dtype. ``torch.topk`` and ``lax.top_k`` agree but on ties,
which random f32 probabilities do not have.

Under a sharding plan (``shard=``, a ``train.grad.PlanCtx``) each rank of
a worker's model group holds the plan's shard of the router and of the
three expert weights. The plan (``launch.shardings.param_pspec``, JAX's
greedy rule) does not cut the expert dim: it takes each leaf's largest
dim, so the router ``(d, E)`` is cut on d_model (a row-parallel product,
in f32, summed in model-index order so that every rank gets the same
logits bits), and ``w_gate`` / ``w_up`` ``(E, d, d_ff)`` are cut on
d_ff, or on d_model where d_model is as large (the reduced llama4), and
``w_down`` ``(E, d_ff, d)`` on d_ff. The routing, the capacity, the
dispatch and the combine then run whole and identical on every rank;
only the three expert products are cut (``PlanCtx.up`` / ``down`` on
expert-major ``(E, G*C, d)`` activations), and a row-parallel
``w_down``'s f32 partial is combined before its one sum over the group.
The aux loss comes from the identical probabilities, once.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common

PyTree = Any
# the leaf every use reads in f32: a compute-dtype copy would move the
# routing
F32_LEAVES = ("router",)


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype: torch.dtype) -> PyTree:
    """The router (f32, as JAX's) and the stacked (E, d_in, d_out) expert
    weights, drawn from ``gen`` in JAX's order at JAX's scales."""
    def ew(di, do):
        return (torch.randn((n_experts, di, do), generator=gen,
                            device=gen.device, dtype=torch.float32)
                * (1.0 / math.sqrt(di))).to(dtype)

    router = common.dense_init(gen, d_model, n_experts, torch.float32)
    return {"router": router, "w_gate": ew(d_model, d_ff),
            "w_up": ew(d_model, d_ff), "w_down": ew(d_ff, d_model)}


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float = 1.25, group_size: int = 1024
             ) -> Tuple[int, int]:
    """(group size g, per-expert capacity C) for ``n_tokens`` tokens."""
    g = min(group_size, n_tokens)
    while n_tokens % g:
        g -= 1
    C = max(4, int(g * top_k * capacity_factor / n_experts))
    return g, min(C, g)


class Routing(NamedTuple):
    """One MoE call's routing over its G groups of g tokens, E experts of
    capacity C: the f32 probabilities (G, g, E), the top-k experts (G, g,
    k), whether each (token, choice) pair is kept (G, g*k), the one-hot
    (pair, expert, slot) tensor (G, g*k, E, C) and its dispatch (G, g, E,
    C) in the hidden's dtype, and each pair's normalised gate, zero where
    dropped (G, g*k), in the hidden's dtype."""

    probs: torch.Tensor
    gate_idx: torch.Tensor
    keep: torch.Tensor
    pair: torch.Tensor
    disp: torch.Tensor
    gates: torch.Tensor


def route(params: PyTree, x: torch.Tensor, *, top_k: int,
          capacity_factor: float = 1.25, group_size: int = 1024,
          shard: Any = None) -> Routing:
    """The routing of x (B, S, d) through ``params``' router: the part of
    :func:`moe_forward` before the experts. The router runs in f32; a
    pair's rank within its expert counts in token order, the choices of a
    token in order. ``shard``: a sharding plan's context, whose f32 router
    product gives every rank of the group the same bits, and so the same
    routing."""
    B, S, d = x.shape
    E = params["w_gate"].shape[0]
    N = B * S
    g, C = capacity(N, top_k, E, capacity_factor, group_size)
    G = N // g
    dt = x.dtype
    x32 = x.reshape(G, g, d).to(torch.float32)
    router = params["router"]
    logits = (x32 @ router.to(torch.float32) if shard is None
              else shard.project(x32, [(router, "router")])[0])
    probs = torch.softmax(logits, dim=-1)                         # (G,g,E)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)        # (G,g,k)
    flat = F.one_hot(gate_idx, E).reshape(G, g * top_k, E)
    pos = torch.sum((torch.cumsum(flat, dim=1) - flat) * flat, dim=-1)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    keep = pos < C                                                # (G, gk)

    slot_oh = F.one_hot(torch.where(keep, pos, C), C + 1)[..., :C].to(dt)
    exp_oh = flat.to(dt)                                          # (G,gk,E)
    pair = exp_oh[..., :, None] * slot_oh[..., None, :]           # (G,gk,E,C)
    disp = pair.reshape(G, g, top_k, E, C).sum(dim=2)             # (G,g,E,C)
    gates = (gate_vals.reshape(G, g * top_k)
             * keep.to(gate_vals.dtype)).to(dt)
    return Routing(probs, gate_idx, keep, pair, disp, gates)


def moe_forward(params: PyTree, x: torch.Tensor, *, top_k: int,
                capacity_factor: float = 1.25, group_size: int = 1024,
                shard: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, f32 aux loss).
    ``shard``: a sharding plan's context (the module's docstring)."""
    B, S, d = x.shape
    r = route(params, x, top_k=top_k, capacity_factor=capacity_factor,
              group_size=group_size, shard=shard)
    G, g, E, C = r.disp.shape
    dt = x.dtype
    xf = x.reshape(G, g, d)

    # expert-major slots: each expert product is one batched matmul
    expert_in = torch.einsum("gnec,gnd->egcd", r.disp, xf
                             ).reshape(E, G * C, d)

    def combine(gates, expert_out):          # (E, G*C, d) -> (G, g, d)
        comb = (r.pair * gates[..., None, None]
                ).reshape(G, g, top_k, E, C).sum(dim=2)           # (G,g,E,C)
        return torch.einsum("gnec,egcd->gnd", comb.to(expert_out.dtype),
                            expert_out.reshape(E, G, C, d))

    if shard is None:
        h = common.swiglu(torch.bmm(expert_in, params["w_gate"].to(dt)),
                          torch.bmm(expert_in, params["w_up"].to(dt)))
        out = combine(r.gates, torch.bmm(h, params["w_down"].to(dt)))
    else:
        (gate, up), split = shard.up(expert_in,
                                     [(params["w_gate"], "w_gate"),
                                      (params["w_up"], "w_up")])
        out = shard.down(common.swiglu(gate, up), params["w_down"], "w_down",
                         split, combine=(combine, r.gates))
    out = out.reshape(B, S, d)

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    frac_tokens = torch.mean(F.one_hot(r.gate_idx[..., 0].reshape(-1), E)
                             .to(torch.float32), dim=0)
    mean_probs = torch.mean(r.probs.reshape(-1, E), dim=0)
    aux = E * torch.sum(frac_tokens * mean_probs)
    return out.to(dt), aux


def dropped_share(params: PyTree, x: torch.Tensor, *, top_k: int,
                  capacity_factor: float = 1.25, group_size: int = 1024
                  ) -> float:
    """The share of (token, choice) pairs of x (B, S, d) that the capacity
    drops in :func:`moe_forward`'s routing (a host number: it reads the
    device)."""
    keep = route(params, x, top_k=top_k, capacity_factor=capacity_factor,
                 group_size=group_size).keep
    return float((~keep).double().mean())
