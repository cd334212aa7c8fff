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
which random f32 probabilities do not have. Expert parallelism (the
experts sharded over a mesh axis) waits for the port's mesh (ROADMAP
queue 1: multi-GPU comm); on one device every expert is local.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

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


def _route(router: torch.Tensor, xf: torch.Tensor, top_k: int):
    """The f32 router over grouped tokens xf (G, g, d): (probs (G,g,E),
    top-k values and experts (G,g,k), the one-hot experts of the (token,
    choice) pairs (G, g*k, E) int64, and each pair's rank within its
    expert in its group (G, g*k)). Ranks count in token order, the
    choices of a token in order."""
    G, g, _ = xf.shape
    E = router.shape[-1]
    probs = torch.softmax(xf.to(torch.float32) @ router.to(torch.float32),
                          dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    flat = F.one_hot(gate_idx, E).reshape(G, g * top_k, E)
    pos = torch.sum((torch.cumsum(flat, dim=1) - flat) * flat, dim=-1)
    return probs, gate_vals, gate_idx, flat, pos


def moe_forward(params: PyTree, x: torch.Tensor, *, top_k: int,
                capacity_factor: float = 1.25, group_size: int = 1024
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, f32 aux loss)."""
    B, S, d = x.shape
    E = params["router"].shape[-1]
    N = B * S
    g, C = capacity(N, top_k, E, capacity_factor, group_size)
    G = N // g
    dt = x.dtype
    xf = x.reshape(G, g, d)

    probs, gate_vals, gate_idx, flat, pos = _route(params["router"], xf,
                                                   top_k)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    keep = pos < C                                                # (G, gk)

    slot_oh = F.one_hot(torch.where(keep, pos, C), C + 1)[..., :C].to(dt)
    exp_oh = flat.to(dt)                                          # (G,gk,E)
    pair = exp_oh[..., :, None] * slot_oh[..., None, :]           # (G,gk,E,C)
    disp = pair.reshape(G, g, top_k, E, C).sum(dim=2)             # (G,g,E,C)

    expert_in = torch.einsum("gnec,gnd->gecd", disp, xf)          # (G,E,C,d)
    h = common.swiglu(
        torch.einsum("gecd,edf->gecf", expert_in, params["w_gate"].to(dt)),
        torch.einsum("gecd,edf->gecf", expert_in, params["w_up"].to(dt)))
    expert_out = torch.einsum("gecf,efd->gecd", h,
                              params["w_down"].to(dt))            # (G,E,C,d)

    gates_flat = (gate_vals.reshape(G, g * top_k)
                  * keep.to(gate_vals.dtype)).to(dt)
    comb = (pair * gates_flat[..., None, None]
            ).reshape(G, g, top_k, E, C).sum(dim=2)               # (G,g,E,C)
    out = torch.einsum("gnec,gecd->gnd", comb, expert_out).reshape(B, S, d)

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    frac_tokens = torch.mean(F.one_hot(gate_idx[..., 0].reshape(-1), E)
                             .to(torch.float32), dim=0)
    mean_probs = torch.mean(probs.reshape(-1, E), dim=0)
    aux = E * torch.sum(frac_tokens * mean_probs)
    return out.to(dt), aux


def dropped_share(params: PyTree, x: torch.Tensor, *, top_k: int,
                  capacity_factor: float = 1.25, group_size: int = 1024
                  ) -> float:
    """The share of (token, choice) pairs of x (B, S, d) that the capacity
    drops in :func:`moe_forward`'s routing (a host number: it reads the
    device)."""
    B, S, d = x.shape
    g, C = capacity(B * S, top_k, params["router"].shape[-1],
                    capacity_factor, group_size)
    pos = _route(params["router"], x.reshape(-1, g, d), top_k)[-1]
    return float((pos >= C).double().mean())
