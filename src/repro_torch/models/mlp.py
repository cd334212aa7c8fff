"""Feed-forward blocks, the port of ``repro.models.mlp``: SwiGLU (llama
family) and the GELU MLP (starcoder / whisper).

Under a sharding plan (``shard=``, a ``train.grad.PlanCtx``) the first
matrices (``w_gate`` and ``w_up``, or ``w_in`` with ``b_in``) are
column-parallel, the hidden activation stays split, and ``w_down`` /
``w_out`` is row-parallel on it: one sum each way. Without one the
functions compute what they always did."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import common

PyTree = Any


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                dtype: torch.dtype) -> PyTree:
    return {
        "w_gate": common.dense_init(gen, d_model, d_ff, dtype),
        "w_up": common.dense_init(gen, d_model, d_ff, dtype),
        "w_down": common.dense_init(gen, d_ff, d_model, dtype),
    }


def swiglu_forward(params: PyTree, x: torch.Tensor,
                   shard: Any = None) -> torch.Tensor:
    if shard is not None:
        (gate, up), split = shard.up(x, [(params["w_gate"], "w_gate"),
                                         (params["w_up"], "w_up")])
        return shard.down(common.swiglu(gate, up), params["w_down"],
                          "w_down", split)
    dt = x.dtype
    gate = x @ params["w_gate"].to(dt)
    up = x @ params["w_up"].to(dt)
    return common.swiglu(gate, up) @ params["w_down"].to(dt)


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype: torch.dtype, bias: bool = True) -> PyTree:
    p = {
        "w_in": common.dense_init(gen, d_model, d_ff, dtype),
        "w_out": common.dense_init(gen, d_ff, d_model, dtype),
    }
    if bias:
        p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=gen.device)
        p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=gen.device)
    return p


def gelu_mlp_forward(params: PyTree, x: torch.Tensor,
                     shard: Any = None) -> torch.Tensor:
    dt = x.dtype
    if shard is not None:
        (h,), split = shard.up(x, [(params["w_in"], "w_in")],
                               [(params.get("b_in"), "b_in")])
        out = shard.down(common.gelu(h), params["w_out"], "w_out", split)
        if "b_out" in params:
            out = out + params["b_out"].to(dt)
        return out
    h = x @ params["w_in"].to(dt)
    if "b_in" in params:
        h = h + params["b_in"].to(dt)
    h = common.gelu(h)
    out = h @ params["w_out"].to(dt)
    if "b_out" in params:
        out = out + params["b_out"].to(dt)
    return out
