"""The paper's CTR models, DeepFM [8] and Wide&Deep [6], on stacked params.

The port of ``repro.models.deepfm``. Widths follow Section 6.1: embedding
dim 10, MLP 400-400-400. Every function takes the params of all K workers
stacked on a leading dim and ids ``(K, B, F)``, and returns one value per
worker: the worker dim is written out, not mapped over. Dropout is not
ported yet (the JAX package's benchmarks run without it too).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

PyTree = Any


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``repro.models.common.dense_init``: N(0, 1/d_in) in f32."""
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32) * (1.0 / math.sqrt(d_in))
    return w.to(dtype)


def init_deepfm(gen: torch.Generator, n_features: int, n_fields: int,
                embed_dim: int = 10,
                hidden: Tuple[int, ...] = (400, 400, 400)) -> PyTree:
    """One worker's params, drawn from ``gen`` on ``gen.device``."""
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.01

    p: Dict[str, Any] = {
        "embed": normal(n_features, embed_dim),
        "linear": normal(n_features),
        "bias": torch.zeros((), device=dev),
    }
    d_in = n_fields * embed_dim
    mlp = []
    for h in hidden:
        mlp.append({"w": dense_init(gen, d_in, h),
                    "b": torch.zeros((h,), device=dev)})
        d_in = h
    mlp.append({"w": dense_init(gen, d_in, 1),
                "b": torch.zeros((1,), device=dev)})
    p["mlp"] = mlp
    return p


def init_widedeep(gen: torch.Generator, n_features: int, n_fields: int,
                  embed_dim: int = 10,
                  hidden: Tuple[int, ...] = (400, 400, 400)) -> PyTree:
    # wide part = 'linear'; deep part = 'mlp'; no FM term
    return init_deepfm(gen, n_features, n_fields, embed_dim, hidden)


def _gather(table: torch.Tensor, feat_ids: torch.Tensor) -> torch.Tensor:
    """``table[k][feat_ids[k]]`` for every worker k: one gather over the
    stacked ``(K, n_features, ...)`` table."""
    K = feat_ids.shape[0]
    kidx = torch.arange(K, device=feat_ids.device).view(K, 1, 1)
    return table[kidx, feat_ids.long()]


def _deep(params: PyTree, emb: torch.Tensor) -> torch.Tensor:
    h = emb.reshape(emb.shape[0], emb.shape[1], -1)
    layers = params["mlp"]
    for i, layer in enumerate(layers):
        h = torch.bmm(h, layer["w"]) + layer["b"][:, None, :]
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h[..., 0]


def deepfm_logits(params: PyTree, feat_ids: torch.Tensor) -> torch.Tensor:
    """feat_ids: (K, B, n_fields) int — one active feature per field.
    Returns (K, B) logits."""
    emb = _gather(params["embed"], feat_ids)              # (K, B, F, E)
    first = torch.sum(_gather(params["linear"], feat_ids), dim=-1) \
        + params["bias"][:, None]
    # FM second order: 0.5 * ((sum e)^2 - sum e^2)
    s = torch.sum(emb, dim=2)
    s2 = torch.sum(emb * emb, dim=2)
    second = 0.5 * torch.sum(s * s - s2, dim=-1)
    return first + second + _deep(params, emb)


def _logloss(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Per-worker mean of the stable log-loss (``deepfm.py:80-81``)."""
    y = label.to(torch.float32)
    return torch.mean(torch.clamp_min(logits, 0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))), dim=-1)


def deepfm_loss(params: PyTree, batch: PyTree) -> torch.Tensor:
    """batch: {'feat_ids': (K, B, F), 'label': (K, B) in {0, 1}}.
    Returns the (K,) per-worker losses."""
    return _logloss(deepfm_logits(params, batch["feat_ids"]),
                    batch["label"])


def widedeep_logits(params: PyTree, feat_ids: torch.Tensor) -> torch.Tensor:
    emb = _gather(params["embed"], feat_ids)
    wide = torch.sum(_gather(params["linear"], feat_ids), dim=-1) \
        + params["bias"][:, None]
    return wide + _deep(params, emb)


def widedeep_loss(params: PyTree, batch: PyTree) -> torch.Tensor:
    return _logloss(widedeep_logits(params, batch["feat_ids"]),
                    batch["label"])
