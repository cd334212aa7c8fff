"""Model registry, the port of ``repro.models.registry``: one interface
over the model families the port can build.

    api = build_model(cfg)
    params = api.init(gen)                        # a torch.Generator
    loss   = api.loss(params, batch)
    logits, cache = api.prefill(params, batch, cache_len=..., attn_impl=...)
    logits, cache = api.decode_step(params, cache, token)

Only the dense family is ported; the others (moe, vlm, audio, ssm,
hybrid) raise ``NotImplementedError`` (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

PyTree = Any
FAMILIES = ("dense",)


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[[torch.Generator], PyTree]
    loss: Callable[..., torch.Tensor]
    prefill: Callable[..., Tuple[torch.Tensor, Any]]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            f"item 11: model zoo); the port builds {FAMILIES}")
    return ModelAPI(
        cfg=cfg,
        init=lambda gen: transformer.init_params(gen, cfg),
        loss=lambda p, b, remat="none": transformer.loss_fn(
            p, b, cfg, remat=remat),
        prefill=lambda p, b, cache_len=None, attn_impl="auto":
            transformer.prefill(p, b["tokens"], cfg, cache_len=cache_len,
                                attn_impl=attn_impl),
        decode_step=lambda p, c, t: transformer.decode_step(p, c, t, cfg),
    )
