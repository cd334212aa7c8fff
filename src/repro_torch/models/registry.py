"""Model registry, the port of ``repro.models.registry``: one interface
over the model families the port can build.

    api = build_model(cfg)
    params = api.init(gen)                        # a torch.Generator
    loss   = api.loss(params, batch)      # dense, moe, vlm: also shard=
    logits, cache = api.prefill(params, batch, cache_len=..., <impl>=...)
    logits, cache = api.decode_step(params, cache, token[, <impl>=...])

Each family names its kernel choice with its own keyword, the JAX
package's: ``attn_impl`` for the prefill attention of the dense, MoE,
hybrid, vlm and audio families (decode attention has no kernel),
``wkv_impl`` for the ssm family's recurrence in prefill and in decode.
``impl_kwargs`` gives the keywords of one choice for a config's family.
The defaults are JAX's (``"auto"``, ``"scan"``); the serving engine asks
for the kernels.

All six families of the JAX package are ported, with JAX's batch
layouts:

    dense, moe, ssm, hybrid: {'tokens': (B, S+1)}
    vlm:   {'tokens': (B, S_txt+1), 'patches': (B, n_patches, 1024)}
    audio: {'tokens': (B, S+1), 'audio_embeds': (B, n_audio_ctx, d_model)}

(``models.transformer``, ``rwkv6``, ``hybrid``, ``vlm``, ``whisper``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, moe, rwkv6, transformer, vlm, whisper

PyTree = Any
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[[torch.Generator], PyTree]
    loss: Callable[..., torch.Tensor]
    prefill: Callable[..., Tuple[torch.Tensor, Any]]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]
    # per-layer leaves the forward reads in f32 wherever it uses them:
    # a compute-dtype copy of the params keeps them as they are
    f32_leaves: Tuple[str, ...] = ()


def impl_kwargs(cfg: ModelConfig, *, attn_impl: str = "auto",
                wkv_impl: str = "scan"
                ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """The keywords that carry a kernel choice into the family's prefill
    and decode_step: ``(prefill_kw, decode_kw)``."""
    if cfg.family == "ssm":
        return {"wkv_impl": wkv_impl}, {"wkv_impl": wkv_impl}
    return {"attn_impl": attn_impl}, {}


def family_extras(cfg: ModelConfig, batch: int,
                  gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The batch leaves of a family besides the tokens, N(0, 1) f32 from
    ``gen`` on its device, as the JAX drivers draw them (the stubbed image
    and audio frontends' outputs): ``patches`` (batch, n_patches, 1024)
    for vlm, ``audio_embeds`` (batch, n_audio_ctx, d_model) for audio;
    empty for the others."""
    shape = {"vlm": ("patches", (batch, cfg.n_patches, vlm.CLIP_DIM)),
             "audio": ("audio_embeds",
                       (batch, cfg.n_audio_ctx, cfg.d_model))}
    if cfg.family not in shape:
        return {}
    name, dims = shape[cfg.family]
    return {name: torch.randn(dims, generator=gen, device=gen.device)}


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}; the port builds "
                       f"{FAMILIES}")
    if cfg.family == "ssm":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen: rwkv6.init_params(gen, cfg),
            loss=lambda p, b, remat="none": rwkv6.loss_fn(
                p, b, cfg, remat=remat),
            prefill=lambda p, b, cache_len=None, wkv_impl="scan":
                rwkv6.prefill(p, b["tokens"], cfg, cache_len=cache_len,
                              wkv_impl=wkv_impl),
            decode_step=lambda p, c, t, wkv_impl="scan": rwkv6.decode_step(
                p, c, t, cfg, wkv_impl=wkv_impl),
            f32_leaves=rwkv6.F32_LEAVES,
        )
    if cfg.family == "hybrid":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen: hybrid.init_params(gen, cfg),
            loss=lambda p, b, remat="none": hybrid.loss_fn(
                p, b, cfg, remat=remat),
            prefill=lambda p, b, cache_len=None, attn_impl="auto":
                hybrid.prefill(p, b["tokens"], cfg, cache_len=cache_len,
                               attn_impl=attn_impl),
            decode_step=lambda p, c, t: hybrid.decode_step(p, c, t, cfg),
            f32_leaves=hybrid.F32_LEAVES,
        )
    if cfg.family == "vlm":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen: vlm.init_params(gen, cfg),
            loss=lambda p, b, remat="none", shard=None: vlm.loss_fn(
                p, b, cfg, remat=remat, shard=shard),
            prefill=lambda p, b, cache_len=None, attn_impl="auto":
                vlm.prefill(p, b["tokens"], b["patches"], cfg,
                            cache_len=cache_len, attn_impl=attn_impl),
            decode_step=lambda p, c, t: vlm.decode_step(p, c, t, cfg),
        )
    if cfg.family == "audio":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen: whisper.init_params(gen, cfg),
            loss=lambda p, b, remat="none": whisper.loss_fn(
                p, b, cfg, remat=remat),
            prefill=lambda p, b, cache_len=None, attn_impl="auto":
                whisper.prefill(p, b["tokens"], b["audio_embeds"], cfg,
                                cache_len=cache_len, attn_impl=attn_impl),
            decode_step=lambda p, c, t: whisper.decode_step(p, c, t, cfg),
        )
    return ModelAPI(
        cfg=cfg,
        init=lambda gen: transformer.init_params(gen, cfg),
        loss=lambda p, b, remat="none", shard=None: transformer.loss_fn(
            p, b, cfg, remat=remat, shard=shard),
        prefill=lambda p, b, cache_len=None, attn_impl="auto":
            transformer.prefill(p, b["tokens"], cfg, cache_len=cache_len,
                                attn_impl=attn_impl),
        decode_step=lambda p, c, t: transformer.decode_step(p, c, t, cfg),
        f32_leaves=moe.F32_LEAVES,     # a MoE layer's router
    )
