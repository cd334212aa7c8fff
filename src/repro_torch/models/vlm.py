"""Phi-3-vision backbone (hf:microsoft/Phi-3-vision-128k-instruct), the
port of ``repro.models.vlm``.

Early fusion: the CLIP ViT-L/14 image encoder is a stub, so the inputs
carry (B, n_patches=576, 1024) patch features. The projector (1024 ->
d_model) and the phi3-mini language backbone (``models.transformer``,
32 dense layers) are real; the backbone reads [projected patches ; text
tokens] under one causal mask.

``prefill`` takes ``attn_impl`` for ``attention.sdpa`` (default
``"auto"``, as JAX's); the serving engine passes ``"kernel"``, the CUDA
flash kernel, once per layer over the patches and the text together.
The KV cache holds the patches' positions first, so a prompt of L tokens
ends at cache index ``n_patches + L``.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, transformer

PyTree = Any

CLIP_DIM = 1024


def init_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """The backbone's params (``transformer.init_params``), then the
    projector."""
    p = transformer.init_params(gen, cfg)
    p["projector"] = common.dense_init(gen, CLIP_DIM, cfg.d_model,
                                       cfg.param_dtype)
    return p


def project_patches(params: PyTree, patches: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """(B, P, 1024) stub CLIP features -> (B, P, d_model)."""
    return patches.to(cfg.compute_dtype) @ params["projector"].to(
        cfg.compute_dtype)


def forward(params: PyTree, tokens: torch.Tensor, patches: torch.Tensor,
            cfg: ModelConfig, *, remat: str = "none",
            attn_impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, P + S, V), aux): the patches' positions come first."""
    embeds = project_patches(params, patches, cfg)
    return transformer.forward(params, tokens, cfg, extra_embeds=embeds,
                               remat=remat, attn_impl=attn_impl)


def loss_fn(params: PyTree, batch: PyTree, cfg: ModelConfig, *,
            remat: str = "none") -> torch.Tensor:
    """Next-token CE over the text positions; JAX's adds no aux loss."""
    tokens = batch["tokens"]
    logits, _ = forward(params, tokens[:, :-1], batch["patches"], cfg,
                        remat=remat)
    logits = logits[:, batch["patches"].shape[1]:]
    return common.cross_entropy_loss(logits, tokens[:, 1:],
                                     batch.get("mask"))


def prefill(params: PyTree, tokens: torch.Tensor, patches: torch.Tensor,
            cfg: ModelConfig, *, cache_len: Optional[int] = None,
            attn_impl: str = "auto"
            ) -> Tuple[torch.Tensor, attention.KVCache]:
    embeds = project_patches(params, patches, cfg)
    return transformer.prefill(params, tokens, cfg, cache_len=cache_len,
                               extra_embeds=embeds, attn_impl=attn_impl)


def decode_step(params: PyTree, cache: attention.KVCache,
                token: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, attention.KVCache]:
    return transformer.decode_step(params, cache, token, cfg)
