"""Decoder-only transformer LM, dense and MoE families: the port of
``repro.models.transformer``.

Layers are stacked as in JAX: every per-layer leaf carries a leading
``n_layers`` dim and the key names are JAX's, so ``convert.params_from_
numpy`` carries a JAX param tree across as a plain copy. JAX's
``lax.scan`` over the stack becomes a Python loop over the layers' views
(``common.layer_views``).

Entry points:
  forward(params, tokens, cfg)           -> (logits, aux)  (parity only)
  prefill(params, tokens, cfg, ...)      -> (logits, KVCache)
  decode_step(params, cache, token, cfg) -> (logits, KVCache)

``prefill`` and ``forward`` take ``attn_impl`` for ``attention.sdpa``
(default ``"auto"``, as JAX's); the serving engine passes ``"kernel"``.
A MoE layer (``cfg.family == "moe"``, or experts set) has ``"moe"`` in
place of ``"mlp"`` (``models.moe``); its Switch aux loss is summed over
the layers and ``loss_fn`` adds ``router_aux_weight`` times it.
``loss_fn`` is what LM training differentiates: through ``sdpa``'s naive
or chunked path, never the flash kernel (it has no backward), with the
``remat`` policy around each layer.

``loss_fn(..., shard=ctx)`` is the loss under a sharding plan
(``train.grad``'s planned mode) of the dense and MoE families, and of the
vision-language backbone (``models.vlm``, its projected patches as
``extra_embeds``): ``params`` hold the rank's plan shards, and every
product with a cut matrix goes through ``ctx`` (a
``train.grad.PlanCtx``): the vocab-parallel embedding, the attention
projections, the MLP or the MoE's router and experts
(``moe.moe_forward``), and a vocab-parallel cross-entropy over the text
positions in place of ``unembed``, so the logits are never whole on a
rank. Norms and biases are whole. Without a plan every function computes
what it did.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, mlp, moe

PyTree = Any


# ------------------------------- params -------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """One layer's params, drawn from ``gen``: attention (wq, wk, wv, wo),
    then the MLP or the MoE block."""
    dt, dev = cfg.param_dtype, gen.device
    p = {
        "attn": attention.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, dt, cfg.qkv_bias),
        "norm1": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "norm2": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if cfg.norm_kind == "layer":
        p["norm1_b"] = torch.zeros((cfg.d_model,), dtype=dt, device=dev)
        p["norm2_b"] = torch.zeros((cfg.d_model,), dtype=dt, device=dev)
    if cfg.family == "moe" or (cfg.n_experts and cfg.experts_per_token):
        p["moe"] = moe.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                dt)
    elif cfg.mlp_kind == "gelu":
        p["mlp"] = mlp.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dt)
    else:
        p["mlp"] = mlp.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """The model's params on ``gen.device``: the embedding, then the
    layers in order (``common.stack_layers``), then the untied head."""
    dt, dev = cfg.param_dtype, gen.device
    embed = common.embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
    layers = common.stack_layers(cfg.n_layers, lambda: init_layer(gen, cfg))
    p = {"embed": embed, "layers": layers,
         "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev)}
    if cfg.norm_kind == "layer":
        p["final_norm_b"] = torch.zeros((cfg.d_model,), dtype=dt,
                                        device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = common.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dt)
    return p


# ------------------------------- forward ------------------------------------


def _norm(x, w, b, kind, eps):
    if kind == "layer":
        return common.layer_norm(x, w, b, eps)
    return common.rms_norm(x, w, eps)


def _ffn(layer: PyTree, hn: torch.Tensor, cfg: ModelConfig,
         shard: Any = None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the feed-forward output, the MoE aux loss or ``None``)."""
    if "moe" in layer:
        return moe.moe_forward(layer["moe"], hn,
                               top_k=cfg.experts_per_token,
                               capacity_factor=cfg.capacity_factor,
                               group_size=cfg.moe_group_size, shard=shard)
    if cfg.mlp_kind == "gelu":
        return mlp.gelu_mlp_forward(layer["mlp"], hn, shard), None
    return mlp.swiglu_forward(layer["mlp"], hn, shard), None


def _layer_forward(layer: PyTree, h: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, attn_impl: str = "auto",
                   shard: Any = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (h, this layer's f32 aux loss, ``None`` without experts).
    ``shard``: a sharding plan's context (the module's docstring)."""
    hn = _norm(h, layer["norm1"], layer.get("norm1_b"), cfg.norm_kind,
               cfg.norm_eps)
    h = h + attention.attention_forward(
        layer["attn"], hn, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        causal=True, window=cfg.sliding_window, positions=positions,
        impl=attn_impl, shard=shard)
    hn = _norm(h, layer["norm2"], layer.get("norm2_b"), cfg.norm_kind,
               cfg.norm_eps)
    out, aux = _ffn(layer, hn, cfg, shard)
    return h + out, aux


def backbone(params: PyTree, h: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor, remat: str = "none",
             attn_impl: str = "auto", shard: Any = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed-space in, embed-space out. Returns (h, total_aux), the sum of
    the layers' aux losses (0 for the dense family). ``remat`` ("none",
    "dots", "full") is the activation-checkpoint policy around each layer
    (:func:`common.remat_call`), as JAX wraps its scan body."""
    common.check_remat(remat)
    auxes = []
    for layer in common.layer_views(params["layers"]):
        h, aux = common.remat_call(_layer_forward, remat, layer, h, cfg,
                                   positions, attn_impl, shard)
        if aux is not None:
            auxes.append(aux)
    if not auxes:
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    return h, torch.sum(torch.stack(auxes))


def embed_tokens(params: PyTree, tokens: torch.Tensor,
                 cfg: ModelConfig, shard: Any = None) -> torch.Tensor:
    if shard is not None:
        return shard.embed(params["embed"], "embed", tokens,
                           cfg.compute_dtype)
    return params["embed"][tokens.long()].to(cfg.compute_dtype)


def unembed(params: PyTree, h: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    h = _norm(h, params["final_norm"], params.get("final_norm_b"),
              cfg.norm_kind, cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ params["embed"].T.to(h.dtype)
    return h @ params["lm_head"].to(h.dtype)


def forward(params: PyTree, tokens: torch.Tensor, cfg: ModelConfig, *,
            extra_embeds: Optional[torch.Tensor] = None,
            remat: str = "none", attn_impl: str = "auto"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward. tokens: (B, S) int. extra_embeds (B, P, d) are
    prepended. Returns (logits (B, S', V), aux_loss)."""
    h = embed_tokens(params, tokens, cfg)
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)
    h, aux = backbone(params, h, cfg, positions, remat, attn_impl)
    return unembed(params, h, cfg), aux


def loss_fn(params: PyTree, batch: PyTree, cfg: ModelConfig, *,
            remat: str = "none", shard: Any = None) -> torch.Tensor:
    """batch: {'tokens': (B, S+1)} (+ optional 'extra_embeds', 'mask').
    ``shard``: a sharding plan's context (the module's docstring)."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    if shard is not None:
        return _planned_loss(params, batch, cfg, shard, remat, inputs,
                             labels)
    logits, aux = forward(params, inputs, cfg,
                          extra_embeds=batch.get("extra_embeds"),
                          remat=remat)
    if batch.get("extra_embeds") is not None:
        logits = logits[:, batch["extra_embeds"].shape[1]:]
    ce = common.cross_entropy_loss(logits, labels, batch.get("mask"))
    return ce + cfg.router_aux_weight * aux


def _planned_loss(params: PyTree, batch: PyTree, cfg: ModelConfig,
                  shard: Any, remat: str, inputs: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """``loss_fn`` through a sharding plan's context: the forward of
    ``forward`` with the rank's shards, and the cross-entropy taken
    vocab-parallel from the final norm's output at the text positions
    (the ``extra_embeds`` positions before them are left out before the
    head, where ``loss_fn`` slices the logits after it: the same
    value)."""
    if remat != "none":
        raise ValueError(
            "a sharding plan's loss takes remat='none' (remat would run the "
            "layers' sums over the model group again in the backward)")
    h = embed_tokens(params, inputs, cfg, shard)
    extra = batch.get("extra_embeds")
    if extra is not None:
        h = torch.cat([extra.to(h.dtype), h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)
    h, aux = backbone(params, h, cfg, positions, shard=shard)
    if extra is not None:
        h = h[:, extra.shape[1]:]
    h = _norm(h, params["final_norm"], params.get("final_norm_b"),
              cfg.norm_kind, cfg.norm_eps)
    tied = cfg.tie_embeddings
    ce = shard.vocab_loss(h, params["embed" if tied else "lm_head"],
                          "embed" if tied else "lm_head", labels,
                          batch.get("mask"), transposed=tied)
    return ce + cfg.router_aux_weight * aux


# ----------------------------- prefill/decode -------------------------------


def _layer_prefill(layer: PyTree, h: torch.Tensor, cfg: ModelConfig,
                   rope: Tuple[torch.Tensor, torch.Tensor],
                   attn_impl: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like _layer_forward but also returns this layer's rope'd K/V.
    ``rope``: the prompt positions' ``common.rope_tables``."""
    hn = _norm(h, layer["norm1"], layer.get("norm1_b"), cfg.norm_kind,
               cfg.norm_eps)
    q, k, v = attention._project_qkv(
        layer["attn"], hn, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    q = common.rotate(q, rope)
    k = common.rotate(k, rope)
    attn_out = attention.sdpa(q, k, v, causal=True,
                              window=cfg.sliding_window, impl=attn_impl)
    h = h + attn_out @ layer["attn"]["wo"].to(attn_out.dtype)
    hn = _norm(h, layer["norm2"], layer.get("norm2_b"), cfg.norm_kind,
               cfg.norm_eps)
    return h + _ffn(layer, hn, cfg)[0], k, v


def prefill(params: PyTree, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache_len: Optional[int] = None,
            extra_embeds: Optional[torch.Tensor] = None,
            attn_impl: str = "auto"
            ) -> Tuple[torch.Tensor, attention.KVCache]:
    """Run the full prompt, build the KV cache, return the last
    position's logits (B, 1, V).

    Slot i of the cache holds position i, zero past the prompt. Sliding-
    window archs get a rotating cache of ``sliding_window`` slots (slot =
    pos % window, as decode_step writes it)."""
    h = embed_tokens(params, tokens, cfg)
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
    B, S, _ = h.shape
    if cache_len is None:
        cache_len = cfg.sliding_window if cfg.sliding_window else S
    # one RoPE table for q and k of every layer (JAX recomputes it per
    # call; the values are the same)
    rope = common.rope_tables(torch.arange(S, device=h.device),
                              cfg.resolved_head_dim, cfg.rope_theta)
    kv_shape = (cfg.n_layers, B, cache_len, cfg.n_kv_heads,
                cfg.resolved_head_dim)
    ks = torch.zeros(kv_shape, dtype=h.dtype, device=h.device)
    vs = torch.zeros(kv_shape, dtype=h.dtype, device=h.device)
    for i, layer in enumerate(common.layer_views(params["layers"])):
        h, k, v = _layer_prefill(layer, h, cfg, rope, attn_impl)
        if S <= cache_len:
            ks[i, :, :S] = k
            vs[i, :, :S] = v
        else:  # a rotating cache keeps the last slots
            ks[i] = k[:, -cache_len:]
            vs[i] = v[:, -cache_len:]
    logits = unembed(params, h[:, -1:, :], cfg)
    if cfg.sliding_window and S > cfg.sliding_window:
        # rotate so the slot layout matches decode's (pos % window)
        shift = S % cache_len
        ks = torch.roll(ks, shift, dims=2)
        vs = torch.roll(vs, shift, dims=2)
    return logits, attention.KVCache(ks, vs, S)


def decode_step(params: PyTree, cache: attention.KVCache,
                token: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, attention.KVCache]:
    """One-token decode. token: (B,) int; returns (logits (B, V), the
    cache with the new K/V written in place and its index advanced)."""
    h = embed_tokens(params, token[:, None], cfg)
    rotating = bool(cfg.sliding_window)
    index = int(cache.index)
    # the RoPE table and the slot mask of this position, made once for
    # all layers from host ints
    pos = torch.full((h.shape[0], 1), index, dtype=torch.int32,
                     device=h.device)
    rope = common.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
    mask = attention.decode_mask(cache.max_len, index,
                                 window=cfg.sliding_window,
                                 rotating=rotating, device=h.device)
    for i, layer in enumerate(common.layer_views(params["layers"])):
        hn = _norm(h, layer["norm1"], layer.get("norm1_b"), cfg.norm_kind,
                   cfg.norm_eps)
        attn_out, _, _ = attention.decode_attention(
            layer["attn"], hn, cache.k[i], cache.v[i], index,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            window=cfg.sliding_window, rotating=rotating, rope=rope,
            mask=mask)
        h = h + attn_out
        hn = _norm(h, layer["norm2"], layer.get("norm2_b"), cfg.norm_kind,
                   cfg.norm_eps)
        h = h + _ffn(layer, hn, cfg)[0]
    logits = unembed(params, h, cfg)[:, 0, :]
    return logits, attention.KVCache(cache.k, cache.v, index + 1)
