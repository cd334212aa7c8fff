"""Zamba2-style hybrid (arXiv:2411.15242), the port of
``repro.models.hybrid``: a Mamba2 backbone with a single *shared*
attention + MLP block invoked periodically.

Config zamba2-7b: 81 Mamba2 layers (d_model=3584, ssm_state=64), one
shared attention block (32 heads, no GQA: head dim 112) + SwiGLU MLP
(d_ff=14336) applied after every whole segment of ``shared_attn_period``
layers with the same weights (Zamba2's weight sharing; the per-invocation
LoRA deltas are omitted, as in JAX). ``_segments(81, 14)`` ends in a
partial segment of 11 layers with no block: 5 attention sites.

The layers are stacked as in JAX (a leading ``n_layers`` dim, JAX's key
names) and walked as views (``common.layer_views``), segment by segment,
where JAX runs one ``lax.scan`` a segment. ``prefill`` and ``forward``
take ``attn_impl`` for the shared block's ``attention.sdpa`` (default
``"auto"``, as JAX's); the serving engine passes ``"kernel"``, the CUDA
flash kernel. The cache's index is a host int, and ``decode_step``
writes the new conv and SSM states and K/V into the cache in place; the
SSM state enters the scan in f32 whatever the cache's dtype (JAX's scan
refuses a bf16 carry).

Entry points:
  forward(params, tokens, cfg, ...)       -> (logits, (conv, ssm))
  prefill(params, tokens, cfg, ...)       -> (last logits, HybridCache)
  decode_step(params, cache, token, cfg)  -> (logits, HybridCache)
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, mamba2, mlp

PyTree = Any
F32_LEAVES = mamba2.F32_LEAVES


def init_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """The model's params on ``gen.device``: the embedding, the Mamba2
    layers in order (``common.stack_layers``), the shared block, the
    head."""
    dt, dev = cfg.param_dtype, gen.device
    embed = common.embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
    layers = common.stack_layers(cfg.n_layers,
                                 lambda: mamba2.init_layer(gen, cfg))
    shared = {
        "attn": attention.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, dt),
        "mlp": mlp.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt),
        "norm1": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "norm2": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    return {
        "embed": embed, "layers": layers, "shared": shared,
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": common.dense_init(gen, cfg.d_model, cfg.vocab_size, dt),
    }


def _segments(n_layers: int, period: int) -> List[Tuple[int, int, bool]]:
    """Split [0, n_layers) into chunks; a shared attn block follows each
    chunk except possibly the last partial one."""
    if period <= 0:
        return [(0, n_layers, False)]
    segs = []
    start = 0
    while start < n_layers:
        end = min(start + period, n_layers)
        segs.append((start, end, end - start == period))
        start = end
    return segs


class HybridCache(NamedTuple):
    conv: torch.Tensor     # (L, B, k-1, di+2N)
    ssm: torch.Tensor      # (L, B, H, P, N)
    attn_k: torch.Tensor   # (A, B, S_max, n_kv, hd): per shared-attn site
    attn_v: torch.Tensor
    index: int             # tokens cached (a host int; JAX's int32 scalar)


def n_attn_sites(cfg: ModelConfig) -> int:
    return sum(1 for s in _segments(cfg.n_layers, cfg.shared_attn_period)
               if s[2])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: "str | torch.device" = "cpu") -> HybridCache:
    st = mamba2.init_state(cfg, batch, device)
    L = cfg.n_layers
    kv = (n_attn_sites(cfg), batch, max_len, cfg.n_kv_heads,
          cfg.resolved_head_dim)
    return HybridCache(
        st.conv.expand((L,) + tuple(st.conv.shape)).clone(),
        st.ssm.expand((L,) + tuple(st.ssm.shape)).clone(),
        torch.zeros(kv, dtype=dtype, device=device),
        torch.zeros(kv, dtype=dtype, device=device), 0)


def _shared_block(shared: PyTree, h: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor,
                  attn_impl: str = "auto") -> torch.Tensor:
    hn = common.rms_norm(h, shared["norm1"], cfg.norm_eps)
    h = h + attention.attention_forward(
        shared["attn"], hn, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        causal=True, positions=positions, impl=attn_impl)
    hn = common.rms_norm(h, shared["norm2"], cfg.norm_eps)
    return h + mlp.swiglu_forward(shared["mlp"], hn)


def _unembed(params: PyTree, h: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    h = common.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h @ params["lm_head"].to(h.dtype)


def forward(params: PyTree, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache: Optional[HybridCache] = None, remat: str = "none",
            attn_impl: str = "auto"
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Training / prefill forward over the whole sequence: (logits (B, S,
    V), the new (conv, ssm) states stacked over the layers). ``remat``
    other than "none" recomputes each Mamba2 layer in the backward (JAX
    checkpoints the scan body whole)."""
    common.check_remat(remat)
    policy = "none" if remat == "none" else "full"
    B, S = tokens.shape
    h = params["embed"][tokens.long()].to(cfg.compute_dtype)
    if cache is None:
        st = mamba2.init_state(cfg, B, h.device)
        conv_all = [st.conv] * cfg.n_layers
        ssm_all = [st.ssm] * cfg.n_layers
        start = 0
    else:
        conv_all, ssm_all, start = cache.conv, cache.ssm, int(cache.index)
    positions = torch.arange(S, device=h.device) + start
    layers = common.layer_views(params["layers"])
    new_conv, new_ssm = [], []
    for s0, s1, has_attn in _segments(cfg.n_layers, cfg.shared_attn_period):
        for i in range(s0, s1):
            h, st = common.remat_call(
                mamba2.layer_forward, policy, layers[i], h, cfg,
                mamba2.MambaState(conv_all[i], ssm_all[i]))
            new_conv.append(st.conv)
            new_ssm.append(st.ssm)
        if has_attn:
            h = _shared_block(params["shared"], h, cfg, positions,
                              attn_impl)
    return _unembed(params, h, cfg), (torch.stack(new_conv),
                                      torch.stack(new_ssm))


def loss_fn(params: PyTree, batch: PyTree, cfg: ModelConfig, *,
            remat: str = "none") -> torch.Tensor:
    tokens = batch["tokens"]
    logits, _ = forward(params, tokens[:, :-1], cfg, remat=remat)
    return common.cross_entropy_loss(logits, tokens[:, 1:],
                                     batch.get("mask"))


# --------------------------- prefill / decode -------------------------------


def prefill(params: PyTree, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache_len: Optional[int] = None, attn_impl: str = "auto"
            ) -> Tuple[torch.Tensor, HybridCache]:
    """Full-sequence prefill that also fills the shared-attn KV sites
    (slot i holds position i, zero past the prompt). Returns the last
    position's logits (B, 1, V) and the cache."""
    B, S = tokens.shape
    cache_len = cache_len or S
    if cache_len < S:
        raise ValueError(f"cache_len={cache_len} cannot hold the {S}-token "
                         "prompt")
    h = params["embed"][tokens.long()].to(cfg.compute_dtype)
    st = mamba2.init_state(cfg, B, h.device)
    cache = init_cache(cfg, B, cache_len, dtype=h.dtype, device=h.device)
    rope = common.rope_tables(torch.arange(S, device=h.device),
                              cfg.resolved_head_dim, cfg.rope_theta)
    sh = params["shared"]
    layers = common.layer_views(params["layers"])
    site = 0
    for s0, s1, has_attn in _segments(cfg.n_layers, cfg.shared_attn_period):
        for i in range(s0, s1):
            h, new = mamba2.layer_forward(layers[i], h, cfg, st)
            cache.conv[i] = new.conv
            cache.ssm[i] = new.ssm
        if has_attn:
            hn = common.rms_norm(h, sh["norm1"], cfg.norm_eps)
            q, k, v = attention._project_qkv(
                sh["attn"], hn, cfg.n_heads, cfg.n_kv_heads,
                cfg.resolved_head_dim)
            q = common.rotate(q, rope)
            k = common.rotate(k, rope)
            ao = attention.sdpa(q, k, v, causal=True,
                                window=cfg.sliding_window, impl=attn_impl)
            h = h + ao @ sh["attn"]["wo"].to(ao.dtype)
            hn = common.rms_norm(h, sh["norm2"], cfg.norm_eps)
            h = h + mlp.swiglu_forward(sh["mlp"], hn)
            cache.attn_k[site, :, :S] = k
            cache.attn_v[site, :, :S] = v
            site += 1
    return _unembed(params, h[:, -1:, :], cfg), cache._replace(index=S)


def decode_step(params: PyTree, cache: HybridCache, token: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, HybridCache]:
    """One-token decode. token: (B,) int; returns (logits (B, V), the
    cache with the new states and K/V written in place and its index
    advanced)."""
    h = params["embed"][token[:, None].long()].to(cfg.compute_dtype)
    index = int(cache.index)
    # the RoPE table and the slot mask of this position, made once for
    # all sites from host ints
    pos = torch.full((h.shape[0], 1), index, dtype=torch.int32,
                     device=h.device)
    rope = common.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
    mask = attention.decode_mask(cache.attn_k.shape[2], index,
                                 device=h.device)
    sh = params["shared"]
    layers = common.layer_views(params["layers"])
    site = 0
    for s0, s1, has_attn in _segments(cfg.n_layers, cfg.shared_attn_period):
        for i in range(s0, s1):
            h, new = mamba2.layer_forward(
                layers[i], h, cfg,
                mamba2.MambaState(cache.conv[i], cache.ssm[i]))
            cache.conv[i] = new.conv
            cache.ssm[i] = new.ssm
        if has_attn:
            hn = common.rms_norm(h, sh["norm1"], cfg.norm_eps)
            ao, _, _ = attention.decode_attention(
                sh["attn"], hn, cache.attn_k[site], cache.attn_v[site],
                index, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                rope=rope, mask=mask)
            h = h + ao
            hn = common.rms_norm(h, sh["norm2"], cfg.norm_eps)
            h = h + mlp.swiglu_forward(sh["mlp"], hn)
            site += 1
    logits = _unembed(params, h, cfg)[:, 0, :]
    return logits, cache._replace(index=index + 1)
