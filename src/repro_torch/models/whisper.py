"""Whisper-large-v3 backbone (arXiv:2212.04356), the port of
``repro.models.whisper``: an encoder-decoder transformer.

The mel-spectrogram and conv frontend are a stub: the inputs carry frame
embeddings (B, n_audio_ctx=1500, d_model). The encoder transformer over
them (sinusoidal positions, non-causal self-attention) and the causal
decoder with cross-attention are real. LayerNorm with biases, GELU MLPs,
q/k/v biases; the output head is tied to ``embed``.

Deviation of the JAX package, kept: the decoder's learned positions are
allocated to ``MAX_TEXT_POSITIONS`` (33,024) where the published model
caps them at 448.

A fault of the JAX package, mirrored: ``attention.cross_attention_
forward`` adds no ``bq``, ``bk`` or ``bv``, while the prefill's cached
cross K/V and the decode query add them. Biases start at zero and the
cross biases get a zero gradient through ``loss_fn``, so D-Adam keeps
them at zero; with nonzero cross biases decode parts from the
teacher-forced forward, in both packages alike.

The encoder and decoder layers are stacked as in JAX (``enc_layers``,
``dec_layers``: a leading layer dim, JAX's key names) and walked as views
(``common.layer_views``). ``prefill`` and ``forward`` take ``attn_impl``
for every ``attention.sdpa`` they reach, the encoder's (non-causal), the
decoder's (causal) and the cross-attention (non-causal, S != T) (default
``"auto"``, as JAX's); the serving engine passes ``"kernel"``, the CUDA
flash kernel. Decode attention, the cross-attention over the cached
encoder K/V included, runs in torch ops, as JAX's. The cache's index is a
host int and ``decode_step`` writes the new self K/V into the cache in
place.

Entry points:
  encode(params, audio_embeds, cfg, ...)          -> (B, T, d)
  forward(params, tokens, audio_embeds, cfg, ...) -> logits (B, S, V)
  prefill(params, tokens, audio_embeds, cfg, ...) -> (logits, WhisperCache)
  decode_step(params, cache, token, cfg)          -> (logits, WhisperCache)
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, mlp

PyTree = Any

MAX_TEXT_POSITIONS = 33024


def _init_block(gen: torch.Generator, cfg: ModelConfig,
                cross: bool) -> PyTree:
    d, dt, dev = cfg.d_model, cfg.param_dtype, gen.device
    hd = cfg.resolved_head_dim
    p = {
        "self_attn": attention.init_attention(
            gen, d, cfg.n_heads, cfg.n_kv_heads, hd, dt, qkv_bias=True),
        "mlp": mlp.init_gelu_mlp(gen, d, cfg.d_ff, dt),
        "ln1": torch.ones((d,), dtype=dt, device=dev),
        "ln1_b": torch.zeros((d,), dtype=dt, device=dev),
        "ln2": torch.ones((d,), dtype=dt, device=dev),
        "ln2_b": torch.zeros((d,), dtype=dt, device=dev),
    }
    if cross:
        p["cross_attn"] = attention.init_attention(
            gen, d, cfg.n_heads, cfg.n_kv_heads, hd, dt, qkv_bias=True)
        p["ln_x"] = torch.ones((d,), dtype=dt, device=dev)
        p["ln_x_b"] = torch.zeros((d,), dtype=dt, device=dev)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """The encoder layers, the decoder layers, the embedding, the decoder
    positions (N(0, 0.01²), drawn in f32) and the final norms, on
    ``gen.device``."""
    dt, dev, d = cfg.param_dtype, gen.device, cfg.d_model
    enc = common.stack_layers(cfg.n_encoder_layers,
                              lambda: _init_block(gen, cfg, cross=False))
    dec = common.stack_layers(cfg.n_layers,
                              lambda: _init_block(gen, cfg, cross=True))
    embed = common.embed_init(gen, cfg.vocab_size, d, dt)
    dec_pos = (torch.randn((MAX_TEXT_POSITIONS, d), generator=gen,
                           device=dev, dtype=torch.float32) * 0.01).to(dt)
    return {
        "enc_layers": enc,
        "dec_layers": dec,
        "embed": embed,
        "dec_pos": dec_pos,
        "enc_ln": torch.ones((d,), dtype=dt, device=dev),
        "enc_ln_b": torch.zeros((d,), dtype=dt, device=dev),
        "dec_ln": torch.ones((d,), dtype=dt, device=dev),
        "dec_ln_b": torch.zeros((d,), dtype=dt, device=dev),
    }


def _ln(x: torch.Tensor, layer: PyTree, name: str,
        cfg: ModelConfig) -> torch.Tensor:
    return common.layer_norm(x, layer[name], layer[name + "_b"],
                             cfg.norm_eps)


def _encoder_layer(layer: PyTree, h: torch.Tensor, cfg: ModelConfig,
                   attn_impl: str) -> torch.Tensor:
    hn = _ln(h, layer, "ln1", cfg)
    h = h + attention.attention_forward(
        layer["self_attn"], hn, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta, causal=False, use_rope=False,
        impl=attn_impl)
    hn = _ln(h, layer, "ln2", cfg)
    return h + mlp.gelu_mlp_forward(layer["mlp"], hn)


def encode(params: PyTree, audio_embeds: torch.Tensor, cfg: ModelConfig,
           *, attn_impl: str = "auto") -> torch.Tensor:
    """audio_embeds: (B, T, d), the stubbed conv frontend's output; the
    sinusoidal positions are added in the compute dtype."""
    h = audio_embeds.to(cfg.compute_dtype)
    h = h + common.sinusoidal_positions(h.shape[1], cfg.d_model,
                                        h.device).to(h.dtype)
    for layer in common.layer_views(params["enc_layers"]):
        h = _encoder_layer(layer, h, cfg, attn_impl)
    return common.layer_norm(h, params["enc_ln"], params["enc_ln_b"],
                             cfg.norm_eps)


def _cross(layer: PyTree, hn: torch.Tensor, enc_out: torch.Tensor,
           cfg: ModelConfig, attn_impl: str) -> torch.Tensor:
    return attention.cross_attention_forward(
        layer["cross_attn"], hn, enc_out, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
        impl=attn_impl)


def _decoder_block(layer: PyTree, h: torch.Tensor, enc_out: torch.Tensor,
                   cfg: ModelConfig, positions: torch.Tensor,
                   attn_impl: str = "auto") -> torch.Tensor:
    hn = _ln(h, layer, "ln1", cfg)
    h = h + attention.attention_forward(
        layer["self_attn"], hn, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta, causal=True, use_rope=False,
        positions=positions, impl=attn_impl)
    hn = _ln(h, layer, "ln_x", cfg)
    h = h + _cross(layer, hn, enc_out, cfg, attn_impl)
    hn = _ln(h, layer, "ln2", cfg)
    return h + mlp.gelu_mlp_forward(layer["mlp"], hn)


def _embed_text(params: PyTree, tokens: torch.Tensor, start: int,
                cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings plus the learned positions ``start`` onwards."""
    S = tokens.shape[1]
    if start + S > MAX_TEXT_POSITIONS:
        raise IndexError(f"text positions {start}..{start + S - 1} past the "
                         f"{MAX_TEXT_POSITIONS} learned ones")
    h = params["embed"][tokens.long()].to(cfg.compute_dtype)
    return h + params["dec_pos"][start:start + S][None].to(h.dtype)


def _unembed(params: PyTree, h: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """The final norm and the head tied to ``embed``."""
    h = common.layer_norm(h, params["dec_ln"], params["dec_ln_b"],
                          cfg.norm_eps)
    return h @ params["embed"].T.to(h.dtype)


def forward(params: PyTree, tokens: torch.Tensor,
            audio_embeds: torch.Tensor, cfg: ModelConfig, *,
            remat: str = "none", attn_impl: str = "auto") -> torch.Tensor:
    """Teacher-forced decode over the whole text sequence: logits (B, S,
    V). ``remat`` wraps each decoder layer, as JAX's."""
    common.check_remat(remat)
    enc_out = encode(params, audio_embeds, cfg, attn_impl=attn_impl)
    h = _embed_text(params, tokens, 0, cfg)
    positions = torch.arange(tokens.shape[1], device=h.device)
    for layer in common.layer_views(params["dec_layers"]):
        h = common.remat_call(_decoder_block, remat, layer, h, enc_out, cfg,
                              positions, attn_impl)
    return _unembed(params, h, cfg)


def loss_fn(params: PyTree, batch: PyTree, cfg: ModelConfig, *,
            remat: str = "none") -> torch.Tensor:
    tokens = batch["tokens"]
    logits = forward(params, tokens[:, :-1], batch["audio_embeds"], cfg,
                     remat=remat)
    return common.cross_entropy_loss(logits, tokens[:, 1:],
                                     batch.get("mask"))


# --------------------------- prefill / decode -------------------------------


class WhisperCache(NamedTuple):
    """self_k, self_v: (L, B, S_max, n_kv, hd); cross_k, cross_v: (L, B,
    T_audio, n_kv, hd), the encoder's K/V with their biases, made once in
    the prefill; ``index``: the next write position, a host int."""
    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    index: int


def _biased(x: torch.Tensor, params: PyTree, w: str, b: str
            ) -> torch.Tensor:
    return x @ params[w].to(x.dtype) + params[b].to(x.dtype)


def prefill(params: PyTree, tokens: torch.Tensor,
            audio_embeds: torch.Tensor, cfg: ModelConfig, *,
            cache_len: Optional[int] = None, attn_impl: str = "auto"
            ) -> Tuple[torch.Tensor, WhisperCache]:
    """Encode the audio, run the prompt, build the cache; returns the last
    position's logits (B, 1, V). Slot i of the self cache holds position
    i, zero past the prompt."""
    enc_out = encode(params, audio_embeds, cfg, attn_impl=attn_impl)
    B, S = tokens.shape
    cache_len = cache_len or S
    if cache_len < S:
        raise ValueError(f"cache_len={cache_len} cannot hold the {S}-token "
                         "prompt")
    T = enc_out.shape[1]
    Hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    h = _embed_text(params, tokens, 0, cfg)
    L, dt, dev = cfg.n_layers, h.dtype, h.device
    ks = torch.zeros((L, B, cache_len, Hk, hd), dtype=dt, device=dev)
    vs = torch.zeros_like(ks)
    cks = torch.empty((L, B, T, Hk, hd), dtype=dt, device=dev)
    cvs = torch.empty_like(cks)
    for i, layer in enumerate(common.layer_views(params["dec_layers"])):
        hn = _ln(h, layer, "ln1", cfg)
        q, k, v = attention._project_qkv(layer["self_attn"], hn,
                                         cfg.n_heads, Hk, hd)
        ao = attention.sdpa(q, k, v, causal=True, impl=attn_impl)
        h = h + ao @ layer["self_attn"]["wo"].to(ao.dtype)
        hn = _ln(h, layer, "ln_x", cfg)
        h = h + _cross(layer, hn, enc_out, cfg, attn_impl)
        # the cross K/V are fixed for the request: made once for decode
        xa = layer["cross_attn"]
        cks[i] = _biased(enc_out, xa, "wk", "bk").reshape(B, T, Hk, hd)
        cvs[i] = _biased(enc_out, xa, "wv", "bv").reshape(B, T, Hk, hd)
        hn = _ln(h, layer, "ln2", cfg)
        h = h + mlp.gelu_mlp_forward(layer["mlp"], hn)
        ks[i, :, :S] = k
        vs[i, :, :S] = v
    logits = _unembed(params, h[:, -1:, :], cfg)
    return logits, WhisperCache(ks, vs, cks, cvs, S)


def decode_step(params: PyTree, cache: WhisperCache, token: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, WhisperCache]:
    """One-token decode: token (B,) int; returns (logits (B, V), the cache
    with the new self K/V written in place and its index advanced)."""
    B = token.shape[0]
    index = int(cache.index)
    hd = cfg.resolved_head_dim
    h = _embed_text(params, token[:, None], index, cfg)
    mask = attention.decode_mask(cache.self_k.shape[2], index,
                                 device=h.device)
    for i, layer in enumerate(common.layer_views(params["dec_layers"])):
        hn = _ln(h, layer, "ln1", cfg)
        ao, _, _ = attention.decode_attention(
            layer["self_attn"], hn, cache.self_k[i], cache.self_v[i], index,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=hd,
            rope_theta=cfg.rope_theta, use_rope=False, mask=mask)
        h = h + ao
        hn = _ln(h, layer, "ln_x", cfg)
        xa = layer["cross_attn"]
        q = _biased(hn, xa, "wq", "bq").reshape(B, 1, cfg.n_heads, hd)
        probs = torch.softmax(attention._gqa_scores(q, cache.cross_k[i]),
                              dim=-1)
        ao = attention._gqa_out(probs, cache.cross_v[i])
        h = h + ao @ xa["wo"].to(ao.dtype)
        hn = _ln(h, layer, "ln2", cfg)
        h = h + mlp.gelu_mlp_forward(layer["mlp"], hn)
    logits = _unembed(params, h, cfg)[:, 0, :]
    return logits, cache._replace(index=index + 1)
