"""RWKV6 "Finch" (arXiv:2404.05892), the ssm family: the port of
``repro.models.rwkv6``. Attention-free LM with a data-dependent
per-channel decay; arch rwkv6-3b (32L, d_model=2560, d_ff=8960,
vocab=65536).

Per layer, as in JAX:

  time-mix:  r, k, v, g, w from static lerps of (x, x_{t-1}); decay
             w_t = exp(-exp(w0 + tanh(x_w A) B)) in (0, 1)^d; the WKV
             state S in R^{H x D x D}:
                 y_t = r_t . (S + (u * k_t) (x) v_t)
                 S  <- diag(w_t) S + k_t (x) v_t
             y -> per-head groupnorm -> * silu(g) -> W_o
  channel-mix: k = relu(lerp @ W_k)^2 ; out = sigmoid(lerp @ W_r) * (k W_v)

Layers are stacked as in JAX (every per-layer leaf has a leading
``n_layers`` dim, JAX's key names), and ``lax.scan`` over the stack is a
loop over views ``layers[leaf][i]``. The rounding points are JAX's: r, k,
v in the compute dtype, the decay, the scan, the group norm and the gates
in f32, ``(y * g)`` cast to the compute dtype before ``W_o``. The leaves
in ``F32_LEAVES`` are read in f32 wherever they are used, so a compute-
dtype copy of the params keeps them as they are.

``wkv_impl`` picks the recurrence: ``"scan"`` (JAX's ``"xla"``) the plain
loop, ``"kernel"`` (JAX's ``"pallas"``) ``ops.rwkv_scan``, the CUDA kernel
on a CUDA tensor and the same plain loop on a CPU one. The kernel has no
backward, so training (``loss_fn``, with the ``remat`` policy around each
layer) takes ``"scan"``, as JAX's trains through ``"xla"``.

Entry points:
  forward(params, tokens, cfg, ...)        -> (logits, RWKVCache)
  prefill(params, tokens, cfg, ...)        -> (last logits, RWKVCache)
  decode_step(params, cache, token, cfg)   -> (logits, RWKVCache)
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv_scan import rwkv_scan_plain
from repro_torch.models import common

PyTree = Any
WKV_IMPLS = ("scan", "kernel")
# per-layer leaves every use reads in f32 (_decay, the scan's bonus u,
# _group_norm): a compute-dtype copy of them would move the decays
F32_LEAVES = ("w0", "w_A", "w_B", "u", "gn", "gn_b")


# ------------------------------- params -------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """One layer's params, drawn from ``gen`` at JAX's init scales."""
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    H = d // hs
    rank = cfg.rwkv_decay_rank
    dt, dev = cfg.param_dtype, gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    def dense(d_in, d_out, scale=None):
        return common.dense_init(gen, d_in, d_out, dt, scale=scale)

    return {
        "ln1": full((d,), 1.0), "ln1_b": full((d,), 0.0),
        "ln2": full((d,), 1.0), "ln2_b": full((d,), 0.0),
        "mix": full((5, d), 0.5),                    # r, k, v, w, g lerps
        "w_r": dense(d, d), "w_k": dense(d, d), "w_v": dense(d, d),
        "w_g": dense(d, d), "w_o": dense(d, d),
        "w0": full((d,), -5.0),                      # base decay (slow)
        "w_A": dense(d, rank, scale=0.01),
        "w_B": dense(rank, d, scale=0.01),
        "u": (torch.randn((H, hs), generator=gen, device=dev,
                          dtype=torch.float32) * 0.1).to(dt),
        "gn": full((d,), 1.0), "gn_b": full((d,), 0.0),
        "cm_mix": full((2, d), 0.5),                 # channel-mix (k, r)
        "cm_k": dense(d, cfg.d_ff), "cm_v": dense(cfg.d_ff, d),
        "cm_r": dense(d, d),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """The model's params on ``gen.device``: the embedding, the layers in
    order (``common.stack_layers``), then the final norm and the untied
    head."""
    dt, dev = cfg.param_dtype, gen.device
    embed = common.embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
    layers = common.stack_layers(cfg.n_layers, lambda: init_layer(gen, cfg))
    return {
        "embed": embed, "layers": layers,
        "ln_out": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "ln_out_b": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": common.dense_init(gen, cfg.d_model, cfg.vocab_size, dt),
    }


# ------------------------------ primitives ----------------------------------


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """x: (B, S, d) -> previous-token features; prev (B, d) seeds t=0."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _lerp(x, xp, mu):
    return x + mu.to(x.dtype) * (xp - x)


def _decay(layer: PyTree, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay w_t in (0,1): exp(-exp(w0 + tanh(x A) B)), in
    f32."""
    f32 = torch.float32
    low = torch.tanh(xw.to(f32) @ layer["w_A"].to(f32))
    logw = layer["w0"].to(f32) + low @ layer["w_B"].to(f32)
    return torch.exp(-torch.exp(logw))


# the sequential WKV recurrence, JAX's jnp path: the kernel module's plain
# version (r, k, v, w (B, S, H, D); u (H, D); state (B, H, D, D) [key x
# value] -> (y (B, S, H, D), final state), both f32)
wkv_scan = rwkv_scan_plain


def _group_norm(y: torch.Tensor, w, b, H: int, eps: float = 64e-5
                ) -> torch.Tensor:
    """Per-head LayerNorm over the head dim, in f32. y: (B, S, H*D)."""
    B, S, d = y.shape
    yh = y.reshape(B, S, H, d // H).to(torch.float32)
    mu = torch.mean(yh, dim=-1, keepdim=True)
    var = torch.mean(torch.square(yh - mu), dim=-1, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return (yh.reshape(B, S, d) * w.to(torch.float32)
            + b.to(torch.float32))


# ------------------------------- blocks -------------------------------------


def time_mix(layer: PyTree, x: torch.Tensor, cfg: ModelConfig,
             prev_x: Optional[torch.Tensor], state: torch.Tensor,
             wkv_impl: str = "scan"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, last_x, new_state). x: (B, S, d) post-ln; the state
    enters the recurrence in f32 and leaves in its own dtype."""
    B, S, d = x.shape
    hs = cfg.rwkv_head_size
    H = d // hs
    dt = x.dtype
    xp = _token_shift(x, prev_x)
    mix = layer["mix"]
    xr, xk, xv, xw, xg = (_lerp(x, xp, mix[i]) for i in range(5))
    r = (xr @ layer["w_r"].to(dt)).reshape(B, S, H, hs)
    k = (xk @ layer["w_k"].to(dt)).reshape(B, S, H, hs)
    v = (xv @ layer["w_v"].to(dt)).reshape(B, S, H, hs)
    g = F.silu((xg @ layer["w_g"].to(dt)).to(torch.float32))
    w = _decay(layer, xw).reshape(B, S, H, hs)
    s32 = state.to(torch.float32)
    if wkv_impl == "kernel":
        y, new_state = ops.rwkv_scan(r, k, v, w, layer["u"], s32)
    elif wkv_impl == "scan":
        y, new_state = wkv_scan(r, k, v, w, layer["u"], s32)
    else:
        raise ValueError(f"wkv_impl must be one of {WKV_IMPLS}, got "
                         f"{wkv_impl!r}")
    y = _group_norm(y.reshape(B, S, d), layer["gn"], layer["gn_b"], H)
    out = (y * g).to(dt) @ layer["w_o"].to(dt)
    return out, x[:, -1, :], new_state.to(state.dtype)


def channel_mix(layer: PyTree, x: torch.Tensor,
                prev_x: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = x.dtype
    xp = _token_shift(x, prev_x)
    xk = _lerp(x, xp, layer["cm_mix"][0])
    xr = _lerp(x, xp, layer["cm_mix"][1])
    k = torch.square(torch.relu(xk @ layer["cm_k"].to(dt)))
    out = torch.sigmoid((xr @ layer["cm_r"].to(dt)).to(torch.float32)
                        ).to(dt) * (k @ layer["cm_v"].to(dt))
    return out, x[:, -1, :]


def _layer(layer: PyTree, h: torch.Tensor, cfg: ModelConfig, tm_prev,
           cm_prev, state, wkv_impl="scan"):
    hn = common.layer_norm(h, layer["ln1"], layer["ln1_b"], cfg.norm_eps)
    out, tm_x, state = time_mix(layer, hn, cfg, tm_prev, state, wkv_impl)
    h = h + out
    hn = common.layer_norm(h, layer["ln2"], layer["ln2_b"], cfg.norm_eps)
    out, cm_x = channel_mix(layer, hn, cm_prev)
    return h + out, tm_x, cm_x, state


# ----------------------------- full forward ---------------------------------


class RWKVCache(NamedTuple):
    tm_x: torch.Tensor   # (L, B, d)   last token-shift input, time-mix
    cm_x: torch.Tensor   # (L, B, d)   last token-shift input, channel-mix
    wkv: torch.Tensor    # (L, B, H, D, D) WKV state
    index: int           # tokens seen (a host int; JAX's int32 scalar)


def init_cache(cfg: ModelConfig, batch: int, dtype=None,
               device: "str | torch.device" = "cpu") -> RWKVCache:
    """Zero state: the token shifts in ``dtype`` (default the compute
    dtype), the WKV state in f32."""
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    L = cfg.n_layers
    dtype = dtype or cfg.compute_dtype
    return RWKVCache(
        torch.zeros((L, batch, d), dtype=dtype, device=device),
        torch.zeros((L, batch, d), dtype=dtype, device=device),
        torch.zeros((L, batch, d // hs, hs, hs), dtype=torch.float32,
                    device=device), 0)


def _backbone(params: PyTree, tokens: torch.Tensor, cfg: ModelConfig,
              cache: Optional[RWKVCache], remat: str, wkv_impl: str
              ) -> Tuple[torch.Tensor, RWKVCache]:
    """Embed, every layer, the final norm: (h (B, S, d), new cache)."""
    common.check_remat(remat)
    # JAX checkpoints the whole scan body for any policy but "none"
    policy = "none" if remat == "none" else "full"
    B, S = tokens.shape
    h = params["embed"][tokens.long()].to(cfg.compute_dtype)
    if cache is None:
        cache = init_cache(cfg, B, device=h.device)
    tm: List[torch.Tensor] = []
    cm: List[torch.Tensor] = []
    wkv: List[torch.Tensor] = []
    for i, layer in enumerate(common.layer_views(params["layers"])):
        h, tm_x, cm_x, st = common.remat_call(
            _layer, policy, layer, h, cfg, cache.tm_x[i], cache.cm_x[i],
            cache.wkv[i], wkv_impl)
        tm.append(tm_x)
        cm.append(cm_x)
        wkv.append(st)
    h = common.layer_norm(h, params["ln_out"], params["ln_out_b"],
                          cfg.norm_eps)
    return h, RWKVCache(torch.stack(tm), torch.stack(cm), torch.stack(wkv),
                        int(cache.index) + S)


def _unembed(params: PyTree, h: torch.Tensor) -> torch.Tensor:
    return h @ params["lm_head"].to(h.dtype)


def forward(params: PyTree, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache: Optional[RWKVCache] = None, remat: str = "none",
            wkv_impl: str = "scan") -> Tuple[torch.Tensor, RWKVCache]:
    """Full-sequence forward (train / prefill). tokens (B, S) int.
    Returns (logits (B, S, V), cache)."""
    h, new_cache = _backbone(params, tokens, cfg, cache, remat, wkv_impl)
    return _unembed(params, h), new_cache


def loss_fn(params: PyTree, batch: PyTree, cfg: ModelConfig, *,
            remat: str = "none") -> torch.Tensor:
    """Mean next-token CE of batch['tokens'] (B, S+1), through the plain
    scan (the kernel has no backward)."""
    tokens = batch["tokens"]
    logits, _ = forward(params, tokens[:, :-1], cfg, remat=remat)
    return common.cross_entropy_loss(logits, tokens[:, 1:],
                                     batch.get("mask"))


def prefill(params: PyTree, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache_len: Optional[int] = None, wkv_impl: str = "scan"
            ) -> Tuple[torch.Tensor, RWKVCache]:
    """Run the prompt; returns the last position's logits (B, 1, V) and
    the recurrent cache. ``cache_len`` is ignored, as in JAX: the state
    does not grow with the context. Only the last position goes through
    the head (JAX computes every position's logits and slices)."""
    h, cache = _backbone(params, tokens, cfg, None, "none", wkv_impl)
    return _unembed(params, h[:, -1:, :]), cache


def decode_step(params: PyTree, cache: RWKVCache, token: torch.Tensor,
                cfg: ModelConfig, *, wkv_impl: str = "scan"
                ) -> Tuple[torch.Tensor, RWKVCache]:
    """One-token decode. token: (B,) int; returns (logits (B, V), the
    advanced cache)."""
    logits, cache = forward(params, token[:, None], cfg, cache=cache,
                            wkv_impl=wkv_impl)
    return logits[:, 0, :], cache
