"""Grouped-query attention with RoPE, sliding windows and KV caches, the
port of ``repro.models.attention``.

``sdpa`` dispatches between the materialised-score path (``"naive"``),
the online-softmax path tiled in torch ops (``"chunked"``, JAX's
flash-in-XLA), and the hand-written CUDA flash kernel (``"kernel"``,
through ``kernels.ops.flash_attention``: JAX's ``impl="pallas"``).
``"auto"`` keeps JAX's rule: chunked from ``AUTO_CHUNK_THRESHOLD`` score
elements per head on, naive below. The serving path (``DecodeEngine``)
passes ``"kernel"``.

JAX's activation-sharding context (``activation_sharding`` /
``_shard_heads``) constrains q/k/v under a device mesh and is a no-op
outside one; it is left out until the port has a mesh (ROADMAP queue 1:
multi-GPU comm).

The cache write position is a host int: positions, the rotating slot and
the validity mask are decided on the host, so no decode step reads the
device. Decode writes the new K/V into the cache in place.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import common

PyTree = Any
NEG_INF = -1e30
IMPLS = ("auto", "naive", "chunked", "kernel")
# S*T from which 'auto' picks the tiled online-softmax path
AUTO_CHUNK_THRESHOLD = 2048 * 2048


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                   qkv_bias: bool = False) -> PyTree:
    p = {
        "wq": common.dense_init(gen, d_model, n_heads * head_dim, dtype),
        "wk": common.dense_init(gen, d_model, n_kv_heads * head_dim, dtype),
        "wv": common.dense_init(gen, d_model, n_kv_heads * head_dim, dtype),
        "wo": common.dense_init(gen, n_heads * head_dim, d_model, dtype),
    }
    if qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype,
                              device=dev)
        p["bv"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype,
                              device=dev)
    return p


def _project_qkv(params: PyTree, x: torch.Tensor, n_heads: int, n_kv: int,
                 head_dim: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, n_kv, head_dim),
            v.reshape(B, S, n_kv, head_dim))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,S,Hq,D), k (B,T,Hk,D) -> f32 scores (B,Hk,G,S,T); JAX's
    ``preferred_element_type=f32`` is an f32 product of the upcast
    operands (exact for bf16 inputs)."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    qg = q.reshape(B, S, Hk, Hq // Hk, D).to(torch.float32)
    return torch.einsum("bskgd,btkd->bkgst", qg,
                        k.to(torch.float32)) / math.sqrt(D)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,Hk,G,S,T), v (B,T,Hk,D) -> (B,S,Hq*D) in v's dtype."""
    B, Hk, G, S, T = probs.shape
    D = v.shape[-1]
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, Hk * G * D)


def _mask_scores(scores: torch.Tensor, q_pos: torch.Tensor,
                 k_pos: torch.Tensor, causal: bool, window: int,
                 k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add the causal / sliding-window / validity masks (0 or -1e30) in
    f32 score space. q_pos (S,), k_pos (T,) absolute positions."""
    S, T = scores.shape[-2], scores.shape[-1]
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=scores.device)
    if causal:
        ok = ok & (dk <= dq)
    if window and window > 0:
        ok = ok & (dq - dk < window)
    scores = scores + torch.where(ok, 0.0, NEG_INF)
    if k_valid is not None:  # (B, T) per-batch validity
        scores = scores + torch.where(k_valid, 0.0,
                                      NEG_INF)[:, None, None, None, :]
    return scores


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, chunk_q: int = 2048,
                        chunk_kv: int = 2048) -> torch.Tensor:
    """Online-softmax attention tiled in torch ops (JAX's flash-in-XLA,
    ``impl="chunked"``): never materialises the (S, T) score matrix. A
    loop tiles the query dim and, inside it, the KV chunks that the causal
    / window band reaches, with the carried (acc, max, sumexp) of JAX's
    ``lax.scan``. Chunk sizes shrink to divisors of S and T, as in JAX.

    q: (B, S, Hq, D); k, v: (B, T, Hk, D). Returns (B, S, Hq, D) in
    q.dtype."""
    B, S, Hq, D = q.shape
    T, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    cq = min(chunk_q, S)
    while S % cq:
        cq -= 1
    ckv = min(chunk_kv, T)
    while T % ckv:
        ckv -= 1
    n_kv = T // ckv
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = q.reshape(B, S, Hk, G, D)
    outs = []
    for i in range(S // cq):
        q_pos0 = q_offset + i * cq
        qc = qg[:, i * cq:(i + 1) * cq].to(torch.float32)
        q_pos = q_pos0 + torch.arange(cq, device=dev)
        lo_chunk, hi_chunk = 0, n_kv
        if causal:
            hi_chunk = min(n_kv, (q_pos0 + cq + ckv - 1) // ckv)
        if window and window > 0:
            lo_chunk = max(0, (q_pos0 - window + 1) // ckv)
        acc = torch.zeros((B, Hk, G, cq, D), dtype=torch.float32, device=dev)
        m = torch.full((B, Hk, G, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hk, G, cq), dtype=torch.float32, device=dev)
        for j in range(lo_chunk, hi_chunk):
            k_c = k[:, j * ckv:(j + 1) * ckv]
            v_c = v[:, j * ckv:(j + 1) * ckv]
            s = torch.einsum("bqkgd,btkd->bkgqt", qc,
                             k_c.to(torch.float32)) * scale
            k_pos = j * ckv + torch.arange(ckv, device=dev)
            ok = torch.ones((cq, ckv), dtype=torch.bool, device=dev)
            if causal:
                ok = ok & (k_pos[None, :] <= q_pos[:, None])
            if window and window > 0:
                ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
            s = s + torch.where(ok, 0.0, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(v_c.dtype), v_c)
            acc = acc * corr[..., None] + pv.to(torch.float32)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        # (B, Hk, G, cq, D) -> (B, cq, Hk, G, D)
        outs.append(torch.movedim(out, 3, 1).to(q.dtype))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(B, S, Hq, D)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, window: int = 0, q_offset: int = 0,
         impl: str = "auto") -> torch.Tensor:
    """Scaled-dot-product attention dispatcher.

    impl: ``"naive"`` (materialised scores), ``"chunked"`` (online softmax
    in torch ops), ``"kernel"`` (the CUDA flash kernel; the plain version
    on CPU tensors), ``"auto"`` (chunked when the score matrix would
    reach AUTO_CHUNK_THRESHOLD elements per head). The kernel counts
    positions from 0, so it takes no ``q_offset``. Returns (B, S, Hq*D)."""
    B, S, Hq, D = q.shape
    T = k.shape[1]
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        impl = "chunked" if S * T >= AUTO_CHUNK_THRESHOLD else "naive"
    if impl == "kernel":
        if q_offset:
            raise ValueError("the flash kernel counts query positions from "
                             "0; q_offset needs impl='naive' or 'chunked'")
        out = kops.flash_attention(q, k, v, causal=causal, window=window)
    elif impl == "chunked":
        out = flash_attention_xla(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    else:
        q_pos = q_offset + torch.arange(S, device=q.device)
        k_pos = torch.arange(T, device=q.device)
        scores = _gqa_scores(q, k)
        scores = _mask_scores(scores, q_pos, k_pos, causal, window)
        probs = torch.softmax(scores, dim=-1)
        out = _gqa_out(probs, v).reshape(B, S, Hq, D)
    return out.reshape(B, S, Hq * D)


def attention_forward(params: PyTree, x: torch.Tensor, *, n_heads: int,
                      n_kv_heads: int, head_dim: int, rope_theta: float,
                      causal: bool = True, window: int = 0,
                      positions: Optional[torch.Tensor] = None,
                      use_rope: bool = True,
                      impl: str = "auto") -> torch.Tensor:
    """Full-sequence attention (training / prefill). x: (B, S, d_model)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    pos = (positions if positions is not None
           else torch.arange(S, device=x.device))
    if use_rope:
        q = common.apply_rope(q, pos.expand(B, S), rope_theta)
        k = common.apply_rope(k, pos.expand(B, S), rope_theta)
    out = sdpa(q, k, v, causal=causal, window=window, impl=impl)
    return out @ params["wo"].to(out.dtype)


def cross_attention_forward(params: PyTree, x: torch.Tensor,
                            kv: torch.Tensor, *, n_heads: int,
                            n_kv_heads: int, head_dim: int,
                            impl: str = "auto") -> torch.Tensor:
    """Encoder-decoder cross attention (whisper), non-causal. x: (B, S,
    d_model), kv: (B, T, d_model). Like JAX's, it adds no ``bq``, ``bk``
    or ``bv``: the decode path does (``models.whisper``), so with nonzero
    cross biases decode parts from this forward in both packages."""
    B, S, _ = x.shape
    T = kv.shape[1]
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, S, n_heads, head_dim)
    k = (kv @ params["wk"].to(dt)).reshape(B, T, n_kv_heads, head_dim)
    v = (kv @ params["wv"].to(dt)).reshape(B, T, n_kv_heads, head_dim)
    out = sdpa(q, k, v, causal=False, impl=impl)
    return out @ params["wo"].to(out.dtype)


# ------------------------------ KV cache ------------------------------------


class KVCache(NamedTuple):
    """Per-layer-stacked KV cache.

    k, v: (L, B, S_max, n_kv, head_dim). ``index``: the next write
    position, a host int (the number of tokens already cached). For
    sliding-window archs S_max = window and writes wrap (rotating
    cache)."""
    k: torch.Tensor
    v: torch.Tensor
    index: int

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_kv_cache(n_layers: int, batch: int, max_len: int, n_kv: int,
                  head_dim: int, dtype: torch.dtype,
                  device: "str | torch.device" = "cpu") -> KVCache:
    shape = (n_layers, batch, max_len, n_kv, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def decode_mask(S_max: int, index: int, *, window: int = 0,
                rotating: bool = False,
                device: "str | torch.device" = "cpu") -> torch.Tensor:
    """The additive (0 / -1e30) mask over the S_max cache slots for the
    token at absolute position ``index``, made from host ints."""
    slots = torch.arange(S_max, device=device)
    if rotating:
        # slot s holds the largest position q <= index with q % S_max == s
        abs_pos = index - torch.remainder(index - slots, S_max)
        valid = abs_pos >= max(0, index - S_max + 1)
    else:
        abs_pos = slots
        valid = slots <= index
    if window and window > 0:
        valid = valid & (index - abs_pos < window)
    return torch.where(valid, 0.0, NEG_INF)


def decode_attention(params: PyTree, x: torch.Tensor,
                     layer_k: torch.Tensor, layer_v: torch.Tensor,
                     index: int, *, n_heads: int, n_kv_heads: int,
                     head_dim: int, rope_theta: float, window: int = 0,
                     rotating: bool = False, use_rope: bool = True,
                     rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a cache slice.

    x: (B, 1, d_model); layer_k/v: (B, S_max, n_kv, hd), written IN PLACE
    at ``index`` (``index % S_max`` with ``rotating``). Returns
    (out (B,1,d_model), layer_k, layer_v). ``index`` is the absolute
    position of the new token, a host int. ``rope`` (``common.
    rope_tables`` at ``index``) and ``mask`` (:func:`decode_mask`) may be
    passed in, made once for all layers of a step; they are the values
    made here otherwise."""
    B = x.shape[0]
    S_max = layer_k.shape[1]
    index = int(index)
    dev = x.device
    q, k_new, v_new = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    if use_rope:
        if rope is None:
            pos_new = torch.full((B, 1), index, dtype=torch.int32,
                                 device=dev)
            rope = common.rope_tables(pos_new, head_dim, rope_theta)
        q = common.rotate(q, rope)
        k_new = common.rotate(k_new, rope)
    slot = (index % S_max) if rotating else index
    if not 0 <= slot < S_max:
        raise IndexError(f"cache position {index} past the cache's "
                         f"{S_max} slots")
    layer_k[:, slot] = k_new[:, 0].to(layer_k.dtype)
    layer_v[:, slot] = v_new[:, 0].to(layer_v.dtype)
    if mask is None:
        mask = decode_mask(S_max, index, window=window, rotating=rotating,
                           device=dev)
    scores = _gqa_scores(q, layer_k)  # (B, Hk, G, 1, S_max)
    scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, layer_v)
    out = out @ params["wo"].to(out.dtype)
    return out, layer_k, layer_v
