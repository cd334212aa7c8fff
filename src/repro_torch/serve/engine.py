"""Serving engine: cache specs, decode steps and the batched bucket
engine, the port of ``repro.serve.engine``.

``cache_spec`` gives the shapes and dtypes of the decode cache (it
allocates nothing); ``make_serve_step`` / ``make_prefill_step`` the
one-token decode and the prefill; :class:`DecodeEngine` is the serving
path: padded-bucket batching over a fixed set of ``(batch, seq)`` shapes,
batched prefill plus decode through the family's CUDA kernel (the flash
kernel in the prefill of the dense, MoE and vlm families, of the
hybrid's shared attention block, and of whisper's encoder, decoder and
cross-attention; the WKV kernel in the ssm family's prefill and every
decode step), optional bf16 cache storage, and lock-free param
hot-swap through a ``serve.publish.ParamStore``.

**Why seq padding is exact** (JAX's bucket contract): decode attention
masks cache slots with ``slot <= index`` and writes the new token at
``index``. A prompt of true length L right-padded to a bucket length S
prefills pad K/V into slots [L, S); the engine then REWINDS the cache
index to L-1 and re-feeds the last real token: that decode step
recomputes slot L-1's K/V from the same token and rope position, attends
only to slots <= L-1, and yields the logits of an unpadded prefill. Every
later step overwrites one pad slot before the mask reaches it. This holds
for positional, non-rotating KV caches (a vlm prompt's positions start
after its ``n_patches`` image positions, so its rewind index is
``L - 1 + n_patches``); with a rotating window, in the recurrent state of
the ssm and hybrid families, and in whisper (the JAX engine pads only the
dense, MoE and vlm families), the engine pads only the batch dim.
``generate_batch(extras=)`` carries a family's other prefill inputs
(``patches``, ``audio_embeds``); ``generate`` passes none, as JAX's. A
MoE layer routes the pad tokens too, which take expert capacity from the
real ones, as in JAX.

JAX states that contract bit for bit. On the card a ``(B, 1, d)`` and a
``(B, S, d)`` projection may take GEMM kernels that round differently, so
the port holds it as: tokens equal at ``compute_dtype=float32``; at bf16,
tokens equal wherever the top-2 logit gap exceeds the two paths' logit
difference (within 2e-2 at the reduced config).

**The engine casts the params once per published version** to the
compute dtype (``cast_params``), where JAX writes ``x @ W.astype(bf16)``
in every projection and XLA fuses the convert into the dot: eagerly that
would re-read and re-write every f32 weight on every decode step. The
leaves a family reads in f32 (``ModelAPI.f32_leaves``: RWKV6's decay,
bonus and group-norm leaves, Mamba2's ``A_log``, ``D`` and ``dt_bias``,
the MoE router) stay as they are, so the values are
identical to a per-call cast; the copy costs half the f32 params' memory.

The positions, the rewind and the rotating slot are host ints, so no
decode step reads the device; the tokens stay on the device until the
final ``stack``. JAX pins one compiled program per bucket with
``RecompileWatch``; the port runs eagerly and keeps the same contract with
:class:`~repro_torch.analysis.recompile.SignatureWatch` (the trainer's
too) over the signature of each phase's inputs: their structure, each
tensor's shape, dtype and device, each host value's type (CUDA-graph
capture per bucket is later work).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, \
    Sequence, Tuple

import torch

from repro_torch._tree import tree_map
from repro_torch.analysis.recompile import RecompileError, SignatureWatch
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import attention, hybrid, rwkv6, whisper
from repro_torch.models.registry import build_model, impl_kwargs

PyTree = Any
# a family's decode cache: attention.KVCache, rwkv6.RWKVCache,
# hybrid.HybridCache or whisper.WhisperCache
Cache = Any


class TensorSpec(NamedTuple):
    """The shape and dtype of a tensor that is not allocated."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def effective_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Apply the long-context window substitution for long_500k."""
    if (shape.name == "long_500k" and cfg.long_context_window
            and cfg.family in ("dense", "moe", "vlm", "hybrid")):
        return dataclasses.replace(cfg,
                                   sliding_window=cfg.long_context_window)
    return cfg


def kv_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
               cache_dtype: torch.dtype = torch.bfloat16
               ) -> Cache:
    """The decode cache's shapes and dtypes as a ``KVCache``, an
    ``RWKVCache``, a ``HybridCache`` or a ``WhisperCache`` of
    :class:`TensorSpec` (the index: a host int, spec'd as JAX's int32
    scalar). As in JAX, the recurrent states take the compute dtype and
    f32 whatever ``cache_dtype`` says (the hybrid's KV sites take
    ``cache_dtype``); whisper's self K/V take ``seq_len`` slots and its
    cross K/V ``n_audio_ctx``, both in ``cache_dtype``."""
    L = cfg.n_layers
    hd = cfg.resolved_head_dim
    idx = TensorSpec((), torch.int32)
    if cfg.family in ("dense", "moe", "vlm"):
        S = kv_cache_len(cfg, seq_len)
        kv = TensorSpec((L, batch, S, cfg.n_kv_heads, hd), cache_dtype)
        return attention.KVCache(kv, kv, idx)
    if cfg.family == "ssm":
        d, hs = cfg.d_model, cfg.rwkv_head_size
        x = TensorSpec((L, batch, d), cfg.compute_dtype)
        return rwkv6.RWKVCache(
            x, x, TensorSpec((L, batch, d // hs, hs, hs), torch.float32),
            idx)
    if cfg.family == "hybrid":
        di, N = cfg.d_inner, cfg.ssm_state
        H = cfg.resolved_ssm_heads
        kv = TensorSpec((hybrid.n_attn_sites(cfg), batch,
                         kv_cache_len(cfg, seq_len), cfg.n_kv_heads, hd),
                        cache_dtype)
        return hybrid.HybridCache(
            TensorSpec((L, batch, cfg.ssm_conv - 1, di + 2 * N),
                       cfg.compute_dtype),
            TensorSpec((L, batch, H, di // H, N), torch.float32), kv, kv,
            idx)
    if cfg.family == "audio":
        kv = TensorSpec((L, batch, seq_len, cfg.n_kv_heads, hd), cache_dtype)
        xkv = TensorSpec((L, batch, cfg.n_audio_ctx, cfg.n_kv_heads, hd),
                         cache_dtype)
        return whisper.WhisperCache(kv, kv, xkv, xkv, idx)
    raise KeyError(cfg.family)


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, cache, token) -> (logits, cache): one decode step."""
    api = build_model(cfg)

    def serve_step(params, cache, token):
        return api.decode_step(params, cache, token)

    return serve_step


def make_prefill_step(cfg: ModelConfig, cache_len: int) -> Callable:
    """(params, batch) -> (logits, cache): the prefill at ``cache_len``."""
    api = build_model(cfg)

    def prefill_step(params, batch):
        return api.prefill(params, batch, cache_len=cache_len)

    return prefill_step


def cast_params(params: PyTree, dtype: torch.dtype,
                keep: Sequence[str] = ()) -> PyTree:
    """Every float leaf in ``dtype`` (a leaf already in it is kept, not
    copied), but the leaves under a dict key in ``keep``, which stay as
    they are. The dense family's forward casts every weight to the compute
    dtype where it uses it; the ssm family's does too, except for the
    leaves it reads in f32 (``rwkv6.F32_LEAVES``: ``w0``, ``w_A``, ``w_B``,
    ``u``, ``gn``, ``gn_b``), which a bf16 copy would round. So with
    ``keep=api.f32_leaves`` this changes no value: it moves the cast out
    of the per-step path."""
    if isinstance(params, dict):
        return {k: v if k in keep else cast_params(v, dtype, keep)
                for k, v in params.items()}
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)


def _argmax_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy tokens, int32; ``torch.argmax`` returns the first maximum,
    as ``jnp.argmax`` does."""
    if logits.dim() == 3:
        logits = logits[:, -1, :]
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ----------------------------- request serving ------------------------------


@torch.no_grad()
def greedy_generate(cfg: ModelConfig, params: PyTree, batch: PyTree,
                    n_new: int, *, cache_len: Optional[int] = None,
                    attn_impl: str = "auto", wkv_impl: str = "scan"
                    ) -> torch.Tensor:
    """Batched greedy decoding: prefill the prompt, then n_new - 1 decode
    steps. Returns (B, n_new) int32 on the prompt's device. ``attn_impl``
    (every family but ssm) or ``wkv_impl`` (ssm) picks the family's
    kernel path."""
    api = build_model(cfg)
    prefill_kw, decode_kw = impl_kwargs(cfg, attn_impl=attn_impl,
                                        wkv_impl=wkv_impl)
    prompt = batch["tokens"]
    B = prompt.shape[0]
    if n_new < 0:
        raise ValueError(f"n_new must be >= 0, got {n_new}")
    if n_new == 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=prompt.device)
    need = prompt.shape[1] + n_new + (cfg.n_patches or 0)
    if cache_len is None:
        cache_len = need
    elif cache_len < need:
        raise ValueError(
            f"cache_len={cache_len} cannot hold prompt + {n_new} new "
            f"tokens (need >= {need})")
    params = cast_params(params, cfg.compute_dtype, keep=api.f32_leaves)
    logits, cache = api.prefill(params, batch, cache_len=cache_len,
                                **prefill_kw)
    tok = _argmax_tokens(logits)
    out = [tok]
    for _ in range(n_new - 1):
        logits, cache = api.decode_step(params, cache, tok, **decode_kw)
        tok = _argmax_tokens(logits)
        out.append(tok)
    return torch.stack(out, dim=1)


# --------------------------- batched decode engine ---------------------------


def cast_cache(cache: Cache, cache_dtype: Optional[torch.dtype]) -> Cache:
    """Every float tensor of the cache in ``cache_dtype`` (bf16 halves the
    cache's memory and decode read traffic): K/V, the token shifts AND the
    WKV state, the conv and SSM states AND the K/V sites, or whisper's
    self AND cross K/V, as JAX casts every float leaf. The index passes
    through. ``None`` is the identity."""
    if cache_dtype is None:
        return cache
    return cache._replace(**{
        f: x.to(cache_dtype) for f, x in zip(cache._fields, cache)
        if isinstance(x, torch.Tensor) and x.is_floating_point()})


def select_bucket(buckets: Sequence[Tuple[int, int]], batch: int, seq: int,
                  *, pad_seq: bool = True) -> Tuple[int, int]:
    """The tightest ``(batch, seq)`` bucket that holds a request group.

    Seq is padded up to the nearest bucket seq (an exact match when
    ``pad_seq`` is False); batch up to the smallest bucket batch >=
    ``batch``, else the largest available (the caller then splits the
    group across calls)."""
    fits = [b for b in buckets if (b[1] >= seq if pad_seq else b[1] == seq)]
    if not fits:
        raise ValueError(
            f"no bucket holds seq={seq} (pad_seq={pad_seq}); "
            f"buckets={list(buckets)}")
    best_seq = min(s for _, s in fits)
    fits = [b for b in fits if b[1] == best_seq]
    exact = [b for b in fits if b[0] >= batch]
    return min(exact) if exact else max(fits)


class DecodeEngine:
    """Padded-bucket batched serving engine over a fixed shape set.

    Requests are grouped by prompt length and padded (batch up to the
    bucket's batch, seq, where exact, up to the bucket's seq), so every
    prefill and decode runs one of ``len(buckets)`` ``(batch, seq)``
    shapes; a :class:`SignatureWatch` per phase raises on a shape that
    escapes the set. Params come from a ``ParamStore`` (each call decodes
    one complete versioned snapshot) or a plain param tree.

    Args:
      cfg: the model config.
      source: a ``ParamStore`` or a param tree.
      buckets: the ``(batch, seq)`` shape set.
      max_new_tokens: per-bucket decode cache headroom (cache length
        ``seq + max_new_tokens``), so every ``n_new <= max_new_tokens``
        runs the same shapes.
      cache_dtype: optional storage dtype of the decode cache; ``None``
        keeps the prefill's. Must not be wider than ``cfg.compute_dtype``.
      recompile_limit: distinct signatures per phase; default
        ``len(buckets)``.
      attn_impl: the prefill ``sdpa`` impl of every family but the ssm
        one, the CUDA flash kernel by default (its plain version on a
        CPU tensor).
      wkv_impl: the ssm family's recurrence in prefill and decode, the
        CUDA WKV kernel by default (its plain version on a CPU tensor).
    """

    def __init__(self, cfg: ModelConfig, source: Any, *,
                 buckets: Sequence[Tuple[int, int]] = ((1, 32), (8, 32)),
                 max_new_tokens: int = 32,
                 cache_dtype: Optional[torch.dtype] = None,
                 recompile_limit: Optional[int] = None,
                 attn_impl: str = "kernel", wkv_impl: str = "kernel"):
        if not buckets:
            raise ValueError("DecodeEngine needs at least one bucket")
        if attn_impl not in attention.IMPLS:
            raise ValueError(f"attn_impl must be one of {attention.IMPLS}, "
                             f"got {attn_impl!r}")
        if wkv_impl not in rwkv6.WKV_IMPLS:
            raise ValueError(f"wkv_impl must be one of {rwkv6.WKV_IMPLS}, "
                             f"got {wkv_impl!r}")
        self.cfg = cfg
        self.api = build_model(cfg)
        self.buckets = tuple(sorted({(int(b), int(s)) for b, s in buckets}))
        self.max_new_tokens = int(max_new_tokens)
        if cache_dtype is not None and (cache_dtype.itemsize
                                        > cfg.compute_dtype.itemsize):
            # an upcast cache would widen the hidden state mid-decode; only
            # storage downcasts are meaningful
            raise ValueError(
                f"cache_dtype {cache_dtype} is wider than compute_dtype "
                f"{cfg.compute_dtype}; the KV cache dtype may only narrow "
                "storage")
        self.cache_dtype = cache_dtype
        self._prefill_kw, self._decode_kw = impl_kwargs(
            cfg, attn_impl=attn_impl, wkv_impl=wkv_impl)
        self._source = source
        self.pad_seq = (cfg.family in ("dense", "moe", "vlm")
                        and not cfg.sliding_window)
        limit = (len(self.buckets) if recompile_limit is None
                 else recompile_limit)
        self._watch_prefill = SignatureWatch("engine.prefill", limit)
        self._watch_decode = SignatureWatch("engine.decode", limit)
        self._cast_key: Any = None
        self._cast: PyTree = None
        self.last_version = 0

    # ------------------------------ internals ------------------------------

    def _params(self) -> Tuple[int, PyTree]:
        """The current snapshot's version and its compute-dtype copy, cast
        once per version (and per plain tree)."""
        snap = getattr(self._source, "snapshot", None)
        version, params = snap() if snap is not None else (0, self._source)
        key = (version, id(params))
        if key != self._cast_key:
            self._cast = None          # free the old copy before the new
            self._cast = cast_params(params, self.cfg.compute_dtype,
                                     keep=self.api.f32_leaves)
            self._cast_key = key
        return version, self._cast

    def cache_len_for(self, seq: int) -> int:
        """Per-bucket cache length: prompt slots + decode headroom (+ the
        vlm patch prefix)."""
        extra = self.cfg.n_patches or 0
        return kv_cache_len(self.cfg, seq + extra + self.max_new_tokens)

    @property
    def compile_counts(self) -> dict:
        """Distinct input signatures per phase, pinned at the bucket-set
        size."""
        return {"prefill": len(self._watch_prefill.signatures),
                "decode": len(self._watch_decode.signatures)}

    def _decode(self, params, cache, tok):
        self._watch_decode.observe(params, tuple(cache), tok)
        self._watch_decode.check()
        return self.api.decode_step(params, cache, tok, **self._decode_kw)

    # ------------------------------ execution ------------------------------

    @torch.no_grad()
    def generate_batch(self, tokens: torch.Tensor, n_new: int, *,
                       true_len: Optional[int] = None,
                       extras: Optional[dict] = None) -> torch.Tensor:
        """Greedy-decode one bucket-shaped batch.

        ``tokens``: (B, S) ints with (B, S) in the bucket set, right-padded
        past ``true_len`` (the shared real prompt length; default S).
        Returns (B, n_new) int32 on the tokens' device."""
        B, S = tokens.shape
        if (B, S) not in self.buckets:
            raise ValueError(
                f"batch shape ({B}, {S}) is not in the bucket set "
                f"{list(self.buckets)}; pad requests with generate()")
        if n_new < 0:
            raise ValueError(f"n_new must be >= 0, got {n_new}")
        if n_new > self.max_new_tokens:
            raise ValueError(
                f"n_new={n_new} exceeds max_new_tokens="
                f"{self.max_new_tokens} (the per-bucket cache headroom)")
        if n_new == 0:
            return torch.zeros((B, 0), dtype=torch.int32,
                               device=tokens.device)
        L = S if true_len is None else int(true_len)
        if not 0 < L <= S:
            raise ValueError(f"true_len={L} out of range for seq {S}")
        if L < S and not self.pad_seq:
            raise ValueError(
                f"family {self.cfg.family!r} (or a rotating window) folds "
                "pad tokens into its decode state; seq must match a "
                "bucket exactly (pad_seq=False)")
        tokens = tokens.to(torch.int32)
        version, params = self._params()
        batch = {"tokens": tokens, **(extras or {})}
        self._watch_prefill.observe(params, batch)
        self._watch_prefill.check()
        logits, cache = self.api.prefill(params, batch,
                                         cache_len=self.cache_len_for(S),
                                         **self._prefill_kw)
        cache = cast_cache(cache, self.cache_dtype)
        if L == S:
            tok = _argmax_tokens(logits)
        else:
            # rewind + re-feed: recompute slot L-1, attend only to real
            # slots, recover the true last position's logits
            extra = self.cfg.n_patches or 0
            cache = cache._replace(index=L - 1 + extra)
            logits, cache = self._decode(params, cache, tokens[:, L - 1])
            tok = _argmax_tokens(logits)
        out = [tok]
        for _ in range(n_new - 1):
            logits, cache = self._decode(params, cache, tok)
            tok = _argmax_tokens(logits)
            out.append(tok)
        self.last_version = version
        return torch.stack(out, dim=1)

    def generate(self, prompts: Sequence[torch.Tensor], n_new: int
                 ) -> List[torch.Tensor]:
        """Serve a ragged request list: group by prompt length, pad each
        group to its bucket (batch rows repeat the group's first request
        and are dropped on the way out), split groups larger than the
        biggest bucket. Returns one (n_new,) int32 tensor per request, in
        request order."""
        if any(p.dim() != 1 for p in prompts):
            raise ValueError("generate() takes 1-D token prompts; use "
                             "generate_batch() for pre-batched input")
        groups: dict = {}
        for i, p in enumerate(prompts):
            groups.setdefault(int(p.shape[0]), []).append(i)
        results: List[Optional[torch.Tensor]] = [None] * len(prompts)
        for L, idxs in sorted(groups.items()):
            pending = idxs
            while pending:
                B, S = select_bucket(self.buckets, len(pending), L,
                                     pad_seq=self.pad_seq)
                take = pending[:B]
                pending = pending[B:]
                rows = [torch.nn.functional.pad(prompts[i], (0, S - L))
                        for i in take]
                while len(rows) < B:          # batch-dim padding
                    rows.append(rows[0])
                out = self.generate_batch(
                    torch.stack(rows).to(torch.int32), n_new, true_len=L)
                for r, i in enumerate(take):
                    results[i] = out[r]
        return results  # type: ignore[return-value]
