"""The port's serving slice against the JAX package's, on the CPU: the
configs, the dense transformer's prefill / decode at the reduced
llama3.2-1b config, ``greedy_generate`` and ``DecodeEngine`` (mirroring
``tests/test_serve.py`` and ``tests/test_serve_engine.py``), and the
engine serving the reduced rwkv6-3b (``TestRWKVEngine``).

JAX's params cross as numpy arrays (``convert.params_from_numpy``).
Logits are held to f32 rtol = atol = 2e-5 at ``compute_dtype=float32``
and 2e-2 at bf16. JAX's engine tests state bitwise equality between the
engine and ``greedy_generate``; the port holds tokens equal at f32
compute and, at bf16, wherever the top-2 logit gap exceeds the bf16
tolerance (GEMMs of other shapes may round differently on a card).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import get_reduced as jget_reduced
from repro.configs import list_archs as jlist_archs
from repro.models import attention as jattention
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtransformer
from repro.serve import greedy_generate as jgreedy_generate
from repro.serve.engine import cast_cache as jcast_cache
from repro_torch.configs import (INPUT_SHAPES, get_arch, get_reduced,
                                 list_archs)
from repro_torch._tree import tree_leaves
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import rwkv6, transformer
from repro_torch.models.registry import build_model
from repro_torch.serve import (DecodeEngine, ParamStore, cache_spec,
                               cast_cache, cast_params, effective_config,
                               greedy_generate,
                               make_prefill_step, make_serve_step,
                               select_bucket)
from repro_torch.serve.engine import RecompileError, kv_cache_len

torch.set_num_threads(2)

TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
BF16_TOL = 2e-2
ARCH = "llama3.2-1b"


def configs(dt):
    """(JAX cfg, port cfg) of the reduced llama3.2-1b at compute dtype
    ``dt``."""
    jcfg, tcfg = jget_reduced(ARCH).model, get_reduced(ARCH).model
    if dt == "f32":
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["f32", "bf16"])
def lm(request):
    """JAX params of the reduced config and the port's copy of them."""
    jcfg, tcfg = configs(request.param)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return request.param, jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def lm32():
    """The f32-compute model alone (token-exact engine contracts)."""
    jcfg, tcfg = configs("f32")
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return tcfg, tp


def tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def assert_tokens_close(got, want, logits):
    """Tokens equal wherever the top-2 gap of ``logits`` (N, V) exceeds
    the bf16 tolerance (``got``/``want``: (N,))."""
    top2 = np.sort(f32(logits), axis=-1)[:, -2:]
    firm = (top2[:, 1] - top2[:, 0]) > BF16_TOL
    np.testing.assert_array_equal(np.asarray(got)[firm],
                                  np.asarray(want)[firm])


# -------------------------------- configs -----------------------------------


def test_param_count_matches_jax():
    assert get_arch(ARCH).model.param_count() == 1_235_746_816
    assert get_arch(ARCH).model.param_count() == \
        jget_arch(ARCH).model.param_count()
    assert get_reduced(ARCH).model.param_count() == \
        jget_reduced(ARCH).model.param_count()
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab_size", "head_dim", "rope_theta", "tie_embeddings",
                 "long_context_window", "norm_eps"):
        assert getattr(get_arch(ARCH).model, name) == \
            getattr(jget_arch(ARCH).model, name)
    assert get_arch(ARCH).model.compute_dtype == torch.bfloat16
    assert get_arch(ARCH).model.param_dtype == torch.float32


def test_config_registry():
    """Every JAX arch is registered, the vlm and audio ones too;
    an unknown arch or family raises ``KeyError``, as in JAX."""
    assert list_archs() == sorted(jlist_archs())
    assert get_arch("zamba2-7b").model.family == "hybrid"
    assert get_reduced("phi3.5-moe-42b-a6.6b").model.family == "moe"
    assert get_arch("whisper-large-v3").model.family == "audio"
    assert get_reduced("phi-3-vision-4.2b").model.family == "vlm"
    with pytest.raises(KeyError):
        get_arch("gpt-2")
    for family in ("vlm", "audio"):
        cfg = dataclasses.replace(get_reduced(ARCH).model, family=family)
        assert build_model(cfg).cfg.family == family
    with pytest.raises(KeyError, match="family"):
        build_model(dataclasses.replace(get_reduced(ARCH).model,
                                        family="gnn"))


def test_init_params_tree_matches_jax():
    """Same keys, shapes, dtypes and init scales as JAX's tree."""
    jcfg, tcfg = configs("bf16")
    want = jax.eval_shape(lambda: jbuild_model(jcfg).init(
        jax.random.PRNGKey(0)))
    got = build_model(tcfg).init(torch.Generator().manual_seed(0))
    wl = jax.tree_util.tree_leaves(want)
    gl = tree_leaves(got)      # sorted keys: JAX's leaf order
    assert [tuple(x.shape) for x in gl] == [x.shape for x in wl]
    assert all(x.dtype == torch.float32 for x in gl)
    # wq ~ N(0, 1/d_model), embed ~ N(0, 0.02^2), to 10%
    wq_std = float(got["layers"]["attn"]["wq"].std())
    assert abs(wq_std * tcfg.d_model ** 0.5 - 1.0) < 0.1
    assert abs(float(got["embed"].std()) / 0.02 - 1.0) < 0.1
    assert float(got["layers"]["norm1"].min()) == 1.0


def test_convert_carries_the_stacked_tree_both_ways():
    """A stacked transformer tree, f32 and bf16 leaves, crosses bit for
    bit in both directions."""
    jcfg, _ = configs("bf16")
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(2))
    jp["layers"]["norm1"] = jp["layers"]["norm1"].astype(jnp.bfloat16)
    jp["embed"] = jp["embed"].astype(jnp.bfloat16)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_numpy(npp, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tuple(tp["layers"]["attn"]["wq"].shape) == (2, 256, 256)
    back = params_to_numpy(tp)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8)),
        npp, back)


# --------------------------- prefill and decode -----------------------------


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_prefill_and_decode_match_jax(lm, impl, monkeypatch):
    """Each impl against JAX's prefill running the same one (JAX's
    ``prefill`` takes no impl: its ``sdpa`` default is patched here; the
    kernel's counterpart is the Pallas kernel in interpret mode)."""
    dt, jcfg, tcfg, jp, tp = lm
    monkeypatch.setattr(jattention, "sdpa", functools.partial(
        jattention.sdpa, impl={"kernel": "pallas"}.get(impl, impl)))
    japi, tapi = jbuild_model(jcfg), build_model(tcfg)
    toks = tokens((2, 12), jcfg.vocab_size)
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=20)
    with torch.no_grad():
        tl, tc = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              cache_len=20, attn_impl=impl)
    assert tl.shape == (2, 1, jcfg.vocab_size) and tc.index == 12
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL[dt])
    np.testing.assert_allclose(f32(tc.k), f32(jc.k), **TOL[dt])
    np.testing.assert_allclose(f32(tc.v), f32(jc.v), **TOL[dt])
    for step, tok in enumerate(([3, 7], [11, 500])):
        jl, jc = japi.decode_step(jp, jc, jnp.asarray(tok, jnp.int32))
        with torch.no_grad():
            tl, tc = tapi.decode_step(tp, tc, torch.tensor(tok,
                                                           dtype=torch.int32))
        assert tc.index == 13 + step
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL[dt])
    np.testing.assert_allclose(f32(tc.k), f32(jc.k), **TOL[dt])


def test_sliding_window_prefill_and_rotating_decode_match_jax():
    """S > window: the prefill keeps the last slots, rotated so slot =
    pos % window, and decode wraps around the 8-slot cache."""
    jcfg, tcfg = configs("f32")
    jcfg = dataclasses.replace(jcfg, sliding_window=8)
    tcfg = dataclasses.replace(tcfg, sliding_window=8)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(4))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = tokens((1, 13), jcfg.vocab_size, seed=5)
    jl, jc = jtransformer.prefill(jp, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        tl, tc = transformer.prefill(tp, torch.from_numpy(toks), tcfg,
                                     attn_impl="kernel")
    assert tc.k.shape[2] == 8
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL["f32"])
    np.testing.assert_allclose(f32(tc.k), f32(jc.k), **TOL["f32"])
    for tok in (9, 4, 17):
        jl, jc = jtransformer.decode_step(jp, jc, jnp.asarray([tok]), jcfg)
        with torch.no_grad():
            tl, tc = transformer.decode_step(tp, tc, torch.tensor([tok]),
                                             tcfg)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL["f32"])


def test_forward_and_loss_match_jax(lm):
    dt, jcfg, tcfg, jp, tp = lm
    toks = tokens((2, 9), jcfg.vocab_size, seed=3)
    jlogits, _ = jtransformer.forward(jp, jnp.asarray(toks[:, :-1]), jcfg)
    tlogits, aux = transformer.forward(tp, torch.from_numpy(toks[:, :-1]),
                                       tcfg)
    np.testing.assert_allclose(f32(tlogits), f32(jlogits), **TOL[dt])
    jloss = jbuild_model(jcfg).loss(jp, {"tokens": jnp.asarray(toks)})
    tloss = build_model(tcfg).loss(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL[dt])
    # training goes through autograd on the naive path
    tp32 = {k: v for k, v in tp.items()}
    tp32["final_norm"] = tp["final_norm"].clone().requires_grad_(True)
    build_model(tcfg).loss(tp32, {"tokens": torch.from_numpy(toks)}
                           ).backward()
    assert tp32["final_norm"].grad is not None
    # remat is the activation-checkpoint policy of training: the forward
    # is the same, and an unknown policy raises
    dots, _ = transformer.forward(tp, torch.from_numpy(toks[:, :-1]), tcfg,
                                  remat="dots")
    assert torch.equal(dots, tlogits)
    with pytest.raises(ValueError, match="remat"):
        transformer.forward(tp, torch.from_numpy(toks), tcfg, remat="some")


def test_cache_spec_matches_actual_prefill(lm32):
    tcfg, tp = lm32
    spec = cache_spec(tcfg, 2, 16, cache_dtype=torch.float32)
    with torch.no_grad():
        _, cache = build_model(tcfg).prefill(
            tp, {"tokens": torch.from_numpy(tokens((2, 16), 512))},
            cache_len=kv_cache_len(tcfg, 16))
    assert spec.k.shape == tuple(cache.k.shape) == tuple(cache.v.shape)
    assert spec.k.dtype == cache.k.dtype
    windowed = dataclasses.replace(tcfg, sliding_window=8)
    assert cache_spec(windowed, 1, 524288).k.shape[2] == 8
    audio = cache_spec(dataclasses.replace(tcfg, family="audio"), 1, 16)
    assert audio.cross_k.shape[2] == tcfg.n_audio_ctx
    with pytest.raises(KeyError):
        cache_spec(dataclasses.replace(tcfg, family="gnn"), 1, 16)


def test_effective_config_substitutes_window():
    cfg = get_reduced(ARCH).model
    eff = effective_config(cfg, INPUT_SHAPES["long_500k"])
    assert eff.sliding_window == cfg.long_context_window > 0
    assert effective_config(cfg, INPUT_SHAPES["decode_32k"]
                            ).sliding_window == cfg.sliding_window


def test_serve_and_prefill_steps(lm32):
    tcfg, tp = lm32
    toks = torch.from_numpy(tokens((1, 6), 512))
    with torch.no_grad():
        logits, cache = make_prefill_step(tcfg, 8)(tp, {"tokens": toks})
        logits2, cache = make_serve_step(tcfg)(tp, cache, toks[:, -1])
    assert logits.shape == (1, 1, 512) and logits2.shape == (1, 512)
    assert cache.index == 7


# ------------------------------ greedy decode -------------------------------


def test_greedy_generate_matches_jax():
    """f32 compute: the tokens equal JAX's; the kernel path too."""
    jcfg, tcfg = configs("f32")
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = tokens((2, 12), jcfg.vocab_size)
    want = np.asarray(jgreedy_generate(jcfg, jp, {"tokens": jnp.asarray(
        toks)}, 5))
    for impl in ("auto", "kernel"):
        got = greedy_generate(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                              5, attn_impl=impl)
        assert got.shape == (2, 5) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_validation(lm32):
    tcfg, tp = lm32
    prompt = {"tokens": torch.from_numpy(tokens((2, 12), 512))}
    out = greedy_generate(tcfg, tp, prompt, 0)
    assert out.shape == (2, 0) and out.dtype == torch.int32
    with pytest.raises(ValueError, match="n_new"):
        greedy_generate(tcfg, None, prompt, -1)
    with pytest.raises(ValueError, match="cache_len"):
        greedy_generate(tcfg, None, prompt, 4, cache_len=0)
    with pytest.raises(ValueError, match="cache_len"):
        greedy_generate(tcfg, None, prompt, 4, cache_len=15)
    o1 = greedy_generate(tcfg, tp, prompt, 3)
    o2 = greedy_generate(tcfg, tp, prompt, 3, cache_len=15)
    assert torch.equal(o1, o2)


# ------------------------------ decode engine -------------------------------


def prompts_of(lengths, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, vocab, (L,)).astype(np.int32))
            for L in lengths]


class TestEngineExactness:
    def test_exact_seq_matches_greedy_generate(self, lm32):
        tcfg, tp = lm32
        toks = torch.from_numpy(tokens((4, 16), 512))
        eng = DecodeEngine(tcfg, tp, buckets=((4, 16),), max_new_tokens=8)
        ref = greedy_generate(tcfg, tp, {"tokens": toks}, 8,
                              cache_len=eng.cache_len_for(16),
                              attn_impl="kernel")
        assert torch.equal(eng.generate_batch(toks, 8), ref)

    def test_seq_padded_prompt_is_exact(self, lm32):
        """The rewind + re-feed path: a 13-token prompt through a (2, 16)
        bucket gives the tokens of serving it unpadded."""
        tcfg, tp = lm32
        toks = torch.from_numpy(tokens((2, 13), 512))
        eng = DecodeEngine(tcfg, tp, buckets=((2, 16),), max_new_tokens=8)
        padded = torch.nn.functional.pad(toks, (0, 3))
        ref = greedy_generate(tcfg, tp, {"tokens": toks}, 8,
                              cache_len=eng.cache_len_for(16),
                              attn_impl="kernel")
        assert torch.equal(eng.generate_batch(padded, 8, true_len=13), ref)

    def test_bf16_seq_padded_prompt_within_margin(self):
        """bf16 compute: the padded prompt's first logits within the bf16
        tolerance of the unpadded prefill's, tokens per the margin rule."""
        _, tcfg = configs("bf16")
        tp = build_model(tcfg).init(torch.Generator().manual_seed(3))
        toks = torch.from_numpy(tokens((2, 13), 512, seed=4))
        api = build_model(tcfg)
        with torch.no_grad():
            want, _ = api.prefill(tp, {"tokens": toks}, cache_len=24,
                                  attn_impl="kernel")
            _, cache = api.prefill(
                tp, {"tokens": torch.nn.functional.pad(toks, (0, 3))},
                cache_len=24, attn_impl="kernel")
            got, _ = api.decode_step(tp, cache._replace(index=12),
                                     toks[:, 12])
        np.testing.assert_allclose(f32(got), f32(want[:, 0]),
                                   **TOL["bf16"])
        assert_tokens_close(got.argmax(-1).numpy(),
                            want[:, 0].argmax(-1).numpy(), want[:, 0])
        eng = DecodeEngine(tcfg, tp, buckets=((2, 16),), max_new_tokens=4)
        out = eng.generate_batch(torch.nn.functional.pad(toks, (0, 3)), 4,
                                 true_len=13)
        ref = greedy_generate(tcfg, tp, {"tokens": toks}, 4,
                              cache_len=eng.cache_len_for(16),
                              attn_impl="kernel")
        assert_tokens_close(out[:, 0].numpy(), ref[:, 0].numpy(),
                            want[:, 0])

    def test_generate_groups_and_drops_batch_padding(self, lm32):
        tcfg, tp = lm32
        prompts = prompts_of((16, 9, 16, 12, 16), 512)
        eng = DecodeEngine(tcfg, tp, buckets=((1, 16), (4, 16)),
                           max_new_tokens=6)
        outs = eng.generate(prompts, 6)
        assert len(outs) == len(prompts)
        for p, out in zip(prompts, outs):
            ref = greedy_generate(tcfg, tp, {"tokens": p[None]}, 6,
                                  cache_len=eng.cache_len_for(16),
                                  attn_impl="kernel")
            assert torch.equal(out, ref[0])
        # 9 and 12 alone through (1, 16); the three 16s padded to (4, 16)
        assert eng.compile_counts == {"prefill": 2, "decode": 2}

    def test_engine_matches_jax_greedy(self):
        """The slice as a whole: the port's engine (kernel prefill, padded
        bucket) gives JAX's greedy tokens at f32 compute."""
        jcfg, tcfg = configs("f32")
        jp = jbuild_model(jcfg).init(jax.random.PRNGKey(5))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        prompts = prompts_of((11, 16, 11), 512, seed=6)
        eng = DecodeEngine(tcfg, tp, buckets=((2, 16),), max_new_tokens=5)
        outs = eng.generate(prompts, 5)
        for p, out in zip(prompts, outs):
            want = jgreedy_generate(jcfg, jp, {"tokens": jnp.asarray(
                p.numpy()[None])}, 5, cache_len=eng.cache_len_for(16))
            np.testing.assert_array_equal(out.numpy(), np.asarray(want)[0])

    def test_n_new_zero(self, lm32):
        tcfg, tp = lm32
        eng = DecodeEngine(tcfg, tp, buckets=((1, 16),))
        toks = torch.from_numpy(tokens((1, 16), 512))
        assert eng.generate_batch(toks, 0).shape == (1, 0)


class TestEngineShapes:
    def test_one_signature_per_bucket(self, lm32):
        tcfg, tp = lm32
        eng = DecodeEngine(tcfg, tp, buckets=((1, 16), (4, 16)),
                           max_new_tokens=4)
        for B in (1, 4, 1, 4):
            eng.generate_batch(torch.from_numpy(tokens((B, 16), 512)), 4)
        assert eng.compile_counts == {"prefill": 2, "decode": 2}

    def test_bucket_escape_raises(self, lm32):
        tcfg, tp = lm32
        eng = DecodeEngine(tcfg, tp, buckets=((1, 16),))
        with pytest.raises(ValueError, match="bucket"):
            eng.generate_batch(torch.from_numpy(tokens((2, 16), 512)), 2)
        # a new input signature in a bucket's shape (here: params with
        # one more vocab row) is caught by the watch
        store = ParamStore()
        eng = DecodeEngine(tcfg, store, buckets=((1, 16),),
                           max_new_tokens=2)
        store.publish(tp)
        eng.generate_batch(torch.from_numpy(tokens((1, 16), 512)), 2)
        store.publish({**tp, "embed": torch.cat([tp["embed"],
                                                 tp["embed"][:1]])})
        with pytest.raises(RecompileError, match="signatures"):
            eng.generate_batch(torch.from_numpy(tokens((1, 16), 512)), 2)

    def test_select_bucket(self):
        buckets = ((1, 16), (4, 16), (8, 32))
        assert select_bucket(buckets, 3, 10) == (4, 16)
        assert select_bucket(buckets, 1, 16) == (1, 16)
        assert select_bucket(buckets, 8, 20) == (8, 32)
        assert select_bucket(buckets, 9, 16) == (4, 16)
        with pytest.raises(ValueError, match="bucket"):
            select_bucket(buckets, 1, 64)
        with pytest.raises(ValueError, match="bucket"):
            select_bucket(buckets, 1, 10, pad_seq=False)


class TestEngineCacheDtype:
    def test_bf16_cache_logits_parity(self, lm32):
        tcfg, tp = lm32
        api = build_model(tcfg)
        toks = torch.from_numpy(tokens((2, 12), 512))
        tok = torch.zeros((2,), dtype=torch.int32)
        with torch.no_grad():
            _, cache = api.prefill(tp, {"tokens": toks}, cache_len=20)
            bf = cast_cache(cache, torch.bfloat16)
            l32, _ = api.decode_step(tp, cache, tok)
            l16, _ = api.decode_step(tp, bf, tok)
        assert l32.dtype == l16.dtype == torch.float32
        np.testing.assert_allclose(f32(l16), f32(l32), rtol=5e-2, atol=5e-2)

    def test_bf16_cache_end_to_end(self, lm32):
        tcfg, tp = lm32
        eng = DecodeEngine(tcfg, tp, buckets=((2, 12),), max_new_tokens=4,
                           cache_dtype=torch.bfloat16)
        out = eng.generate_batch(torch.from_numpy(tokens((2, 12), 512)), 4)
        assert out.shape == (2, 4) and out.dtype == torch.int32

    def test_upcast_cache_dtype_rejected(self):
        _, tcfg = configs("bf16")
        with pytest.raises(ValueError, match="wider"):
            DecodeEngine(tcfg, {}, cache_dtype=torch.float32)

    def test_cast_cache_preserves_the_index(self, lm32):
        tcfg, tp = lm32
        with torch.no_grad():
            _, cache = build_model(tcfg).prefill(
                tp, {"tokens": torch.from_numpy(tokens((1, 8), 512))},
                cache_len=12)
        cast = cast_cache(cache, torch.bfloat16)
        assert cast.index == cache.index == 8
        assert cast.k.dtype == torch.bfloat16
        assert cast_cache(cache, None) is cache


class TestEngineHotSwap:
    def test_version_pickup_without_new_signatures(self, lm32):
        tcfg, tp = lm32
        store = ParamStore()
        store.publish(tp)
        eng = DecodeEngine(tcfg, store, buckets=((2, 16),),
                           max_new_tokens=4)
        toks = torch.from_numpy(tokens((2, 16), 512))
        out1 = eng.generate_batch(toks, 4)
        assert eng.last_version == 1
        store.publish(build_model(tcfg).init(
            torch.Generator().manual_seed(7)))
        out2 = eng.generate_batch(toks, 4)
        assert eng.last_version == 2
        assert not torch.equal(out1, out2)
        assert eng.compile_counts == {"prefill": 1, "decode": 1}

    def test_cast_once_per_version(self):
        """bf16 compute: the engine keeps one compute-dtype copy per
        published version and serves the values a per-call cast gives."""
        _, tcfg = configs("bf16")
        tp = build_model(tcfg).init(torch.Generator().manual_seed(8))
        store = ParamStore()
        store.publish(tp)
        eng = DecodeEngine(tcfg, store, buckets=((1, 16),),
                           max_new_tokens=3)
        v, cast = eng._params()
        assert v == 1 and cast["embed"].dtype == torch.bfloat16
        assert eng._params()[1] is cast
        toks = torch.from_numpy(tokens((1, 16), 512))
        assert torch.equal(eng.generate_batch(toks, 3),
                           greedy_generate(tcfg, tp, {"tokens": toks}, 3,
                                           cache_len=eng.cache_len_for(16),
                                           attn_impl="kernel"))
        store.publish(tp)
        assert eng._params()[1] is not cast

    def test_plain_tree_source_serves_version_zero(self, lm32):
        tcfg, tp = lm32
        eng = DecodeEngine(tcfg, tp, buckets=((1, 16),), max_new_tokens=2)
        eng.generate_batch(torch.from_numpy(tokens((1, 16), 512)), 2)
        assert eng.last_version == 0


class TestEngineValidation:
    def test_empty_buckets_and_unknown_impl_rejected(self, lm32):
        tcfg, tp = lm32
        with pytest.raises(ValueError, match="bucket"):
            DecodeEngine(tcfg, tp, buckets=())
        with pytest.raises(ValueError, match="attn_impl"):
            DecodeEngine(tcfg, tp, attn_impl="pallas")

    def test_true_len_out_of_range(self, lm32):
        tcfg, tp = lm32
        eng = DecodeEngine(tcfg, tp, buckets=((1, 16),))
        toks = torch.from_numpy(tokens((1, 16), 512))
        with pytest.raises(ValueError, match="true_len"):
            eng.generate_batch(toks, 2, true_len=17)
        with pytest.raises(ValueError, match="true_len"):
            eng.generate_batch(toks, 2, true_len=0)

    def test_n_new_beyond_headroom_rejected(self, lm32):
        tcfg, tp = lm32
        eng = DecodeEngine(tcfg, tp, buckets=((1, 16),), max_new_tokens=4)
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.generate_batch(torch.from_numpy(tokens((1, 16), 512)), 5)

    def test_seq_padding_rejected_for_rotating_cache(self, lm32):
        tcfg, tp = lm32
        eng = DecodeEngine(dataclasses.replace(tcfg, sliding_window=8), tp,
                           buckets=((1, 16),), max_new_tokens=2)
        assert eng.pad_seq is False
        with pytest.raises(ValueError, match="pad_seq"):
            eng.generate_batch(torch.from_numpy(tokens((1, 16), 512)), 2,
                               true_len=10)

    def test_2d_prompts_rejected_by_generate(self, lm32):
        tcfg, tp = lm32
        eng = DecodeEngine(tcfg, tp, buckets=((1, 16),))
        with pytest.raises(ValueError, match="1-D"):
            eng.generate([torch.zeros((1, 16), dtype=torch.int32)], 2)


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    rec = serve.main(["--device", "cpu", "--buckets", "1x16,4x16",
                      "--batch", "3", "--prompt-len", "13",
                      "--new-tokens", "3"])
    assert rec["bucket"] == [4, 16]
    assert rec["compile_counts"] == {"prefill": 1, "decode": 1}
    assert rec["launches"]["flash_attention"] == 0   # CPU: plain version
    assert rec["prefill_ms"] > 0 and rec["first_token_ms"] > 0
    assert "[serve] llama3.2-1b (reduced)" in capsys.readouterr().out


# ---------------------------- rwkv6 through the engine ----------------------

RWKV = "rwkv6-3b"


def rwkv_configs(dt):
    jcfg, tcfg = jget_reduced(RWKV).model, get_reduced(RWKV).model
    if dt == "f32":
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["f32", "bf16"])
def rwkv_lm(request):
    jcfg, tcfg = rwkv_configs(request.param)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return request.param, jcfg, tcfg, jp, tp


class TestRWKVEngine:
    def test_engine_matches_jax_greedy(self, rwkv_lm):
        """The slice as a whole: the engine (WKV kernel path, exact
        buckets) against JAX's ``greedy_generate``. At f32 the tokens are
        equal; at bf16 they are equal up to the first step whose top-2 gap
        (JAX's logits along its tokens) is not past twice the two
        packages' logit difference there, where a rounding may swap
        them."""
        dt, jcfg, tcfg, jp, tp = rwkv_lm
        toks = tokens((2, 16), 512, seed=21)
        n_new = 5
        want = np.asarray(jgreedy_generate(
            jcfg, jp, {"tokens": jnp.asarray(toks)}, n_new))
        eng = DecodeEngine(tcfg, tp, buckets=((2, 16),),
                           max_new_tokens=n_new)
        got = eng.generate_batch(torch.from_numpy(toks), n_new).numpy()
        if dt == "f32":
            np.testing.assert_array_equal(got, want)
            return
        japi, tapi = jbuild_model(jcfg), build_model(tcfg)
        with jax.disable_jit():   # op by op: see tests/test_torch_rwkv.py
            jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks)})
            jlog = [f32(jl[:, 0])]
            for t in range(n_new - 1):
                jl, jc = japi.decode_step(jp, jc, jnp.asarray(want[:, t]))
                jlog.append(f32(jl))
        with torch.no_grad():
            tl, tc = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                  wkv_impl="kernel")
            tlog = [f32(tl[:, 0])]
            for t in range(n_new - 1):
                tl, tc = tapi.decode_step(
                    tp, tc, torch.from_numpy(want[:, t]), wkv_impl="kernel")
                tlog.append(f32(tl))
        jlog, tlog = np.stack(jlog, 1), np.stack(tlog, 1)     # (B, T, V)
        top2 = np.sort(jlog, axis=-1)[..., -2:]
        firm = (top2[..., 1] - top2[..., 0]) > 2 * np.abs(
            tlog - jlog).max(-1)
        for b in range(toks.shape[0]):
            for t in range(n_new):
                if not firm[b, t]:
                    break
                assert got[b, t] == want[b, t], (b, t)

    def test_recast_keeps_the_f32_leaves(self, rwkv_lm):
        """The once-per-version cast keeps the leaves RWKV6 reads in f32,
        so the engine's logits equal forward on the uncast params; a cast
        of every leaf would not (at bf16 it moves the decays)."""
        dt, _, tcfg, _, tp = rwkv_lm
        eng = DecodeEngine(tcfg, tp, buckets=((2, 16),), max_new_tokens=2)
        _, cast = eng._params()
        for name, x in cast["layers"].items():
            want = (torch.float32 if name in rwkv6.F32_LEAVES
                    else tcfg.compute_dtype)
            assert x.dtype == want, name
            if name in rwkv6.F32_LEAVES:
                assert x is tp["layers"][name]
        toks = torch.from_numpy(tokens((2, 16), 512, seed=22))
        with torch.no_grad():
            want, _ = rwkv6.prefill(tp, toks, tcfg, wkv_impl="kernel")
            full, _ = rwkv6.forward(tp, toks, tcfg, wkv_impl="kernel")
            got, _ = eng.api.prefill(cast, {"tokens": toks},
                                     wkv_impl="kernel")
            every, _ = eng.api.prefill(cast_params(tp, tcfg.compute_dtype),
                                       {"tokens": toks}, wkv_impl="kernel")
        assert torch.equal(got, want)
        # the head on the last position alone: a GEMM of another shape
        np.testing.assert_allclose(f32(got[:, 0]), f32(full[:, -1]),
                                   **TOL[dt])
        if dt == "bf16":
            assert not torch.equal(every, want)

    def test_bf16_cache_casts_the_wkv_state_as_jax(self, rwkv_lm):
        """cache_dtype=bf16 casts every float leaf, the WKV state too, as
        JAX's cast_cache does; a decode step from it matches JAX's (op by
        op at bf16 compute: see tests/test_torch_rwkv.py)."""
        dt, jcfg, tcfg, jp, tp = rwkv_lm
        toks = tokens((2, 12), 512, seed=23)
        with torch.no_grad():
            _, cache = build_model(tcfg).prefill(
                tp, {"tokens": torch.from_numpy(toks)})
        def eager():
            return (jax.disable_jit() if dt == "bf16"
                    else contextlib.nullcontext())

        with eager():
            _, jc = jbuild_model(jcfg).prefill(jp, {"tokens": jnp.asarray(
                toks)})
        cast, jcast = cast_cache(cache, torch.bfloat16), jcast_cache(
            jc, jnp.bfloat16)
        assert [x.dtype for x in cast[:3]] == [torch.bfloat16] * 3
        assert cast.index == cache.index == int(jcast.index) == 12
        for a, b in zip(cast[:3], jcast[:3]):
            assert str(b.dtype) == "bfloat16"
            np.testing.assert_allclose(f32(a), f32(b), **TOL["bf16"])
        tok = np.array([5, 300], np.int32)
        with torch.no_grad():
            tl, tc = build_model(tcfg).decode_step(tp, cast,
                                                   torch.from_numpy(tok))
        with eager():
            jl, jc2 = jbuild_model(jcfg).decode_step(jp, jcast,
                                                     jnp.asarray(tok))
        assert tc.wkv.dtype == torch.bfloat16 and str(jc2.wkv.dtype) == \
            "bfloat16"
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL["bf16"])
        eng = DecodeEngine(tcfg, tp, buckets=((2, 12),), max_new_tokens=3,
                           cache_dtype=torch.bfloat16)
        if dt == "bf16":
            out = eng.generate_batch(torch.from_numpy(toks), 3)
            assert out.shape == (2, 3) and out.dtype == torch.int32
            return
        # at f32 compute the token shifts come back from a decode step in
        # f32 (JAX's time_mix returns x[:, -1] in the compute dtype), so
        # the second step is a new input signature: JAX's RecompileWatch
        # raises there too (ROADMAP queue 3)
        assert tc.tm_x.dtype == torch.float32 and str(jc2.tm_x.dtype) == \
            "float32"
        with pytest.raises(RecompileError, match="signatures"):
            eng.generate_batch(torch.from_numpy(toks), 3)

    def test_short_prompt_raises(self, rwkv_lm):
        """The recurrent state would fold pads in: buckets match the
        prompt length exactly, as in JAX."""
        _, _, tcfg, _, tp = rwkv_lm
        eng = DecodeEngine(tcfg, tp, buckets=((2, 16),), max_new_tokens=2)
        assert eng.pad_seq is False
        with pytest.raises(ValueError, match="pad_seq"):
            eng.generate_batch(torch.from_numpy(tokens((2, 16), 512)), 2,
                               true_len=12)
        with pytest.raises(ValueError, match="bucket"):
            eng.generate(prompts_of((12,), 512), 2)
        with pytest.raises(ValueError, match="wkv_impl"):
            DecodeEngine(tcfg, tp, wkv_impl="pallas")

    def test_one_signature_per_bucket_and_generate(self, rwkv_lm):
        _, _, tcfg, _, tp = rwkv_lm
        eng = DecodeEngine(tcfg, tp, buckets=((1, 8), (4, 16)),
                           max_new_tokens=3)
        prompts = prompts_of((16, 8, 16, 8, 16), 512, seed=24)
        outs = eng.generate(prompts, 3)
        for B in (1, 4, 1):
            eng.generate_batch(torch.from_numpy(tokens(
                (B, 8 if B == 1 else 16), 512)), 3)
        assert eng.compile_counts == {"prefill": 2, "decode": 2}
        for p, out in zip(prompts, outs):
            ref = greedy_generate(tcfg, tp, {"tokens": p[None]}, 3,
                                  wkv_impl="kernel")
            assert torch.equal(out, ref[0])

    def test_cache_spec_matches_actual_prefill(self, rwkv_lm):
        _, jcfg, tcfg, _, tp = rwkv_lm
        spec = cache_spec(tcfg, 2, 16)
        with torch.no_grad():
            _, cache = build_model(tcfg).prefill(
                tp, {"tokens": torch.from_numpy(tokens((2, 16), 512))},
                cache_len=kv_cache_len(tcfg, 16))
        assert isinstance(cache, rwkv6.RWKVCache)
        for s_, x in zip(spec[:3], cache[:3]):
            assert s_.shape == tuple(x.shape) and s_.dtype == x.dtype
        assert spec.index == ((), torch.int32) and cache.index == 16

    def test_hot_swap_and_launcher(self, rwkv_lm, capsys):
        dt, _, tcfg, _, tp = rwkv_lm
        store = ParamStore()
        store.publish(tp)
        eng = DecodeEngine(tcfg, store, buckets=((2, 16),),
                           max_new_tokens=3)
        toks = torch.from_numpy(tokens((2, 16), 512))
        out1 = eng.generate_batch(toks, 3)
        store.publish(build_model(tcfg).init(
            torch.Generator().manual_seed(9)))
        out2 = eng.generate_batch(toks, 3)
        assert eng.last_version == 2 and not torch.equal(out1, out2)
        assert eng.compile_counts == {"prefill": 1, "decode": 1}
        if dt == "f32":
            return
        from repro_torch.launch import serve

        rec = serve.main(["--arch", RWKV, "--device", "cpu", "--buckets",
                          "1x16,4x16", "--batch", "3", "--prompt-len", "16",
                          "--new-tokens", "3"])
        assert rec["bucket"] == [4, 16]
        assert rec["launches"]["rwkv_scan"] == 0    # CPU: plain version
        assert "[serve] rwkv6-3b (reduced)" in capsys.readouterr().out
