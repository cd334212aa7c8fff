"""The port's whisper-large-v3 (the audio family) against the JAX package,
on the CPU.

* ``common.sinusoidal_positions`` and ``attention.cross_attention_
  forward`` (the port's naive, chunked and kernel impls, the kernel as
  its plain version on CPU tensors) against JAX's;
* the param tree (JAX's sorted keys: ``dec_layers``, ``dec_ln``, ...,
  ``enc_layers``, ...) and ``convert`` both ways;
* at the reduced config, from one set of numpy weights and inputs:
  ``encode``, ``forward``, ``loss_fn`` and its gradient, and ``prefill``
  plus 3 ``decode_step``s (each step's logits and the ``WhisperCache``
  leaves in JAX's order, and one more step from JAX's cache carried
  across by ``convert``) against JAX's, and the port's own decode
  contract (the steps equal one forward);
* the mirrored fault of both packages: ``cross_attention_forward`` adds
  no ``bq``, ``bk``, ``bv`` while the prefill's cross K/V and the decode
  query do, so with nonzero cross biases decode parts from the forward,
  in the port exactly as in JAX;
* ``cache_spec`` against JAX's; the engine at exact seq against JAX's
  ``greedy_generate``, a padded prompt refused; a bf16 cache decoding;
  the serving and training CLIs.

JAX's params cross as numpy. Tolerances are ``tests/test_kernels.py``'s:
f32 rtol = atol = 2e-5, bf16 2e-2. At bf16 the JAX side runs op by op
(``jax.disable_jit``), as in ``tests/test_torch_moe.py``. Both prefills
take sdpa's "auto" path.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import get_reduced as jget_reduced
from repro.launch.train import make_batch_iter as jmake_batch_iter
from repro.models import attention as jattention
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import whisper as jwhisper
from repro.serve import greedy_generate as jgreedy_generate
from repro.serve.engine import cache_spec as jcache_spec
from repro_torch._tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.configs import get_arch, get_reduced
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import attention, common, whisper
from repro_torch.models.registry import build_model
from repro_torch.serve import DecodeEngine, cache_spec

torch.set_num_threads(2)

TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
ARCH = "whisper-large-v3"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def jax_side(dt):
    """The JAX side's context: op by op at bf16, compiled at f32."""
    return jax.disable_jit() if dt == "bf16" else contextlib.nullcontext()


def configs(dt, **kw):
    jd, td = DTYPES[dt]
    return (dataclasses.replace(jget_reduced(ARCH).model, compute_dtype=jd,
                                **kw),
            dataclasses.replace(get_reduced(ARCH).model, compute_dtype=td,
                                **kw))


def model(dt, seed=0, **kw):
    jcfg, tcfg = configs(dt, **kw)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=["f32", "bf16"])
def lm(request):
    return (request.param,) + model(request.param)


def tokens(shape, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def audio(batch, cfg, seed=2):
    return normal((batch, cfg.n_audio_ctx, cfg.d_model), seed)


def both(x, dt):
    jd, td = DTYPES[dt]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def with_cross_biases(jp, seed):
    """``jp`` with N(0, 0.5²) cross-attention ``bq``, ``bk``, ``bv`` in every
    decoder layer."""
    xa = dict(jp["dec_layers"]["cross_attn"])
    for i, name in enumerate(("bq", "bk", "bv")):
        xa[name] = jnp.asarray(normal(xa[name].shape, seed + i, 0.5))
    dec = dict(jp["dec_layers"], cross_attn=xa)
    return dict(jp, dec_layers=dec)


def decode_run(api, params, toks, ex, cfg_len):
    """A prefill of the first 10 tokens, then a decode step on each of the
    rest: (the stacked logits, the final cache)."""
    logits, cache = api.prefill(params, {"tokens": toks[:, :10], **ex},
                                cache_len=cfg_len)
    steps = [logits[:, 0]]
    for t in range(10, toks.shape[1]):
        logits, cache = api.decode_step(params, cache, toks[:, t])
        steps.append(logits)
    return steps, cache


# ------------------------------ the blocks ----------------------------------


@pytest.mark.parametrize("n_ctx,d", [(1500, 1280), (16, 128), (7, 2), (3, 1)])
def test_sinusoidal_positions_match_jax(n_ctx, d):
    """The f32 tolerance, plus what the rounding of the angle ``pos *
    inv`` allows: the port's and XLA's f32 ``exp`` may give ``inv`` one ulp
    apart (2**-23 of it), which moves an angle at position ``pos`` by up
    to ``pos * 2**-23`` of a radian (1.8e-4 at 1499), and its sine and
    cosine as much."""
    got = common.sinusoidal_positions(n_ctx, d)
    want = np.asarray(jcommon.sinusoidal_positions(n_ctx, d))
    assert got.dtype == torch.float32 and got.shape == want.shape
    angle_ulp = np.arange(n_ctx, dtype=np.float64)[:, None] * 2.0 ** -23
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= 2e-5 + 2e-5 * np.abs(want) + angle_ulp).all(), err.max()
    np.testing.assert_allclose(got.numpy()[:16], want[:16], **TOL["f32"])


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cross_attention_matches_jax(impl, dt):
    """Non-causal, S != T, GQA 4/2: every impl of the port (the kernel as
    its plain version on CPU tensors) against JAX's (its "auto" path);
    the biases are ignored in both."""
    d, H, Hk, hd = 64, 4, 2, 16
    p = {"wq": normal((d, H * hd), 3, 0.1), "wk": normal((d, Hk * hd), 4, 0.1),
         "wv": normal((d, Hk * hd), 5, 0.1), "wo": normal((H * hd, d), 6, 0.1),
         "bq": normal((H * hd,), 7), "bk": normal((Hk * hd,), 8),
         "bv": normal((Hk * hd,), 9)}
    jx, tx = both(normal((2, 5, d), 10), dt)
    jkv, tkv = both(normal((2, 11, d), 11), dt)
    with jax_side(dt):
        want = jattention.cross_attention_forward(
            {k: jnp.asarray(v) for k, v in p.items()}, jx, jkv, n_heads=H,
            n_kv_heads=Hk, head_dim=hd)
    got = attention.cross_attention_forward(
        {k: torch.from_numpy(v) for k, v in p.items()}, tx, tkv, n_heads=H,
        n_kv_heads=Hk, head_dim=hd, impl=impl)
    assert got.dtype == tx.dtype and got.shape == (2, 5, d)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dt])


# ---------------------------- config and tree -------------------------------


def test_param_tree_matches_jax_and_converts_both_ways():
    """JAX's sorted keys, shapes and dtypes; the decoder positions at
    33,024 and 0.01 scale; the tree of the full config is 1,577,858,560
    parameters (the analytic count adds an untied head and leaves out
    the positions, biases and norms)."""
    jcfg, tcfg = configs("bf16")
    want = jax.eval_shape(lambda: jbuild_model(jcfg).init(
        jax.random.PRNGKey(0)))
    got = build_model(tcfg).init(torch.Generator().manual_seed(0))
    assert sorted(got) == list(tree_flatten(got)[1].keys) == [
        "dec_layers", "dec_ln", "dec_ln_b", "dec_pos", "embed", "enc_layers",
        "enc_ln", "enc_ln_b"]
    assert sorted(got["dec_layers"]) == [
        "cross_attn", "ln1", "ln1_b", "ln2", "ln2_b", "ln_x", "ln_x_b", "mlp",
        "self_attn"]
    wl, gl = jax.tree_util.tree_leaves(want), tree_leaves(got)
    assert [tuple(x.shape) for x in gl] == [x.shape for x in wl]
    assert [str(x.dtype) for x in gl] == ["torch." + str(x.dtype)
                                          for x in wl]
    assert tuple(got["dec_pos"].shape) == (whisper.MAX_TEXT_POSITIONS,
                                           tcfg.d_model)
    assert abs(float(got["dec_pos"].float().std()) / 0.01 - 1.0) < 0.05
    full = jax.eval_shape(lambda: jwhisper.init_params(
        jax.random.PRNGKey(0), jget_arch(ARCH).model))
    assert sum(x.size for x in jax.tree_util.tree_leaves(full)) == \
        1_577_858_560
    _, _, jp, tp = model("f32", seed=3)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, jp),
                           params_to_numpy(tp))


def test_cache_spec_matches_jax_and_the_prefill():
    jcfg, tcfg = configs("bf16")
    for cd, jcd in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        got = cache_spec(tcfg, 3, 40, cache_dtype=cd)
        want = jcache_spec(jcfg, 3, 40, cache_dtype=jcd)
        assert isinstance(got, whisper.WhisperCache)
        assert got._fields == want._fields
        for a, b in zip(got, want):
            assert a.shape == tuple(b.shape)
            assert str(a.dtype) == "torch." + str(b.dtype)
    spec = cache_spec(get_arch(ARCH).model, 8, 416)
    assert spec.self_k.shape == (32, 8, 416, 20, 64)
    assert spec.cross_v.shape == (32, 8, 1500, 20, 64)
    _, tcfg, _, tp = model("bf16")
    with torch.no_grad():
        _, cache = build_model(tcfg).prefill(tp, {
            "tokens": torch.from_numpy(tokens((3, 10))),
            "audio_embeds": torch.from_numpy(audio(3, tcfg))}, cache_len=40)
    for a, b in zip(cache_spec(tcfg, 3, 40), cache[:4]):
        assert a.shape == tuple(b.shape) and a.dtype == b.dtype
    with pytest.raises(ValueError, match="cache_len"):
        whisper.prefill(tp, torch.zeros((1, 8), dtype=torch.int32),
                        torch.from_numpy(audio(1, tcfg)), tcfg, cache_len=4)


# ------------------------------- the model ----------------------------------


def test_encode_forward_and_loss_match_jax(lm):
    dt, jcfg, tcfg, jp, tp = lm
    toks, au = tokens((2, 13), seed=3), audio(2, tcfg, 4)
    with jax_side(dt):
        jenc = jwhisper.encode(jp, jnp.asarray(au), jcfg)
        jl = jwhisper.forward(jp, jnp.asarray(toks[:, :-1]), jnp.asarray(au),
                              jcfg)
        jloss = jbuild_model(jcfg).loss(jp, {"tokens": jnp.asarray(toks),
                                             "audio_embeds": jnp.asarray(au)})
    with torch.no_grad():
        tenc = whisper.encode(tp, torch.from_numpy(au), tcfg)
        tl = whisper.forward(tp, torch.from_numpy(toks[:, :-1]),
                             torch.from_numpy(au), tcfg)
        tloss = build_model(tcfg).loss(tp, {
            "tokens": torch.from_numpy(toks),
            "audio_embeds": torch.from_numpy(au)})
    assert tenc.dtype == tl.dtype == DTYPES[dt][1]
    assert tl.shape == (2, 12, tcfg.vocab_size)
    np.testing.assert_allclose(f32(tenc), f32(jenc), **TOL[dt])
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL[dt])
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL[dt])
    # remat wraps the decoder layers and changes no value
    with torch.no_grad():
        assert torch.equal(whisper.forward(
            tp, torch.from_numpy(toks[:, :-1]), torch.from_numpy(au), tcfg,
            remat="full"), tl)


def test_loss_gradient_matches_jax():
    """f32 compute: every leaf's gradient within 2e-5 of the leaf's
    largest entry, the remat policies alike; the cross-attention biases
    get none (the forward ignores them, as JAX's)."""
    jcfg, tcfg, jp, tp = model("f32", seed=5)
    toks, au = tokens((2, 9), seed=6), audio(2, tcfg, 7)
    jl, jg = jax.value_and_grad(jbuild_model(jcfg).loss)(
        jp, {"tokens": jnp.asarray(toks), "audio_embeds": jnp.asarray(au)})
    leaves, td = tree_flatten(tp)
    out = {}
    for remat in ("none", "full"):
        xs = [x.detach().requires_grad_(True) for x in leaves]
        loss = build_model(tcfg).loss(tree_unflatten(td, xs), {
            "tokens": torch.from_numpy(toks),
            "audio_embeds": torch.from_numpy(au)}, remat=remat)
        out[remat] = loss, torch.autograd.grad(loss, xs, allow_unused=True)
    loss, grads = out["none"]
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL["f32"])
    for a, b in zip(grads, jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))
    for a, b in zip(out["full"][1], grads):
        assert (a is None and b is None) or torch.equal(a, b)
    g = tree_unflatten(td, list(grads))["dec_layers"]["cross_attn"]
    for name in ("bq", "bk", "bv"):
        assert g[name] is None or float(g[name].abs().max()) == 0.0
    assert float(g["wk"].abs().max()) > 0


def test_prefill_and_decode_equal_forward_and_jax(lm):
    """A prefill of 10 tokens over the audio, then 3 decode steps: the
    logits of one forward over all 13 (the port's contract, exact while
    the cross biases are zero), each step and the final cache, leaf by
    leaf in JAX's order, equal to JAX's."""
    dt, jcfg, tcfg, jp, tp = lm
    api, japi = build_model(tcfg), jbuild_model(jcfg)
    toks, au = tokens((2, 13), seed=8), audio(2, tcfg, 9)
    tt, ta = torch.from_numpy(toks), torch.from_numpy(au)
    with torch.no_grad():
        full = whisper.forward(tp, tt, ta, tcfg)
        steps, cache = decode_run(api, tp, tt, {"audio_embeds": ta}, 16)
    steps = torch.stack(steps, 1)
    assert cache.index == 13
    np.testing.assert_allclose(f32(steps), f32(full[:, 9:]), **TOL[dt])
    with jax_side(dt):
        jsteps, jc = decode_run(japi, jp, jnp.asarray(toks),
                                {"audio_embeds": jnp.asarray(au)}, 16)
    assert int(jc.index) == cache.index
    np.testing.assert_allclose(f32(steps), f32(jnp.stack(jsteps, 1)),
                               **TOL[dt])
    assert cache._fields == jc._fields == (
        "self_k", "self_v", "cross_k", "cross_v", "index")
    got, want = tree_leaves(cache), jax.tree_util.tree_leaves(jc)
    assert len(got) == len(want) == 5
    for a, b in zip(got[:4], want[:4]):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype) == "torch." + str(b.dtype)
        np.testing.assert_allclose(f32(a), f32(b), **TOL[dt])
    # JAX's cache crosses as numpy (``convert``, leaf by leaf in its order)
    # and the port decodes on from it as JAX does
    moved = whisper.WhisperCache(*params_from_numpy(
        [np.asarray(x) for x in want], "cpu"))
    tok = toks[:, 0]
    with torch.no_grad():
        got_next, after = build_model(tcfg).decode_step(
            tp, moved, torch.from_numpy(tok))
    with jax_side(dt):
        want_next, _ = japi.decode_step(jp, jc, jnp.asarray(tok))
    assert after.index == 14
    np.testing.assert_allclose(f32(got_next), f32(want_next), **TOL[dt])


def test_cross_biases_part_decode_from_forward_as_in_jax():
    """The fault of both packages, mirrored: with nonzero cross ``bq``,
    ``bk`` and ``bv`` the teacher-forced forward and the prefill ignore
    them (the prefill's logits still equal the forward's) while the cached
    cross K/V and the decode query add them, so the decode steps part
    from the forward. The forward, the steps, and their difference equal
    JAX's (f32 compute)."""
    jcfg, tcfg, jp, _ = model("f32", seed=12)
    jp = with_cross_biases(jp, 13)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks, au = tokens((2, 13), seed=14), audio(2, tcfg, 15)
    api, japi = build_model(tcfg), jbuild_model(jcfg)
    with torch.no_grad():
        full = whisper.forward(tp, torch.from_numpy(toks),
                               torch.from_numpy(au), tcfg)[:, 9:]
        steps, _ = decode_run(api, tp, torch.from_numpy(toks),
                              {"audio_embeds": torch.from_numpy(au)}, 16)
    steps = torch.stack(steps, 1)
    jfull = jwhisper.forward(jp, jnp.asarray(toks), jnp.asarray(au),
                             jcfg)[:, 9:]
    jsteps, _ = decode_run(japi, jp, jnp.asarray(toks),
                           {"audio_embeds": jnp.asarray(au)}, 16)
    jsteps = jnp.stack(jsteps, 1)
    np.testing.assert_allclose(f32(full), f32(jfull), **TOL["f32"])
    np.testing.assert_allclose(f32(steps), f32(jsteps), **TOL["f32"])
    # the prefill's last logits are the forward's; every decode step parts
    np.testing.assert_allclose(f32(steps[:, 0]), f32(full[:, 0]),
                               **TOL["f32"])
    gap, jgap = f32(steps - full)[:, 1:], f32(jsteps - jfull)[:, 1:]
    assert np.abs(gap).max(axis=-1).min() > 0.1
    np.testing.assert_allclose(gap, jgap, **TOL["f32"])


# ------------------------------ serving -------------------------------------


def test_engine_serves_exact_lengths_as_jax_greedy():
    """f32 compute: the engine (exact-length buckets, as JAX's pads no
    audio prompt) with batch-padding rows gives JAX's greedy tokens; a
    padded prompt is refused."""
    jcfg, tcfg, jp, tp = model("f32", seed=16)
    toks, au = tokens((3, 12), seed=17), audio(3, tcfg, 18)
    want = np.asarray(jgreedy_generate(jcfg, jp, {
        "tokens": jnp.asarray(toks), "audio_embeds": jnp.asarray(au)}, 6))
    eng = DecodeEngine(tcfg, tp, buckets=((4, 12),), max_new_tokens=6)
    assert not eng.pad_seq and eng.cache_len_for(12) == 18
    rows = np.concatenate([toks, toks[:1]])
    ex = {"audio_embeds": torch.from_numpy(np.concatenate([au, au[:1]]))}
    got = eng.generate_batch(torch.from_numpy(rows), 6, extras=ex)
    np.testing.assert_array_equal(got.numpy()[:3], want)
    np.testing.assert_array_equal(got.numpy()[3], want[0])
    assert eng.compile_counts == {"prefill": 1, "decode": 1}
    with pytest.raises(ValueError, match="folds"):
        eng.generate_batch(torch.from_numpy(rows), 2, true_len=9, extras=ex)


def test_engine_bf16_cache_decodes_as_jax():
    """f32 compute, bf16 cache (self and cross K/V cast, as JAX's
    ``cast_cache`` casts every float leaf): the engine's tokens equal
    JAX's greedy decode over the same bf16-cast cache."""
    jcfg, tcfg, jp, tp = model("f32", seed=19)
    toks, au = tokens((2, 8), seed=20), audio(2, tcfg, 21)
    eng = DecodeEngine(tcfg, tp, buckets=((2, 8),), max_new_tokens=5,
                       cache_dtype=torch.bfloat16)
    got = eng.generate_batch(torch.from_numpy(toks), 5, extras={
        "audio_embeds": torch.from_numpy(au)})
    japi = jbuild_model(jcfg)
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks),
                               "audio_embeds": jnp.asarray(au)},
                          cache_len=13)
    jc = jc._replace(**{f: x.astype(jnp.bfloat16) for f, x in
                        zip(jc._fields[:4], jc[:4])})
    tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    want = [tok]
    for _ in range(4):
        jl, jc = japi.decode_step(jp, jc, tok)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        want.append(tok)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))
    assert got.dtype == torch.int32


def test_serve_and_train_clis_run_whisper(capsys):
    """The serving CLI at exact seq (its frame embeddings from the seed);
    the training CLI's audio batch (tokens and audio_embeds, the shapes
    and dtypes of JAX's ``make_batch_iter``) and three packed D-Adam
    steps."""
    rec = serve_cli.main(["--device", "cpu", "--arch", ARCH,
                          "--new-tokens", "4"])
    assert rec["arch"] == ARCH and rec["bucket"] == [8, 32]
    assert rec["compile_counts"] == {"prefill": 1, "decode": 1}
    cfg = get_reduced(ARCH).model
    batch = next(train_cli.make_batch_iter(cfg, 2, 3, 8, 0.5,
                                           torch.device("cpu")))
    jbatch = next(jmake_batch_iter(jget_reduced(ARCH).model, 2, 3, 8, 0.5))
    assert sorted(batch) == sorted(jbatch) == ["audio_embeds", "tokens"]
    for k in batch:
        assert tuple(batch[k].shape) == tuple(jbatch[k].shape)
        assert str(batch[k].dtype) == "torch." + str(jbatch[k].dtype)
    run = train_cli.main(["--device", "cpu", "--arch", ARCH, "--workers",
                          "2", "--steps", "3", "--period", "2", "--seq", "8",
                          "--batch", "1", "--backend", "packed",
                          "--log-every", "1"])
    assert f"[train] {ARCH} (reduced)" in capsys.readouterr().out
    assert run.log.step == [1, 2, 3] and all(np.isfinite(run.log.loss))
