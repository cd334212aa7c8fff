"""The port's Mamba2 and zamba2 hybrid against the JAX package, on the CPU.

* ``_causal_conv``, ``ssd_scan`` (the port's chunked form against JAX's
  sequential ``lax.scan``, with the carried state, at S in {1, 7, 64,
  130}) and ``layer_forward``;
* the hybrid's ``forward``, ``loss_fn`` and gradient, and the decode
  contract (prefill plus decode steps equal one forward, each step equal
  to JAX's), at the reduced zamba2-7b (2 layers, a shared block after
  each) and at 5 layers with a period of 2 (a last segment with no
  block);
* ``n_attn_sites``, the param tree, ``cache_spec`` against JAX's, the
  engine at exact sequence lengths against JAX's ``greedy_generate``,
  the serving and training CLIs (the training checkpoint restored by the
  JAX package: the packed layout of the hybrid tree is JAX's).

JAX's params cross as numpy. Tolerances are ``tests/test_kernels.py``'s:
f32 rtol = atol = 2e-5, bf16 2e-2; gradients within 2e-5 of each leaf's
largest entry. At bf16 the JAX side runs op by op (``jax.disable_jit``),
as in ``tests/test_torch_rwkv.py``.

The chunked scan sums in another order than the sequential one (each
chunk's outputs as products of a (Q, Q) decay-weighted score matrix, the
state carried from chunk to chunk): on these inputs it stays within a
tenth of the f32 tolerance of JAX's scan, so the tolerance is the
round's. At bf16 compute the port's f32 elementwise functions and XLA's
differ in the last bit (silu in 23% of the elements, softplus in 12%,
exp in 10%, on the CPU), and where such a value is rounded to bf16 a
last-bit difference now and then becomes a bf16 ulp, which later layers
carry on: the reduced model's bf16 logits lay up to 0.036 from JAX's in
4 of 16,384 places (0.047 at 5 layers), past 2e-2 where the logit is
small, the same with the port's scan swapped for a sequential one; the
bf16 conv states and KV sites behind later layers likewise (up to 0.031
in 8 of 8,640). So the whole model's bf16 outputs against JAX's
(``bf16_close``) are held to 2e-2 in all but 1% of their elements and to
five times that in every one, and its logits as a whole to JAX's f32
logits: no farther from them than 1.25 times JAX's own bf16 logits lie.
One block, the f32 SSM states, the losses and the port's own decode
contract keep 2e-2 everywhere.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_arch as jget_arch
from repro.configs import get_reduced as jget_reduced
from repro.core import make_optimizer as jax_make_optimizer
from repro.models import build_model as jbuild_model
from repro.models import hybrid as jhybrid
from repro.models import mamba2 as jmamba2
from repro.serve import greedy_generate as jgreedy_generate
from repro.serve.engine import cache_spec as jcache_spec
from repro.train import DecentralizedTrainer as JaxTrainer
from repro_torch._tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.configs import get_arch, get_reduced
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import common, hybrid, mamba2
from repro_torch.models.registry import build_model
from repro_torch.serve import DecodeEngine, cache_spec, cast_params

torch.set_num_threads(2)

TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
ARCH = "zamba2-7b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# the reduced config, and 5 layers at period 2: segments (0, 2), (2, 4)
# with a block each and (4, 5) without
SHAPES = {"reduced": {}, "tail": dict(n_layers=5, shared_attn_period=2)}


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
    """JAX params of the reduced zamba2-7b and the port's copy."""
    return (request.param,) + model(request.param)


def tokens(shape, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def both(x, dt):
    jd, td = DTYPES[dt]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def bf16_close(got, want, ref32=None, share=0.01, ratio=1.25):
    """bf16 outputs ``got`` against ``want`` (JAX's bf16): within 2e-2 in
    all but ``share`` of the elements and within five times that in all;
    given ``ref32`` (JAX's f32 logits), no farther from them than
    ``ratio`` times ``want`` lies."""
    got, want = f32(got), f32(want)
    err = np.abs(got - want) / (TOL["bf16"]["atol"]
                                + TOL["bf16"]["rtol"] * np.abs(want))
    assert (err > 1).mean() <= share, (err > 1).mean()
    assert err.max() <= 5, err.max()
    if ref32 is not None:
        ref32 = f32(ref32)
        assert np.abs(got - ref32).max() <= \
            ratio * np.abs(want - ref32).max()


def layer0(jp, tp):
    return (jax.tree_util.tree_map(lambda x: x[0], jp["layers"]),
            common.layer_views(tp["layers"])[0])


# ---------------------------- config and tree -------------------------------


def test_zamba2_has_five_attention_sites():
    """_segments(81, 14) ends in a partial segment of 11 layers with no
    block: 5 sites, as JAX's n_attn_sites counts (its config's docstring
    says 6)."""
    cfg = get_arch(ARCH).model
    assert hybrid.n_attn_sites(cfg) == jhybrid.n_attn_sites(
        jget_arch(ARCH).model) == 5
    assert hybrid._segments(81, 14) == jhybrid._segments(81, 14)
    assert hybrid._segments(81, 14)[-1] == (70, 81, False)
    assert hybrid.n_attn_sites(get_reduced(ARCH).model) == 2
    assert hybrid._segments(5, 0) == [(0, 5, False)]
    assert cfg.resolved_head_dim == 112 and cfg.n_kv_heads == cfg.n_heads


def test_param_tree_matches_jax():
    """Same keys (JAX's sorted order: ``A_log`` and ``D`` before
    ``conv_b``), shapes, dtypes and scales; the f32 leaves stay f32 under
    a bf16 param dtype and in the serving copy. The full tree holds
    6,751,130,832 parameters (the analytic count leaves out the norms,
    ``conv_b`` and ``D``)."""
    jcfg, tcfg = configs("bf16", param_dtype=None)
    jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16)
    want = jax.eval_shape(lambda: jbuild_model(jcfg).init(
        jax.random.PRNGKey(0)))
    got = build_model(tcfg).init(torch.Generator().manual_seed(0))
    assert list(tree_flatten(got["layers"])[1].keys) == [
        "A_log", "D", "conv_b", "conv_w", "dt_bias", "gn", "in_proj", "norm",
        "out_proj"]
    assert sorted(got) == ["embed", "final_norm", "layers", "lm_head",
                           "shared"]
    wl, gl = jax.tree_util.tree_leaves(want), tree_leaves(got)
    assert [tuple(x.shape) for x in gl] == [x.shape for x in wl]
    assert [str(x.dtype) for x in gl] == ["torch." + str(x.dtype)
                                          for x in wl]
    L = got["layers"]
    assert {L[k].dtype for k in mamba2.F32_LEAVES} == {torch.float32}
    assert float(L["A_log"].abs().max()) == 0.0 == float(
        L["dt_bias"].abs().max())
    assert float(L["D"].min()) == 1.0
    assert abs(float(L["conv_w"].float().std()) / 0.1 - 1.0) < 0.1
    d = tcfg.d_model
    assert abs(float(L["in_proj"].float().std()) * d ** 0.5 - 1.0) < 0.1
    half = cast_params(got, torch.bfloat16,
                       keep=build_model(tcfg).f32_leaves)
    assert {half["layers"][k].dtype for k in mamba2.F32_LEAVES} == {
        torch.float32}
    full = jax.eval_shape(lambda: jhybrid.init_params(
        jax.random.PRNGKey(0), jget_arch(ARCH).model))
    assert sum(x.size for x in jax.tree_util.tree_leaves(full)) == \
        6_751_130_832
    assert get_arch(ARCH).model.param_count() == 6_750_229_728


def test_convert_carries_the_hybrid_tree_both_ways():
    _, _, jp, tp = model("f32", seed=2)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    assert tuple(tp["layers"]["in_proj"].shape) == (2, 128, 2 * 256 + 32 + 4)
    back = params_to_numpy(tp)
    jax.tree_util.tree_map(np.testing.assert_array_equal, npp, back)


def test_cache_spec_matches_jax_and_the_prefill():
    """Conv in the compute dtype, the SSM state in f32, the KV sites in
    ``cache_dtype``; one site per whole segment."""
    for kw in SHAPES.values():
        jcfg, tcfg = configs("bf16", **kw)
        for cd, jcd in ((torch.bfloat16, jnp.bfloat16),
                        (torch.float32, jnp.float32)):
            got = cache_spec(tcfg, 3, 40, cache_dtype=cd)
            want = jcache_spec(jcfg, 3, 40, cache_dtype=jcd)
            assert isinstance(got, hybrid.HybridCache)
            for a, b in zip(got, want):
                assert a.shape == tuple(b.shape)
                assert str(a.dtype) == "torch." + str(b.dtype)
    spec = cache_spec(get_arch(ARCH).model, 8, 1056)
    assert spec.ssm.shape == (81, 8, 112, 64, 64)
    assert spec.attn_k.shape == (5, 8, 1056, 32, 112)
    _, tcfg, _, tp = model("bf16")
    with torch.no_grad():
        _, cache = build_model(tcfg).prefill(
            tp, {"tokens": torch.from_numpy(tokens((3, 10)))}, cache_len=40)
    for a, b in zip(cache_spec(tcfg, 3, 40), cache[:4]):
        assert a.shape == tuple(b.shape) and a.dtype == b.dtype


# ------------------------------ the blocks ----------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_causal_conv_matches_jax(dt):
    """JAX's k shifted adds in the compute dtype, a nonzero carried
    prefix: equal to the bit."""
    jx, tx = both(normal((2, 9, 24), 3), dt)
    jw, tw = both(normal((4, 24), 4, 0.1), dt)
    jb, tb = both(normal((24,), 5), dt)
    jprev, tprev = both(normal((2, 3, 24), 6), dt)
    jout, jnew = jmamba2._causal_conv(jx, jw, jb, jprev)
    tout, tnew = mamba2._causal_conv(tx, tw, tb, tprev)
    assert tout.dtype == tx.dtype
    np.testing.assert_array_equal(f32(tout), f32(jout))
    np.testing.assert_array_equal(f32(tnew), f32(jnew))


@pytest.mark.parametrize("S", [1, 7, 64, 130])
def test_ssd_scan_chunked_matches_jax_sequential(S):
    """The chunked form against JAX's scan over S steps (chunks of 64:
    one partial chunk at 7, one whole at 64, two whole and a padded one
    at 130; S = 1 is the recurrence step), from a nonzero state: y and
    the carried state."""
    B, H, P, N = 2, 4, 8, 16
    x = normal((B, S, H, P), 7)
    dt = np.log1p(np.exp(normal((B, S, H), 8))).astype(np.float32)
    A_log = normal((H,), 9, 0.5)
    log_a = (-np.exp(A_log)[None, None] * dt).astype(np.float32)
    Bm, Cm = normal((B, S, N), 10), normal((B, S, N), 11)
    st = normal((B, H, P, N), 12, 0.5)
    a = jnp.exp(-jnp.exp(jnp.asarray(A_log))[None, None] * jnp.asarray(dt))
    jy, js = jmamba2.ssd_scan(*(jnp.asarray(t) for t in (x, dt)), a,
                              *(jnp.asarray(t) for t in (Bm, Cm, st)))
    ty, ts = mamba2.ssd_scan(*(torch.from_numpy(t) for t in (
        x, dt, log_a, Bm, Cm, st)))
    assert ty.dtype == ts.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL["f32"])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL["f32"])
    # one call equals two that carry the state (the decode path's use)
    if S > 1:
        cut = S // 2
        args = [torch.from_numpy(t) for t in (x, dt, log_a, Bm, Cm)]
        y1, s1 = mamba2.ssd_scan(*(t[:, :cut] for t in args),
                                 torch.from_numpy(st))
        y2, s2 = mamba2.ssd_scan(*(t[:, cut:] for t in args), s1)
        np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                                   np.asarray(jy), **TOL["f32"])
        np.testing.assert_allclose(s2.numpy(), np.asarray(js), **TOL["f32"])


def test_layer_forward_matches_jax(lm):
    dt, jcfg, tcfg, jp, tp = lm
    jl, tl = layer0(jp, tp)
    # JAX's init zeroes A_log and dt_bias: move them so the decays differ
    # by head
    for k, seed in (("A_log", 13), ("dt_bias", 14)):
        v = normal((tcfg.resolved_ssm_heads,), seed, 0.5)
        jl = dict(jl, **{k: jnp.asarray(v)})
        tl = dict(tl, **{k: torch.from_numpy(v)})
    jh, th = both(normal((2, 11, tcfg.d_model), 15), dt)
    conv = normal((2, tcfg.ssm_conv - 1, tcfg.d_inner + 2 * tcfg.ssm_state),
                  16)
    ssm = normal((2, tcfg.resolved_ssm_heads,
                  tcfg.d_inner // tcfg.resolved_ssm_heads, tcfg.ssm_state),
                 17, 0.3)
    jconv, tconv = both(conv, dt)
    with jax_side(dt):
        jout, jst = jmamba2.layer_forward(
            jl, jh, jcfg, jmamba2.MambaState(jconv, jnp.asarray(ssm)))
    with torch.no_grad():
        tout, tst = mamba2.layer_forward(
            tl, th, tcfg, mamba2.MambaState(tconv, torch.from_numpy(ssm)))
    assert tout.dtype == th.dtype and tst.ssm.dtype == torch.float32
    assert tst.conv.dtype == th.dtype
    np.testing.assert_allclose(f32(tout), f32(jout), **TOL[dt])
    # the conv inputs come from in_proj's product (rounded apart at f32)
    np.testing.assert_allclose(f32(tst.conv), f32(jst.conv), **TOL[dt])
    np.testing.assert_allclose(f32(tst.ssm), f32(jst.ssm), **TOL[dt])


# ------------------------------- the model ----------------------------------


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_and_loss_match_jax(lm, shape):
    dt = lm[0]
    jcfg, tcfg, jp, tp = model(dt, seed=1, **SHAPES[shape])
    toks = tokens((2, 17), seed=3)
    with jax_side(dt):
        jl, (jconv, jssm) = jhybrid.forward(jp, jnp.asarray(toks[:, :-1]),
                                            jcfg)
        jloss = jbuild_model(jcfg).loss(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, (tconv, tssm) = hybrid.forward(tp, torch.from_numpy(
            toks[:, :-1]), tcfg)
        tloss = build_model(tcfg).loss(tp, {"tokens": torch.from_numpy(
            toks)})
    assert tl.dtype == DTYPES[dt][1]
    if dt == "bf16":
        jcfg32 = configs("f32", **SHAPES[shape])[0]
        bf16_close(tl, jl, jhybrid.forward(jp, jnp.asarray(toks[:, :-1]),
                                           jcfg32)[0])
    else:
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL[dt])
    np.testing.assert_array_equal(tconv.shape, jconv.shape)
    if dt == "bf16":
        bf16_close(tconv, jconv)
    else:
        np.testing.assert_allclose(f32(tconv), f32(jconv), **TOL[dt])
    np.testing.assert_allclose(f32(tssm), f32(jssm), **TOL[dt])
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL[dt])


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_loss_gradient_matches_jax(shape):
    """f32 compute: the loss and every leaf's gradient (the shared block's
    summed over its sites) within 2e-5 of the leaf's largest entry; the
    remat policies give the same gradients."""
    jcfg, tcfg, jp, tp = model("f32", seed=4, **SHAPES[shape])
    toks = tokens((2, 13), seed=5)
    jl, jg = jax.value_and_grad(jbuild_model(jcfg).loss)(
        jp, {"tokens": jnp.asarray(toks)})
    leaves, td = tree_flatten(tp)
    out = {}
    for remat in ("none", "full"):
        xs = [x.detach().requires_grad_(True) for x in leaves]
        loss = build_model(tcfg).loss(tree_unflatten(td, xs),
                                      {"tokens": torch.from_numpy(toks)},
                                      remat=remat)
        out[remat] = loss, torch.autograd.grad(loss, xs)
    loss, grads = out["none"]
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               **TOL["f32"])
    for a, b in zip(grads, jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))
    assert torch.equal(out["full"][0], loss)
    for a, b in zip(out["full"][1], grads):
        assert torch.equal(a, b)
    assert float(grads[-1].abs().max()) > 0   # the shared block's wv


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_prefill_and_decode_equal_forward_and_jax(lm, shape):
    """JAX's decode contract (``tests/test_models.py``): a prefill of 10
    tokens then 4 decode steps give the logits of one forward over all
    14; each step's logits and the final cache equal JAX's (both prefills
    on sdpa's "auto" path; the flash kernel's plain version rounds its
    output once in f32 where the naive path rounds the probabilities to
    bf16 first, ``tests/test_torch_attention.py``)."""
    dt = lm[0]
    jcfg, tcfg, jp, tp = model(dt, seed=6, **SHAPES[shape])
    api, japi = build_model(tcfg), jbuild_model(jcfg)
    toks = tokens((2, 14), seed=7)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        full, _ = hybrid.forward(tp, tt, tcfg)
        logits, cache = api.prefill(tp, {"tokens": tt[:, :10]},
                                    cache_len=20)
        steps = [logits[:, 0]]
        for t in range(10, 14):
            logits, cache = api.decode_step(tp, cache, tt[:, t])
            steps.append(logits)
    assert cache.index == 14
    steps = torch.stack(steps, 1)
    np.testing.assert_allclose(f32(steps), f32(full[:, 9:]), **TOL[dt])
    with jax_side(dt):
        jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks[:, :10])},
                              cache_len=20)
        jsteps = [jl[:, 0]]
        for t in range(10, 14):
            jl, jc = japi.decode_step(jp, jc, jnp.asarray(toks[:, t]))
            jsteps.append(jl)
    assert int(jc.index) == cache.index
    if dt == "bf16":
        ref32 = jhybrid.forward(jp, jnp.asarray(toks),
                                configs("f32", **SHAPES[shape])[0])[0]
        bf16_close(steps, jnp.stack(jsteps, 1), ref32[:, 9:])
    else:
        np.testing.assert_allclose(f32(steps), f32(jnp.stack(jsteps, 1)),
                                   **TOL[dt])
    for a, b in zip(cache[:4], jc[:4]):
        assert a.dtype == DTYPES[dt][1] or a.dtype == torch.float32
        assert str(a.dtype) == "torch." + str(b.dtype)
        if a.dtype == torch.bfloat16:
            bf16_close(a, b)
        else:
            np.testing.assert_allclose(f32(a), f32(b), **TOL[dt])


def test_prefill_refuses_a_short_cache():
    _, tcfg, _, tp = model("f32")
    with pytest.raises(ValueError, match="cache_len"):
        hybrid.prefill(tp, torch.zeros((1, 8), dtype=torch.int32), tcfg,
                       cache_len=4)


# ------------------------------ serving -------------------------------------


def test_engine_serves_exact_lengths_as_jax_greedy():
    """f32 compute: the engine (exact-length buckets: the recurrent state
    would fold pads in) gives JAX's greedy tokens; a padded prompt is
    refused; the f32 leaves survive the engine's cast."""
    jcfg, tcfg, jp, tp = model("f32", seed=8)
    toks = tokens((3, 12), seed=9)
    want = np.asarray(jgreedy_generate(jcfg, jp,
                                       {"tokens": jnp.asarray(toks)}, 6))
    eng = DecodeEngine(tcfg, tp, buckets=((4, 12),), max_new_tokens=6)
    assert not eng.pad_seq
    got = eng.generate([torch.from_numpy(t) for t in toks], 6)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)
    assert eng.compile_counts == {"prefill": 1, "decode": 1}
    with pytest.raises(ValueError, match="no bucket"):
        eng.generate([torch.from_numpy(toks[0, :9])], 2)
    with pytest.raises(ValueError, match="folds"):
        eng.generate_batch(torch.zeros((4, 12), dtype=torch.int32), 2,
                           true_len=9)
    kept = eng._params()[1]["layers"]
    assert {kept[k].dtype for k in mamba2.F32_LEAVES} == {torch.float32}


def test_engine_bf16_cache_keeps_decoding():
    """A bf16 cache (the engine casts every float leaf, the SSM state
    too, as JAX's ``cast_cache`` does) decodes: the scan takes the state
    in f32 and the new state is stored back in bf16."""
    _, tcfg, _, tp = model("bf16", seed=10)
    eng = DecodeEngine(tcfg, tp, buckets=((2, 8),), max_new_tokens=5,
                       cache_dtype=torch.bfloat16)
    out = eng.generate_batch(torch.from_numpy(tokens((2, 8), seed=11)), 5)
    assert out.shape == (2, 5) and out.dtype == torch.int32


def test_serve_and_train_clis_run_zamba2(tmp_path, capsys):
    rec = serve_cli.main(["--device", "cpu", "--arch", ARCH,
                          "--new-tokens", "4"])
    assert rec["arch"] == ARCH and rec["bucket"] == [8, 32]
    assert rec["compile_counts"] == {"prefill": 1, "decode": 1}
    path = str(tmp_path / "zamba2.npz")
    run = train_cli.main(["--device", "cpu", "--arch", ARCH, "--workers",
                          "2", "--steps", "3", "--period", "2", "--seq", "8",
                          "--batch", "1", "--backend", "packed",
                          "--log-every", "1", "--ckpt", path])
    assert f"[train] {ARCH} (reduced)" in capsys.readouterr().out
    assert run.log.step == [1, 2, 3] and all(np.isfinite(run.log.loss))
    jcfg = jget_reduced(ARCH).model
    jopt = jax_make_optimizer("d-adam", 2, period=2, backend="pallas")
    jlike = JaxTrainer(lambda p, b: jbuild_model(jcfg).loss(p, b),
                       jopt).init(jbuild_model(jcfg).init(
                           jax.random.PRNGKey(1)))
    js, step = jio.restore(path, jlike)
    assert step == 3
    np.testing.assert_array_equal(np.asarray(js.buf), run.state.buf.numpy())
    for a, b in zip(tree_leaves(run.state.params),
                    jax.tree_util.tree_leaves(js.params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
