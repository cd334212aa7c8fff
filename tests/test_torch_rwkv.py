"""The port's RWKV6 against the JAX package's, on the CPU.

``rwkv_scan_plain`` (what ``ops.rwkv_scan`` runs on a CPU tensor, and what
the CUDA kernel is held to on the card) against JAX's Pallas ``rwkv_scan``
in interpret mode and against ``ref.rwkv_scan_ref``, over the sweep of
``tests/test_kernels.py``; then the model at the reduced rwkv6-3b config:
``_decay``, ``_group_norm``, ``time_mix``, ``channel_mix``, ``forward``
(both ``wkv_impl``s on each side), ``loss_fn``, and the decode contract
(prefill plus decode steps equal one forward over the whole sequence).
Inputs come from numpy seeds; JAX's params cross as numpy arrays.
Tolerances are ``tests/test_kernels.py``'s: f32 rtol = atol = 2e-5, bf16
2e-2.

At bf16 the JAX side runs op by op (``jax.disable_jit``), where each op
rounds to bf16 as the port's eager ops do. Compiled, XLA's CPU backend
fuses the bf16 elementwise chains of the lerps and gates and keeps them
in f32 inside a fusion: the reduced model's logits then move by up to
0.096 (1.7% of them past 2e-2) from the op-by-op ones, which the port
matches to the bit on the plain scan.
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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.models import rwkv6 as jrwkv
from repro.serve.engine import cache_spec as jcache_spec
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_arch, get_reduced
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv_scan as twkv
from repro_torch.models import common
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.registry import build_model
from repro_torch.serve import cache_spec

torch.set_num_threads(2)

TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
ARCH = "rwkv6-3b"
# JAX's names of the two recurrence paths, by the port's
JAX_IMPL = {"scan": "xla", "kernel": "pallas"}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def scan_inputs(B, S, H, D, seed=0):
    """tests/test_kernels.py's distributions: r, k, v ~ 0.3 N, w =
    sigmoid(N), u ~ 0.1 N, s0 ~ 0.1 N; numpy f32."""
    rng = np.random.default_rng(seed)

    def n(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    r, k, v = (n((B, S, H, D), 0.3) for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-n((B, S, H, D))))).astype(np.float32)
    return r, k, v, w, n((H, D), 0.1), n((B, H, D, D), 0.1)


def configs(dt):
    """(JAX cfg, port cfg) of the reduced rwkv6-3b at compute dtype
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


def jax_side(dt):
    """The JAX side's context: op by op at bf16, compiled at f32."""
    return jax.disable_jit() if dt == "bf16" else contextlib.nullcontext()


def tokens(shape, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def layer0(jp, tp):
    return (jax.tree_util.tree_map(lambda x: x[0], jp["layers"]),
            common.layer_views(tp["layers"])[0])


def hidden(shape, dt, seed=2):
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.5
         ).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dt == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dt == "bf16"
                                else torch.float32)
    return jx, tx


# ------------------------------- the kernel ---------------------------------


@pytest.mark.parametrize("S,H,D,chunk", [
    (64, 2, 32, 16), (96, 3, 32, 32), (128, 1, 64, 128),
    (60, 2, 32, 16),  # chunk does not divide S: JAX shrinks it
])
def test_rwkv_scan_plain_matches_jax(S, H, D, chunk):
    ins = scan_inputs(2, S, H, D, seed=S + H)
    jy, js = jops.rwkv_scan(*map(jnp.asarray, ins), chunk=chunk,
                            interpret=True)
    ry, rs = jref.rwkv_scan_ref(*map(jnp.asarray, ins))
    ops.reset_launches()
    ty, ts = ops.rwkv_scan(*map(torch.from_numpy, ins))
    assert ops.launch_counts()["rwkv_scan"] == 0      # CPU: plain version
    assert ty.dtype == ts.dtype == torch.float32
    assert tuple(ty.shape) == (2, S, H, D) and tuple(ts.shape) == (2, H, D, D)
    for want_y, want_s in ((jy, js), (ry, rs)):
        np.testing.assert_allclose(f32(ty), f32(want_y), **TOL["f32"])
        np.testing.assert_allclose(f32(ts), f32(want_s), **TOL["f32"])


def test_rwkv_scan_state_continuity_across_calls():
    """Two calls that carry the state give one long call (the decode
    contract), against JAX's two chunked calls too."""
    r, k, v, w, u, _ = scan_inputs(1, 64, 2, 32, seed=10)
    s0 = np.zeros((1, 2, 32, 32), np.float32)
    t = [torch.from_numpy(x) for x in (r, k, v, w, u, s0)]
    y_full, s_full = twkv.rwkv_scan_plain(*t)
    halves = [[x[:, a:b] for x in t[:4]] for a, b in ((0, 32), (32, 64))]
    y1, s1 = twkv.rwkv_scan_plain(*halves[0], t[4], t[5])
    y2, s2 = twkv.rwkv_scan_plain(*halves[1], t[4], s1)
    assert torch.equal(torch.cat([y1, y2], 1), y_full)
    assert torch.equal(s2, s_full)
    j = [jnp.asarray(x) for x in (r, k, v, w, u, s0)]
    _, js1 = jops.rwkv_scan(*[x[:, :32] for x in j[:4]], j[4], j[5],
                            chunk=32, interpret=True)
    jy2, js2 = jops.rwkv_scan(*[x[:, 32:] for x in j[:4]], j[4], js1,
                              chunk=32, interpret=True)
    np.testing.assert_allclose(f32(y2), f32(jy2), **TOL["f32"])
    np.testing.assert_allclose(f32(s2), f32(js2), **TOL["f32"])


def test_rwkv_scan_bf16_operands_match_jax():
    """bf16 r, k, v and u enter the f32 recurrence exactly on both
    sides."""
    r, k, v, w, u, s0 = scan_inputs(2, 24, 2, 32, seed=3)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (r, k, v)]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v)]
    ju, tu = (jnp.asarray(u).astype(jnp.bfloat16),
              torch.from_numpy(u).to(torch.bfloat16))
    jy, js = jref.rwkv_scan_ref(*jb, jnp.asarray(w), ju, jnp.asarray(s0))
    ty, ts = tref.rwkv_scan_ref(*tb, torch.from_numpy(w), tu,
                                torch.from_numpy(s0))
    np.testing.assert_allclose(f32(ty), f32(jy), **TOL["f32"])
    np.testing.assert_allclose(f32(ts), f32(js), **TOL["f32"])


def test_rwkv_scan_checks_and_refusals():
    r, k, v, w, u, s0 = map(torch.from_numpy, scan_inputs(1, 4, 2, 32))
    with pytest.raises(ValueError, match="state"):
        ops.rwkv_scan(r, k, v, w, u, s0[:, :1])
    with pytest.raises(ValueError, match="u"):
        ops.rwkv_scan(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="match"):
        ops.rwkv_scan(r, k[:, :2], v, w, u, s0)
    # the CUDA wrapper never runs a CPU tensor (no silent fallback)
    with pytest.raises(ValueError, match="CUDA"):
        twkv.rwkv_scan(r, k, v, w, u, s0)
    # no backward: a call that autograd would record raises
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rwkv_scan(r.clone().requires_grad_(True), k, v, w, u, s0)
    with torch.no_grad():
        y, _ = ops.rwkv_scan(r.clone().requires_grad_(True), k, v, w, u, s0)
    assert not y.requires_grad
    # an empty sequence returns the state
    y, st = ops.rwkv_scan(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)
    assert tuple(y.shape) == (1, 0, 2, 32) and torch.equal(st, s0)


# ------------------------------- the config ---------------------------------


def test_config_and_param_counts_match_jax():
    jfull, tfull = jget_arch(ARCH).model, get_arch(ARCH).model
    for name in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                 "d_ff", "vocab_size", "rwkv_head_size", "rwkv_decay_rank",
                 "norm_eps", "tie_embeddings"):
        assert getattr(tfull, name) == getattr(jfull, name), name
        assert getattr(get_reduced(ARCH).model, name) == \
            getattr(jget_reduced(ARCH).model, name), name
    assert get_arch(ARCH).source == jget_arch(ARCH).source
    # the analytic count (4 d^2 per time-mix, no cm_r, no embeddings)
    assert tfull.param_count() == jfull.param_count() == 2_653_470_720
    # the tree's own count, from JAX's shapes at full width
    shapes = jax.eval_shape(lambda: jrwkv.init_params(
        jax.random.PRNGKey(0), jfull))
    assert sum(x.size for x in jax.tree_util.tree_leaves(shapes)) == \
        3_073_561_600


def test_init_params_tree_matches_jax():
    """Same keys (JAX's sorted leaf order), shapes, dtypes and init
    scales; ``u`` is f32 under an f32 param dtype."""
    jcfg, tcfg = configs("bf16")
    want = jax.eval_shape(lambda: jbuild_model(jcfg).init(
        jax.random.PRNGKey(0)))
    got = build_model(tcfg).init(torch.Generator().manual_seed(0))
    assert sorted(got["layers"]) == sorted(jrwkv.init_layer(
        jax.random.PRNGKey(0), jcfg))
    assert sorted(got["layers"]) == [
        "cm_k", "cm_mix", "cm_r", "cm_v", "gn", "gn_b", "ln1", "ln1_b",
        "ln2", "ln2_b", "mix", "u", "w0", "w_A", "w_B", "w_g", "w_k", "w_o",
        "w_r", "w_v"]
    wl = jax.tree_util.tree_leaves(want)
    gl = tree_leaves(got)
    assert [tuple(x.shape) for x in gl] == [x.shape for x in wl]
    assert all(x.dtype == torch.float32 for x in gl)
    assert [str(x.dtype) for x in wl] == ["float32"] * len(wl)
    L = got["layers"]
    d, rank = tcfg.d_model, tcfg.rwkv_decay_rank
    assert float(L["w0"].min()) == float(L["w0"].max()) == -5.0
    assert float(L["mix"].min()) == float(L["cm_mix"].max()) == 0.5
    assert abs(float(L["u"].std()) / 0.1 - 1.0) < 0.15
    assert abs(float(L["w_r"].std()) * d ** 0.5 - 1.0) < 0.1
    assert abs(float(L["w_A"].std()) / 0.01 - 1.0) < 0.15
    assert abs(float(L["w_B"].std()) / 0.01 - 1.0) < 0.3   # rank*d draws
    assert tuple(L["w_B"].shape) == (2, rank, d)
    assert abs(float(got["embed"].std()) / 0.02 - 1.0) < 0.1


def test_convert_carries_the_rwkv_tree_both_ways():
    jcfg, _ = configs("bf16")
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(2))
    npp = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_numpy(npp, "cpu")
    assert tp["layers"]["u"].dtype == torch.float32
    assert tuple(tp["layers"]["u"].shape) == (2, 4, 32)
    back = params_to_numpy(tp)
    jax.tree_util.tree_map(np.testing.assert_array_equal, npp, back)


def test_cache_state_size_does_not_depend_on_context():
    """Mirrors tests/test_serve.py: the recurrent cache is O(1) in the
    context, at the JAX spec's shapes and dtypes."""
    cfg = get_reduced(ARCH).model
    s1, s2 = cache_spec(cfg, 1, 32768), cache_spec(cfg, 1, 524288)
    j1 = jcache_spec(jget_reduced(ARCH).model, 1, 32768)
    for a, b, j in zip(s1[:3], s2[:3], j1[:3]):
        assert a.shape == b.shape == tuple(j.shape)
    assert [str(x.dtype) for x in s1[:3]] == [
        "torch.bfloat16", "torch.bfloat16", "torch.float32"]
    assert s1.wkv.shape == (2, 1, 4, 32, 32)


# ------------------------------- the blocks ---------------------------------


def test_decay_and_group_norm_match_jax(lm):
    dt, jcfg, tcfg, jp, tp = lm
    jl, tl = layer0(jp, tp)
    jx, tx = hidden((2, 5, tcfg.d_model), dt)
    np.testing.assert_allclose(f32(trwkv._decay(tl, tx)),
                               f32(jrwkv._decay(jl, jx)), **TOL["f32"])
    H = tcfg.d_model // tcfg.rwkv_head_size
    gn_w = np.random.default_rng(3).standard_normal(tcfg.d_model).astype(
        np.float32)
    got = trwkv._group_norm(tx, torch.from_numpy(gn_w), tl["gn_b"], H)
    want = jrwkv._group_norm(jx, jnp.asarray(gn_w), jl["gn_b"], H)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), **TOL["f32"])


@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_time_mix_matches_jax(lm, impl):
    dt, jcfg, tcfg, jp, tp = lm
    jl, tl = layer0(jp, tp)
    jx, tx = hidden((2, 6, tcfg.d_model), dt, seed=4)
    jprev, tprev = hidden((2, tcfg.d_model), dt, seed=5)
    H, D = tcfg.d_model // tcfg.rwkv_head_size, tcfg.rwkv_head_size
    s0 = (np.random.default_rng(6).standard_normal((2, H, D, D)) * 0.1
          ).astype(np.float32)
    jout, jlast, jst = jrwkv.time_mix(jl, jx, jcfg, jprev, jnp.asarray(s0),
                                      JAX_IMPL[impl])
    with torch.no_grad():
        tout, tlast, tst = trwkv.time_mix(tl, tx, tcfg, tprev,
                                          torch.from_numpy(s0), impl)
    assert tout.dtype == tx.dtype and tst.dtype == torch.float32
    np.testing.assert_allclose(f32(tout), f32(jout), **TOL[dt])
    np.testing.assert_array_equal(f32(tlast), f32(jlast))
    np.testing.assert_allclose(f32(tst), f32(jst), **TOL[dt])


def test_channel_mix_matches_jax(lm):
    dt, jcfg, tcfg, jp, tp = lm
    jl, tl = layer0(jp, tp)
    jx, tx = hidden((2, 6, tcfg.d_model), dt, seed=7)
    jout, jlast = jrwkv.channel_mix(jl, jx, None)
    tout, tlast = trwkv.channel_mix(tl, tx, None)
    assert tout.dtype == tx.dtype
    np.testing.assert_allclose(f32(tout), f32(jout), **TOL[dt])
    np.testing.assert_array_equal(f32(tlast), f32(jlast))


# ------------------------------- the model ----------------------------------


@pytest.mark.parametrize("timpl,jimpl", [
    ("scan", "xla"), ("scan", "pallas"), ("kernel", "xla"),
    ("kernel", "pallas")])
def test_forward_matches_jax_f32(timpl, jimpl):
    jcfg, tcfg = configs("f32")
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = tokens((2, 12), seed=8)
    jl, jc = jrwkv.forward(jp, jnp.asarray(toks), jcfg, wkv_impl=jimpl)
    with torch.no_grad():
        tl, tc = trwkv.forward(tp, torch.from_numpy(toks), tcfg,
                               wkv_impl=timpl)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL["f32"])
    for a, b in zip(tc[:3], jc[:3]):
        np.testing.assert_allclose(f32(a), f32(b), **TOL["f32"])
    assert tc.index == int(jc.index) == 12


@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_forward_matches_jax_bf16(impl):
    """Both of the port's paths (on the CPU both run the plain loop)
    against JAX's plain scan. JAX's Pallas kernel sums y in another order,
    and at bf16 a changed last bit of y becomes a bf16 ulp of the next
    layer's input: JAX's own two paths part by up to 0.033 here (3 of
    12,288 logits past 2e-2), so the Pallas side is held at f32 alone."""
    jcfg, tcfg = configs("bf16")
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = tokens((2, 12), seed=9)
    with jax_side("bf16"):
        jl, jc = jrwkv.forward(jp, jnp.asarray(toks), jcfg, wkv_impl="xla")
    with torch.no_grad():
        tl, tc = trwkv.forward(tp, torch.from_numpy(toks), tcfg,
                               wkv_impl=impl)
    assert tl.dtype == torch.bfloat16
    assert [x.dtype for x in tc[:3]] == [torch.bfloat16, torch.bfloat16,
                                         torch.float32]
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL["bf16"])
    np.testing.assert_allclose(f32(tc.wkv), f32(jc.wkv), **TOL["bf16"])


def test_loss_matches_jax(lm):
    dt, jcfg, tcfg, jp, tp = lm
    toks = tokens((2, 9), seed=10)
    with jax_side(dt):
        jloss = jbuild_model(jcfg).loss(jp, {"tokens": jnp.asarray(toks)})
    tloss = build_model(tcfg).loss(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL[dt])
    # the plain scan is differentiable; the kernel path refuses autograd
    w_k = tp["layers"]["w_k"].clone().requires_grad_(True)
    tp2 = dict(tp, layers=dict(tp["layers"], w_k=w_k))
    build_model(tcfg).loss(tp2, {"tokens": torch.from_numpy(toks)}
                           ).backward()
    assert w_k.grad is not None and bool(w_k.grad.abs().sum() > 0)
    with pytest.raises(RuntimeError, match="no backward"):
        trwkv.forward(tp2, torch.from_numpy(toks), tcfg, wkv_impl="kernel")
    # remat is the activation-checkpoint policy of training: the forward
    # is the same, and an unknown policy raises
    with torch.no_grad():
        plain, _ = trwkv.forward(tp, torch.from_numpy(toks), tcfg)
    full, _ = trwkv.forward(tp2, torch.from_numpy(toks), tcfg, remat="full")
    assert torch.equal(full.detach(), plain)
    with pytest.raises(ValueError, match="remat"):
        trwkv.forward(tp, torch.from_numpy(toks), tcfg, remat="some")
    with pytest.raises(ValueError, match="wkv_impl"):
        trwkv.forward(tp, torch.from_numpy(toks), tcfg, wkv_impl="pallas")


@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_prefill_and_decode_equal_one_forward(lm, impl):
    """JAX's decode contract: a prefill of 8 tokens plus 4 decode steps
    give the logits and the final cache of one forward over all 12; and
    the final cache equals JAX's, leaf for leaf."""
    dt, jcfg, tcfg, jp, tp = lm
    api = build_model(tcfg)
    toks = tokens((2, 12), seed=11)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        full, fcache = trwkv.forward(tp, tt, tcfg, wkv_impl=impl)
        logits, cache = api.prefill(tp, {"tokens": tt[:, :8]},
                                    cache_len=99, wkv_impl=impl)
        steps = [logits[:, 0]]
        for t in range(8, 12):
            logits, cache = api.decode_step(tp, cache, tt[:, t],
                                            wkv_impl=impl)
            steps.append(logits)
    assert cache.index == fcache.index == 12
    np.testing.assert_allclose(f32(torch.stack(steps, 1)),
                               f32(full[:, 7:]), **TOL[dt])
    for a, b in zip(cache[:3], fcache[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(f32(a), f32(b), **TOL[dt])
    japi = jbuild_model(jcfg)
    with jax_side(dt):
        jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])})
        np.testing.assert_allclose(f32(steps[0]), f32(jl[:, 0]), **TOL[dt])
        for t in range(8, 12):
            jl, jc = japi.decode_step(jp, jc, jnp.asarray(toks[:, t]))
    np.testing.assert_allclose(f32(steps[-1]), f32(jl), **TOL[dt])
    for a, b in zip(cache[:3], jc[:3]):
        np.testing.assert_allclose(f32(a), f32(b), **TOL[dt])
    assert int(jc.index) == cache.index
