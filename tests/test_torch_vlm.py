"""The port's phi-3-vision (the vlm family) against the JAX package, on
the CPU.

* both new configs' parameter counts (phi-3-vision and whisper-large-v3)
  and the registry: every JAX architecture is listed and every family
  builds;
* the param tree (JAX's sorted keys, ``projector`` after ``layers``) and
  ``convert`` both ways;
* at the reduced config, from one set of numpy weights and inputs:
  ``project_patches``, ``forward``, ``loss_fn`` and ``prefill`` plus 3
  ``decode_step``s against JAX's, and the port's own decode contract
  (the steps equal one forward over patches and text);
* ``DecodeEngine.generate_batch(extras=)`` on a padded prompt (the rewind
  at ``L - 1 + n_patches``) with batch-padding rows, and on a full one,
  against JAX's ``greedy_generate`` of the unpadded prompts (JAX's
  bucket contract; JAX's own engine goes through ``repro.analysis``,
  which this jax breaks);
* the training CLI's vlm batch (JAX's ``launch/train.py:43-45``) and a
  packed D-Adam run through it; the serving CLI.

JAX's params cross as numpy. Tolerances are ``tests/test_kernels.py``'s:
f32 rtol = atol = 2e-5, bf16 2e-2. Both prefills take sdpa's "auto" path.
At bf16 the JAX side runs op by op (``jax.disable_jit``), as in
``tests/test_torch_moe.py``: compiled, XLA's CPU backend keeps fused bf16
elementwise chains in f32, and the reduced model's logits then lie up to
0.037 from the port's eager ones (13 of 20,480 past 2e-2). Op by op, the
port's f32 silu and XLA's differ in the last bit now and then, which a
bf16 rounding turns into an ulp that later layers carry: 1 logit of
20,480 lay 0.022 from JAX's. So the whole model's bf16 logits are held as
``tests/test_torch_hybrid.py`` holds its (``bf16_close``): within 2e-2 in
all but 1% of the elements and five times that in every one, and no
farther from JAX's f32 logits than 1.25 times JAX's own bf16 logits lie;
the projection, the losses and the port's own decode contract keep 2e-2
everywhere.
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
from repro.configs import list_archs as jlist_archs
from repro.launch.train import make_batch_iter as jmake_batch_iter
from repro.models import build_model as jbuild_model
from repro.models import vlm as jvlm
from repro.serve import greedy_generate as jgreedy_generate
from repro_torch._tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.configs import get_arch, get_reduced, list_archs
from repro_torch.configs import _NOT_PORTED
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import vlm
from repro_torch.models.registry import FAMILIES, build_model
from repro_torch.serve import DecodeEngine

torch.set_num_threads(2)

TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
ARCH = "phi-3-vision-4.2b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def configs(dt, **kw):
    jd, td = DTYPES[dt]
    return (dataclasses.replace(jget_reduced(ARCH).model, compute_dtype=jd,
                                **kw),
            dataclasses.replace(get_reduced(ARCH).model, compute_dtype=td,
                                **kw))


def jax_side(dt):
    """The JAX side's context: op by op at bf16, compiled at f32."""
    return jax.disable_jit() if dt == "bf16" else contextlib.nullcontext()


def model(dt, seed=0, **kw):
    jcfg, tcfg = configs(dt, **kw)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=["f32", "bf16"])
def lm(request):
    return (request.param,) + model(request.param)


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


def logits_close(dt, got, want, ref32):
    """f32: 2e-5; bf16: ``bf16_close`` against JAX's bf16 and f32 logits
    (``ref32``, a thunk)."""
    if dt == "bf16":
        bf16_close(got, want, ref32())
    else:
        np.testing.assert_allclose(f32(got), f32(want), **TOL[dt])


def tokens(shape, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def patches(batch, n, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, n, vlm.CLIP_DIM)).astype(np.float32)


# ---------------------------- configs and tree ------------------------------


@pytest.mark.parametrize("arch,count", [("phi-3-vision-4.2b", 3_820_879_872),
                                        ("whisper-large-v3", 1_600_783_360)])
def test_param_count_matches_jax(arch, count):
    assert get_arch(arch).model.param_count() == count == \
        jget_arch(arch).model.param_count()
    assert get_reduced(arch).model.param_count() == \
        jget_reduced(arch).model.param_count()
    for f in dataclasses.fields(get_arch(arch).model):
        if f.name not in ("compute_dtype", "param_dtype"):
            assert getattr(get_arch(arch).model, f.name) == \
                getattr(jget_arch(arch).model, f.name), f.name
    assert get_arch(arch).source == jget_arch(arch).source


def test_every_jax_arch_and_family_is_ported():
    assert list_archs() == sorted(jlist_archs())
    assert _NOT_PORTED == ()
    assert {get_reduced(a).model.family for a in list_archs()} == \
        set(FAMILIES)
    for arch in list_archs():
        assert build_model(get_reduced(arch).model).cfg.arch_id == arch


def test_param_tree_matches_jax_and_converts_both_ways():
    """JAX's sorted keys (``projector`` after ``layers``), shapes and
    dtypes; the projector drawn at 1/sqrt(1024)."""
    jcfg, tcfg = configs("bf16")
    want = jax.eval_shape(lambda: jbuild_model(jcfg).init(
        jax.random.PRNGKey(0)))
    got = build_model(tcfg).init(torch.Generator().manual_seed(0))
    assert list(tree_flatten(got)[1].keys) == [
        "embed", "final_norm", "layers", "lm_head", "projector"]
    wl, gl = jax.tree_util.tree_leaves(want), tree_leaves(got)
    assert [tuple(x.shape) for x in gl] == [x.shape for x in wl]
    assert [str(x.dtype) for x in gl] == ["torch." + str(x.dtype)
                                          for x in wl]
    assert tuple(got["projector"].shape) == (vlm.CLIP_DIM, tcfg.d_model)
    assert abs(float(got["projector"].std()) * 32 - 1.0) < 0.05
    _, _, jp, tp = model("f32", seed=3)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, jp),
                           params_to_numpy(tp))


# -------------------------------- the model ---------------------------------


def test_forward_and_loss_match_jax(lm):
    dt, jcfg, tcfg, jp, tp = lm
    toks, pt = tokens((2, 13), seed=3), patches(2, tcfg.n_patches, 4)
    with torch.no_grad():
        temb = vlm.project_patches(tp, torch.from_numpy(pt), tcfg)
        tl, taux = vlm.forward(tp, torch.from_numpy(toks[:, :-1]),
                               torch.from_numpy(pt), tcfg)
        tloss = build_model(tcfg).loss(tp, {
            "tokens": torch.from_numpy(toks), "patches": torch.from_numpy(pt)})
    with jax_side(dt):
        jemb = jvlm.project_patches(jp, jnp.asarray(pt), jcfg)
        jl, jaux = jvlm.forward(jp, jnp.asarray(toks[:, :-1]),
                                jnp.asarray(pt), jcfg)
        jloss = jbuild_model(jcfg).loss(jp, {"tokens": jnp.asarray(toks),
                                             "patches": jnp.asarray(pt)})
    assert tl.dtype == temb.dtype == DTYPES[dt][1]
    assert tl.shape == (2, tcfg.n_patches + 12, tcfg.vocab_size)
    np.testing.assert_allclose(f32(temb), f32(jemb), **TOL[dt])
    logits_close(dt, tl, jl, lambda: jvlm.forward(
        jp, jnp.asarray(toks[:, :-1]), jnp.asarray(pt),
        configs("f32")[0])[0])
    assert float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL[dt])


def test_loss_gradient_matches_jax():
    """f32 compute: every leaf's gradient, the projector's included,
    within 2e-5 of the leaf's largest entry."""
    jcfg, tcfg, jp, tp = model("f32", seed=5)
    toks, pt = tokens((2, 9), seed=6), patches(2, tcfg.n_patches, 7)
    jg = jax.grad(jbuild_model(jcfg).loss)(
        jp, {"tokens": jnp.asarray(toks), "patches": jnp.asarray(pt)})
    leaves, td = tree_flatten(tp)
    xs = [x.detach().requires_grad_(True) for x in leaves]
    loss = build_model(tcfg).loss(tree_unflatten(td, xs), {
        "tokens": torch.from_numpy(toks), "patches": torch.from_numpy(pt)})
    grads = torch.autograd.grad(loss, xs)
    for a, b in zip(grads, jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))
    assert float(grads[-1].abs().max()) > 0      # the projector


def test_prefill_and_decode_equal_forward_and_jax(lm):
    """A prefill of the patches and 10 tokens, then 3 decode steps: the
    logits of one forward over all of it (the port's contract), each step
    and the final cache equal to JAX's; the cache index counts the
    patches."""
    dt, jcfg, tcfg, jp, tp = lm
    api, japi = build_model(tcfg), jbuild_model(jcfg)
    P = tcfg.n_patches
    toks, pt = tokens((2, 13), seed=8), patches(2, P, 9)
    tt, tpt = torch.from_numpy(toks), torch.from_numpy(pt)
    with torch.no_grad():
        full, _ = vlm.forward(tp, tt, tpt, tcfg)
        logits, cache = api.prefill(tp, {"tokens": tt[:, :10],
                                         "patches": tpt}, cache_len=P + 16)
        steps = [logits[:, 0]]
        for t in range(10, 13):
            logits, cache = api.decode_step(tp, cache, tt[:, t])
            steps.append(logits)
    assert cache.index == P + 13
    steps = torch.stack(steps, 1)
    np.testing.assert_allclose(f32(steps), f32(full[:, P + 9:]), **TOL[dt])
    with jax_side(dt):
        jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks[:, :10]),
                                   "patches": jnp.asarray(pt)},
                              cache_len=P + 16)
        jsteps = [jl[:, 0]]
        for t in range(10, 13):
            jl, jc = japi.decode_step(jp, jc, jnp.asarray(toks[:, t]))
            jsteps.append(jl)
    assert int(jc.index) == cache.index
    logits_close(dt, steps, jnp.stack(jsteps, 1), lambda: jvlm.forward(
        jp, jnp.asarray(toks), jnp.asarray(pt), configs("f32")[0])[0][
            :, P + 9:])
    for a, b in zip(cache[:2], jc[:2]):
        assert str(a.dtype) == "torch." + str(b.dtype)
        if dt == "bf16":
            bf16_close(a, b)
        else:
            np.testing.assert_allclose(f32(a), f32(b), **TOL[dt])


# ------------------------------ serving -------------------------------------


def test_engine_rewinds_past_the_patches_as_jax():
    """f32 compute: a padded prompt (true length 9 in a seq-16 bucket,
    the rewind at 9 - 1 + n_patches) with batch-padding rows gives JAX's
    ``greedy_generate`` tokens of the unpadded prompt; a full bucket
    gives those of the full one."""
    jcfg, tcfg, jp, tp = model("f32", seed=10)
    P = tcfg.n_patches
    toks = tokens((2, 9), seed=11)
    pt = patches(2, P, 12)
    padded = np.zeros((4, 16), np.int32)
    padded[:2, :9] = toks
    padded[2:, :9] = toks[0]
    ppad = np.concatenate([pt, pt[[0, 0]]])
    eng = DecodeEngine(tcfg, tp, buckets=((4, 16),), max_new_tokens=5)
    assert eng.pad_seq and eng.cache_len_for(16) == 16 + P + 5
    got = eng.generate_batch(torch.from_numpy(padded), 5, true_len=9,
                             extras={"patches": torch.from_numpy(ppad)})
    ref = np.asarray(jgreedy_generate(jcfg, jp, {
        "tokens": jnp.asarray(toks), "patches": jnp.asarray(pt)}, 5))
    np.testing.assert_array_equal(got.numpy()[:2], ref)
    np.testing.assert_array_equal(got.numpy()[2:], ref[[0, 0]])
    full = tokens((4, 16), seed=13)
    got = eng.generate_batch(torch.from_numpy(full), 5,
                             extras={"patches": torch.from_numpy(ppad)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgreedy_generate(
        jcfg, jp, {"tokens": jnp.asarray(full),
                   "patches": jnp.asarray(ppad)}, 5)))
    assert eng.compile_counts == {"prefill": 1, "decode": 1}


def test_train_batch_matches_jax_cli_shapes_and_trains(capsys):
    """The CLI's vlm batch: tokens (K, b, S + 1) int32 and patches (K, b,
    n_patches, 1024) f32, as JAX's ``make_batch_iter``; three packed
    D-Adam steps through the CLI; the serving CLI's patch features."""
    cfg = get_reduced(ARCH).model
    batch = next(train_cli.make_batch_iter(cfg, 2, 3, 8, 0.5,
                                           torch.device("cpu")))
    jbatch = next(jmake_batch_iter(jget_reduced(ARCH).model, 2, 3, 8, 0.5))
    assert sorted(batch) == sorted(jbatch) == ["patches", "tokens"]
    for k in batch:
        assert tuple(batch[k].shape) == tuple(jbatch[k].shape)
        assert str(batch[k].dtype) == "torch." + str(jbatch[k].dtype)
    assert tuple(batch["patches"].shape) == (2, 3, cfg.n_patches, 1024)
    run = train_cli.main(["--device", "cpu", "--arch", ARCH, "--workers",
                          "2", "--steps", "3", "--period", "2", "--seq", "8",
                          "--batch", "1", "--backend", "packed",
                          "--log-every", "1"])
    assert f"[train] {ARCH} (reduced)" in capsys.readouterr().out
    assert run.log.step == [1, 2, 3] and all(np.isfinite(run.log.loss))
    rec = serve_cli.main(["--device", "cpu", "--arch", ARCH,
                          "--prompt-len", "20", "--new-tokens", "4"])
    assert rec["bucket"] == [8, 32] and rec["compile_counts"] == {
        "prefill": 1, "decode": 1}
