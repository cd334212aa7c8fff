"""The port's MoE family and the model zoo's configs against the JAX
package, on the CPU.

* the six configs the zoo gained (yi-6b, qwen1.5-32b, starcoder2-15b,
  phi3.5-moe, llama4-maverick, zamba2-7b): ``FULL`` and ``reduced()``
  field for field, and ``param_count``;
* ``moe_forward`` (out and aux loss) at the reduced phi3.5-moe widths,
  with and without capacity drops, and its routing's group size and
  capacity;
* the MoE ``transformer.forward``, ``loss_fn`` and its gradient, and the
  decode contract (prefill plus decode steps equal one forward) at the
  reduced phi3.5-moe and llama4-maverick configs;
* the training CLI on the reduced phi3.5-moe through packed D-Adam, its
  checkpoint restored by the JAX package (the packed layout of the MoE
  tree is JAX's).

JAX's params cross as numpy. Tolerances are ``tests/test_kernels.py``'s:
f32 rtol = atol = 2e-5, bf16 2e-2; gradients within 2e-5 of each leaf's
largest entry. At bf16 the JAX side runs op by op (``jax.disable_jit``),
as in ``tests/test_torch_rwkv.py``. ``torch.topk`` and ``lax.top_k``
would part only on tied router probabilities, which random f32 inputs do
not have; every test below checks that the two sides routed alike by
comparing the outputs.
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
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.train import DecentralizedTrainer as JaxTrainer
from repro_torch._tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.configs import get_arch, get_reduced, list_archs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import train as train_cli
from repro_torch.models import moe, transformer
from repro_torch.models.registry import build_model
from repro_torch.serve import cast_params

torch.set_num_threads(2)

TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
ARCH = "phi3.5-moe-42b-a6.6b"
NEW_ARCHS = ("yi-6b", "qwen1.5-32b", "starcoder2-15b",
             "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
             "zamba2-7b")
# the analytic counts of the published configs (JAX's param_count)
PARAM_COUNTS = {"yi-6b": 6_060_769_280, "qwen1.5-32b": 35_195_453_440,
                "starcoder2-15b": 15_955_132_416,
                "phi3.5-moe-42b-a6.6b": 41_872_261_120,
                "llama4-maverick-400b-a17b": 778_214_440_960,
                "zamba2-7b": 6_750_229_728}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def jax_side(dt):
    """The JAX side's context: op by op at bf16, compiled at f32."""
    return jax.disable_jit() if dt == "bf16" else contextlib.nullcontext()


def configs(dt, arch=ARCH):
    jcfg, tcfg = jget_reduced(arch).model, get_reduced(arch).model
    jd, td = DTYPES[dt]
    return (dataclasses.replace(jcfg, compute_dtype=jd),
            dataclasses.replace(tcfg, compute_dtype=td))


def tokens(shape, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def hidden(shape, dt, seed=2):
    x = (np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)
    jd, td = DTYPES[dt]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def lm(request):
    """JAX params of the reduced phi3.5-moe and the port's copy."""
    jcfg, tcfg = configs(request.param)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return request.param, jcfg, tcfg, jp, tp


# -------------------------------- configs -----------------------------------


def as_fields(cfg):
    """A config's fields, dtypes by name (jnp and torch dtypes alike)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = as_fields(v)
        elif v is not None and not isinstance(v, (int, float, str, bool)):
            v = str(v).replace("torch.", "").split(".")[-1].strip("'>")
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_equal_jax_field_for_field(arch):
    assert as_fields(get_arch(arch)) == as_fields(jget_arch(arch))
    assert as_fields(get_reduced(arch)) == as_fields(jget_reduced(arch))
    assert get_arch(arch).model.param_count() == \
        jget_arch(arch).model.param_count() == PARAM_COUNTS[arch]
    assert get_reduced(arch).model.param_count() == \
        jget_reduced(arch).model.param_count()
    assert arch in list_archs()


def test_bf16_moments_are_torch_dtypes():
    assert get_arch(ARCH).parallel.moment_dtype is torch.bfloat16
    assert get_reduced(ARCH).parallel.moment_dtype is None
    assert get_arch("starcoder2-15b").parallel.moment_dtype \
        is torch.bfloat16


def test_init_params_tree_matches_jax():
    """Same keys (JAX's sorted leaf order), shapes, dtypes and scales; the
    router is f32 at any param dtype."""
    jcfg, tcfg = configs("bf16")
    want = jax.eval_shape(lambda: jbuild_model(jcfg).init(
        jax.random.PRNGKey(0)))
    got = build_model(tcfg).init(torch.Generator().manual_seed(0))
    assert sorted(got["layers"]["moe"]) == ["router", "w_down", "w_gate",
                                            "w_up"]
    assert "mlp" not in got["layers"]
    wl, gl = jax.tree_util.tree_leaves(want), tree_leaves(got)
    assert [tuple(x.shape) for x in gl] == [x.shape for x in wl]
    assert [str(x.dtype) for x in gl] == ["torch." + str(x.dtype)
                                          for x in wl]
    E, d, ff = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    m = got["layers"]["moe"]
    assert tuple(m["w_down"].shape) == (2, E, ff, d)
    assert abs(float(m["w_gate"].std()) * d ** 0.5 - 1.0) < 0.1
    assert abs(float(m["w_down"].std()) * ff ** 0.5 - 1.0) < 0.1
    assert abs(float(m["router"].std()) * d ** 0.5 - 1.0) < 0.15
    # the router stays f32 in the serving copy of the params
    half = cast_params(got, torch.bfloat16,
                       keep=build_model(tcfg).f32_leaves)
    assert half["layers"]["moe"]["router"].dtype == torch.float32
    assert half["layers"]["moe"]["w_up"].dtype == torch.bfloat16


# ------------------------------- moe_forward --------------------------------


@pytest.mark.parametrize("n", [1, 7, 64, 96, 1000, 1024, 4096])
@pytest.mark.parametrize("gs,k,E", [(1024, 2, 16), (64, 2, 4), (512, 1, 128)])
def test_group_size_and_capacity_follow_jax(n, gs, k, E):
    """The group size shrinks until it divides N, and C = min(max(4,
    int(g k cf / E)), g), as JAX's static shape arithmetic."""
    g, C = moe.capacity(n, k, E, 1.25, gs)
    jg = min(gs, n)
    while n % jg:
        jg -= 1
    assert (g, C) == (jg, min(max(4, int(jg * k * 1.25 / E)), jg))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape,gs", [((2, 16, 256), 64), ((3, 40, 256), 8),
                                      ((4, 1, 256), 64)])
def test_moe_forward_matches_jax(dt, shape, gs):
    """Out and aux loss of one MoE block (4 experts, top-2, d_ff 320);
    group size 8 gives C = 5 of 16 pairs a group, so pairs are dropped,
    and 4 single tokens make one group of 4 (C = 4, none dropped)."""
    jd, td = DTYPES[dt]
    jp = jmoe.init_moe(jax.random.PRNGKey(3), 256, 320, 4, jd)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tp["router"].dtype == torch.float32
    jx, tx = hidden(shape, dt)
    kw = dict(top_k=2, capacity_factor=1.25, group_size=gs)
    with jax_side(dt):
        jout, jaux = jmoe.moe_forward(jp, jx, **kw)
    tout, taux = moe.moe_forward(tp, tx, **kw)
    assert tout.dtype == tx.dtype and taux.dtype == torch.float32
    np.testing.assert_allclose(f32(tout), f32(jout), **TOL[dt])
    np.testing.assert_allclose(float(taux), float(jaux), **TOL["f32"])
    share = moe.dropped_share(tp, tx, **kw)
    assert (share > 0) == (gs == 8)
    if gs == 8:   # JAX's keep mask, from its own routing
        xf = jnp.asarray(f32(tx)).reshape(-1, 8, 256)
        probs = jax.nn.softmax(xf @ jp["router"], axis=-1)
        idx = jax.lax.top_k(probs, 2)[1]
        flat = jax.nn.one_hot(idx, 4, dtype=jnp.int32).reshape(-1, 16, 4)
        pos = jnp.sum((jnp.cumsum(flat, 1) - flat) * flat, -1)
        assert share == pytest.approx(float(jnp.mean(pos >= 5)))


def test_moe_gradient_matches_jax():
    """The gradient of a loss of the block's output and aux loss w.r.t.
    the router, the experts and the input, f32, capacity drops on."""
    jp = jmoe.init_moe(jax.random.PRNGKey(4), 64, 96, 4, jnp.float32)
    x = np.random.default_rng(5).standard_normal((2, 24, 64)).astype(
        np.float32)
    kw = dict(top_k=2, capacity_factor=1.25, group_size=8)

    def jloss(p, x):
        out, aux = jmoe.moe_forward(p, x, **kw)
        return jnp.sum(out * out) + 3.0 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves, td = tree_flatten(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    xs = [t.requires_grad_(True) for t in leaves]
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_forward(tree_unflatten(td, xs), tx, **kw)
    grads = torch.autograd.grad(torch.sum(out * out) + 3.0 * aux,
                                xs + [tx])
    for a, b in zip(grads, jax.tree_util.tree_leaves(jg) + [jgx]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))


# ------------------------------- the model ----------------------------------


def test_forward_and_loss_match_jax(lm):
    dt, jcfg, tcfg, jp, tp = lm
    toks = tokens((2, 17))
    with jax_side(dt):
        jl, jaux = jtransformer.forward(jp, jnp.asarray(toks[:, :-1]), jcfg)
        jloss = jbuild_model(jcfg).loss(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, taux = transformer.forward(tp, torch.from_numpy(toks[:, :-1]),
                                       tcfg)
        tloss = build_model(tcfg).loss(tp, {"tokens": torch.from_numpy(
            toks)})
    assert tl.dtype == DTYPES[dt][1] and taux.dtype == torch.float32
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL[dt])
    np.testing.assert_allclose(float(taux), float(jaux), **TOL[dt])
    # loss_fn adds router_aux_weight * aux to the cross entropy
    assert float(taux) > 1.0
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL[dt])


@pytest.mark.parametrize("arch", [ARCH, "llama4-maverick-400b-a17b"])
def test_loss_gradient_matches_jax(arch):
    """f32 compute: the loss and every leaf's gradient (the router's
    through the gates and the aux loss) within 2e-5 of the leaf's
    largest entry."""
    jcfg, tcfg = configs("f32", arch)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(1))
    toks = tokens((2, 13), seed=4)
    jl, jg = jax.value_and_grad(jbuild_model(jcfg).loss)(
        jp, {"tokens": jnp.asarray(toks)})
    leaves, td = tree_flatten(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    xs = [x.requires_grad_(True) for x in leaves]
    loss = build_model(tcfg).loss(tree_unflatten(td, xs),
                                  {"tokens": torch.from_numpy(toks)},
                                  remat="dots")
    grads = torch.autograd.grad(loss, xs)
    np.testing.assert_allclose(float(loss), float(jl), **TOL["f32"])
    for a, b in zip(grads, jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))
    assert float(grads[0].abs().max()) > 0   # the embedding's, in order


def test_prefill_and_decode_equal_forward_and_jax(lm):
    """Each step of a prefill of 10 tokens then 3 decode steps equals
    JAX's (both prefills on sdpa's "auto" path); and with no pair dropped
    (capacity factor E / k: C = g) they give the logits of one forward
    over all 13 (JAX's decode contract, ``tests/test_models.py``). At the
    config's own factor a token's output depends on the group it is routed
    with, in both packages: the forward's 26-token group drops pairs that
    the 2-token decode groups keep."""
    dt, jcfg, tcfg, jp, tp = lm
    toks = tokens((2, 13), seed=6)
    tt = torch.from_numpy(toks)

    def port(cfg):
        api = build_model(cfg)
        with torch.no_grad():
            logits, cache = api.prefill(tp, {"tokens": tt[:, :10]},
                                        cache_len=16)
            steps = [logits[:, 0]]
            for t in range(10, 13):
                logits, cache = api.decode_step(tp, cache, tt[:, t])
                steps.append(logits)
        assert cache.index == 13
        return torch.stack(steps, 1), cache

    steps, cache = port(tcfg)
    japi = jbuild_model(jcfg)
    with jax_side(dt):
        jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks[:, :10])},
                              cache_len=16)
        jsteps = [jl[:, 0]]
        for t in range(10, 13):
            jl, jc = japi.decode_step(jp, jc, jnp.asarray(toks[:, t]))
            jsteps.append(jl)
    np.testing.assert_allclose(f32(steps), f32(jnp.stack(jsteps, 1)),
                               **TOL[dt])
    np.testing.assert_allclose(f32(cache.k), f32(jc.k), **TOL[dt])
    roomy = dataclasses.replace(
        tcfg, capacity_factor=tcfg.n_experts / tcfg.experts_per_token)
    steps, _ = port(roomy)
    with torch.no_grad():
        full, _ = transformer.forward(tp, tt, roomy)
    np.testing.assert_allclose(f32(steps), f32(full[:, 9:]), **TOL[dt])


# ----------------------------- the training CLI -----------------------------


def test_train_cli_trains_the_moe_and_its_checkpoint_loads_in_jax(
        tmp_path, capsys):
    path = str(tmp_path / "moe.npz")
    run = train_cli.main(["--device", "cpu", "--arch", ARCH, "--workers",
                          "2", "--steps", "3", "--period", "2", "--seq", "8",
                          "--batch", "1", "--backend", "packed",
                          "--log-every", "1", "--ckpt", path])
    out = capsys.readouterr().out
    assert f"[train] {ARCH} (reduced)" in out
    assert run.log.step == [1, 2, 3] and run.state.count == 3
    assert all(np.isfinite(run.log.loss))
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


@pytest.mark.parametrize("arch", [ARCH, "zamba2-7b"])
def test_train_batches_are_tokens_only_and_vlm_audio_still_raise(arch):
    """The MoE and hybrid families train on tokens-only batches, as the
    JAX CLI's ``make_batch_iter`` gives them; the vlm and audio families'
    batches add their patch features and frame embeddings
    (``tests/test_torch_vlm.py`` and ``tests/test_torch_whisper.py`` hold
    them against JAX's)."""
    cfg = get_reduced(arch).model
    batch = next(train_cli.make_batch_iter(cfg, 2, 3, 8, 0.5,
                                           torch.device("cpu")))
    assert list(batch) == ["tokens"]
    assert tuple(batch["tokens"].shape) == (2, 3, 9)
    for family, extra in (("vlm", "patches"), ("audio", "audio_embeds")):
        batch = next(train_cli.make_batch_iter(
            dataclasses.replace(cfg, family=family), 2, 3, 8, 0.5,
            torch.device("cpu")))
        assert sorted(batch) == sorted(["tokens", extra])
        assert tuple(batch[extra].shape[:2]) == (2, 3)
