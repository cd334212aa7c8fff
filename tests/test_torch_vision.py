"""The paper's CIFAR experiment on the port against the JAX package:
ResNet-20, the image batches, ``accuracy``, the centralized Adam oracle, the
step-decay schedule, and the CTR models' dropout.

Inputs are made from seeds with numpy, or drawn by the JAX package and
handed across as numpy (random streams do not cross packages). Tolerances:
f32 rtol = atol = 2e-5 for logits and losses; grads within 2e-5 of each
leaf's largest (a conv's weight grad sums B x H x W products in another
order than XLA's); params within the optimizer-state tolerance (rtol 2e-5,
atol 2e-6); image batches, labels, packed buffers and chunk counts equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_optimizer as jax_make_optimizer
from repro.data import synthetic as jsynthetic
from repro.kernels import pack as jpacking
from repro.models import deepfm as jdeepfm
from repro.optim import adam as jadam
from repro.optim import schedules as jschedules
from repro.train import DecentralizedTrainer as JaxTrainer
from repro.train.metrics import accuracy as jax_accuracy
from repro_torch._tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.convert import params_from_numpy
from repro_torch.core.api import make_optimizer
from repro_torch.data import synthetic
from repro_torch.kernels import pack as packing
from repro_torch.models import deepfm
from repro_torch.optim import adam, schedules
from repro_torch.train.loop import DecentralizedTrainer
from repro_torch.train.metrics import accuracy

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
FTOL = dict(rtol=2e-5, atol=2e-6)
K, WIDTH, B = 2, 8, 3


def stacked_resnet(width=WIDTH, workers=K, seed=0):
    """K workers' JAX ResNet-20 params as numpy, each from its own key."""
    per = [jdeepfm.init_resnet20(jax.random.PRNGKey(seed + k), width=width)
           for k in range(workers)]
    return jax.tree_util.tree_map(lambda *xs: np.stack(
        [np.asarray(x) for x in xs]), *per)


def images(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def leafwise_close(got, want, tol=TOL):
    """Each leaf within ``tol`` of its largest element."""
    la, lb = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        atol = tol["atol"] * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=atol)


# --------------------------------- ResNet-20 --------------------------------


def test_resnet20_init_has_jax_tree_and_counts():
    got = deepfm.init_resnet20(torch.Generator().manual_seed(0), width=16)
    want = jdeepfm.init_resnet20(jax.random.PRNGKey(0), width=16)
    la, td = tree_flatten(got)
    lb = jax.tree_util.tree_leaves(want)
    assert [tuple(x.shape) for x in la] == [x.shape for x in lb]
    # He et al.'s CIFAR width 16
    assert sum(x.numel() for x in la) == 272_250
    assert "proj" in got["stages"][1][0] and "proj" not in got["stages"][0][0]


@pytest.mark.parametrize("pad", [(32, 3, 2), (32, 3, 1), (32, 1, 2),
                                 (16, 3, 2), (8, 3, 2), (31, 3, 2)])
def test_same_padding_is_xla_s(pad):
    """A 3x3 stride-2 conv on 32 pads (0, 1): XLA's "SAME" puts the odd
    row on the high side, where F.conv2d(padding=1) puts (1, 1)."""
    size, k, stride = pad
    x = images((1, size, size, 2))
    w = images((k, k, 2, 3), seed=2)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = deepfm._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w)[None], stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


def test_resnet20_logits_loss_and_grads_match_jax():
    """Width 8, 32 x 32 images: the batch goes through the stem, both
    stride-2 stages with their 1x1 projections, and every group norm."""
    jp = stacked_resnet()
    imgs = images((K, B, 32, 32, 3))
    labels = np.array([[1, 7, 3], [0, 9, 3]], np.int32)
    jbatch = {"images": jnp.asarray(imgs), "label": jnp.asarray(labels)}
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    want_logits = jax.vmap(jdeepfm.resnet20_logits)(jparams, jbatch["images"])
    jl, jg = jax.vmap(jax.value_and_grad(jdeepfm.resnet20_loss))(jparams,
                                                                jbatch)
    leaves, td = tree_flatten(params_from_numpy(jp, "cpu"))
    xs = [x.requires_grad_(True) for x in leaves]
    params = tree_unflatten(td, xs)
    batch = {"images": torch.from_numpy(imgs),
             "label": torch.from_numpy(labels)}
    logits = deepfm.resnet20_logits(params, batch["images"])
    assert logits.shape == (K, B, 10)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), **TOL)
    losses = deepfm.resnet20_loss(params, batch)
    assert losses.shape == (K,)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jl),
                               **TOL)
    grads = torch.autograd.grad(losses.sum(), xs)
    leafwise_close(tree_unflatten(td, list(grads)), jg)


def test_resnet20_packed_buffer_equals_jax_element_for_element():
    """The leaves keep JAX's HWIO layout, so the resident packed buffer
    (and with it every checkpoint) is JAX's, element for element."""
    jp = stacked_resnet(width=16)
    jstate = jax_make_optimizer("d-adam", K, backend="pallas").init(
        jax.tree_util.tree_map(jnp.asarray, jp))
    tstate = make_optimizer("d-adam", K, backend="packed",
                            device="cpu").init(params_from_numpy(jp, "cpu"))
    assert tstate.spec.n == 272_250
    np.testing.assert_array_equal(tstate.buf.numpy(), np.asarray(jstate.buf))


def test_resnet20_dadam_trajectory_tracks_jax():
    """The slice as a whole: three packed D-Adam steps at period 2 (two
    ``fused_adam`` steps around a ``gossip_adam_mix`` step) with the
    paper's CIFAR weight decay, 1e-4, on image batches drawn by JAX, from
    one init.

    The losses must agree at every step. The params cannot be held to the
    optimizer-state tolerance past step 1: both packages' f32 gradients
    lie up to ~1e-3 (relative) from an f64 gradient in elements of a
    thousandth of their leaf's largest (group norm's backward cancels),
    the port's no farther than JAX's, and Adam's normalised step turns
    such a difference in a small or sign-changing gradient into a
    difference of a sizeable share of eta (here 0.24 eta at step 2, 1.6
    eta at step 3). At step 1 m is the gradient plus the decay, within 2e-5
    of each leaf's largest, and p parts only where Adam's first step is
    not yet saturated (|g| near tau / sqrt(1 - beta2) = 3.2e-5): at most
    1e-4 of the elements outside the tolerance, each within 0.01 eta."""
    steps, eta = 3, 1e-3
    kw = dict(eta=eta, period=2, weight_decay=1e-4, topology="ring")
    p0 = jdeepfm.init_resnet20(jax.random.PRNGKey(0), width=WIDTH)
    batches = [jax.tree_util.tree_map(np.asarray, jsynthetic.
                                      image_batch_stacked(
                                          jax.random.PRNGKey(10 + t), K, 4))
               for t in range(steps)]
    jopt = jax_make_optimizer("d-adam", K, backend="pallas", **kw)
    jtr = JaxTrainer(jdeepfm.resnet20_loss, jopt)
    topt = make_optimizer("d-adam", K, backend="packed", device="cpu", **kw)
    ttr = DecentralizedTrainer(deepfm.resnet20_loss, topt)
    js = jtr.init(p0)
    ts = ttr.init(params_from_numpy(jax.tree_util.tree_map(np.asarray, p0),
                                    "cpu"))
    jlog = tlog = None
    for t in range(steps):
        js, jlog = jtr.fit(js, iter([jax.tree_util.tree_map(
            jnp.asarray, batches[t])]), 1, log=jlog)
        ts, tlog = ttr.fit(ts, iter([params_from_numpy(batches[t], "cpu")]),
                           1, log=tlog)
        if t == 0:
            leafwise_close(packing.unpack(ts.m, ts.spec),
                           jpacking.unpack(js.m, js.spec))
            got, want = ts.buf.numpy(), np.asarray(js.buf)
            diff = np.abs(got - want)
            outside = diff > FTOL["atol"] + FTOL["rtol"] * np.abs(want)
            assert outside.mean() <= 1e-4 and diff.max() <= 0.01 * eta
    np.testing.assert_allclose(tlog.loss, jlog.loss, **TOL)
    # one round, at step 2 (JAX's trainer counts the period from each
    # one-step fit call's start and finds none: ROADMAP section 3)
    assert tlog.comm_rounds_total == 1 and ts.count == int(js.count) == steps


# ------------------------------- image batches ------------------------------


def jax_image_draws(key, batch, worker, n_workers, skew, n_classes=10):
    """JAX's ``image_batch`` draws for one worker, as tensors."""
    k1, k2, _ = jax.random.split(jax.random.fold_in(key, worker), 3)
    if n_workers > 1 and skew > 0:
        logits = jnp.asarray(synthetic.class_logits(n_classes, worker,
                                                    skew).numpy())
        label = jax.random.categorical(k1, logits, shape=(batch,))
    else:
        label = jax.random.randint(k1, (batch,), 0, n_classes)
    noise = jax.random.normal(k2, (batch, 32, 32, 3))
    return (torch.from_numpy(np.array(label)),
            torch.from_numpy(np.array(noise)))


def jax_patterns():
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(7), (10, 32, 32, 3)) * 0.5))


@pytest.mark.parametrize("workers,skew", [(1, 0.5), (8, 0.0), (8, 0.5),
                                          (8, 1.0)])
def test_image_batch_equals_jax_on_its_draws(workers, skew):
    key = jax.random.PRNGKey(3)
    for k in (0, workers - 1):
        label, noise = jax_image_draws(key, 5, k, workers, skew)
        got = synthetic.image_batch(None, 5, 10, k, workers, skew,
                                    label=label, noise=noise,
                                    patterns=jax_patterns())
        want = jsynthetic.image_batch(key, 5, 10, k, workers, skew)
        assert got["label"].dtype == torch.int32
        np.testing.assert_array_equal(got["label"].numpy(),
                                      np.asarray(want["label"]))
        np.testing.assert_array_equal(got["images"].numpy(),
                                      np.asarray(want["images"]))
    got = synthetic.image_batch_stacked(
        None, workers, 4, skew, patterns=jax_patterns(),
        draws=lambda k: jax_image_draws(key, 4, k, workers, skew))
    want = jsynthetic.image_batch_stacked(key, workers, 4, skew)
    assert got["images"].shape == (workers, 4, 32, 32, 3)
    for name in ("images", "label"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


@pytest.mark.parametrize("worker", [0, 3, 12])
def test_class_logits_equal_jax_formula(worker):
    n, skew = 10, 0.7
    want = -skew * 2.0 * jnp.square(
        (jnp.arange(n) - (worker % n) + n / 2) % n - n / 2)
    got = synthetic.class_logits(n, worker, skew)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_image_batch_from_a_generator_keeps_the_class_skew():
    gen = torch.Generator().manual_seed(0)
    b = synthetic.image_batch_stacked(gen, 8, 256, skew=1.0)
    assert b["images"].shape == (8, 256, 32, 32, 3)
    assert b["images"].dtype == torch.float32
    assert b["label"].dtype == torch.int32
    for k in range(8):
        # worker k over-samples class k, as test_infra's JAX batch does
        assert int(torch.bincount(b["label"][k].long(),
                                  minlength=10).argmax()) == k
    # the class patterns: a seeded draw, the same in every call
    one = synthetic.image_batch(gen, 4)
    again = synthetic.image_batch(None, 4, label=one["label"],
                                  noise=torch.zeros(4, 32, 32, 3))
    pats = synthetic.class_patterns(torch.Generator().manual_seed(
        synthetic.PATTERN_SEED))
    assert torch.equal(again["images"], pats[one["label"].long()])
    with pytest.raises(ValueError, match="draws"):
        synthetic.image_batch(None, 4, label=one["label"],
                              noise=torch.zeros(3, 32, 32, 3))


def test_accuracy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((300, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 300).astype(np.int32)
    labels[:100] = logits[:100].argmax(-1)
    got = accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got == jax_accuracy(jnp.asarray(logits), jnp.asarray(labels))


# ---------------------------- Adam oracle, schedule -------------------------


def quad_grads(params, c):
    return {"x": 2.0 * (params["x"] - c), "y": params["y"] * 0.5}


def test_adam_oracle_matches_jax():
    rng = np.random.default_rng(0)
    c = rng.standard_normal((1, 16)).astype(np.float32)
    p0 = {"x": np.zeros((1, 16), np.float32),
          "y": rng.standard_normal((3, 2)).astype(np.float32)}
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = params_from_numpy(p0, "cpu")
    js, ts = jadam.init(jp), adam.init(tp)
    tc = torch.from_numpy(c)
    for _ in range(10):
        jp, js = jadam.step(jp, quad_grads(jp, jnp.asarray(c)), js,
                            eta=0.01, tau=1e-6)
        tp, ts = adam.step(tp, quad_grads(tp, tc), ts, eta=0.01, tau=1e-6)
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FTOL)


@pytest.mark.parametrize("backend", ["packed", "reference"])
def test_k1_dadam_equals_the_adam_oracle(backend):
    """K=1 D-Adam is the oracle Adam (``tests/test_backend_parity.py``'s
    identity): one worker, nothing to gossip."""
    d = 16
    c = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, d)).astype(np.float32))
    opt = make_optimizer("d-adam", K=1, eta=0.01, tau=1e-6, backend=backend,
                         device="cpu")
    state = opt.init({"x": torch.zeros((1, d))})
    ref_p = {"x": torch.zeros((1, d))}
    ref_s = adam.init(ref_p)
    for _ in range(15):
        state = opt.step(state, {"x": 2.0 * (opt.params_of(state)["x"] - c)})
        ref_p, ref_s = adam.step(ref_p, {"x": 2.0 * (ref_p["x"] - c)},
                                 ref_s, eta=0.01, tau=1e-6)
    np.testing.assert_allclose(opt.params_of(state)["x"].numpy(),
                               ref_p["x"].numpy(), rtol=1e-5, atol=1e-6)


def test_step_decay_and_constant_match_jax():
    got, want = (schedules.step_decay(1e-3, [3, 7, 7]),
                 jschedules.step_decay(1e-3, [3, 7, 7]))
    assert [got(s) for s in range(10)] == [want(s) for s in range(10)]
    assert got(7) == pytest.approx(1e-6)
    assert schedules.constant(0.5)(99) == jschedules.constant(0.5)(99)


# ---------------------------------- dropout ---------------------------------


def jax_masks(key, batch, hidden, rate):
    """The keep masks JAX's ``*_logits`` draw from ``key``: one split per
    hidden layer, in order."""
    out = []
    for h in hidden:
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.bernoulli(sub, 1 - rate,
                                                   (batch, h))))
    return out


@pytest.mark.parametrize("model", ["deepfm", "widedeep"])
def test_dropout_with_jax_masks_matches_jax(model):
    n_fields, fpf, embed, hidden, batch = 4, 16, 4, (16, 8), 6
    jlogits = getattr(jdeepfm, f"{model}_logits")
    jloss = getattr(jdeepfm, f"{model}_loss")
    init = getattr(jdeepfm, f"init_{model}")
    per = [init(jax.random.PRNGKey(k), n_fields * fpf, n_fields, embed,
                hidden) for k in range(K)]
    jp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per)
    rng = np.random.default_rng(0)
    ids = (np.arange(n_fields) * fpf + rng.integers(
        0, fpf, (K, batch, n_fields))).astype(np.int32)
    label = rng.integers(0, 2, (K, batch)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(5), K)
    want = jax.vmap(jlogits)(jp, jnp.asarray(ids), keys)
    want_loss = jax.vmap(jloss)(jp, {"feat_ids": jnp.asarray(ids),
                                     "label": jnp.asarray(label)}, keys)
    masks = [torch.from_numpy(np.stack(m)) for m in zip(
        *[jax_masks(keys[k], batch, hidden, 0.5) for k in range(K)])]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    got = getattr(deepfm, f"{model}_logits")(tp, torch.from_numpy(ids),
                                             masks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got_loss = getattr(deepfm, f"{model}_loss")(
        tp, {"feat_ids": torch.from_numpy(ids),
             "label": torch.from_numpy(label)}, masks)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss),
                               **TOL)
    # off by default: no masks, JAX without a key
    np.testing.assert_allclose(
        getattr(deepfm, f"{model}_logits")(tp, torch.from_numpy(ids)).numpy(),
        np.asarray(jax.vmap(jlogits)(jp, jnp.asarray(ids))), **TOL)


def test_dropout_takes_one_mask_per_hidden_layer():
    params = {"mlp": [{"w": torch.ones(1, 2, 2), "b": torch.zeros(1, 2)},
                      {"w": torch.ones(1, 2, 1), "b": torch.zeros(1, 1)}]}
    keep = torch.tensor([[[True, False], [False, True]]])
    out = deepfm._deep(params, torch.ones(1, 2, 2), [keep])
    # each hidden unit is 2 before dropout; a kept one is scaled by 2
    np.testing.assert_array_equal(out.numpy(), [[4.0, 4.0]])
    with pytest.raises(ValueError, match="dropout masks"):
        deepfm._deep(params, torch.ones(1, 2, 2), [keep, keep])
