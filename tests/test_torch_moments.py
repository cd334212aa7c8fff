"""bf16 Adam moments (``make_optimizer(moment_dtype=torch.bfloat16)``)
against the JAX package's ``moment_dtype=jnp.bfloat16``.

Four steps at period 2 from the same numpy params, grads computed on each
side from its own params by one rule (``tests/test_torch_dadam.py``):

* the kernel path ('packed' against 'pallas', both f32 math with m and v
  rounded to bf16 at the store): m and v within one bf16 ulp, params
  within the f32 tolerance 2e-5;
* the reference path, which computes in bf16 one op at a time, against
  JAX's reference run op by op (not jitted: XLA's fusion would keep the
  bf16 step in excess precision): params within 2e-5, m and v within the
  bf16 tolerance of the repo (2e-2);
* reference against packed inside the port: JAX's own ``BTOL``
  (``tests/test_backend_parity.py:28``), rtol and atol 2e-2.

Then the dtype survives an elastic resize and a checkpoint that crosses
the two packages both ways (bf16 is stored as its bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.core import make_optimizer as jax_make_optimizer
from repro_torch import convert
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint import io as tio
from repro_torch.core import elastic
from repro_torch.core.api import make_optimizer

torch.set_num_threads(2)

K = 4
FTOL = dict(rtol=2e-5, atol=2e-5)
BTOL = dict(rtol=2e-2, atol=2e-2)
BACKENDS = {"reference": "reference", "packed": "pallas"}
KINDS = ("d-adam", "cd-adam")
OPT = dict(eta=1e-2, period=2, weight_decay=0.01, topology="ring")


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, 13, 7)).astype(np.float32),
            "b": rng.standard_normal((K, 5)).astype(np.float32)}


def noise(t, like):
    rng = np.random.default_rng(100 + t)
    return {k: rng.standard_normal(x.shape).astype(np.float32)
            for k, x in like.items()}


def run_jax(kind, backend, steps=4):
    params = tree()
    jopt = jax_make_optimizer(kind, K, backend=BACKENDS[backend],
                              moment_dtype=jnp.bfloat16, **OPT)
    js = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    # the reference runs op by op: under jit XLA fuses the bf16 step and
    # keeps excess precision inside the fusion (one bf16 rounding of the
    # step apart), where the port, like JAX's eager ops, rounds every op
    jstep = jax.jit(jopt.step) if backend == "packed" else jopt.step
    for t in range(steps):
        g = jax.tree_util.tree_map(lambda x, n: 0.5 * x + 0.1 * n,
                                   jopt.params_of(js), noise(t, params))
        js = jstep(js, g)
    return jopt, js


def run_port(kind, backend, steps=4):
    params = tree()
    topt = make_optimizer(kind, K, backend=backend, device="cpu",
                          moment_dtype=torch.bfloat16, **OPT)
    ts = topt.init(convert.params_from_numpy(params, "cpu"))
    for t in range(steps):
        g = tree_map(lambda x, n: 0.5 * x + 0.1 * torch.from_numpy(n),
                     topt.params_of(ts), noise(t, params))
        ts = topt.step(ts, g)
    return topt, ts


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def bf16_bits(x) -> np.ndarray:
    """A bf16 tensor or array's bits as int32."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


def assert_moments_bf16(ts):
    for x in tree_leaves(ts.moments.m) + tree_leaves(ts.moments.v):
        assert x.dtype == torch.bfloat16
    for x in tree_leaves(ts.params):
        assert x.dtype == torch.float32


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_path_bf16_moments_match_jax(kind):
    _, js = run_jax(kind, "packed")
    _, ts = run_port(kind, "packed")
    assert_moments_bf16(ts)
    assert ts.m.dtype == ts.v.dtype == torch.bfloat16
    assert ts.buf.dtype == torch.float32
    for ours, theirs in ((ts.m, js.m), (ts.v, js.v)):
        assert np.asarray(theirs).dtype == jnp.bfloat16
        assert np.abs(bf16_bits(ours) - bf16_bits(theirs)).max() <= 1
    np.testing.assert_allclose(f32(ts.buf), f32(js.buf), **FTOL)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_bf16_moments_match_jax(kind):
    _, js = run_jax(kind, "reference")
    _, ts = run_port(kind, "reference")
    assert_moments_bf16(ts)
    for a, b in zip(tree_leaves(ts.params),
                    jax.tree_util.tree_leaves(js.params)):
        np.testing.assert_allclose(f32(a), f32(b), **FTOL)
    for ours, theirs in ((ts.moments.m, js.moments.m),
                         (ts.moments.v, js.moments.v)):
        for a, b in zip(tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_allclose(f32(a), f32(b), **BTOL)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_and_packed_backends_within_btol(kind):
    _, ref = run_port(kind, "reference")
    _, packed = run_port(kind, "packed")
    for ours, theirs in ((ref.params, packed.params),
                         (ref.moments.m, packed.moments.m),
                         (ref.moments.v, packed.moments.v)):
        for a, b in zip(tree_leaves(ours), tree_leaves(theirs)):
            np.testing.assert_allclose(f32(a), f32(b), **BTOL)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_resize_keeps_bf16_moments(backend):
    topt, ts = run_port("d-adam", backend)
    for k_new, strategy in ((K - 1, "clone"), (K + 2, "mean")):
        new_opt = topt.rebuild(K=k_new)
        out = elastic.resize_state(ts, new_opt, strategy=strategy)
        assert_moments_bf16(out)
        assert tree_leaves(out.moments.m)[0].shape[0] == k_new
        if backend == "packed":
            assert out.m.dtype == torch.bfloat16
        # the surviving workers' moments are carried bit for bit
        for a, b in zip(tree_leaves(out.moments.v),
                        tree_leaves(ts.moments.v)):
            n = min(K, k_new)
            assert torch.equal(a[:n], b[:n])


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_bf16_moment_checkpoint_crosses_both_ways(tmp_path, backend):
    jopt, js = run_jax("d-adam", backend)
    topt, ts = run_port("d-adam", backend)
    # the port's checkpoint restores into a JAX bf16-moment state
    path = str(tmp_path / "port.npz")
    tio.save(path, ts, step=4)
    jlike = jopt.init(jax.tree_util.tree_map(jnp.asarray, tree(9)))
    jrest, step = jio.restore(path, jlike)
    assert step == 4
    for ours, theirs in ((ts.moments.m, jrest.moments.m),
                         (ts.moments.v, jrest.moments.v)):
        for a, b in zip(tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
            assert np.asarray(b).dtype == jnp.bfloat16
            np.testing.assert_array_equal(bf16_bits(a), bf16_bits(b))
    # JAX's checkpoint restores into the port's, the bits unchanged
    path = str(tmp_path / "jax.npz")
    jio.save(path, js, step=4)
    like = topt.init(convert.params_from_numpy(tree(9), "cpu"))
    back, step = tio.restore(path, like)
    assert step == 4 and back.moments.count == 4
    assert_moments_bf16(back)
    for ours, theirs in ((back.moments.m, js.moments.m),
                         (back.moments.v, js.moments.v)):
        for a, b in zip(tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_array_equal(bf16_bits(a), bf16_bits(b))
    for a, b in zip(tree_leaves(back.params),
                    jax.tree_util.tree_leaves(js.params)):
        np.testing.assert_array_equal(f32(a), f32(b))
