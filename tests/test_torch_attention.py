"""The port's attention path against the JAX package's, on the CPU.

``flash_attention_plain`` (what ``ops.flash_attention`` runs on a CPU
tensor, and what the CUDA kernel is held to on the card) against JAX's
Pallas ``flash_attention`` in interpret mode and against
``ref.flash_attention_ref``, over the sweep of ``tests/test_kernels.py``;
``sdpa`` in each impl, ``decode_attention`` (rotating cache included),
RoPE, the norms and activations against their JAX counterparts. Inputs
come from numpy seeds; bf16 inputs cross as their 16-bit patterns.
Tolerances are ``tests/test_kernels.py``'s: f32 rtol = atol = 2e-5, bf16
2e-2 (one bf16 rounding of values of order 1 is up to 7.8e-3).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon

torch.set_num_threads(2)

TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def rnd(seed, shape, dt="f32", scale=1.0):
    """The same values as a JAX array and a port tensor (CPU)."""
    x = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    j = jnp.asarray(x).astype(JDT[dt])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def qkv(B, S, T, Hq, Hk, D, dt="f32", seed=0):
    return (rnd(seed, (B, S, Hq, D), dt), rnd(seed + 1, (B, T, Hk, D), dt),
            rnd(seed + 2, (B, T, Hk, D), dt))


# ------------------------------ flash kernel --------------------------------


@pytest.mark.parametrize("S,Hq,Hk,D,bq,bkv", [
    (128, 4, 4, 64, 64, 64),     # MHA
    (128, 4, 2, 64, 64, 32),     # GQA 2:1
    (256, 8, 1, 64, 128, 128),   # MQA
    (192, 4, 2, 128, 64, 64),    # 128-lane head dim
    (128, 4, 2, 96, 64, 64),     # phi-3-vision's head dim
    (128, 4, 2, 112, 64, 64),    # zamba2's head dim
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_plain_matches_jax_kernel_and_ref(S, Hq, Hk, D, bq, bkv, dt):
    (jq, q), (jk, k), (jv, v) = qkv(2, S, S, Hq, Hk, D, dt)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    jk_out = jops.flash_attention(jq, jk, jv, causal=True, block_q=bq,
                                  block_kv=bkv)
    jr = jref.flash_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(f32(got), f32(jk_out), **TOL[dt])
    np.testing.assert_allclose(f32(got), f32(jr), **TOL[dt])


@pytest.mark.parametrize("window", [16, 64])
def test_flash_plain_sliding_window(window):
    (jq, q), (jk, k), (jv, v) = qkv(1, 128, 128, 2, 2, 32)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    jk_out = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                  block_q=32, block_kv=32)
    np.testing.assert_allclose(f32(got), f32(jk_out), **TOL["f32"])
    np.testing.assert_allclose(
        f32(got), f32(jref.flash_attention_ref(jq, jk, jv, causal=True,
                                               window=window)),
        **TOL["f32"])


def test_flash_plain_non_causal_and_s_ne_t():
    (jq, q), (jk, k), (jv, v) = qkv(1, 64, 64, 2, 2, 32)
    got = ops.flash_attention(q, k, v, causal=False)
    jk_out = jops.flash_attention(jq, jk, jv, causal=False, block_q=32,
                                  block_kv=32)
    np.testing.assert_allclose(f32(got), f32(jk_out), **TOL["f32"])
    # S != T: row i is causal against key i (positions both from 0)
    (jq, q), (jk, k), (jv, v) = qkv(2, 24, 40, 4, 2, 32, seed=3)
    for causal in (True, False):
        np.testing.assert_allclose(
            f32(ops.flash_attention(q, k, v, causal=causal)),
            f32(jref.flash_attention_ref(jq, jk, jv, causal=causal)),
            **TOL["f32"])


def test_flash_rows_without_a_valid_key_raise():
    """window > 0 and S >= T + window leaves rows with no valid key, whose
    output would depend on the TPU kernel's tiling: both versions
    refuse such shapes; one row short of that is defined."""
    (_, q), (_, k), (_, v) = qkv(1, 40, 24, 2, 2, 32)
    for window in (16, 8):
        with pytest.raises(ValueError, match="no valid key"):
            ops.flash_attention(q, k, v, causal=True, window=window)
        with pytest.raises(ValueError, match="no valid key"):
            tfa.flash_attention(q, k, v, causal=False, window=window)
    out = ops.flash_attention(q[:, :24 + 16 - 1], k, v, causal=True,
                              window=16)
    assert bool(torch.isfinite(out).all())


def test_flash_refuses_autograd_and_cpu_tensors_in_the_kernel():
    (_, q), (_, k), (_, v) = qkv(1, 16, 16, 2, 2, 32)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.sdpa(q, k, v, causal=True, impl="kernel")
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
    assert not out.requires_grad
    # the CUDA wrapper never runs a CPU tensor (no silent fallback)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q.detach(), k, v)
    with pytest.raises(ValueError, match="Hq"):
        ops.flash_attention(torch.zeros(1, 4, 3, 32), k, v)


def test_cpu_flash_launches_nothing():
    (_, q), (_, k), (_, v) = qkv(1, 16, 16, 2, 2, 32)
    ops.reset_launches()
    ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 0


# ---------------------------------- sdpa ------------------------------------


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel", "auto"])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_sdpa_matches_jax(impl, window, dt):
    (jq, q), (jk, k), (jv, v) = qkv(2, 16, 16, 4, 2, 32, dt, seed=5)
    want = jattn.sdpa(jq, jk, jv, causal=True, window=window,
                      impl={"kernel": "pallas"}.get(impl, impl))
    got = tattn.sdpa(q, k, v, causal=True, window=window, impl=impl)
    assert got.shape == (2, 16, 4 * 32) and got.dtype == q.dtype
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dt])


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (True, 0, 8), (True, 5, 4), (False, 0, 0)])
def test_chunked_tiles_match_jax(causal, window, q_offset):
    """Small chunks, so several query chunks and pruned KV chunks run."""
    (jq, q), (jk, k), (jv, v) = qkv(1, 12, 20, 4, 2, 32, seed=9)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk_q=4,
              chunk_kv=8)
    np.testing.assert_allclose(
        f32(tattn.flash_attention_xla(q, k, v, **kw)),
        f32(jattn.flash_attention_xla(jq, jk, jv, **kw)), **TOL["f32"])


def test_sdpa_rejects_unknown_impl_and_kernel_offset():
    (_, q), (_, k), (_, v) = qkv(1, 8, 8, 2, 2, 32)
    with pytest.raises(ValueError, match="impl"):
        tattn.sdpa(q, k, v, causal=True, impl="pallas")
    with pytest.raises(ValueError, match="q_offset"):
        tattn.sdpa(q, k, v, causal=True, q_offset=3, impl="kernel")


# ----------------------------- projections -----------------------------------


def attn_params(d=64, hq=4, hk=2, hd=16, bias=False):
    jp = jattn.init_attention(jax.random.PRNGKey(3), d, hq, hk, hd,
                              jnp.float32, qkv_bias=bias)
    if bias:   # non-zero biases, so their add shows
        jp = {n: (x + 0.1 if n.startswith("b") else x)
              for n, x in jp.items()}
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_attention_forward_matches_jax(dt, impl):
    jp, tp = attn_params(bias=True)
    jx, x = rnd(11, (2, 10, 64), dt)
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=10000.0)
    want = jattn.attention_forward(jp, jx, **kw)
    with torch.no_grad():
        got = tattn.attention_forward(tp, x, impl=impl, **kw)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dt])


@pytest.mark.parametrize("rotating,window,index", [
    (False, 0, 5), (False, 4, 9), (True, 8, 11), (True, 8, 3)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_matches_jax(rotating, window, index, dt):
    """One decode step against a 12-slot (or, rotating, 8-slot) cache: the
    output and the cache with the new K/V written at index (% S_max)."""
    jp, tp = attn_params()
    s_max = 8 if rotating else 12
    jx, x = rnd(12, (2, 1, 64), dt)
    jlk, lk = rnd(13, (2, s_max, 2, 16), dt)
    jlv, lv = rnd(14, (2, s_max, 2, 16), dt)
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=10000.0,
              window=window, rotating=rotating)
    jout, jk2, jv2 = jattn.decode_attention(jp, jx, jlk, jlv,
                                            jnp.asarray(index, jnp.int32),
                                            **kw)
    out, k2, v2 = tattn.decode_attention(tp, x, lk, lv, index, **kw)
    assert k2 is lk and v2 is lv          # written in place
    np.testing.assert_allclose(f32(out), f32(jout), **TOL[dt])
    np.testing.assert_allclose(f32(k2), f32(jk2), **TOL[dt])
    np.testing.assert_allclose(f32(v2), f32(jv2), **TOL[dt])


def test_decode_attention_past_the_cache_raises():
    _, tp = attn_params()
    lk = torch.zeros(1, 4, 2, 16)
    with pytest.raises(IndexError, match="past the cache"):
        tattn.decode_attention(tp, torch.zeros(1, 1, 64), lk, lk.clone(), 4,
                               n_heads=4, n_kv_heads=2, head_dim=16,
                               rope_theta=1e4)


# --------------------------- norms, RoPE, MLP -------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rope_and_norms_match_jax(dt):
    jx, x = rnd(20, (2, 7, 3, 16), dt, scale=3.0)
    pos = np.arange(14).reshape(2, 7).astype(np.int32) * 37
    np.testing.assert_allclose(
        f32(tcommon.apply_rope(x, torch.from_numpy(pos), 500000.0)),
        f32(jcommon.apply_rope(jx, jnp.asarray(pos), 500000.0)), **TOL[dt])
    jh, h = rnd(21, (2, 5, 48), dt, scale=2.0)
    jw, w = rnd(22, (48,), "f32")
    jb, b = rnd(23, (48,), "f32")
    np.testing.assert_allclose(f32(tcommon.rms_norm(h, w)),
                               f32(jcommon.rms_norm(jh, jw)), **TOL[dt])
    np.testing.assert_allclose(f32(tcommon.layer_norm(h, w, b)),
                               f32(jcommon.layer_norm(jh, jw, jb)), **TOL[dt])
    np.testing.assert_allclose(f32(tcommon.swiglu(h, h * 0.5)),
                               f32(jcommon.swiglu(jh, jh * 0.5)), **TOL[dt])
    np.testing.assert_allclose(f32(tcommon.gelu(h)), f32(jcommon.gelu(jh)),
                               **TOL[dt])
    # the hidden tensor keeps its dtype through the norm
    assert tcommon.rms_norm(h, w).dtype == h.dtype


def test_rope_frequencies_and_cross_entropy_match_jax():
    np.testing.assert_allclose(
        tcommon.rope_frequencies(64, 500000.0).numpy(),
        np.asarray(jcommon.rope_frequencies(64, 500000.0)), rtol=1e-6)
    jl, logits = rnd(30, (2, 6, 50), "f32", scale=3.0)
    labels = np.random.default_rng(31).integers(0, 50, (2, 6))
    mask = (np.arange(6) < 4).astype(np.float32)[None].repeat(2, 0)
    for m in (None, mask):
        want = jcommon.cross_entropy_loss(
            jl, jnp.asarray(labels), None if m is None else jnp.asarray(m))
        got = tcommon.cross_entropy_loss(
            logits, torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        assert math.isclose(float(got), float(want), rel_tol=2e-6)
