"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper in ``repro_torch.kernels.ops`` runs the kernel's
plain PyTorch version; these tests hold that version against the TPU
kernel run in interpret mode (``block_rows=8, interpret=True``), at the
repo's f32 tolerance (``tests/test_kernels.py``: rtol = atol = 2e-5).

``gossip_adam_mix`` is held against the two-pass ``fused_adam`` ->
``gossip_mix`` sequence within that tolerance, not bit for bit: the JAX
kernels themselves differ by about 1 ulp on jax 0.9.0.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.topology import make_topology as jax_topology
from repro.kernels import fused_adam as jfa
from repro.kernels import gossip as jgossip
from repro_torch.core.topology import make_topology, offsets_matrix
from repro_torch.kernels import fused_adam as tfa
from repro_torch.kernels import gossip as tgossip
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAPHS = ["ring", "torus", "exponential"]
K = 8
ROWS = 8


def adam_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    m = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    v = np.abs(rng.standard_normal(shape) * 0.01).astype(np.float32)
    return p, g, m, v


def to_t(*xs, device="cpu"):
    return [torch.from_numpy(x).to(device) for x in xs]


def close(got, want, **tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a.cpu() if isinstance(
            a, torch.Tensor) else a), np.asarray(b), **(tol or TOL))


ADAM_VARIANTS = {"plain": dict(tau=1e-6, weight_decay=0.0),
                 "weight_decay": dict(tau=1e-6, weight_decay=0.1),
                 "tau0": dict(tau=0.0, weight_decay=0.0)}


@pytest.mark.parametrize("n", [1, 128, 1000, 32768 + 17])
@pytest.mark.parametrize("variant", sorted(ADAM_VARIANTS))
def test_fused_adam_plain_matches_jax_kernel(n, variant):
    kw = dict(eta=1e-3, beta1=0.9, beta2=0.999, **ADAM_VARIANTS[variant])
    p, g, m, v = adam_inputs((n,))
    want = jfa.fused_adam(*map(jnp.asarray, (p, g, m, v)), block_rows=8,
                          interpret=True, **kw)
    got = ops.fused_adam(*to_t(p, g, m, v), **kw)
    close(got, want)
    if variant != "tau0":
        close(got, ref.fused_adam_ref(*to_t(p, g, m, v), **kw))


def test_fused_adam_keeps_dtypes_and_shape():
    p, g, m, v = adam_inputs((37, 53))
    pt, gt, mt, vt = to_t(p, g, m, v)
    po, mo, vo = ops.fused_adam(pt.to(torch.bfloat16), gt, mt, vt, eta=1e-2)
    assert po.dtype == torch.bfloat16 and po.shape == (37, 53)
    assert mo.dtype == vo.dtype == torch.float32


def bufs(seed=0):
    return adam_inputs((K, ROWS, 128), seed)


@pytest.mark.parametrize("name", GRAPHS)
def test_gossip_mix_plain_matches_jax_kernel(name):
    topo, jtopo = make_topology(name, K), jax_topology(name, K)
    x = bufs()[0]
    want = jgossip.gossip_mix(jnp.asarray(x), jtopo.offsets,
                              jtopo.offset_weights, jtopo.self_weight,
                              block_rows=ROWS, interpret=True)
    got = ops.gossip_mix(torch.from_numpy(x), topo.offsets,
                         topo.offset_weights, topo.self_weight)
    close([got], [want])


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_gossip_adam_mix_plain_matches_jax_kernel(name, weight_decay):
    topo, jtopo = make_topology(name, K), jax_topology(name, K)
    kw = dict(eta=1e-2, beta1=0.9, beta2=0.999, tau=1e-6,
              weight_decay=weight_decay)
    ins = bufs(1)
    want = jgossip.gossip_adam_mix(
        *map(jnp.asarray, ins), jtopo.offsets, jtopo.offset_weights,
        jtopo.self_weight, block_rows=ROWS, interpret=True, **kw)
    got = ops.gossip_adam_mix(*to_t(*ins), topo.offsets,
                              topo.offset_weights, topo.self_weight, **kw)
    close(got, want)


@pytest.mark.parametrize("name", GRAPHS + ["fully_connected"])
def test_gossip_adam_mix_tracks_two_pass(name):
    """The fused pass equals fused_adam then gossip_mix within f32
    rounding (m and v exactly: they are the same ops)."""
    topo = make_topology(name, K)
    kw = dict(eta=1e-2, tau=1e-6, weight_decay=1e-4)
    p, g, m, v = to_t(*bufs(2))
    p2, m2, v2 = ops.fused_adam(p, g, m, v, **kw)
    want = ops.gossip_mix(p2, topo.offsets, topo.offset_weights,
                          topo.self_weight)
    got_p, got_m, got_v = ops.gossip_adam_mix(
        p, g, m, v, topo.offsets, topo.offset_weights, topo.self_weight,
        **kw)
    close([got_p], [want])
    assert torch.equal(got_m, m2) and torch.equal(got_v, v2)


@pytest.mark.parametrize("name,k", [("ring", 8), ("torus", 8),
                                    ("torus", 12), ("exponential", 8),
                                    ("fully_connected", 5)])
def test_mix_table_reproduces_the_weight_matrix(name, k):
    topo = make_topology(name, k)
    src, w = tgossip.mix_table(tuple(topo.offsets),
                               tuple(topo.offset_weights), topo.self_weight,
                               k, torch.device("cpu"))
    W = np.zeros((k, k))
    np.fill_diagonal(W, float(w[0]))
    for j in range(len(topo.offsets)):
        for dst in range(k):
            W[dst, int(src[j, dst])] += float(w[j + 1])
    np.testing.assert_allclose(W, topo.weights, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(W, offsets_matrix(topo), rtol=1e-6,
                               atol=1e-7)


def test_degree_limits_and_shapes_rejected():
    p = torch.zeros(16, 8, 128)
    too_many = tuple(range(1, tgossip.MAX_GOSSIP_ADAM_DEGREE + 2))
    with pytest.raises(ValueError, match="degree"):
        ops.gossip_adam_mix(p, p, p, p, too_many, (0.05,) * len(too_many),
                            0.2, eta=1e-2)
    with pytest.raises(ValueError, match="at least one offset"):
        ops.gossip_adam_mix(p, p, p, p, (), (), 1.0, eta=1e-2)
    with pytest.raises(ValueError, match="packed"):
        ops.gossip_mix(torch.zeros(8, 100), (1,), (0.5,), 0.5)
    x = torch.randn(8, 8, 128)
    assert ops.gossip_mix(x, (), (), 1.0) is x


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    ops.reset_launches()
    p, g, m, v = to_t(*bufs())
    topo = make_topology("ring", K)
    ops.fused_adam(p, g, m, v, eta=1e-3)
    ops.gossip_mix(p, topo.offsets, topo.offset_weights, topo.self_weight)
    ops.gossip_adam_mix(p, g, m, v, topo.offsets, topo.offset_weights,
                        topo.self_weight, eta=1e-3)
    assert ops.launch_counts() == {"fused_adam": 0, "gossip_mix": 0,
                                   "gossip_adam_mix": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run a CPU tensor (no silent fallback)."""
    p, g, m, v = to_t(*bufs())
    with pytest.raises(ValueError, match="CUDA"):
        tfa.fused_adam(p, g, m, v, eta=1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        tgossip.gossip_mix(p, (1, 7), (1 / 3, 1 / 3), 1 / 3)
    with pytest.raises(ValueError, match="CUDA"):
        tgossip.gossip_adam_mix(p, g, m, v, (1, 7), (1 / 3, 1 / 3), 1 / 3,
                                eta=1e-3)
