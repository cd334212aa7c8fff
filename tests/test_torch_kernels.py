"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper in ``repro_torch.kernels.ops`` runs the kernel's
plain PyTorch version; these tests hold that version against the TPU
kernel run in interpret mode (``block_rows=8, interpret=True``), at the
repo's f32 tolerance (``tests/test_kernels.py``: rtol = atol = 2e-5).

``sign_compress_stacked`` and ``sign_compress``: the int8 payload ``q`` must
be equal; the scale and the new ``hat`` agree at the f32 tolerance (the
scale is a sum, taken in another order by each package).

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
from repro.kernels import ref as jref
from repro.kernels import sign_compress as jsc
from repro_torch.core.dadam import shift_worker
from repro_torch.core.topology import make_topology, offsets_matrix
from repro_torch.kernels import fused_adam as tfa
from repro_torch.kernels import gossip as tgossip
from repro_torch.kernels import sign_compress as tsc
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


@pytest.mark.parametrize("deg", [1, 2, 5])
def test_payload_mix_plain_matches_jax_kernel(deg):
    """The staleness / overlap mix: identity index maps, payloads already
    chosen per destination worker (deg 5: one-peer-exponential's union
    at K=8, with the zero weights of an idle round)."""
    rng = np.random.default_rng(9)
    x, *pay = rng.standard_normal((1 + deg, K, ROWS, 128)).astype(np.float32)
    weights = (1 / 3, 1 / 3, 0.0, 0.0, 1 / 3)[:deg]
    want = jgossip.payload_mix(jnp.asarray(x), [jnp.asarray(p) for p in pay],
                               weights, 1 / 3, block_rows=ROWS,
                               interpret=True)
    got = ops.payload_mix(torch.from_numpy(x), to_t(*pay), weights, 1 / 3)
    close([got], [want])
    x0 = torch.from_numpy(x)
    assert ops.payload_mix(x0, (), (), 1.0) is x0


def test_payload_mix_of_shifted_copies_is_gossip_mix_bitwise():
    """With every payload the fresh shift, the payload mix is the
    synchronous gossip_mix to the last bit: same order, same constants."""
    topo = make_topology("exponential", K)
    x = torch.from_numpy(bufs(3)[0])
    pay = [shift_worker(x, s, K) for s in topo.offsets]
    got = ops.payload_mix(x, pay, topo.offset_weights, topo.self_weight)
    want = ops.gossip_mix(x, topo.offsets, topo.offset_weights,
                          topo.self_weight)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="align"):
        ops.payload_mix(x, pay[:1], topo.offset_weights, topo.self_weight)
    with pytest.raises(ValueError, match="payload shape"):
        ops.payload_mix(x, [p[:, :4] for p in pay], topo.offset_weights,
                        topo.self_weight)


def test_payload_mix_chained_in_chunks_is_one_mix_bitwise():
    """The CUDA wrapper chains launches of at most MAX_FUSED_DEGREE
    payloads, each later one with self weight 1.0 on the previous output;
    in f32 that is the one-pass sum to the last bit."""
    deg, step = 70, tgossip.MAX_FUSED_DEGREE
    rng = np.random.default_rng(11)
    x, *pay = to_t(*rng.standard_normal((1 + deg, 2, 8, 128)).astype(
        np.float32))
    weights = list(rng.uniform(0.0, 1.0 / deg, deg))
    acc, w_self = x, 0.3
    for i in range(0, deg, step):
        acc = ops.payload_mix(acc, pay[i:i + step], weights[i:i + step],
                              w_self)
        w_self = 1.0
    assert torch.equal(acc, ops.payload_mix(x, pay, weights, 0.3))


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
    ops.consensus_mix(p, g, (m, v), topo.offset_weights, 0.4)
    ops.sign_compress_stacked(p, g, row_ranges=((0, 4), (4, ROWS)))
    ops.sign_compress(p, g)
    ops.payload_mix(p, (m, v), topo.offset_weights, topo.self_weight)
    q = p.reshape(1, K * ROWS, 4, 32)
    ops.flash_attention(q, q[:, :, :2], q[:, :, 2:])
    x = p.reshape(2, K * ROWS // 2, 4, 32)
    ops.rwkv_scan(x, x, x, x.sigmoid(), x[0, 0], p.reshape(2, 4, 32, 32))
    assert ops.launch_counts() == {
        "fused_adam": 0, "gossip_mix": 0, "gossip_adam_mix": 0,
        "consensus_mix": 0, "sign_compress_stacked": 0, "sign_compress": 0,
        "payload_mix": 0, "flash_attention": 0, "rwkv_scan": 0}


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
    with pytest.raises(ValueError, match="CUDA"):
        tgossip.consensus_mix(p, g, (m, v), (1 / 3, 1 / 3), 0.4)
    with pytest.raises(ValueError, match="CUDA"):
        tsc.sign_compress_stacked(p, g)
    with pytest.raises(ValueError, match="CUDA"):
        tsc.sign_compress(p, g)
    with pytest.raises(ValueError, match="CUDA"):
        tgossip.payload_mix(p, (m, v), (1 / 3, 1 / 3), 1 / 3)


# ------------------------------ CD-Adam kernels ----------------------------


def assert_compressed_equal(got, want):
    """q exact; scale and hat at the f32 tolerance."""
    q, scale, hat = got
    np.testing.assert_array_equal(q.numpy(), np.asarray(want[0]))
    assert q.dtype == torch.int8
    close([scale, hat], want[1:])


@pytest.mark.parametrize("name", GRAPHS)
def test_consensus_mix_plain_matches_jax_kernel(name):
    topo = make_topology(name, K)
    deg = len(topo.offsets)
    x, hs, *hns = np.random.default_rng(5).standard_normal(
        (2 + deg, K, ROWS, 128)).astype(np.float32)
    want = jgossip.consensus_mix(
        jnp.asarray(x), jnp.asarray(hs), [jnp.asarray(h) for h in hns],
        topo.offset_weights, 0.4, block_rows=ROWS, interpret=True)
    got = ops.consensus_mix(*to_t(x, hs), to_t(*hns), topo.offset_weights,
                            0.4)
    close([got], [want])
    x0 = torch.from_numpy(x)
    assert ops.consensus_mix(x0, x0, (), (), 0.4) is x0


def residual_inputs(shape, seed=0):
    """x and hat whose differences lie far from 0 (no sign within rounding
    of a tie), with zero padding where the shape says so."""
    rng = np.random.default_rng(seed)
    hat = rng.standard_normal(shape).astype(np.float32)
    d = rng.uniform(0.01, 1.0, shape) * rng.choice([-1.0, 1.0], shape)
    return (hat + d).astype(np.float32), hat


@pytest.mark.parametrize("n_true", [None, 8 * 128 - 37])
def test_sign_compress_stacked_plain_matches_jax_kernel(n_true):
    x, hat = residual_inputs((K, ROWS, 128), seed=6)
    if n_true is not None:   # zero padding past the true count
        x.reshape(K, -1)[:, n_true:] = 0.0
        hat.reshape(K, -1)[:, n_true:] = 0.0
    want = jsc.sign_compress_stacked(jnp.asarray(x), jnp.asarray(hat),
                                     n_true=n_true, block_rows=ROWS,
                                     interpret=True)
    got = ops.sign_compress_stacked(*to_t(x, hat), n_true=n_true)
    assert tuple(got[1].shape) == (K,)
    assert_compressed_equal(got, want)
    if n_true is not None:   # the padding stays zero
        assert not got[0].reshape(K, -1)[:, n_true:].any()
        assert not got[2].reshape(K, -1)[:, n_true:].any()


def test_sign_compress_stacked_table_equals_jax_per_leaf_loop():
    """One call over several leaf segments (``row_ranges`` and per-leaf
    true counts, as the packed CD-Adam round makes it) equals the JAX
    package's loop of one call per leaf slice, leaf scale by leaf scale."""
    ranges = ((0, 8), (8, 24), (24, 32), (32, 32), (32, 40))
    sizes = (8 * 128 - 5, 2048, 1, 0, 1000)
    x, hat = residual_inputs((K, 40, 128), seed=7)
    for (r0, r1), sz in zip(ranges, sizes):
        seg_x = x[:, r0:r1].reshape(K, -1)
        seg_h = hat[:, r0:r1].reshape(K, -1)
        seg_x[:, sz:] = 0.0
        seg_h[:, sz:] = 0.0
        x[:, r0:r1] = seg_x.reshape(K, r1 - r0, 128)
        hat[:, r0:r1] = seg_h.reshape(K, r1 - r0, 128)
    parts = [jsc.sign_compress_stacked(
        jnp.asarray(x[:, r0:r1]), jnp.asarray(hat[:, r0:r1]),
        n_true=sz or None, block_rows=ROWS, interpret=True)
        for (r0, r1), sz in zip(ranges, sizes)]
    want = (np.concatenate([np.asarray(p[0]) for p in parts], axis=1),
            np.stack([np.asarray(p[1]) for p in parts], axis=1),
            np.concatenate([np.asarray(p[2]) for p in parts], axis=1))
    got = ops.sign_compress_stacked(*to_t(x, hat), n_true=sizes,
                                    row_ranges=ranges)
    assert tuple(got[1].shape) == (K, len(ranges))
    assert_compressed_equal(got, want)
    assert not got[1][:, 3].any()       # the empty leaf's scale is 0
    # the whole-buffer case is one segment over the true count
    whole = ops.sign_compress_stacked(*to_t(x, hat), n_true=sum(sizes))
    np.testing.assert_array_equal(whole[0].numpy(), got[0].numpy())


@pytest.mark.parametrize("shape", [(37, 53), (1000,), (11,), (3, 8, 128)],
                         ids=str)
def test_sign_compress_plain_matches_jax_kernel(shape):
    x, hat = residual_inputs(shape, seed=8)
    want = jsc.sign_compress(jnp.asarray(x), jnp.asarray(hat),
                             block_rows=ROWS, interpret=True)
    got = ops.sign_compress(*to_t(x, hat))
    assert got[1].shape == () and got[0].shape == shape
    assert_compressed_equal(got, want)
    assert_compressed_equal(ref.sign_compress_ref(*to_t(x, hat)),
                            jref.sign_compress_ref(jnp.asarray(x),
                                                   jnp.asarray(hat)))


def test_sign_compress_edge_cases_and_rejections():
    x = torch.zeros(K, 0)
    q, scale, hat = ops.sign_compress_stacked(x, x)
    assert q.shape == (K, 0) and q.dtype == torch.int8
    assert torch.equal(scale, torch.zeros(K)) and hat is x
    p, g, _, _ = to_t(*bufs())
    with pytest.raises(NotImplementedError, match="multi-GPU comm"):
        ops.sign_compress_stacked(p, g, reduce_axis="model")
    with pytest.raises(ValueError, match="out of range"):
        ops.sign_compress_stacked(p, g, n_true=ROWS * 128 + 1)
    with pytest.raises(ValueError, match="cover"):
        ops.sign_compress_stacked(p, g, row_ranges=((0, 4), (5, ROWS)))
    with pytest.raises(ValueError, match="one entry"):
        ops.sign_compress_stacked(p, g, n_true=(1,),
                                  row_ranges=((0, 4), (4, ROWS)))
    with pytest.raises(ValueError, match="hat"):
        ops.sign_compress_stacked(p, g[:, :4])
    # zero residual maps to zero in q and leaves hat as it was
    q, _, h = ops.sign_compress_stacked(p, p.clone())
    assert not q.any() and torch.equal(h, p)
