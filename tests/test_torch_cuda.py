"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The CUDA kernels have no CPU mode: without a GPU every test here skips.
This file imports neither ``jax`` nor ``repro``, so it runs on a GPU
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.topology import make_topology
from repro_torch.kernels import fused_adam as tfa
from repro_torch.kernels import gossip as tgossip

torch.set_num_threads(2)

K = 8
ROWS = 8
GRAPHS = ["ring", "torus", "exponential", "fully_connected"]
ADAM_VARIANTS = {"plain": dict(tau=1e-6, weight_decay=0.0),
                 "weight_decay": dict(tau=1e-6, weight_decay=0.1),
                 "tau0": dict(tau=0.0, weight_decay=0.0)}


def adam_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    m = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    v = np.abs(rng.standard_normal(shape) * 0.01).astype(np.float32)
    return [torch.from_numpy(x).to("cuda") for x in (p, g, m, v)]


def close(got, want, **tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **tol)


# The kernel and its plain version do the same f32 operations in the same
# order, and the kernels are built without FMA contraction, so they agree
# to the last bit except where rsqrtf's approximation (tau = 0) enters.
CARD_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 128, 1000, 32768 + 17])
@pytest.mark.parametrize("variant", sorted(ADAM_VARIANTS))
def test_cuda_fused_adam_matches_plain(cuda, n, variant):
    kw = dict(eta=1e-3, **ADAM_VARIANTS[variant])
    ins = adam_inputs((n + 1,))
    for sl in (slice(0, n), slice(1, n + 1)):   # aligned and unaligned
        args = [t[sl] for t in ins]
        got = tfa.fused_adam(*args, **kw)
        want = tfa.fused_adam_plain(*args, **kw)
        torch.cuda.synchronize()
        close(got, want, **CARD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", GRAPHS)
def test_cuda_gossip_kernels_match_plain(cuda, name):
    topo = make_topology(name, K)
    args = (topo.offsets, topo.offset_weights, topo.self_weight)
    p, g, m, v = adam_inputs((K, ROWS, 128), seed=3)
    got = tgossip.gossip_mix(p, *args)
    close([got], [tgossip.gossip_mix_plain(p, *args)], **CARD_TOL)
    kw = dict(eta=1e-2, weight_decay=1e-4)
    got = tgossip.gossip_adam_mix(p, g, m, v, *args, **kw)
    want = tgossip.gossip_adam_mix_plain(p, g, m, v, *args, **kw)
    torch.cuda.synchronize()
    close(got, want, **CARD_TOL)


@pytest.mark.gpu
def test_cuda_wrappers_count_launches_and_reject_bad_operands(cuda):
    from repro_torch.kernels import ops

    p, g, m, v = adam_inputs((K, ROWS, 128), seed=4)
    topo = make_topology("ring", K)
    ops.reset_launches()
    ops.fused_adam(p, g, m, v, eta=1e-3)
    ops.gossip_mix(p, topo.offsets, topo.offset_weights, topo.self_weight)
    ops.gossip_adam_mix(p, g, m, v, topo.offsets, topo.offset_weights,
                        topo.self_weight, eta=1e-3)
    assert ops.launch_counts() == {"fused_adam": 1, "gossip_mix": 1,
                                   "gossip_adam_mix": 1}
    with pytest.raises(ValueError, match="f32"):
        ops.fused_adam(p.double(), g.double(), m.double(), v.double(),
                       eta=1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gossip_mix(p.transpose(1, 2).contiguous().transpose(1, 2),
                       topo.offsets, topo.offset_weights, topo.self_weight)
