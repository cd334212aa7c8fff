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
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import fused_adam as tfa
from repro_torch.kernels import gossip as tgossip
from repro_torch.kernels import rwkv_scan as twkv
from repro_torch.kernels import sign_compress as tsc

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
# The sign-compression scale is a sum taken in another order by the kernel
# (tiles, then the segment's tiles in a fixed order) and by torch.sum; hat
# moves by scale * sign, so it inherits that error.
SCALE_TOL = dict(rtol=1e-5, atol=0)


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


# (graph, K): the elastic resize's K=6, the main path's K=8 (every graph
# of degree <= MAX_GOSSIP_ADAM_DEGREE), K=12, whose 256-column
# gossip_adam_mix tile fills the 48 KB a block may take without opting in,
# K=32, whose tile narrows to 64 columns, and K=3072, one column
GOSSIP_CASES = ([(name, 6) for name in GRAPHS] + [(name, 8) for name in GRAPHS]
                + [("ring", 12), ("torus", 12), ("ring", 32), ("torus", 32),
                   ("ring", 3072)])


@pytest.mark.gpu
@pytest.mark.parametrize("name,workers", GOSSIP_CASES)
def test_cuda_gossip_kernels_match_plain(cuda, name, workers):
    """gossip_adam_mix does the plain version's f32 operations in its
    order: equal to it element for element. 12 rows a worker leave the
    last 256-column tile half full."""
    topo = make_topology(name, workers)
    args = (topo.offsets, topo.offset_weights, topo.self_weight)
    p, g, m, v = adam_inputs((workers, 12, 128), seed=3)
    got = tgossip.gossip_mix(p, *args)
    close([got], [tgossip.gossip_mix_plain(p, *args)], **CARD_TOL)
    kw = dict(eta=1e-2, weight_decay=1e-4)
    got = tgossip.gossip_adam_mix(p, g, m, v, *args, **kw)
    want = tgossip.gossip_adam_mix_plain(p, g, m, v, *args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# bf16 moments: the kernels compute in f32 and round m and v once, at the
# store, to nearest-even, as the plain version's .to(bfloat16): m and v
# within one bf16 ulp (equal but where a tie breaks the other way), p, which
# stays f32, within the f32 tolerance of tests/test_kernels.py.
BF16_P_TOL = dict(rtol=2e-5, atol=2e-5)


def bf16_ulps(a, b) -> int:
    """The largest distance in bf16 ulps between two bf16 tensors of one
    sign pattern (the bits read as integers)."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    return int((ia - ib).abs().max()) if a.numel() else 0


def close_bf16_moments(got, want):
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               **BF16_P_TOL)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype == torch.bfloat16
        assert bf16_ulps(a, b) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 128, 1000, 32768 + 17])
@pytest.mark.parametrize("variant", sorted(ADAM_VARIANTS))
def test_cuda_fused_adam_bf16_moments_match_plain(cuda, n, variant):
    kw = dict(eta=1e-3, **ADAM_VARIANTS[variant])
    p, g, m, v = adam_inputs((n + 1,), seed=5)
    m, v = m.to(torch.bfloat16), v.to(torch.bfloat16)
    for sl in (slice(0, n), slice(1, n + 1)):   # aligned and unaligned
        args = [t[sl] for t in (p, g, m, v)]
        got = tfa.fused_adam(*args, **kw)
        want = tfa.fused_adam_plain(*args, **kw)
        torch.cuda.synchronize()
        close_bf16_moments(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name,workers", [("ring", 2), ("ring", 8),
                                          ("torus", 8), ("ring", 12),
                                          ("torus", 12), ("ring", 3072)])
def test_cuda_gossip_adam_mix_bf16_moments_match_plain(cuda, name, workers):
    """K = 2 (the LM path), 8 (the main path) and K = 12 and 3072, where a
    K * 256-column or one-column tile fills the block's shared memory:
    the tile holds only the f32 half-steps, so bf16 moments change it
    not."""
    topo = make_topology(name, workers)
    args = (topo.offsets, topo.offset_weights, topo.self_weight)
    p, g, m, v = adam_inputs((workers, 12, 128), seed=6)
    m, v = m.to(torch.bfloat16), v.to(torch.bfloat16)
    kw = dict(eta=1e-2, weight_decay=1e-4)
    got = tgossip.gossip_adam_mix(p, g, m, v, *args, **kw)
    want = tgossip.gossip_adam_mix_plain(p, g, m, v, *args, **kw)
    torch.cuda.synchronize()
    close_bf16_moments(got, want)


@pytest.mark.gpu
def test_cuda_adam_kernels_reject_other_moment_dtypes(cuda):
    p, g, m, v = adam_inputs((K, ROWS, 128), seed=7)
    topo = make_topology("ring", K)
    mix = (topo.offsets, topo.offset_weights, topo.self_weight)
    for mm, vv in ((m.to(torch.bfloat16), v), (m.half(), v.half()),
                   (m.double(), v.double())):
        with pytest.raises(ValueError, match="moments"):
            tfa.fused_adam(p, g, mm, vv, eta=1e-3)
        with pytest.raises(ValueError, match="moments"):
            tgossip.gossip_adam_mix(p, g, mm, vv, *mix, eta=1e-3)
    with pytest.raises(ValueError, match="f32"):
        tfa.fused_adam(p.to(torch.bfloat16), g, m.to(torch.bfloat16),
                       v.to(torch.bfloat16), eta=1e-3)
    bad = torch.zeros(K * ROWS * 128 + 1, dtype=torch.bfloat16,
                      device="cuda")[1:].view(K, ROWS, 128)
    with pytest.raises(ValueError, match="aligned"):
        tgossip.gossip_adam_mix(p, g, bad, bad, *mix, eta=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("name", GRAPHS)
def test_cuda_consensus_mix_matches_plain(cuda, name):
    topo = make_topology(name, K)
    deg = len(topo.offsets)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x, hs, *hns = torch.randn((2 + deg, K, ROWS, 128), generator=gen,
                              device="cuda")
    got = tgossip.consensus_mix(x, hs, hns, topo.offset_weights, 0.4)
    want = tgossip.consensus_mix_plain(x, hs, hns, topo.offset_weights, 0.4)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("deg", [1, 2, 5, 32, 33, 70])
def test_cuda_payload_mix_matches_plain(cuda, deg):
    """Past MAX_FUSED_DEGREE payloads the launches chain, one per 32, and
    the result stays equal to the plain version to the bit."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    x, *pay = torch.randn((1 + deg, K, ROWS, 128), generator=gen,
                          device="cuda")
    weights = [0.5 / deg] * deg
    before = tgossip.payload_mix.launches
    got = tgossip.payload_mix(x, pay, weights, 0.5)
    assert tgossip.payload_mix.launches - before == -(-deg // 32)
    want = tgossip.payload_mix_plain(x, pay, weights, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def compressed_close(got, want):
    q, scale, hat = got
    assert torch.equal(q, want[0])
    close([scale], [want[1]], **SCALE_TOL)
    tol = float(scale.abs().max()) * SCALE_TOL["rtol"]
    close([hat], [want[2]], rtol=CARD_TOL["rtol"], atol=CARD_TOL["atol"] + tol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["whole", "n_true", "table", "flat_odd",
                                  "unaligned", "k12", "many_segments",
                                  "repeat_bitwise", "side_stream",
                                  "many_items"])
def test_cuda_sign_compress_matches_plain(cuda, case):
    """The persistent kernel against its plain version. ``many_segments``:
    70 segments of 3 rows at K = 2 make fewer items than the grid's lag,
    so B items wait for their segment's last A item; ``many_items``: each
    block of the grid walks many items; ``repeat_bitwise``: a second call
    gives the first one's outputs to the bit (the counters are zeroed at
    every call, the scales summed in a fixed order); ``side_stream``: the
    call runs on a stream that is not the default one."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    shape = {"k12": (12, 776, 128), "many_segments": (2, 210, 128),
             "many_items": (K, 32768, 128)}.get(case, (K, 3 * 256 + 8, 128))
    x = torch.randn(shape, generator=gen, device="cuda")
    hat = torch.randn(x.shape, generator=gen, device="cuda")
    table = dict(row_ranges=((0, 256), (256, 768), (768, 768), (768, 776)),
                 n_true=(32768, 40_000, 0, 5))
    if case in ("whole", "many_items"):
        kw = {}
    elif case == "n_true":
        x.reshape(K, -1)[:, 70_000:] = 0
        hat.reshape(K, -1)[:, 70_000:] = 0
        kw = dict(n_true=70_000)
    elif case == "many_segments":
        kw = dict(row_ranges=tuple((3 * i, 3 * i + 3) for i in range(70)),
                  n_true=tuple(3 * 128 - i for i in range(70)))
    else:
        kw = table
    if case in ("flat_odd", "unaligned"):   # the scalar path
        n = 100_001 if case == "flat_odd" else 40_000
        sl = slice(0, n) if case == "flat_odd" else slice(1, n + 1)
        xs, hs = x.reshape(-1)[sl], hat.reshape(-1)[sl]
        got = tsc.sign_compress(xs, hs)
        want = tsc.sign_compress_plain(xs, hs)
    elif case == "side_stream":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            got = tsc.sign_compress_stacked(x, hat, **kw)
        side.synchronize()
        want = tsc.sign_compress_stacked_plain(x, hat, **kw)
    else:
        got = tsc.sign_compress_stacked(x, hat, **kw)
        want = tsc.sign_compress_stacked_plain(x, hat, **kw)
    torch.cuda.synchronize()
    compressed_close(got, want)
    if case == "repeat_bitwise":
        again = tsc.sign_compress_stacked(x, hat, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))


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
    ops.consensus_mix(p, g, (m, v), topo.offset_weights, 0.4)
    ops.sign_compress_stacked(p, g, row_ranges=((0, 4), (4, ROWS)))
    ops.sign_compress(p, g)
    ops.payload_mix(p, (m, v), topo.offset_weights, topo.self_weight)
    q = p.reshape(1, K * ROWS, 4, 32)
    ops.flash_attention(q, q[:, :, :2], q[:, :, 2:])
    x = p.reshape(2, K * ROWS // 2, 4, 32)
    ops.rwkv_scan(x, x, x, x.sigmoid(), x[0, 0], p.reshape(2, 4, 32, 32))
    assert ops.launch_counts() == {
        "fused_adam": 1, "gossip_mix": 1, "gossip_adam_mix": 1,
        "consensus_mix": 1, "sign_compress_stacked": 1, "sign_compress": 1,
        "payload_mix": 1, "flash_attention": 1, "rwkv_scan": 1}
    with pytest.raises(ValueError, match="f32"):
        ops.fused_adam(p.double(), g.double(), m.double(), v.double(),
                       eta=1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gossip_mix(p.transpose(1, 2).contiguous().transpose(1, 2),
                       topo.offsets, topo.offset_weights, topo.self_weight)


# The flash kernels sum the dot products and the softmax-weighted values
# in another order than the plain version's einsums (one key tile at a
# time), so in f32 they are held to tests/test_kernels.py's 2e-5; both
# take their exponentials by ex2.approx (~1e-6), the bf16 kernel carries
# p as bf16 hi + lo (to ~2**-17) and the f32 kernel each product as three
# TF32 products, hi.hi + hi.lo + lo.hi (to ~2**-21). In bf16 both round
# nearly the same f32 value once: at most one bf16 ulp apart, at most
# 2**-7 of the value (rtol 8e-3), plus the f32 difference where the
# output is near zero (atol 2e-5).
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=8e-3, atol=2e-5)}
# chip_smoke.py's shapes: (B, S, T, Hq, Hk, D, dtype, causal, window)
FLASH_CASES = {
    "serve_bucket": (8, 1024, 1024, 32, 8, 64, torch.bfloat16, True, 0),
    "long_prompt": (1, 8192, 8192, 32, 8, 64, torch.bfloat16, True, 0),
    "window_512": (2, 2048, 2048, 32, 8, 64, torch.bfloat16, True, 512),
    "non_causal_f32_d128": (2, 512, 1024, 16, 16, 128, torch.float32,
                            False, 0),
    "ragged_1021": (2, 1021, 1021, 32, 8, 64, torch.bfloat16, True, 0),
    "d32_window_strided": (2, 300, 300, 8, 2, 32, torch.float32, True, 16),
    "d96_bf16": (2, 1024, 1024, 32, 8, 96, torch.bfloat16, True, 0),
    "d112_bf16": (2, 1024, 1024, 32, 8, 112, torch.bfloat16, True, 0),
    "non_causal_bf16_s_ne_t": (2, 300, 700, 8, 2, 64, torch.bfloat16,
                               False, 0),
    "serve_bucket_f32": (8, 1024, 1024, 32, 8, 64, torch.float32, True, 0),
    "d96_f32": (2, 1024, 1024, 32, 8, 96, torch.float32, True, 0),
    "d112_f32": (2, 1024, 1024, 32, 8, 112, torch.float32, True, 0),
    "ragged_1021_f32": (2, 1021, 1021, 32, 8, 64, torch.float32, True, 0),
    "s_ne_t_window_f32": (2, 300, 700, 8, 2, 128, torch.float32, True, 100),
    # phi-3-vision's (8, 1024) prefill over its 576 patches; whisper's
    # encoder (non-causal, T = 1500 ends mid-tile), cross-attention (S !=
    # T, non-causal), decoder self-attention, and the cross-attention in f32
    "phi3_vision_prefill": (8, 1600, 1600, 32, 32, 96, torch.bfloat16, True,
                            0),
    "whisper_encoder": (8, 1500, 1500, 20, 20, 64, torch.bfloat16, False, 0),
    "whisper_cross": (8, 384, 1500, 20, 20, 64, torch.bfloat16, False, 0),
    "whisper_decoder": (8, 384, 384, 20, 20, 64, torch.bfloat16, True, 0),
    "whisper_cross_f32": (8, 384, 1500, 20, 20, 64, torch.float32, False, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_cuda_flash_attention_matches_plain(cuda, case):
    B, S, T, Hq, Hk, D, dt, causal, window = FLASH_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((B, S, Hq, D), generator=gen, device="cuda").to(dt)
    kv = torch.randn((B, T, 2 * Hk, D), generator=gen, device="cuda").to(dt)
    k, v = kv[:, :, :Hk], kv[:, :, Hk:]       # strided views, read in place
    if case == "d32_window_strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    before = tflash.flash_attention.launches
    got = tflash.flash_attention(q, k, v, causal=causal, window=window)
    assert tflash.flash_attention.launches == before + 1
    want = tflash.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape and got.is_contiguous()
    close([got.float()], [want.float()], **FLASH_TOL[dt])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["whisper_cross_f32", "serve_bucket_f32",
                                  "non_causal_f32_d128"])
def test_cuda_flash_f32_is_as_near_float64_as_the_plain_version(cuda,
                                                                  case):
    """The tensor core truncates as it adds into an accumulator: carried
    across 1500 keys that put the 3xTF32 kernel 15x farther from float64
    than the plain version; each k step now sums on a fresh fragment and
    is added by f32 additions (at most 2x, as ``chip_smoke.py``'s
    F32_FLASH_F64_RATIO)."""
    B, S, T, Hq, Hk, D, dt, causal, window = FLASH_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn((B, S, Hq, D), generator=gen, device="cuda")
    k = torch.randn((B, T, Hk, D), generator=gen, device="cuda")
    v = torch.randn((B, T, Hk, D), generator=gen, device="cuda")
    kk, vv = (t.double().repeat_interleave(Hq // Hk, 2) for t in (k, v))
    s = torch.einsum("bshd,bthd->bhst", q.double(), kk) / D ** 0.5
    if causal:
        s = s.masked_fill(torch.ones((S, T), dtype=torch.bool,
                                     device="cuda").triu(1), -float("inf"))
    ref = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), vv)
    err = {n: float((f(q, k, v, causal=causal).double() - ref).abs().max())
           for n, f in (("kernel", tflash.flash_attention),
                        ("plain", tflash.flash_attention_plain))}
    assert err["kernel"] <= 2.0 * err["plain"], err


@pytest.mark.gpu
def test_cuda_flash_attention_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 16, 2, 48), device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        tflash.flash_attention(q, q, q)
    q = torch.zeros((1, 16, 2, 64), device="cuda")
    with pytest.raises(ValueError, match="one dtype"):
        tflash.flash_attention(q, q.half(), q.half())
    every_other = torch.zeros((1, 16, 2, 128), device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="unit-stride"):
        tflash.flash_attention(q, every_other, q)


@pytest.mark.gpu
def test_cuda_flash_attention_rejects_unaligned_bf16_views(cuda):
    """The bf16 kernel loads q, k and v with TMA: a view whose base is 2
    bytes past a 16-byte boundary raises instead of launching."""
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device="cuda")
    flat = torch.zeros(64 * 2 * 64 + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view(1, 64, 2, 64)
    before = tflash.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte-aligned"):
        tflash.flash_attention(q, shifted, q)
    wide = torch.zeros((1, 64, 2, 68), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tflash.flash_attention(q, wide[..., :64], q)
    assert tflash.flash_attention.launches == before


@pytest.mark.gpu
def test_cuda_flash_attention_rejects_unaligned_f32_views(cuda):
    """The f32 kernel loads k and v with 16-byte cp.async: a view whose
    base is 4 bytes past a 16-byte boundary, or whose seq stride is not a
    multiple of 16 bytes, raises instead of launching."""
    q = torch.zeros((1, 64, 2, 64), device="cuda")
    flat = torch.zeros(64 * 2 * 64 + 1, device="cuda")
    shifted = flat[1:].view(1, 64, 2, 64)
    before = tflash.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte-aligned"):
        tflash.flash_attention(q, shifted, q)
    wide = torch.zeros((1, 64, 1, 130), device="cuda")
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tflash.flash_attention(q[:, :, :1], wide[..., :64], wide[..., :64])
    assert tflash.flash_attention.launches == before


@pytest.mark.gpu
def test_cuda_engine_prefills_through_the_kernel(cuda):
    """The reduced llama3.2-1b served on the card: one flash launch per
    layer per prefill and no other kernel; tokens equal to the naive
    impl's at f32 compute."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.serve import DecodeEngine, ParamStore

    cfg = dataclasses.replace(get_reduced("llama3.2-1b").model,
                              compute_dtype=torch.float32)
    store = ParamStore()
    store.publish(build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0)))
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (L,), generator=gen,
                             device="cuda") for L in (16, 9, 16, 12, 16)]
    outs = {}
    for impl in ("kernel", "naive"):
        eng = DecodeEngine(cfg, store, buckets=((1, 16), (4, 16)),
                           max_new_tokens=4, attn_impl=impl)
        ops.reset_launches()
        outs[impl] = eng.generate(prompts, 4)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = cfg.n_layers * 3 if impl == "kernel" else 0
        assert counts == {**{n: 0 for n in counts}, "flash_attention": want}
        assert eng.compile_counts == {"prefill": 2, "decode": 2}
    for a, b in zip(outs["kernel"], outs["naive"]):
        assert a.is_cuda and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-7b", "phi3.5-moe-42b-a6.6b",
                                  "phi-3-vision-4.2b", "whisper-large-v3"])
def test_cuda_hybrid_and_moe_prefill_match_the_cpu(cuda, arch):
    """The reduced zamba2-7b (its shared block at each of its 2 sites),
    phi3.5-moe and phi-3-vision (one attention per layer) and whisper
    (per encoder layer, and per decoder layer a causal self-attention and
    a cross-attention) at f32 compute: a (2, 16) prefill through the flash
    kernel on the card, with the family's extras drawn on the CPU, and 3
    decode steps, against the same on the CPU (the plain version): logits
    and caches within f32 2e-5."""
    import dataclasses

    from repro_torch._tree import tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import hybrid
    from repro_torch.models.registry import build_model, family_extras

    cfg = dataclasses.replace(get_reduced(arch).model,
                              compute_dtype=torch.float32)
    api = build_model(cfg)
    params = {"cpu": api.init(torch.Generator().manual_seed(0))}
    params["cuda"] = tree_map(lambda x: x.to("cuda"), params["cpu"])
    toks = torch.randint(0, cfg.vocab_size, (2, 19),
                         generator=torch.Generator().manual_seed(1))
    extras = family_extras(cfg, 2, torch.Generator().manual_seed(2))
    sites = {"hybrid": hybrid.n_attn_sites(cfg),
             "audio": cfg.n_encoder_layers + 2 * cfg.n_layers}.get(
                 cfg.family, cfg.n_layers)
    out = {}
    for dev in ("cpu", "cuda"):
        t = toks.to(dev)
        ex = {k: x.to(dev) for k, x in extras.items()}
        ops.reset_launches()
        with torch.no_grad():
            logits, cache = api.prefill(params[dev], {"tokens": t[:, :16],
                                                      **ex},
                                        cache_len=24 + (cfg.n_patches or 0),
                                        attn_impl="kernel")
            steps = [logits[:, 0]]
            for i in range(16, 19):
                logits, cache = api.decode_step(params[dev], cache, t[:, i])
                steps.append(logits)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = sites if dev == "cuda" else 0
        assert counts == {**{n: 0 for n in counts}, "flash_attention": want}
        out[dev] = (torch.stack(steps, 1),) + tuple(
            x for x in cache if isinstance(x, torch.Tensor))
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)


# rwkv_scan against its plain version. Both compute each state element as
# w * S rounded plus k * v rounded (the kernel is built without FMA
# contraction), so the final state is bit-equal, and so is a sequence cut
# into two calls that carry it; y sums over the key dim in another order
# than the plain version's einsum, so it is held to f32 2e-5.
WKV_Y_TOL = dict(rtol=2e-5, atol=2e-5)
# chip_smoke.py's shapes, (B, S, H, D, r/k/v dtype), and a D=128 case
WKV_CASES = {
    "serve_prefill": (8, 1024, 40, 64, torch.bfloat16),
    "b1_s128": (1, 128, 40, 64, torch.bfloat16),
    "decode": (8, 1, 40, 64, torch.bfloat16),
    "d32_f32_ragged": (2, 1000, 8, 32, torch.float32),
    "d128_f32": (2, 96, 4, 128, torch.float32),
    "decode_b1": (1, 1, 40, 64, torch.bfloat16),
}


def wkv_inputs(B, S, H, D, dt, seed=0):
    """r, k, v ~ 0.3 N in ``dt`` (k and v strided views of one tensor), w
    = sigmoid(N) f32, u ~ 0.1 N f32, state ~ 0.1 N f32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def n(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    r = n((B, S, H, D), 0.3).to(dt)
    kv = n((B, S, 2 * H, D), 0.3).to(dt)
    w = torch.sigmoid(n((B, S, H, D)))
    return r, kv[:, :, :H], kv[:, :, H:], w, n((H, D), 0.1), \
        n((B, H, D, D), 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_cuda_rwkv_scan_matches_plain(cuda, case):
    ins = wkv_inputs(*WKV_CASES[case])
    before = twkv.rwkv_scan.launches
    y, st = twkv.rwkv_scan(*ins)
    assert twkv.rwkv_scan.launches == before + 1
    want_y, want_st = twkv.rwkv_scan_plain(*ins)
    torch.cuda.synchronize()
    assert y.dtype == st.dtype == torch.float32 and y.is_contiguous()
    assert torch.equal(st, want_st)
    close([y], [want_y], **WKV_Y_TOL)


@pytest.mark.gpu
def test_cuda_rwkv_scan_state_continuity(cuda):
    """S=1024 in one call against two calls of 512 that carry the state:
    equal to the bit."""
    r, k, v, w, u, s0 = wkv_inputs(8, 1024, 40, 64, torch.bfloat16, seed=1)
    y, st = twkv.rwkv_scan(r, k, v, w, u, s0)
    y1, s1 = twkv.rwkv_scan(r[:, :512], k[:, :512], v[:, :512], w[:, :512],
                            u, s0)
    y2, s2 = twkv.rwkv_scan(r[:, 512:], k[:, 512:], v[:, 512:], w[:, 512:],
                            u, s1)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(s2, st)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 37])
def test_cuda_rwkv_scan_reads_unaligned_views(cuda, S):
    """r, k, v, w, u and the state one element past a 16-byte boundary
    take the kernel's plain loads instead of its 16-byte copies (the state
    its scalar reads instead of float2): same state, same y."""
    r, k, v, w, u, s0 = wkv_inputs(2, S, 4, 64, torch.bfloat16, seed=2)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    ins = [shifted(t) for t in (r, k, v, w, u, s0)]
    y, st = twkv.rwkv_scan(*ins)
    want_y, want_st = twkv.rwkv_scan_plain(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert torch.equal(st, want_st)
    close([y], [want_y], **WKV_Y_TOL)


@pytest.mark.gpu
def test_cuda_rwkv_scan_rejects_what_it_does_not_take(cuda):
    r, k, v, w, u, s0 = wkv_inputs(1, 4, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="one dtype"):
        twkv.rwkv_scan(r, k.bfloat16(), v, w, u, s0)
    with pytest.raises(ValueError, match="f32"):
        twkv.rwkv_scan(r, k, v, w.bfloat16(), u, s0)
    r48, k48, v48, w48, u48, s48 = wkv_inputs(1, 4, 2, 48, torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        twkv.rwkv_scan(r48, k48, v48, w48, u48, s48)
    every_other = torch.zeros((1, 4, 2, 64), device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="unit-stride"):
        twkv.rwkv_scan(every_other, k, v, w, u, s0)


@pytest.mark.gpu
def test_cuda_engine_serves_rwkv_through_the_kernel(cuda):
    """The reduced rwkv6-3b served on the card: one WKV launch per layer
    per prefill and per decode step, no other kernel; tokens equal to the
    plain scan's at f32 compute."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.serve import DecodeEngine, ParamStore

    cfg = dataclasses.replace(get_reduced("rwkv6-3b").model,
                              compute_dtype=torch.float32)
    store = ParamStore()
    store.publish(build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0)))
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (L,), generator=gen,
                             device="cuda") for L in (16, 8, 16, 8, 16)]
    outs = {}
    for impl in ("kernel", "scan"):
        eng = DecodeEngine(cfg, store, buckets=((1, 8), (4, 16)),
                           max_new_tokens=4, wkv_impl=impl)
        ops.reset_launches()
        outs[impl] = eng.generate(prompts, 4)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        # three batches (one (4, 16), two (1, 8)), 4 tokens each
        want = cfg.n_layers * 4 * 3 if impl == "kernel" else 0
        assert counts == {**{n: 0 for n in counts}, "rwkv_scan": want}
        assert eng.compile_counts == {"prefill": 2, "decode": 2}
    for a, b in zip(outs["kernel"], outs["scan"]):
        assert a.is_cuda and torch.equal(a, b)


# ------------------- damping, ResNet-20, the paper's weight decay -----------


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 128, 32768 + 17])
def test_cuda_adam_kernels_at_the_paper_weight_decay(cuda, n):
    """fused_adam and gossip_adam_mix at ResNet-20's weight decay, 1e-4
    (the paper's CIFAR setting), against their plain versions: the f32
    operations of the plain version in its order."""
    kw = dict(eta=1e-3, tau=1e-6, weight_decay=1e-4)
    p, g, m, v = adam_inputs((n,), seed=9)
    close(tfa.fused_adam(p, g, m, v, **kw),
          tfa.fused_adam_plain(p, g, m, v, **kw), **CARD_TOL)
    topo = make_topology("ring", K)
    args = (topo.offsets, topo.offset_weights, topo.self_weight)
    p, g, m, v = adam_inputs((K, 12, 128), seed=10)
    got = tgossip.gossip_adam_mix(p, g, m, v, *args, **kw)
    want = tgossip.gossip_adam_mix_plain(p, g, m, v, *args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def small_deepfm_pipelines(device, **kw):
    """A small DeepFM (K=8, 4 fields x 16 features, embed 4, hidden
    (16, 16)) on ``device``, packed D-Adam: (state, pipeline, batch), the
    init and batch drawn on the CPU."""
    from repro_torch.core.api import make_optimizer
    from repro_torch.data.synthetic import (ctr_batch_stacked, ctr_teacher,
                                            make_ctr_task)
    from repro_torch.models import deepfm
    from repro_torch.train.grad import make_grad_pipeline
    from repro_torch.train.loop import stack_params

    task = make_ctr_task(seed=0, n_fields=4, features_per_field=16,
                         embed_dim=4)
    params = deepfm.init_deepfm(torch.Generator().manual_seed(0),
                                task.n_features, 4, 4, (16, 16))
    batch = ctr_batch_stacked(ctr_teacher(task, "cpu"),
                              torch.Generator().manual_seed(1), K, 32)
    opt = make_optimizer("d-adam", K, backend="packed", device=device)
    state = opt.init(stack_params(params, K))
    return (state, make_grad_pipeline(deepfm.deepfm_loss, opt, **kw),
            {k: x.to(device) for k, x in batch.items()})


@pytest.mark.gpu
def test_cuda_damped_packed_pipeline_matches_its_cpu_run(cuda):
    """The damped packed pipeline at counts that differ between workers:
    the card's losses and packed gradient against the CPU's (summation
    orders only: the optimizer-state tolerance); with every chunk live,
    equal to microbatch=4 on the card to the bit."""
    n = torch.tensor([1, 2, 3, 4, 4, 3, 2, 1], dtype=torch.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        state, pipe, batch = small_deepfm_pipelines(dev, damping_chunks=4)
        out[dev] = pipe.value_and_grad(state, batch, n.to(dev))
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-6)
    state, damped, batch = small_deepfm_pipelines("cuda", damping_chunks=4)
    _, plain, _ = small_deepfm_pipelines("cuda", microbatch=4)
    dl, dg = damped.value_and_grad(state, batch,
                                   torch.full((K,), 4, dtype=torch.int32,
                                              device="cuda"))
    pl, pg = plain.value_and_grad(state, batch)
    assert torch.equal(dl, pl) and torch.equal(dg, pg)


@pytest.mark.gpu
def test_cuda_resnet20_grouped_convs_match_the_cpu(cuda):
    """ResNet-20 at width 8 for K=2 workers, one grouped cuDNN convolution
    per conv (TF32 off): logits and the per-worker losses within the f32
    tolerance of the CPU's, each grad leaf within 1e-3 of its largest.
    cuDNN's algorithms (Winograd transforms among them) sum otherwise than
    the CPU's direct convolutions: at width 16 a weight gradient lay 9.1e-5
    of its leaf's largest apart (chip_smoke.py's VISION_M_TOL); a wrong
    leaf or worker lies O(1) apart."""
    from repro_torch._tree import tree_flatten, tree_map, tree_unflatten
    from repro_torch.models import deepfm
    from repro_torch.train.loop import stack_params

    params = stack_params(deepfm.init_resnet20(
        torch.Generator().manual_seed(0), width=8), 2)
    gen = torch.Generator().manual_seed(1)
    batch = {"images": torch.randn((2, 4, 32, 32, 3), generator=gen),
             "label": torch.randint(0, 10, (2, 4), generator=gen)}
    out = {}
    for dev in ("cuda", "cpu"):
        leaves, td = tree_flatten(tree_map(lambda x: x.to(dev), params))
        xs = [x.requires_grad_(True) for x in leaves]
        p = tree_unflatten(td, xs)
        b = {k: x.to(dev) for k, x in batch.items()}
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            logits = deepfm.resnet20_logits(p, b["images"])
            losses = deepfm.resnet20_loss(p, b)
            grads = torch.autograd.grad(losses.sum(), xs)
        out[dev] = (logits.detach().cpu(), losses.detach().cpu(),
                    [g.cpu() for g in grads])
    for i in (0, 1):
        np.testing.assert_allclose(out["cuda"][i].numpy(),
                                   out["cpu"][i].numpy(), rtol=2e-5,
                                   atol=2e-5)
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        atol = 1e-3 * max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol)
