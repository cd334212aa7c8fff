"""bf16 parameter buffers (a model's ``param_dtype=bfloat16``) on the packed
path, the port against the JAX package.

* Each kernel's plain version on bf16 buffers against its Pallas kernel
  (interpret mode, ``block_rows=8``): ``fused_adam`` and
  ``gossip_adam_mix`` at every (parameter, moment) dtype pair, with
  weight decay and with tau 0; ``gossip_mix``, ``payload_mix`` and
  ``consensus_mix`` on the ring and the torus; ``sign_compress_stacked``
  with and without ``n_true``, and ``sign_compress``. The int8 ``q``
  exactly and the f32 scales within rtol 1e-5; every other f32 output
  within the JAX suite's f32 tolerance (2e-5, ``tests/test_kernels.py``);
  every bf16 output the same bits but for at most ``DIFF_SHARE`` of its
  elements, each of those one bf16 ulp away (``same_outputs``). The change
  each output makes to its input (the Adam update ``p_out - p``, the new
  ``m`` and ``v`` less the old, the mix less ``x``) is held to JAX's in the
  2-norm (``same_change``), at inputs scaled so that the update moves most
  bf16 parameters by several ulps: a plain version that returned its
  inputs fails both. ``gossip_adam_mix`` is held to JAX's fused kernel,
  not to its two-pass composition.
* ``convert`` carries bf16 D-Adam and CD-Adam states across and back, the
  bits and the bfloat16 dtype unchanged.
* The slice: a reduced llama3.2-1b (2 layers, d_model 256) with bf16
  params and f32 compute, packed D-Adam, CD-Adam and D-Adam at staleness 2
  and straggler rate 0.3 over a K=4 ring at p=2, 4 ``fit`` steps, the
  port's ``'packed'`` against JAX's ``'pallas'`` from the same params: the
  losses, the buffer's bits but for a share, and the buffer's change, the
  moments and the hats in the 2-norm. At the LM phase's eta of 1e-4 bf16
  rounding leaves some Adam steps unapplied (a step below half an ulp of
  its parameter); the share the first step swallows is the same in both
  packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import dadam as jdadam
from repro.core import make_optimizer as jax_make_optimizer
from repro.core.topology import make_topology as jax_topology
from repro.kernels import fused_adam as jfa
from repro.kernels import gossip as jgossip
from repro.kernels import sign_compress as jsc
from repro.models import build_model as jbuild_model
from repro.train import DecentralizedTrainer as JaxTrainer
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core.api import make_optimizer
from repro_torch.core.topology import make_topology
from repro_torch.kernels import ops
from repro_torch.models.registry import build_model
from repro_torch.train.loop import DecentralizedTrainer, stacked_loss

torch.set_num_threads(2)

F32_TOL = dict(rtol=2e-5, atol=2e-5)     # the JAX suite's f32 tolerance
SCALE_RTOL = 1e-5
# the share of a bf16 output whose bits may differ from JAX's (each of
# those one ulp away): at most 0.66% (54 of 8,192, gossip_mix on the ring)
# in these cases, where the plain version and interpret-mode JAX round a
# few f32 sums the other way at the bf16 store
DIFF_SHARE = 1e-2
# ||change in the port - change in JAX|| / ||change in JAX||: at most
# 3.6e-4 in these cases
CHANGE_RTOL = 1e-3
K = 8
ROWS = 8
BLOCK = dict(block_rows=ROWS, interpret=True)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
ADAM_VARIANTS = {"weight_decay": dict(tau=1e-6, weight_decay=1e-4),
                 "tau0": dict(tau=0.0, weight_decay=0.0)}


def arrays(shape, seed, n=4):
    """``n`` f32 arrays from a numpy seed. The default four are p, g, m, v
    at scales where one Adam step moves most bf16 parameters by several
    ulps (|p| ~ 0.05, whose ulp is 2**-12, against steps of ~1e-3 at eta
    1e-3) and moves m and v by more than a bf16 ulp of theirs (v ~ 1e-4
    against g * g ~ 1e-2); more are unit normals."""
    rng = np.random.default_rng(seed)
    if n != 4:
        return [rng.standard_normal(shape).astype(np.float32)
                for _ in range(n)]
    p, g, m, v = (rng.standard_normal(shape) * s for s in (0.05, 0.1, 0.01,
                                                            1e-4))
    return [x.astype(np.float32) for x in (p, g, m, np.abs(v))]


def both(x: np.ndarray, dt: str):
    """``x`` rounded to ``dt`` on each side: the same bits."""
    tdt, jdt = DTYPES[dt]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def bits(a) -> np.ndarray:
    """A bf16 tensor or array's bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at magnitude ``x`` (8 significant
    bits)."""
    return np.ldexp(np.float32(1), np.frexp(x)[1] - 8)


def same_bits_but_a_share(ours, theirs) -> None:
    """bf16 ``ours`` has ``theirs``'s bits but for at most DIFF_SHARE of
    the elements, each of those one ulp away: one ulp of its value, or of
    the output's rms where a sum cancels to far below its terms."""
    differ = bits(ours) != bits(theirs)
    assert differ.mean() <= DIFF_SHARE, differ.mean()
    a, b = f32(ours), f32(theirs)
    rms = np.sqrt(np.mean(b * b))
    ulp = bf16_ulp(np.maximum(np.maximum(np.abs(a), np.abs(b)), rms))
    assert (np.abs(a - b) <= ulp).all(), np.abs(a - b).max()


def same_outputs(got, want) -> None:
    """Each port output in JAX's dtype: f32 ones within F32_TOL, bf16 ones
    the same bits but for a share (``same_bits_but_a_share``)."""
    for a, b in zip(got, want):
        assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype)
        if a.dtype == torch.float32:
            np.testing.assert_allclose(f32(a), f32(b), **F32_TOL)
        else:
            same_bits_but_a_share(a, b)


def rel_change_err(ours, theirs, before) -> float:
    """||(ours - before) - (theirs - before)|| / ||theirs - before||."""
    x = f32(before)
    want = f32(theirs) - x
    assert np.linalg.norm(want) > 0
    return float(np.linalg.norm(f32(ours) - x - want)
                 / np.linalg.norm(want))


def same_change(got, want, before) -> None:
    """The change each output makes to its input within CHANGE_RTOL of
    JAX's, in the 2-norm."""
    for a, b, x in zip(got, want, before):
        err = rel_change_err(a, b, x)
        assert err <= CHANGE_RTOL, err


# ------------------------- plain versions against JAX ------------------------


@pytest.mark.parametrize("variant", sorted(ADAM_VARIANTS))
@pytest.mark.parametrize("moments", sorted(DTYPES))
@pytest.mark.parametrize("params", sorted(DTYPES))
def test_fused_adam_plain_matches_jax_at_each_dtype_pair(params, moments,
                                                         variant):
    kw = dict(eta=1e-3, beta1=0.9, beta2=0.999, **ADAM_VARIANTS[variant])
    p, g, m, v = arrays((3 * 128 + 5,), seed=1)
    (tp, jp), (tg, jg) = both(p, params), both(g, params)
    (tm, jm), (tv, jv) = both(m, moments), both(v, moments)
    want = jfa.fused_adam(jp, jg, jm, jv, block_rows=8, interpret=True, **kw)
    got = ops.fused_adam(tp, tg, tm, tv, **kw)
    same_outputs(got, want)
    same_change(got, want, (tp, tm, tv))


@pytest.mark.parametrize("variant", sorted(ADAM_VARIANTS))
@pytest.mark.parametrize("moments", sorted(DTYPES))
@pytest.mark.parametrize("params", sorted(DTYPES))
@pytest.mark.parametrize("name", ["ring", "torus"])
def test_gossip_adam_mix_plain_matches_jax_fused_kernel(name, params,
                                                        moments, variant):
    topo, jtopo = make_topology(name, K), jax_topology(name, K)
    kw = dict(eta=1e-3, beta1=0.9, beta2=0.999, **ADAM_VARIANTS[variant])
    p, g, m, v = arrays((K, ROWS, 128), seed=2)
    (tp, jp), (tg, jg) = both(p, params), both(g, params)
    (tm, jm), (tv, jv) = both(m, moments), both(v, moments)
    want = jgossip.gossip_adam_mix(jp, jg, jm, jv, jtopo.offsets,
                                   jtopo.offset_weights, jtopo.self_weight,
                                   **BLOCK, **kw)
    got = ops.gossip_adam_mix(tp, tg, tm, tv, topo.offsets,
                              topo.offset_weights, topo.self_weight, **kw)
    same_outputs(got, want)
    same_change(got, want, (tp, tm, tv))


@pytest.mark.parametrize("name", ["ring", "torus"])
def test_gossip_mix_plain_matches_jax_in_bf16(name):
    topo, jtopo = make_topology(name, K), jax_topology(name, K)
    tx, jx = both(arrays((K, ROWS, 128), seed=3, n=1)[0], "bf16")
    want = jgossip.gossip_mix(jx, jtopo.offsets, jtopo.offset_weights,
                              jtopo.self_weight, **BLOCK)
    got = ops.gossip_mix(tx, topo.offsets, topo.offset_weights,
                         topo.self_weight)
    same_outputs([got], [want])
    same_change([got], [want], [tx])


@pytest.mark.parametrize("name", ["ring", "torus"])
def test_payload_mix_plain_matches_jax_in_bf16(name):
    topo = make_topology(name, K)
    deg = len(topo.offsets)
    xs = [both(a, "bf16") for a in arrays((K, ROWS, 128), seed=4,
                                          n=1 + deg)]
    want = jgossip.payload_mix(xs[0][1], [j for _, j in xs[1:]],
                               topo.offset_weights, topo.self_weight,
                               **BLOCK)
    got = ops.payload_mix(xs[0][0], [t for t, _ in xs[1:]],
                          topo.offset_weights, topo.self_weight)
    same_outputs([got], [want])
    same_change([got], [want], [xs[0][0]])


@pytest.mark.parametrize("name", ["ring", "torus"])
def test_consensus_mix_plain_matches_jax_in_bf16(name):
    topo = make_topology(name, K)
    deg = len(topo.offsets)
    xs = [both(a, "bf16") for a in arrays((K, ROWS, 128), seed=5,
                                          n=2 + deg)]
    want = jgossip.consensus_mix(xs[0][1], xs[1][1], [j for _, j in xs[2:]],
                                 topo.offset_weights, 0.4, **BLOCK)
    got = ops.consensus_mix(xs[0][0], xs[1][0], [t for t, _ in xs[2:]],
                            topo.offset_weights, 0.4)
    same_outputs([got], [want])
    same_change([got], [want], [xs[0][0]])


def close_compressed(got, want, hat_before):
    q, scale, hat = got
    np.testing.assert_array_equal(q.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(scale.numpy(), np.asarray(want[1]),
                               rtol=SCALE_RTOL, atol=0)
    same_outputs([hat], [want[2]])
    same_change([hat], [want[2]], [hat_before])


@pytest.mark.parametrize("n_true", [None, 700])
def test_sign_compress_stacked_plain_matches_jax_in_bf16(n_true):
    x, hat = arrays((K, 6, 128), seed=6, n=2)
    if n_true is not None:          # a zero-padded slice of a leaf
        x.reshape(K, -1)[:, n_true:] = 0
        hat.reshape(K, -1)[:, n_true:] = 0
    (tx, jx), (th, jh) = both(x, "bf16"), both(hat, "bf16")
    want = jsc.sign_compress_stacked(jx, jh, n_true=n_true, **BLOCK)
    got = ops.sign_compress_stacked(tx, th, n_true=n_true)
    close_compressed(got, want, th)


def test_sign_compress_plain_matches_jax_in_bf16():
    x, hat = arrays((1001,), seed=7, n=2)
    (tx, jx), (th, jh) = both(x, "bf16"), both(hat, "bf16")
    want = jsc.sign_compress(jx, jh, **BLOCK)
    got = ops.sign_compress(tx, th)
    close_compressed(got, want, th)


# ------------------------------- convert -------------------------------------


def bf16_tree(seed=0, workers=4):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((workers, 13, 7)).astype(
                ml_dtypes.bfloat16),
            "b": rng.standard_normal((workers, 5)).astype(ml_dtypes.bfloat16)}


@pytest.mark.parametrize("kind", ["d-adam", "cd-adam"])
def test_convert_round_trips_bf16_states(kind):
    """A JAX bf16 packed state (D-Adam with live straggler buffers) into
    the port and back to numpy: bf16 arrays of the same bits."""
    params = bf16_tree()
    kw = dict(eta=1e-2, period=2, topology="ring")
    if kind == "d-adam":
        kw.update(staleness=2, straggler_rate=0.3, straggler_seed=1)
    jopt = jax_make_optimizer(kind, 4, backend="pallas", **kw)
    js = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    jstep = jax.jit(jopt.step)
    for t in range(2):
        g = jax.tree_util.tree_map(lambda x: (0.5 * x).astype(x.dtype),
                                   jopt.params_of(js))
        js = jstep(js, g)
    assert np.asarray(js.buf).dtype == jnp.bfloat16
    assert np.asarray(js.m).dtype == jnp.bfloat16
    like = convert.params_from_numpy(params, "cpu")
    base = [np.asarray(x) for x in (js.buf, js.m, js.v, js.count)]
    if kind == "d-adam":
        ts = convert.dadam_state_from_numpy(
            *base, like, "cpu",
            stale_bufs=[np.asarray(b) for b in js.stale.bufs],
            stale_age=np.asarray(js.stale.age))
        back = convert.dadam_state_to_numpy(ts)
        pairs = list(zip(back["stale_bufs"], js.stale.bufs))
    else:
        ts = convert.cdadam_state_from_numpy(
            *base, np.asarray(js.hat_buf),
            [np.asarray(h) for h in js.hat_nbr_bufs], like, "cpu")
        back = convert.cdadam_state_to_numpy(ts)
        pairs = ([(back["hat_buf"], js.hat_buf)]
                 + list(zip(back["hat_nbr_bufs"], js.hat_nbr_bufs)))
    assert ts.buf.dtype == ts.m.dtype == torch.bfloat16
    pairs += [(back[k], getattr(js, k)) for k in ("buf", "m", "v")]
    for ours, theirs in pairs:
        assert ours.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(bits(ours), bits(theirs))
    assert back["count"] == 2
    tree = convert.params_to_numpy(ts.params)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(jopt.params_of(js))):
        assert a.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(bits(a), bits(b))


# -------------------------------- the slice ----------------------------------

SK = 4
SLICE_STEPS = 4
SLICE_ETA = 1e-4            # chip_smoke.py's LM_ETA
CD = dict(gamma=0.4, compressor="sign")
STRAGGLE = dict(staleness=2, straggler_rate=0.3, straggler_seed=1)
# The two packages' forward and backward passes sum in different f32
# orders, so a share of the bf16 gradients differs by an ulp, and with them
# the moments and the steps. SLICE_*: their bounds, against at most 1.9e-6
# of the f32 losses (rtol), 0.30% of the buffer's bits (DIFF_SHARE holds
# them), 1.17e-2 of the buffer's change, 1.7e-3 of the moments and 4.3e-4
# of the hats (in the 2-norm) in these cases.
SLICE_LOSS_RTOL = 2e-5
SLICE_CHANGE_RTOL = 3e-2
SLICE_STATE_RTOL = 5e-3
SLICES = {"d-adam": ("d-adam", {}), "cd-adam": ("cd-adam", CD),
          "d-adam-tau2": ("d-adam", STRAGGLE)}


def bf16_configs():
    """The reduced llama3.2-1b (2 layers, d_model 256, vocab 512) with bf16
    params and f32 compute in both packages."""
    jcfg = dataclasses.replace(jget_reduced("llama3.2-1b").model,
                               param_dtype=jnp.bfloat16,
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced("llama3.2-1b").model,
                               param_dtype=torch.bfloat16,
                               compute_dtype=torch.float32)
    return jcfg, tcfg


def swallowed_share(buf0, buf1, m1) -> float:
    """Of the elements whose first Adam step is not zero (m != 0), the
    share whose bf16 value it left unchanged."""
    moved = f32(m1) != 0
    same = bits(buf0) == bits(buf1)
    return float((moved & same).sum() / moved.sum())


def run_slice(kind, opt_kw):
    """Both packages: 1 fit step, then SLICE_STEPS - 1 more. Returns the
    JAX state, the port state, the buffer they started from and both
    swallowed shares of step 1."""
    jcfg, tcfg = bf16_configs()
    p0 = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    batches = [{"tokens": np.random.default_rng(t).integers(
        0, jcfg.vocab_size, (SK, 1, 9)).astype(np.int32)}
        for t in range(SLICE_STEPS)]
    kw = dict(eta=SLICE_ETA, period=2, topology="ring", **opt_kw)
    jopt = jax_make_optimizer(kind, SK, backend="pallas", **kw)
    extra = {}
    if opt_kw.get("straggler_rate"):
        deg = len(jopt.topo.offsets)
        extra["arrival"] = lambda r: np.asarray(
            jdadam._arrival_mask(jopt.cfg, r, SK, deg))
    topt = make_optimizer(kind, SK, device="cpu", backend="packed", **kw,
                          **extra)
    jtr = JaxTrainer(lambda p, b: jbuild_model(jcfg).loss(p, b), jopt)
    ttr = DecentralizedTrainer(stacked_loss(build_model(tcfg).loss), topt)
    jb = iter(jax.tree_util.tree_map(jnp.asarray, b) for b in batches)
    tb = iter({"tokens": torch.from_numpy(b["tokens"])} for b in batches)
    js = jtr.init(p0)
    ts = ttr.init(convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p0), "cpu"))
    assert ts.buf.dtype == ts.m.dtype == ts.v.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(convert.dadam_state_to_numpy(ts)
                                       ["buf"]), bits(js.buf))
    j0, t0 = np.asarray(js.buf), ts.buf.clone()
    js, jlog = jtr.fit(js, jb, 1, log_every=1)
    ts, tlog = ttr.fit(ts, tb, 1, log_every=1)
    shares = (swallowed_share(j0, js.buf, js.m),
              swallowed_share(t0, ts.buf, ts.m))
    js, jlog = jtr.fit(js, jb, SLICE_STEPS - 1, log_every=1, log=jlog)
    ts, tlog = ttr.fit(ts, tb, SLICE_STEPS - 1, log_every=1, log=tlog)
    np.testing.assert_allclose(tlog.loss, jlog.loss, rtol=SLICE_LOSS_RTOL)
    return js, ts, j0, shares


@pytest.mark.parametrize("case", sorted(SLICES))
def test_bf16_param_slice_tracks_jax(case):
    kind, opt_kw = SLICES[case]
    js, ts, buf0, shares = run_slice(kind, opt_kw)
    assert ts.count == int(js.count) == SLICE_STEPS
    for ours, theirs in [(ts.buf, js.buf), (ts.m, js.m), (ts.v, js.v)]:
        assert ours.dtype == torch.bfloat16
        assert np.asarray(theirs).dtype == jnp.bfloat16
    assert (bits(ts.buf) != bits(js.buf)).mean() <= DIFF_SHARE
    err = rel_change_err(ts.buf, js.buf, buf0)
    assert err <= SLICE_CHANGE_RTOL, err
    pairs = [(ts.m, js.m), (ts.v, js.v)]
    if kind == "cd-adam":
        pairs += [(ts.hat_buf, js.hat_buf)] + list(
            zip(ts.hat_nbr_bufs, js.hat_nbr_bufs))
    for ours, theirs in pairs:      # the moments and hats start at 0
        assert ours.dtype == torch.bfloat16
        err = rel_change_err(ours, theirs, np.zeros(ours.shape, np.float32))
        assert err <= SLICE_STATE_RTOL, err
    # bf16 swallows a share of eta 1e-4's first steps (the norm scales at
    # 1.0, whose half ulp is 2**-9, and every parameter past 0.125), the
    # same share in both packages
    jax_share, port_share = shares
    assert 0 < port_share < 1
    assert abs(port_share - jax_share) <= 1e-3, shares
