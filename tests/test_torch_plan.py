"""The 2D layout's sharding plan for the dense family
(``repro_torch.launch.shardings.make_plan`` / ``param_pspec``,
``train.grad``'s planned mode) against the JAX package.

* The rule engine: the port's ``param_pspec`` gives, for every leaf of
  every config (full and reduced) at M in {1, 2, 4, 8}, the dim where
  JAX's ``param_pspec`` puts ``'model'`` (on a stub mesh with only
  ``.shape``; the port's full-width shapes from a ``FakeTensorMode``
  init, so nothing of full width is allocated).
* The planned loss and gradient block equal the unplanned packed route's
  within 2e-5 at f32 compute on the four reduced dense configs (llama at
  M=2 and M=4, where the plan replicates ``wk`` / ``wv``), and with other
  cuts forced on some leaves (the context's other branches); no
  model all-gather, two redistributions, the model sums the formula
  counts, every matrix held as its 1/M shard.
* Two planned trainer steps of the reduced llama at K=2 x M=2 against
  JAX's planned run (``tests/_jax_plan.py``, 4 host devices): losses and
  buffers within 2e-5; then a period gated by ``period_spec``, exact.
* A plan for the ssm, hybrid or audio family raises on the 2D packed
  mode (the MoE and vision-language families take it:
  tests/test_torch_plan_moe.py); the TPU meshes' modes raise; the CLI
  runs the plan at its default bf16.
"""
import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import _plan_ranks as pr
from repro.configs import get_arch as jget_arch
from repro.configs import get_reduced as jget_reduced
from repro.launch import shardings as jsh
from repro.models import build_model as jbuild_model
from repro_torch._tree import keystr, tree_map_with_path
from repro_torch.configs import get_arch, get_reduced, list_archs
from repro_torch.core.api import make_optimizer
from repro_torch.core.dadam import lazy_zeros
from repro_torch.kernels import pack as packing
from repro_torch.launch import shardings
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import WorkerGroup, spawn
from repro_torch.models.registry import build_model
from repro_torch.train.grad import make_grad_pipeline

torch.set_num_threads(2)
SPAWN_TIMEOUT_S = 300
JAX_TIMEOUT_S = 400
TOL = dict(rtol=2e-5, atol=2e-5)
K = 2
STEPS = 2


# ------------------------------ the rule engine -----------------------------


@functools.lru_cache(maxsize=None)
def port_shapes(arch: str, full: bool) -> dict:
    cfg = (get_arch if full else get_reduced)(arch).model
    with FakeTensorMode():
        params = build_model(cfg).init(torch.Generator())
    out = {}
    tree_map_with_path(lambda p, x: out.__setitem__(keystr(p),
                                                    tuple(x.shape)), params)
    return out


@functools.lru_cache(maxsize=None)
def jax_shapes(arch: str, full: bool) -> dict:
    cfg = (jget_arch if full else jget_reduced)(arch).model
    sds = jax.eval_shape(jbuild_model(cfg).init, jax.random.PRNGKey(0))
    return {jax.tree_util.keystr(p): (p, tuple(x.shape))
            for p, x in jax.tree_util.tree_flatten_with_path(sds)[0]}


def jax_model_dim(arch: str, full: bool, M: int, path, shape):
    mesh = types.SimpleNamespace(shape={"worker": K, "model": M})
    plan = jsh.make_plan((jget_arch if full else jget_reduced)(arch), mesh,
                         multi_pod=False, mode="axis")
    spec = jsh.param_pspec(plan, path, (K,) + shape, stacked=True)
    entries = tuple(spec) + (None,) * (len(shape) + 1 - len(spec))
    assert set(entries) <= {None, "worker", "model"}, spec
    return entries.index("model") if "model" in entries else None


@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_pspec_equals_jax(arch, full, M):
    theirs = jax_shapes(arch, full)
    ours = port_shapes(arch, full)
    assert sorted(ours) == sorted(theirs)
    plan = shardings.make_plan((get_arch if full else get_reduced)(arch),
                               (K, M))
    for key, (path, shape) in theirs.items():
        assert ours[key] == shape, key
        got = shardings.param_pspec(plan, key, (K,) + shape, stacked=True)
        assert got == jax_model_dim(arch, full, M, path, shape), (key, M)


def test_make_plan_modes_and_groups():
    arch = get_reduced("llama3.2-1b")
    for mode in ("stacked", "pods", "global"):
        with pytest.raises(NotImplementedError, match="TPU"):
            shardings.make_plan(arch, (2, 2), mode=mode)
    with pytest.raises(ValueError, match="unknown"):
        shardings.make_plan(arch, (2, 2), mode="nope")
    wg = WorkerGroup(group=None, rank=0, K=4, device=torch.device("cpu"),
                     backend="gloo", M=4)
    plan = shardings.make_plan(arch, (2, 2)).for_group(wg)
    assert (plan.K, plan.M, plan.model_cfg) == (4, 4, arch.model)


def test_pack_block_is_the_whole_buffers_block():
    """The 2D init packs a rank's block straight from the params (and
    zero moments as expanded scalars): equal to the bit to the block of
    the whole buffer."""
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(1, 300, 70, generator=g),
            "b": torch.randn(1, 5, generator=g),
            "c": torch.randn(1, 3, 33000, generator=g)}
    for M in (2, 4):
        spec = packing.make_spec(tree, stacked=True, block_rows=256,
                                 leaf_align=True, row_shards=M)
        whole = packing.pack(tree, spec)
        zeros = {k: lazy_zeros(v) for k, v in tree.items()}
        for j in range(M):
            rows = slice(j * spec.local_rows, (j + 1) * spec.local_rows)
            assert torch.equal(packing.pack(tree, spec, block=j),
                               whole[:, rows])
            assert torch.equal(packing.pack(zeros, spec, block=j),
                               torch.zeros(spec.block_shape()))


@pytest.mark.parametrize("topo", ["ring-2", "ring-8", "torus-8",
                                  "exponential-8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_received_mix_equals_the_mix_to_the_bit(topo, dtype):
    """The axis round's mix made in the first received block's memory
    (``dadam._mix_received``, what lets a full-width 2D round fit four
    ranks' state on one card) equals ``_mix_trees``'s to the bit."""
    from repro_torch.core import dadam
    from repro_torch.core.topology import make_topology

    name, k = topo.rsplit("-", 1)
    t = make_topology(name, int(k))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 700, 128, generator=g).to(dtype)
    nbrs = [torch.randn(1, 700, 128, generator=g).to(dtype)
            for _ in t.offsets]
    want = dadam._mix_trees(x, [n.clone() for n in nbrs], t)
    got = dadam._mix_received(x, [n.clone() for n in nbrs], t, rows=1000)
    assert got.dtype == dtype and torch.equal(got, want)


# ------------------------- planned against unplanned -------------------------


@pytest.fixture(scope="module")
def grads():
    ranks = spawn(pr.grad_rank, 4, (sorted(pr.GRAD_CASES),),
                  timeout_s=SPAWN_TIMEOUT_S, threads=1)
    return {n: [r[n] for r in ranks if r[n] is not None]
            for n in pr.GRAD_CASES}


@pytest.mark.parametrize("name", sorted(pr.GRAD_CASES))
def test_planned_loss_and_block_equal_unplanned(name, grads):
    arch, Kc, M, _ = pr.GRAD_CASES[name]
    assert len(grads[name]) == Kc * M
    for r in grads[name]:
        plain, planned = r["plain"], r["planned"]
        assert (plain["mode"], planned["mode"]) == ("packed", "planned")
        np.testing.assert_allclose(planned["loss"], plain["loss"], **TOL)
        np.testing.assert_allclose(planned["block"], plain["block"], **TOL)


@pytest.mark.parametrize("name", sorted(pr.GRAD_CASES))
def test_planned_collectives(name, grads):
    """No model all-gather; two redistributions (out and back), each at
    most one block; the model sums ``plan_model_sums`` counts; every
    matrix held as its 1/M shard but where the plan (or the case)
    replicates it."""
    arch, Kc, M, forced = pr.GRAD_CASES[name]
    for r in grads[name]:
        assert r["plain"]["collectives"]["model_all_gather"]["count"] == 1
        coll = r["planned"]["collectives"]
        assert coll["model_all_gather"]["count"] == 0
        assert coll["model_redistribute"]["count"] == 2
        assert 0 < coll["model_redistribute"]["max_bytes"] <= \
            r["block_bytes"]
        assert coll["model_sum"]["count"] == r["formula"]
        whole = {n for n, (_, held) in r["cuts"].items()
                 if held == "whole"}
        matrices = {"embed", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                    "w_down", "w_in", "w_out", "lm_head"} & set(r["cuts"])
        replicated = {n for n, c in forced.items() if c is None}
        if arch == "llama3.2-1b" and M == 4:
            replicated |= {"wk", "wv"}
        assert matrices & whole == replicated


# ------------------------- the trainer against JAX --------------------------


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    d = tmp_path_factory.mktemp("plan")
    rng = np.random.default_rng(5)
    arrays = {f"tokens{t}": rng.integers(
        0, 512, (K, pr.BATCH, pr.SEQ + 1)).astype(np.int32)
        for t in range(STEPS + pr.PERIOD)}
    np.savez(d / "tokens.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).with_name("_jax_plan.py")),
         str(d / "tokens.npz"), str(d / "jax.npz"), str(STEPS)],
        capture_output=True, text=True, env=env, timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = dict(np.load(d / "jax.npz"))
    np.savez(d / "port.npz", **arrays,
             **{k: v for k, v in want.items() if k.startswith("param")})
    got = spawn(pr.train_rank, 4, (str(d / "port.npz"), STEPS),
                timeout_s=SPAWN_TIMEOUT_S, threads=1)
    return want, got


def test_planned_trainer_matches_jax(jax_and_port):
    want, got = jax_and_port
    rows = want["buf"].shape[1] // 2
    for r in got:
        assert r["mode"] == "planned"
        np.testing.assert_allclose(r["loss"], want["loss"], **TOL)
        w, m = r["worker"], r["model_rank"]
        np.testing.assert_allclose(
            r["block"], want["buf"][w:w + 1, m * rows:(m + 1) * rows], **TOL)


def test_period_spec_of_a_planned_trainer_is_exact(jax_and_port):
    """JAX's figure of 0 model all-gathers a step, 2 redistributions a
    step, and the model sums exactly: 2 steps x (6 L + 3) + the log's."""
    for r in jax_and_port[1]:
        assert r["report_ok"], r["report"]
        s = r["summary"]
        assert s["model_all_gather"]["count"] == 0
        assert s["model_redistribute"]["count"] == 2 * pr.PERIOD
        assert s["model_sum"]["count"] == r["expected_sums"] == \
            pr.PERIOD * (6 * 2 + 3) + 1


# ------------------------------ refusals, CLI --------------------------------


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "rwkv6-3b",
                                  "zamba2-7b", "phi-3-vision-4.2b",
                                  "whisper-large-v3"])
def test_plan_for_a_family_not_dense_raises(arch):
    wg = WorkerGroup(group=None, rank=0, K=K, device=torch.device("cpu"),
                     backend="gloo", M=2)
    opt = make_optimizer("d-adam", K, backend="packed", comm="axis",
                         group=wg)
    plan = shardings.make_plan(get_reduced(arch), wg)
    if get_reduced(arch).model.family in ("moe", "vlm"):
        # the MoE and vision-language families take the plan
        # (tests/test_torch_plan_moe.py)
        assert make_grad_pipeline(lambda p, b: p, opt,
                                  plan=plan).mode == "planned"
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 4.3"):
            make_grad_pipeline(lambda p, b: p, opt, plan=plan)
    # outside the 2D packed mode it changes nothing, as in JAX
    one_d = make_optimizer("d-adam", K, backend="packed", device="cpu")
    assert make_grad_pipeline(lambda p, b: p, one_d, plan=plan).mode == \
        "packed"


def test_cli_runs_the_plan_at_bf16():
    """``--model-parallel 2`` builds the arch's plan and trains the reduced
    llama at its bf16 compute end to end: finite losses from near ln V
    (the planned bf16 products sum in another order than the 1D run's;
    the comparison with it runs at f32, tests/test_torch_grad_2d.py)."""
    argv = ["--device", "cpu", "--comm", "axis", "--workers", "2",
            "--backend", "packed", "--steps", "2", "--period", "2",
            "--seq", "16", "--batch", "1", "--log-every", "1",
            "--dist-backend", "gloo", "--model-parallel", "2"]
    run = train_cli.main(argv)
    assert np.isfinite(run.log.loss).all() and len(run.log.loss) == 2
    assert run.log.loss[0] == pytest.approx(np.log(512), rel=0.05)
