"""The 2D layout's sharding plan for the MoE and vision-language families
(``train.grad``'s planned mode with ``models.moe`` and ``models.vlm``
under ``shard=``) against the unplanned route and the JAX package.

* The cuts: every expert leaf, the router and the projector held as the
  1/M shard of the dim ``param_pspec`` picks (the reduced phi3.5-moe's
  experts on d_ff, the reduced llama4-maverick's gate and up on d_model,
  the reduced phi-3-vision's projector on its 1024 inputs).
* The planned loss and gradient block equal the unplanned packed route's
  within 2e-5 at f32 compute on the three reduced configs at M=2 and
  M=4, and with other cuts forced on the router, the experts and the
  projector (the context's other branches); no model all-gather, two
  redistributions, the model sums ``plan_model_sums`` counts.
* The routing: the experts, the kept pairs and the dispatch tensor equal
  to the bit on every rank of a group, the dropped pairs the unplanned
  forward's, the planned layer's output and aux loss within 2e-5.
* Two planned trainer steps of the reduced phi3.5-moe and phi-3-vision at
  K=2 x M=2 against JAX's planned run (``tests/_jax_plan.py``, Adam's tau
  at ``JAX_TAU``): losses and buffers within 2e-5; then a period gated by
  ``period_spec``, exact. At the default tau 1e-6 JAX's own planned and
  unplanned runs part past 2e-5, which is why.
* The CLI at ``--model-parallel 2`` trains both families at bf16.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _plan_ranks as pr
from repro_torch._tree import tree_map
from repro_torch.configs import get_reduced
from repro_torch.kernels import pack as packing
from repro_torch.launch import shardings
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import spawn
from repro_torch.launch.shardings import LeafCut
from repro_torch.models.registry import build_model
from repro_torch.train import grad as grad_mod

torch.set_num_threads(2)
SPAWN_TIMEOUT_S = 300
JAX_TIMEOUT_S = 400
TOL = dict(rtol=2e-5, atol=2e-5)
K = 2
STEPS = 2
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b")
JAX_ARCHS = ("phi3.5-moe-42b-a6.6b", "phi-3-vision-4.2b")
# Adam's tau in the trainer comparison with JAX. At the default 1e-6 an
# element whose gradient is near zero takes a step set by the gradient's
# rounding (up to eta / tau = 1000 times it): the port's blocks part from
# JAX's planned run by up to 2.3e-5 (phi3.5-moe, 1 element past 2e-5) and
# 8.6e-5 (phi-3-vision, 2), and JAX's own planned and unplanned runs by
# 3.6e-5 and 2.7e-5 (2 elements each; held past TOL by
# test_jax_plan_parts_from_its_unplanned_run_at_the_default_tau). At 1e-3
# a gradient far below 1e-3 takes a step proportional to it, so the
# blocks measure the planned products, within the same 2e-5.
JAX_TAU = 1e-3
# the per-worker cut dim of each leaf at M=2 (param_pspec's, over (L, d,
# E), (L, E, d, d_ff), (L, E, d_ff, d) and (1024, d))
CUTS = {"phi3.5-moe-42b-a6.6b": {"router": 1, "w_gate": 3, "w_up": 3,
                                 "w_down": 2},
        "llama4-maverick-400b-a17b": {"router": 1, "w_gate": 2, "w_up": 2,
                                      "w_down": 2},
        "phi-3-vision-4.2b": {"projector": 0}}


# --------------------------- the cuts, on the host ---------------------------


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("arch", sorted(CUTS))
def test_leaf_cuts_of_experts_router_and_projector(arch, M):
    a = get_reduced(arch)
    params = build_model(a.model).init(torch.Generator().manual_seed(0))
    spec = packing.make_spec(tree_map(lambda x: x[None], params),
                             stacked=True, leaf_align=True, row_shards=M)
    cuts = {lc.name: lc for lc in shardings.leaf_cuts(
        shardings.make_plan(a, (K, M)), spec)}
    for name, dim in CUTS[arch].items():
        lc = cuts[name]
        assert (lc.cut, lc.held) == (dim, "shard"), (name, lc)
        shape = list(lc.shape)
        shape[dim] //= M
        assert lc.shard_shape(M) == tuple(shape)
    # the expert weights are cut among their matrix dims, never on E
    for name in ("w_gate", "w_up", "w_down"):
        if name in cuts:
            assert grad_mod.matrix_cut(cuts[name]) in (0, 1)


def test_plan_ctx_refuses_an_expert_dim_cut_and_a_clash():
    wg = type("G", (), {"M": 2, "model_rank": 0})()
    expert_dim = LeafCut("w_gate", (2, 4, 8, 8), True, 1, "shard")
    with pytest.raises(ValueError, match="expert dim"):
        grad_mod.PlanCtx(wg, [expert_dim])
    a = LeafCut("w_down", (2, 8, 8), True, 1, "shard")      # input dim
    b = LeafCut("w_down", (2, 4, 8, 8), True, 3, "shard")   # output dim
    with pytest.raises(ValueError, match="cut differently"):
        grad_mod.PlanCtx(wg, [a, b])
    # the same matrix cut under one name, dense and expert, is no clash
    c = LeafCut("w_down", (2, 4, 8, 8), True, 2, "shard")
    assert grad_mod.PlanCtx(wg, [a, c]).cut("w_down") == 0


def test_plan_sum_bytes_covers_the_router_and_the_expert_slots():
    moe_cfg = get_reduced("phi3.5-moe-42b-a6.6b").model
    dense = get_reduced("llama3.2-1b").model
    # 32 tokens: one group of 32, capacity 20 a expert: 80 slots of 2 d_ff
    assert grad_mod.plan_sum_bytes(moe_cfg, 2, 16, 2) == \
        4 * 4 * 20 * 2 * moe_cfg.d_ff
    vlm = get_reduced("phi-3-vision-4.2b").model
    assert grad_mod.plan_sum_bytes(vlm, 2, 16, 2) == \
        4 * 2 * (16 + vlm.n_patches) * max(vlm.d_ff, 3 * vlm.d_model)
    # the router's E logits a token bound a call when E is the widest
    wide = dataclasses.replace(dense, d_ff=8, n_heads=1, n_kv_heads=1,
                               d_model=8, n_experts=64, experts_per_token=1)
    assert grad_mod.plan_sum_bytes(wide, 1, 8, 2) >= 4 * 8 * 64


# ------------------------- planned against unplanned -------------------------


@pytest.fixture(scope="module")
def grads():
    ranks = spawn(pr.grad_rank, 4, (sorted(pr.FAMILY_CASES),),
                  timeout_s=SPAWN_TIMEOUT_S, threads=1)
    return {n: [r[n] for r in ranks if r[n] is not None]
            for n in pr.FAMILY_CASES}


@pytest.mark.parametrize("name", sorted(pr.FAMILY_CASES))
def test_planned_moe_vlm_loss_and_block_equal_unplanned(name, grads):
    arch, Kc, M, _ = pr.FAMILY_CASES[name]
    assert len(grads[name]) == Kc * M
    for r in grads[name]:
        plain, planned = r["plain"], r["planned"]
        assert (plain["mode"], planned["mode"]) == ("packed", "planned")
        np.testing.assert_allclose(planned["loss"], plain["loss"], **TOL)
        np.testing.assert_allclose(planned["block"], plain["block"], **TOL)


@pytest.mark.parametrize("name", sorted(pr.FAMILY_CASES))
def test_planned_moe_vlm_collectives(name, grads):
    """No model all-gather; two redistributions, each at most one block;
    the model sums ``plan_model_sums`` counts; the router, the experts
    and the projector held as their shards where the plan (or the case)
    cuts them."""
    arch, Kc, M, forced = pr.FAMILY_CASES[name]
    for r in grads[name]:
        coll = r["planned"]["collectives"]
        assert coll["model_all_gather"]["count"] == 0
        assert coll["model_redistribute"]["count"] == 2
        assert 0 < coll["model_redistribute"]["max_bytes"] <= \
            r["block_bytes"]
        assert coll["model_sum"]["count"] == r["formula"]
        for leaf in ("router", "w_gate", "w_up", "w_down", "projector"):
            if leaf in r["cuts"]:
                held = r["cuts"][leaf][1]
                assert held == ("whole" if forced.get(leaf, 0) is None
                                else "shard"), (leaf, r["cuts"][leaf])


# ------------------------------- the routing --------------------------------


@pytest.fixture(scope="module")
def routes():
    return spawn(pr.route_rank, 4, (MOE_ARCHS,), timeout_s=SPAWN_TIMEOUT_S,
                 threads=1)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_is_the_same_bits_on_every_rank(arch, routes):
    for r in routes:
        first = next(q for q in routes if q["worker"] == r["worker"])
        for key in ("gate_idx", "keep", "disp", "probs"):
            np.testing.assert_array_equal(r[arch]["planned"][key],
                                          first[arch]["planned"][key])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dropped_pairs_equal_the_unplanned_forwards(arch, routes):
    for r in routes:
        plain, planned = r[arch]["plain"], r[arch]["planned"]
        np.testing.assert_array_equal(planned["gate_idx"], plain["gate_idx"])
        np.testing.assert_array_equal(planned["keep"], plain["keep"])
        np.testing.assert_array_equal(planned["disp"], plain["disp"])
    # the capacity drops pairs at this size: the comparison covers drops
    assert (~routes[0][arch]["plain"]["keep"]).sum() > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_planned_moe_layer_equals_unplanned(arch, routes):
    for r in routes:
        plain, planned = r[arch]["plain"], r[arch]["planned"]
        np.testing.assert_allclose(planned["out"], plain["out"], **TOL)
        np.testing.assert_allclose(planned["aux"], plain["aux"], **TOL)


# ------------------------- the trainer against JAX --------------------------


def write_inputs(arch: str, path: Path) -> None:
    """The batches of the trainer comparison, drawn from a seed with
    numpy: tokens, and patch features for the vision-language family."""
    cfg = get_reduced(arch).model
    rng = np.random.default_rng(5)
    arrays = {}
    for t in range(STEPS + pr.PERIOD):
        arrays[f"tokens{t}"] = rng.integers(
            0, cfg.vocab_size, (K, pr.BATCH, pr.SEQ + 1)).astype(np.int32)
        if cfg.family == "vlm":
            arrays[f"patches{t}"] = rng.standard_normal(
                (K, pr.BATCH, cfg.n_patches, 1024)).astype(np.float32)
    np.savez(path, **arrays)


def run_jax(inputs: Path, out: Path, arch: str, tau: float,
            *extra: str) -> dict:
    """JAX's planned trainer (``extra`` ``"none"``: without the plan) on
    ``inputs`` for STEPS steps, in a subprocess (``tests/_jax_plan.py``)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).with_name("_jax_plan.py")),
         str(inputs), str(out), str(STEPS), arch, str(tau), *extra],
        capture_output=True, text=True, env=env, timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module", params=JAX_ARCHS)
def jax_and_port(request, tmp_path_factory):
    arch = request.param
    d = tmp_path_factory.mktemp("plan_moe")
    write_inputs(arch, d / "inputs.npz")
    want = run_jax(d / "inputs.npz", d / "jax.npz", arch, JAX_TAU)
    np.savez(d / "port.npz", **np.load(d / "inputs.npz"),
             **{k: v for k, v in want.items() if k.startswith("param")})
    got = spawn(pr.train_rank, 4, (str(d / "port.npz"), STEPS, arch,
                                   JAX_TAU),
                timeout_s=SPAWN_TIMEOUT_S, threads=1)
    return arch, want, got


def test_planned_moe_vlm_trainer_matches_jax(jax_and_port):
    _, want, got = jax_and_port
    rows = want["buf"].shape[1] // 2
    for r in got:
        assert r["mode"] == "planned"
        np.testing.assert_allclose(r["loss"], want["loss"], **TOL)
        w, m = r["worker"], r["model_rank"]
        np.testing.assert_allclose(
            r["block"], want["buf"][w:w + 1, m * rows:(m + 1) * rows], **TOL)


def test_period_spec_of_a_planned_moe_vlm_trainer_is_exact(jax_and_port):
    """0 model all-gathers and 2 redistributions a step, and the model
    sums exactly: 2 steps x the formula + the log's, the formula 9 L + 3
    for the reduced phi3.5-moe (the router 2, the experts 3 of them the
    gates' cotangent) and 6 L + 4 for the reduced phi-3-vision (the
    projector's 1)."""
    arch, _, got = jax_and_port
    per = {"phi3.5-moe-42b-a6.6b": 9 * 2 + 3, "phi-3-vision-4.2b": 6 * 2 + 4}
    for r in got:
        assert r["report_ok"], r["report"]
        s = r["summary"]
        assert s["model_all_gather"]["count"] == 0
        assert s["model_redistribute"]["count"] == 2 * pr.PERIOD
        assert r["formula"] == per[arch]
        assert s["model_sum"]["count"] == r["expected_sums"] == \
            pr.PERIOD * per[arch] + 1


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_jax_plan_parts_from_its_unplanned_run_at_the_default_tau(
        arch, tmp_path):
    """Why the trainer comparison runs at JAX_TAU: at Adam's default tau
    1e-6 JAX's own planned and unplanned runs of the same params and
    batches agree in the losses within TOL, yet their buffers part past
    TOL. The plan only sums the same gradients in another order; an
    element whose gradient is near zero steps by eta * g / (|g| + tau),
    which turns a rounding of g into up to eta / tau = 1000 times as
    much."""
    write_inputs(arch, tmp_path / "inputs.npz")
    plan, none = (run_jax(tmp_path / "inputs.npz", tmp_path / f"{n}.npz",
                          arch, 1e-6, *extra)
                  for n, extra in (("plan", ()), ("none", ("none",))))
    np.testing.assert_allclose(plan["loss"], none["loss"], **TOL)
    assert not np.allclose(plan["buf"], none["buf"], **TOL)


# ---------------------------------- the CLI ----------------------------------


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_cli_runs_the_moe_and_vlm_plans_at_bf16(arch):
    """``--model-parallel 2`` builds the arch's plan and trains the
    reduced config at its bf16 compute end to end: finite losses, step
    1's within 1e-2 of the 1D run's (``--comm stacked``, the same params
    and batches; the planned bf16 products sum in another order, and the
    f32 comparison is above)."""
    argv = ["--device", "cpu", "--workers", "2", "--backend", "packed",
            "--steps", "2", "--period", "2", "--seq", "16", "--batch", "1",
            "--log-every", "1", "--arch", arch]
    run = train_cli.main(argv + ["--comm", "axis", "--dist-backend", "gloo",
                                 "--model-parallel", "2"])
    one_d = train_cli.main(argv)
    assert np.isfinite(run.log.loss).all() and len(run.log.loss) == 2
    assert run.log.loss[0] == pytest.approx(one_d.log.loss[0], rel=1e-2)
