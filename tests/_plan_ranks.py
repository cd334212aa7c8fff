"""The port's side of the sharding-plan tests (tests/test_torch_plan.py):
rank bodies run under ``repro_torch.launch.mesh.spawn``. The module
imports torch and the port only, never jax; inputs come from an ``.npz``
and results go back as numpy arrays and plain values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._tree import (keystr, tree_map, tree_map_with_path,
                               tree_unflatten)
from repro_torch.analysis import check
from repro_torch.analysis.invariants import check_invariants
from repro_torch.configs import get_reduced
from repro_torch.core.api import make_optimizer
from repro_torch.launch import shardings
from repro_torch.launch.mesh import make_worker_group
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.train import grad as grad_mod
from repro_torch.train.grad import make_grad_pipeline
from repro_torch.train.loop import DecentralizedTrainer, stacked_loss

GROUP_TIMEOUT_S = 60
SEED = 3
BATCH, SEQ = 2, 16
ETA, PERIOD = 1e-3, 2
# the routing test's tokens a sequence: 2 groups of 64, enough that the
# capacity drops pairs
ROUTE_SEQ = 64

# the planned loss and gradient block against the unplanned packed route:
# (arch, K, M, the cuts forced on some leaves, by name: the per-worker dim
# or None for a leaf held whole), on one world of 4 ranks
GRAD_CASES = {
    "llama-M2": ("llama3.2-1b", 2, 2, {}),
    "llama-M4": ("llama3.2-1b", 1, 4, {}),
    "yi-M2": ("yi-6b", 2, 2, {}),
    "starcoder2-M2": ("starcoder2-15b", 2, 2, {}),
    "qwen-M2": ("qwen1.5-32b", 2, 2, {}),
    # the context's other branches: q on its output dim (assembled), k
    # whole, w_down whole after a split hidden, the table on d_model (a
    # row-parallel unembedding)
    "llama-M2-other-cuts": ("llama3.2-1b", 2, 2,
                            {"wq": 2, "wk": None, "w_down": None,
                             "embed": 1}),
    # w_in on its input dim: a whole hidden, b_in assembled
    "starcoder2-M2-other-cuts": ("starcoder2-15b", 2, 2,
                                 {"w_in": 1, "wo": 2}),
}
# the same comparison for the MoE and vision-language families
# (tests/test_torch_plan_moe.py)
FAMILY_CASES = {
    # the MoE and vision-language families: the reduced phi3.5-moe's
    # experts on d_ff (gate and up column-parallel, down row-parallel),
    # the reduced llama4-maverick's on d_model (gate and up row-parallel,
    # a whole hidden sliced for down), the reduced phi-3-vision's projector
    # on its 1024 inputs (row-parallel)
    "phi3.5-moe-M2": ("phi3.5-moe-42b-a6.6b", 2, 2, {}),
    "phi3.5-moe-M4": ("phi3.5-moe-42b-a6.6b", 1, 4, {}),
    "llama4-M2": ("llama4-maverick-400b-a17b", 2, 2, {}),
    "llama4-M4": ("llama4-maverick-400b-a17b", 1, 4, {}),
    "phi3v-M2": ("phi-3-vision-4.2b", 2, 2, {}),
    "phi3v-M4": ("phi-3-vision-4.2b", 1, 4, {}),
    # the other routes (per-worker dims of (L, d, E) and (L, E, d_in,
    # d_out)): the router on E (its logits assembled), gate on d_model
    # and up on d_ff (no split hidden), down on its output (a whole
    # expert output, combined whole); then gate and up on d_ff with down
    # whole (a split hidden assembled) and the router whole; the full
    # config's column-parallel projector
    "phi3.5-moe-M2-other-cuts": ("phi3.5-moe-42b-a6.6b", 2, 2,
                                 {"router": 2, "w_gate": 2, "w_up": 3,
                                  "w_down": 3}),
    "llama4-M2-other-cuts": ("llama4-maverick-400b-a17b", 2, 2,
                             {"router": None, "w_gate": 3, "w_up": 3,
                              "w_down": None}),
    "phi3v-M2-other-cuts": ("phi-3-vision-4.2b", 2, 2, {"projector": 1}),
}
CASES = {**GRAD_CASES, **FAMILY_CASES}


def f32_arch(arch: str):
    """The reduced config at f32 compute, where the planned products'
    other summation order stays within f32 rounding."""
    a = get_reduced(arch)
    return dataclasses.replace(a, model=dataclasses.replace(
        a.model, compute_dtype=torch.float32))


def tokens(arch, K: int, seed: int = SEED) -> dict:
    """A batch of ``arch`` for K workers from ``seed``: the tokens and,
    for the vision-language family, N(0, 1) patch features."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, arch.model.vocab_size, (K, BATCH, SEQ + 1))
    out = {"tokens": torch.from_numpy(t.astype(np.int64))}
    if arch.model.family == "vlm":
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (K, BATCH, arch.model.n_patches, 1024)).astype(np.float32))
    return out


def _forced(cuts: dict):
    """``leaf_cuts`` with the cuts of ``cuts`` (by leaf name) put in."""
    base = shardings.leaf_cuts

    def leaf_cuts(plan, spec):
        out = []
        for lc in base(plan, spec):
            if lc.name in cuts:
                c = cuts[lc.name]
                lc = dataclasses.replace(lc, cut=c, held="whole" if c is None
                                         else "shard")
            out.append(lc)
        return out

    return leaf_cuts


def _group(rank: int, init_method: str, groups: dict, K: int, M: int):
    if (K, M) not in groups:
        groups[(K, M)] = make_worker_group(
            K, model_parallel=M, init_method=init_method, rank=rank,
            device="cpu", backend="gloo", timeout_s=GROUP_TIMEOUT_S)
    return groups[(K, M)]


def grad_rank(rank: int, init_method: str, names) -> dict:
    """Each case of ``names`` on a group over the world's first K M ranks:
    the unplanned and the planned pipeline's (losses, gradient block) on
    one state and batch, their collectives, and the model sums the
    context's formula counts."""
    groups: dict = {}
    out = {}
    for name in names:
        arch_id, K, M, cuts = CASES[name]
        g = _group(rank, init_method, groups, K, M)
        if not g.member:
            out[name] = None
            continue
        saved = shardings.leaf_cuts, grad_mod.leaf_cuts
        if cuts:
            shardings.leaf_cuts = grad_mod.leaf_cuts = _forced(cuts)
        try:
            arch = f32_arch(arch_id)
            api = build_model(arch.model)
            opt = make_optimizer("d-adam", K, backend="packed", comm="axis",
                                 group=g)
            loss = stacked_loss(api.loss)
            state = DecentralizedTrainer(loss, opt).init(
                api.init(torch.Generator().manual_seed(SEED)))
            batch = {k: v[g.rank:g.rank + 1]
                     for k, v in tokens(arch, K).items()}
            res = {}
            for label, plan in (("plain", None),
                                ("planned", shardings.make_plan(arch, g))):
                pipe = make_grad_pipeline(loss, opt, plan=plan)
                g.reset_counts()
                losses, block = pipe.value_and_grad(state, batch)
                res[label] = dict(mode=pipe.mode, loss=float(losses[0]),
                                  block=block.numpy(),
                                  collectives=g.collective_summary())
            res["formula"] = grad_mod.plan_model_sums(
                shardings.make_plan(arch, g), state.spec, arch.model)
            res["block_bytes"] = int(state.buf.nbytes)
            res["cuts"] = {lc.name: (lc.cut, lc.held) for lc in
                           shardings.leaf_cuts(shardings.make_plan(arch, g),
                                               state.spec)}
        finally:
            shardings.leaf_cuts, grad_mod.leaf_cuts = saved
        out[name] = res
    return out


def train_rank(rank: int, init_method: str, inputs: str, steps: int,
               arch_id: str = "llama3.2-1b", tau: float = 1e-6) -> dict:
    """``steps`` steps of the planned trainer (the reduced ``arch_id`` at
    f32 compute, K=2 x M=2, packed D-Adam at p=2 with Adam's ``tau``) from
    JAX's params and
    batches (``inputs``: ``tokens<t>``, and ``patches<t>`` for the
    vision-language family), the log point at every step; then one more
    period of it gated by ``analysis.check.period_spec``."""
    data = dict(np.load(inputs))
    g = make_worker_group(2, model_parallel=2, init_method=init_method,
                          rank=rank, device="cpu", backend="gloo",
                          timeout_s=GROUP_TIMEOUT_S)
    arch = f32_arch(arch_id)
    api = build_model(arch.model)
    opt = make_optimizer("d-adam", 2, backend="packed", comm="axis",
                         group=g, eta=ETA, period=PERIOD, tau=tau)
    trainer = DecentralizedTrainer(stacked_loss(api.loss), opt,
                                   plan=shardings.make_plan(arch, g))
    params = tree_map_with_path(
        lambda p, x: torch.from_numpy(data["param" + keystr(p)]),
        api.init(torch.Generator().manual_seed(0)))
    state = trainer.init(params)
    batches = [{k: torch.from_numpy(data[f"{k}{t}"])
                for k in ("tokens", "patches") if f"{k}{t}" in data}
               for t in range(steps + PERIOD)]
    state, log = trainer.fit(state, iter(batches[:steps]), steps,
                             log_every=1)
    out = {"mode": trainer.pipeline.mode, "loss": list(log.loss),
           "block": state.buf.numpy(), "worker": g.rank,
           "model_rank": g.model_rank}
    spec = check.period_spec(f"planned {arch_id}", trainer, state,
                             steps=PERIOD,
                             activation_bytes=grad_mod.plan_sum_bytes(
                                 arch.model, BATCH, SEQ, 2))
    report = check_invariants(
        lambda: trainer.fit(state, iter(batches[steps:]), PERIOD,
                            log_every=PERIOD), (), spec, g)
    out["report_ok"] = report.ok
    out["report"] = report.format(verbose=False)
    out["summary"] = report.summary
    out["expected_sums"] = spec.collective_counts["model_sum"]
    out["formula"] = grad_mod.plan_model_sums(trainer._plan, state.spec,
                                              arch.model)
    return out


def planned_moe_layer(g, arch):
    """(the whole first MoE layer's params on the CPU, the rank's plan
    shards of them on the group's device, the rank's ``PlanCtx``) for the
    reduced ``arch`` from a seed, through the planned pipeline's own
    redistribution of the rank's packed block."""
    api = build_model(arch.model)
    opt = make_optimizer("d-adam", g.K, backend="packed", comm="axis",
                         group=g)
    params = api.init(torch.Generator().manual_seed(SEED))
    state = DecentralizedTrainer(stacked_loss(api.loss), opt).init(
        tree_map(lambda x: x.to(g.device), params))
    plan = shardings.make_plan(arch, g)
    rd = shardings.Redistribution(state.spec, plan, g.model_rank)
    shards = tree_unflatten(state.spec.treedef, [
        x.to(dt) for x, dt in zip(rd.to_shards(state.buf, g),
                                  state.spec.dtypes)])
    whole = tree_map(lambda x: x[0], params["layers"]["moe"])
    mine = tree_map(lambda x: x[0, 0], shards["layers"]["moe"])
    return whole, mine, grad_mod.PlanCtx(g, rd.cuts)


def route_rank(rank: int, init_method: str, arch_ids) -> dict:
    """For each reduced MoE config of ``arch_ids`` on a K=2 x M=2 group:
    one drawn hidden (the same on every rank) through the first MoE
    layer, routed and forwarded with the rank's plan shards and with the
    whole layer: the routing's experts, kept pairs and dispatch tensor,
    and both outputs and aux losses."""
    g = make_worker_group(2, model_parallel=2, init_method=init_method,
                          rank=rank, device="cpu", backend="gloo",
                          timeout_s=GROUP_TIMEOUT_S)
    out = {"worker": g.rank, "model_rank": g.model_rank}
    for arch_id in arch_ids:
        arch = f32_arch(arch_id)
        cfg = arch.model
        whole, mine, ctx = planned_moe_layer(g, arch)
        x = torch.randn((BATCH, ROUTE_SEQ, cfg.d_model),
                        generator=torch.Generator().manual_seed(SEED + 1))
        kw = dict(top_k=cfg.experts_per_token,
                  capacity_factor=cfg.capacity_factor,
                  group_size=cfg.moe_group_size)
        res = {}
        for label, params, shard in (("plain", whole, None),
                                     ("planned", mine, ctx)):
            r = moe.route(params, x, shard=shard, **kw)
            y, aux = moe.moe_forward(params, x, shard=shard, **kw)
            res[label] = {"gate_idx": r.gate_idx.numpy(),
                          "keep": r.keep.numpy(), "disp": r.disp.numpy(),
                          "probs": r.probs.numpy(), "out": y.numpy(),
                          "aux": float(aux)}
        out[arch_id] = res
    return out


def cuda_moe_rank(rank: int, init_method: str, arch_id: str) -> dict:
    """The planned MoE layer on the card (a K=1 x M=2 gloo group of two
    ranks sharing it, staged through host memory) against the whole
    layer's plain forward on the CPU, on one drawn hidden: both outputs
    and aux losses, and whether the card's routing kept the CPU's
    pairs."""
    g = make_worker_group(1, model_parallel=2, init_method=init_method,
                          rank=rank, device="cuda", backend="gloo",
                          timeout_s=GROUP_TIMEOUT_S)
    arch = f32_arch(arch_id)
    cfg = arch.model
    whole, mine, ctx = planned_moe_layer(g, arch)
    x = torch.randn((BATCH, SEQ, cfg.d_model),
                    generator=torch.Generator().manual_seed(SEED + 1))
    kw = dict(top_k=cfg.experts_per_token,
              capacity_factor=cfg.capacity_factor,
              group_size=cfg.moe_group_size)
    y, aux = moe.moe_forward(mine, x.to("cuda"), shard=ctx, **kw)
    keep = moe.route(mine, x.to("cuda"), shard=ctx, **kw).keep
    y0, aux0 = moe.moe_forward(whole, x, **kw)
    keep0 = moe.route(whole, x, **kw).keep
    return {"out": y.cpu().numpy(), "aux": float(aux),
            "out_cpu": y0.numpy(), "aux_cpu": float(aux0),
            "keep_equal": bool(torch.equal(keep.cpu(), keep0))}
