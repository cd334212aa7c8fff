"""The port's side of the sharding-plan tests (tests/test_torch_plan.py):
rank bodies run under ``repro_torch.launch.mesh.spawn``. The module
imports torch and the port only, never jax; inputs come from an ``.npz``
and results go back as numpy arrays and plain values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._tree import keystr, tree_map_with_path
from repro_torch.analysis import check
from repro_torch.analysis.invariants import check_invariants
from repro_torch.configs import get_reduced
from repro_torch.core.api import make_optimizer
from repro_torch.launch import shardings
from repro_torch.launch.mesh import make_worker_group
from repro_torch.models.registry import build_model
from repro_torch.train import grad as grad_mod
from repro_torch.train.grad import make_grad_pipeline
from repro_torch.train.loop import DecentralizedTrainer, stacked_loss

GROUP_TIMEOUT_S = 60
SEED = 3
BATCH, SEQ = 2, 16
ETA, PERIOD = 1e-3, 2

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


def f32_arch(arch: str):
    """The reduced config at f32 compute, where the planned products'
    other summation order stays within f32 rounding."""
    a = get_reduced(arch)
    return dataclasses.replace(a, model=dataclasses.replace(
        a.model, compute_dtype=torch.float32))


def tokens(arch, K: int, seed: int = SEED) -> dict:
    rng = np.random.default_rng(seed)
    t = rng.integers(0, arch.model.vocab_size, (K, BATCH, SEQ + 1))
    return {"tokens": torch.from_numpy(t.astype(np.int64))}


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
        arch_id, K, M, cuts = GRAD_CASES[name]
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
            batch = tokens(arch, K)
            batch = {"tokens": batch["tokens"][g.rank:g.rank + 1]}
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


def train_rank(rank: int, init_method: str, inputs: str,
               steps: int) -> dict:
    """``steps`` steps of the planned trainer (reduced llama3.2-1b at f32
    compute, K=2 x M=2, packed D-Adam at p=2) from JAX's params and
    batches (``inputs``), the log point at every step; then one more
    period of it gated by ``analysis.check.period_spec``."""
    data = dict(np.load(inputs))
    g = make_worker_group(2, model_parallel=2, init_method=init_method,
                          rank=rank, device="cpu", backend="gloo",
                          timeout_s=GROUP_TIMEOUT_S)
    arch = f32_arch("llama3.2-1b")
    api = build_model(arch.model)
    opt = make_optimizer("d-adam", 2, backend="packed", comm="axis",
                         group=g, eta=ETA, period=PERIOD)
    trainer = DecentralizedTrainer(stacked_loss(api.loss), opt,
                                   plan=shardings.make_plan(arch, g))
    params = tree_map_with_path(
        lambda p, x: torch.from_numpy(data["param" + keystr(p)]),
        api.init(torch.Generator().manual_seed(0)))
    state = trainer.init(params)
    batches = [{"tokens": torch.from_numpy(data[f"tokens{t}"])}
               for t in range(steps + PERIOD)]
    state, log = trainer.fit(state, iter(batches[:steps]), steps,
                             log_every=1)
    out = {"mode": trainer.pipeline.mode, "loss": list(log.loss),
           "block": state.buf.numpy(), "worker": g.rank,
           "model_rank": g.model_rank}
    spec = check.period_spec("planned llama", trainer, state, steps=PERIOD,
                              activation_bytes=grad_mod.plan_sum_bytes(
                                  arch.model, BATCH * SEQ, 2))
    report = check_invariants(
        lambda: trainer.fit(state, iter(batches[steps:]), PERIOD,
                            log_every=PERIOD), (), spec, g)
    out["report_ok"] = report.ok
    out["report"] = report.format(verbose=False)
    out["summary"] = report.summary
    out["expected_sums"] = spec.collective_counts["model_sum"]
    return out
