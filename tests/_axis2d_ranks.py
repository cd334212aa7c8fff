"""The port's side of the 2D worker x model parity tests
(tests/test_torch_axis_2d.py, tests/test_torch_grad_2d.py): the case
runners, stacked in the test's process or under ``comm='axis'`` in the
ranks of a group spawned by ``repro_torch.launch.mesh.spawn``. The module
imports torch and the port only, never jax; inputs come from an ``.npz``
and results go back as numpy arrays and plain values. The cases are the
dicts of ``tests/_jax_axis_2d.py``, which runs the same ones in JAX.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core.api import make_optimizer
from repro_torch.kernels import ops
from repro_torch.kernels import pack as packing
from repro_torch.launch.mesh import make_worker_group, model_sum
from repro_torch.launch.shardings import gather_model, gather_workers
from repro_torch.train.grad import row_parallel_dot
from repro_torch.train.loop import DecentralizedTrainer, stacked_loss

GROUP_TIMEOUT_S = 60
JAX_TIMEOUT_S = 400
BACKEND = {"pallas": "packed", "reference": "reference"}
D_H = 128   # the two-layer model's hidden width


def run_jax(inputs, cases: dict, out,
            script: str = "_jax_axis_2d.py") -> dict:
    """JAX's runs of ``cases`` (``tests/<script>``, by default
    ``_jax_axis_2d.py``, in a subprocess with 8 host devices):
    ``{case: {field: array}}``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script = Path(__file__).with_name(script)
    proc = subprocess.run(
        [sys.executable, str(script), str(inputs), json.dumps(cases),
         str(out)], capture_output=True, text=True, env=env,
        timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res: dict = {}
    with np.load(out) as data:
        for key in data.files:
            name, field = key.split("|")
            res.setdefault(name, {})[field] = data[key]
    return res


def group_of(K: int, M: int, init_method: str):
    return make_worker_group(K, init_method=init_method, device="cpu",
                             backend="gloo", timeout_s=GROUP_TIMEOUT_S,
                             model_parallel=M)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def tree_from(inputs, prefix: str, K: int, rows=None) -> dict:
    def leaf(name):
        x = np.asarray(inputs[f"{prefix}/{name}"])[:K]
        return torch.from_numpy(x if rows is None else x[rows].copy())

    return {"b": leaf("b"), "nest": {"u": leaf("u")}, "w": leaf("w")}


# --------------------------------- losses -----------------------------------


def quad_loss(p, batch):
    return torch.sum((p["x"] - batch) ** 2)


def mean_quad_loss(p, batch):
    return torch.mean((p["x"] - batch) ** 2)


def mlp_loss(p, batch):
    pred = batch["x"] @ p["w"] + p["bias"]
    return torch.mean((pred - batch["y"]) ** 2)


def two_layer_loss(p, batch):
    h = torch.tanh(batch["x"] @ p["w1"])
    return torch.mean((h @ p["w2"] - batch["y"]) ** 2)


def sharded_mlp_loss(chunks, batch, ctx):
    h = row_parallel_dot(batch["x"], chunks["w"], batch["y"].shape[-1], ctx)
    pred = h + ctx.full_leaf(chunks["bias"], 0)
    return torch.mean((pred - batch["y"]) ** 2)


def sharded_quad_loss(chunks, batch, ctx):
    bl = ctx.mirror({"x": batch})
    return ctx.psum(torch.sum((chunks["x"] - bl["x"]) ** 2)) / batch.numel()


def sharded_two_layer(chunks, batch, ctx):
    h = torch.tanh(row_parallel_dot(batch["x"], chunks["w1"], D_H, ctx))
    pred = row_parallel_dot(h, chunks["w2"], batch["y"].shape[-1], ctx)
    return torch.mean((pred - batch["y"]) ** 2)


LOSSES = {"quad": (quad_loss, None),
          "mean_quad": (mean_quad_loss, sharded_quad_loss),
          "mlp": (mlp_loss, sharded_mlp_loss),
          "two_layer": (two_layer_loss, sharded_two_layer)}


def batches_of(inputs, name: str, K: int):
    t = 0
    while True:
        if name in ("quad", "mean_quad"):
            yield torch.from_numpy(inputs["centers"][:K]
                                   + np.float32(0.01 * t))
        else:
            yield {"x": torch.from_numpy(inputs[f"mlp_x{t}"][:K]),
                   "y": torch.from_numpy(inputs[f"mlp_y{t}"][:K])}
        t += 1


def params_of_loss(inputs, name: str) -> dict:
    if name in ("quad", "mean_quad"):
        return {"x": torch.zeros(inputs["centers"].shape[1])}
    if name == "mlp":
        return {"bias": torch.zeros(inputs["mlp_y0"].shape[-1]),
                "w": torch.from_numpy(inputs["mlp_w"])}
    return {"w1": torch.from_numpy(inputs["tl_w1"]),
            "w2": torch.from_numpy(inputs["tl_w2"])}


# ---------------------------------- cases -----------------------------------


def make_opt(c: dict, wg=None):
    kw = dict(c.get("opt", {}))
    if c.get("scales"):
        kw["scales"] = c["scales"]
    if wg is not None:
        kw.update(comm="axis", group=wg)
    else:
        kw.update(device="cpu")
    return make_optimizer(c["kind"], c["K"], backend=BACKEND[c["backend"]],
                          **kw)


def whole(state, wg):
    """The state's packed buffers as the JAX package's global arrays:
    gathered over the model group, then over the workers."""
    if wg is None:
        return state
    return gather_model(state, wg).map_buffers(
        lambda x, dim: gather_workers(x, wg))


def dump_packed(state, wg) -> dict:
    st = whole(state, wg)
    out = {"buf": _np(st.buf), "m": _np(st.m), "v": _np(st.v)}
    if hasattr(st, "hat_buf"):
        out["hat"] = _np(st.hat_buf)
        for i, h in enumerate(st.hat_nbr_bufs):
            out[f"nbr{i}"] = _np(h)
    return out


def run_steps(c: dict, inputs, wg=None) -> dict:
    K = c["K"]
    opt = make_opt(c, wg)
    st = opt.init(tree_from(inputs, "params", K))
    rows = None if wg is None else slice(wg.rank, wg.rank + 1)
    block = st.buf.shape if hasattr(st, "buf") else None
    for t in range(c["steps"]):
        noise = tree_from(inputs, f"noise{t}", K, rows)
        grads = tree_map(lambda x, n: 0.5 * x + 0.1 * n, opt.params_of(st),
                         noise)
        st = opt.step(st, grads)
    out = dump_packed(st, wg) if block is not None else {}
    for j, x in enumerate(tree_leaves(opt.gather_params(st))):
        out[f"p{j}"] = _np(x)
    out["bytes"] = opt.comm_bytes_per_round(opt.params_of(st))
    if block is not None:
        out["block"] = tuple(block)
        out["rows"] = st.spec.rows
    return out


def portable(state, wg) -> list:
    """The state's checkpoint form, all K workers, as numpy leaves."""
    if wg is not None:
        st = gather_workers(gather_model(state, wg).unpacked(), wg)
    else:
        st = state.unpacked()
    return [_np(x) if isinstance(x, torch.Tensor) else x
            for x in tree_leaves(st)]


def run_ckpt_src(c: dict, inputs, wg=None) -> dict:
    """One step, a checkpoint to ``c["save"]``, then one more step with
    grads ``0.3 buf``: the state saved and the state after."""
    from repro_torch.checkpoint.io import save

    opt = make_opt(c, wg)
    st = opt.init(tree_from(inputs, "params", c["K"]))
    st = opt.step(st, 0.3 * st.buf)
    save(c["save"], st, step=1, group=wg)
    out = {"saved": portable(st, wg)}
    st = opt.step(st, 0.3 * st.buf)
    out["after"] = portable(st, wg)
    return out


def run_ckpt_dst(c: dict, inputs, wg=None) -> dict:
    """Each checkpoint of ``c["restore"]`` restored onto this group's
    state; the first saved again to ``c["save"]`` and stepped once with
    grads ``0.3 buf``."""
    from repro_torch.checkpoint.io import restore, save

    opt = make_opt(c, wg)
    like = opt.init(tree_from(inputs, "params", c["K"]))
    out = {}
    for i, path in enumerate(c["restore"]):
        st, step = restore(path, like, group=wg)
        out[f"restored{i}"] = portable(st, wg)
        out[f"step{i}"] = step
        out[f"row_shards{i}"] = st.spec.row_shards
        out[f"block{i}"] = tuple(st.buf.shape)
        if i == 0:
            save(c["save"], st, step=2, group=wg)
            out["after"] = portable(opt.step(st, 0.3 * st.buf), wg)
    return out


def run_round(c: dict, inputs, wg=None) -> dict:
    opt = make_opt(c, wg)
    st = opt.init(tree_from(inputs, "params", c["K"]))
    p = c["opt"]["period"]
    batches = torch.zeros((p, 1 if wg is not None else c["K"], 1))
    seen = []

    def grad_fn(buf, batch):
        seen.append(tuple(buf.shape))
        return 0.5 * buf

    st = opt.round(st, grad_fn, batches)
    out = dump_packed(st, wg)
    out["count"] = st.count
    out["grad_fn_shapes"] = seen
    return out


def run_fit(c: dict, inputs, wg=None) -> dict:
    K = c["K"]
    loss, sharded = LOSSES[c["loss"]]
    opt = make_opt(c, wg)
    extra = {}
    if c.get("sharded"):
        extra["sharded_loss"] = sharded
    if c.get("microbatch", 1) > 1:
        extra["microbatch"] = c["microbatch"]
    if c.get("damping"):
        extra["damping"] = c["damping"]
    tr = DecentralizedTrainer(stacked_loss(loss), opt, **extra)
    st = tr.init(params_of_loss(inputs, c["loss"]))
    if wg is not None:
        wg.reset_counts()
    st, log = tr.fit(st, batches_of(inputs, c["loss"], K), c["steps"],
                     log_every=c["log_every"])
    out = {"loss": np.asarray(log.loss), "consensus": np.asarray(
        log.consensus), "evals": np.asarray(log.grad_evals),
        "mode": tr.pipeline.mode}
    if wg is not None:
        out["collectives"] = wg.collective_summary()
    for j, x in enumerate(tree_leaves(opt.gather_params(st))):
        out[f"p{j}"] = _np(x)
    if c.get("damping"):
        out["level"] = _np(tr.damp_state.level)
    return out


def run_sign(c: dict, inputs, wg) -> dict:
    """The plain ``sign_compress_stacked`` with ``reduce_axis`` (the model
    group's sum) on this rank's block, leaf by leaf in one call and over
    the whole block; returns the rank's q, hat and scales."""
    K, M = c["K"], c["M"]
    x_tree = tree_from(inputs, "params", K)
    spec = packing.make_spec(x_tree, stacked=True,
                             block_rows=packing.BLOCK_ROWS, leaf_align=True,
                             row_shards=M)
    rows = spec.local_rows
    w, m = wg.rank, wg.model_rank

    def block(t):
        return packing.pack(t, spec)[w:w + 1, m * rows:(m + 1) * rows]

    x, hat = block(x_tree), block(tree_from(inputs, "noise0", K))
    reduce = functools.partial(model_sum, wg=wg)
    out = {}
    q, s, h = ops.sign_compress_stacked(
        x, hat, n_true=spec.sizes, row_ranges=packing.leaf_row_ranges(spec),
        reduce_axis=reduce)
    out.update(leaf_q=_np(q), leaf_scale=_np(s), leaf_hat=_np(h))
    q, s, h = ops.sign_compress_stacked(x, hat, n_true=spec.n,
                                        reduce_axis=reduce)
    out.update(worker_q=_np(q), worker_scale=_np(s), worker_hat=_np(h))
    return out


RUN = {"steps": run_steps, "round": run_round, "fit": run_fit,
       "sign": run_sign, "ckpt_src": run_ckpt_src, "ckpt_dst": run_ckpt_dst}


def cases_rank(rank: int, init_method: str, K: int, M: int, cases: dict,
               path: str) -> dict:
    """Every case of ``cases`` in one group of K x M ranks."""
    wg = group_of(K, M, init_method)
    with np.load(path) as data:
        inputs = {k: data[k] for k in data.files}
    return {name: RUN[c["type"]](c, inputs, wg) for name, c in cases.items()}


def cli_f32_rank(rank: int, init_method: str, argv) -> dict:
    """One rank of the training CLI's run (``launch.train._run``, what
    ``main`` spawns) with the reduced configs at f32 compute: the 2D
    layout's planned products sum in another order than the 1D run's,
    which stays within f32 rounding."""
    import dataclasses

    from repro_torch.launch import train as cli

    reduced = cli.get_reduced

    def f32(arch_id):
        a = reduced(arch_id)
        return dataclasses.replace(a, model=dataclasses.replace(
            a.model, compute_dtype=torch.float32))

    cli.get_reduced = f32
    try:
        run = cli._run(cli.parser().parse_args(argv),
                       init_method=init_method)
    finally:
        cli.get_reduced = reduced
    return dict(loss=list(run.log.loss), comm_mb=list(run.log.comm_mb),
                grad_evals=list(run.log.grad_evals), n_params=run.n_params,
                mode=run.trainer.pipeline.mode)
