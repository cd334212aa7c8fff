"""The port's side of the elastic-resize and online-publish parity tests
under ``comm='axis'`` (tests/test_torch_elastic_axis.py,
tests/test_torch_online_axis.py): the case runners, each run by every rank
of one world of 8 gloo ranks spawned by ``repro_torch.launch.mesh.spawn``.
A membership change is a new worker group over another prefix of that
world. The module imports torch and the port only, never jax; inputs come
from an ``.npz`` and results go back as numpy arrays and plain values. The
cases are the dicts of ``tests/_jax_elastic_axis.py``, which runs the same
ones in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint.io import _to_portable
from repro_torch.core.api import make_optimizer
from repro_torch.core.elastic import resize_state
from repro_torch.launch.mesh import barrier, exchange, make_worker_group
from repro_torch.launch.shardings import gather_model, gather_workers
from repro_torch.serve.publish import ParamStore
from repro_torch.train.loop import DecentralizedTrainer, stacked_loss
from repro_torch.train.online import train_online

GROUP_TIMEOUT_S = 60
WORLD = 8


def group_of(K: int, M: int, init_method: str = None):
    return make_worker_group(K, init_method=init_method, device="cpu",
                             backend="gloo", timeout_s=GROUP_TIMEOUT_S,
                             model_parallel=M)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def tree_from(inputs, prefix: str, K: int, rows=None) -> dict:
    def leaf(name):
        x = np.asarray(inputs[f"{prefix}/{name}"])[:K]
        return torch.from_numpy(x if rows is None else x[rows].copy())

    return {"b": leaf("b"), "nest": {"u": leaf("u")}, "w": leaf("w")}


def make_opt(c: dict, K: int, wg=None, inputs=None):
    """``c``'s optimizer at K workers: under comm='axis' on ``wg``, else
    stacked on the CPU; the straggler arrivals from the inputs' table for
    K."""
    kw = dict(c.get("opt", {}))
    masks = c.get("masks")
    if masks:
        table = np.asarray(inputs[masks[str(K)]])
        kw["arrival"] = lambda r: table[r]
    if wg is not None:
        kw.update(comm="axis", group=wg)
    else:
        kw.update(device="cpu")
    return make_optimizer(c["kind"], K, backend=c["backend"], **kw)


def stepped(opt, st, inputs, K: int, t0: int, n: int, wg=None):
    """``n`` steps with grads ``0.5 x + 0.1 noise_t`` (this rank's row of
    the noise under comm='axis')."""
    rows = None if wg is None else slice(wg.rank, wg.rank + 1)
    for t in range(t0, t0 + n):
        noise = tree_from(inputs, f"noise{t}", K, rows)
        st = opt.step(st, tree_map(lambda x, n: 0.5 * x + 0.1 * n,
                                   opt.params_of(st), noise))
    return st


def local(st) -> dict:
    """This rank's own state: its buffers (its block under the 2D
    layout) or its leaves, the count and the straggler ages."""
    out = {}
    if hasattr(st, "buf"):
        out.update(buf=_np(st.buf), m=_np(st.m), v=_np(st.v),
                   count=st.count)
        if hasattr(st, "hat_buf"):
            out["hat"] = _np(st.hat_buf)
            for i, h in enumerate(st.hat_nbr_bufs):
                out[f"nbr{i}"] = _np(h)
    else:
        for name, t in (("p", st.params), ("m", st.moments.m),
                        ("v", st.moments.v)):
            for j, x in enumerate(tree_leaves(t)):
                out[f"{name}{j}"] = _np(x)
        out["count"] = st.moments.count
    stale = getattr(st, "stale", None)
    if stale is not None:
        out["age"] = _np(stale.age)
    return out


def whole(st, wg, prefix: str) -> dict:
    """The state as the JAX package's global arrays (gathered over the
    model group, then over the workers), by the names of
    ``_jax_elastic_axis.dump``."""
    if hasattr(st, "buf"):
        st = gather_model(st, wg).map_buffers(
            lambda x, dim: gather_workers(x, wg))
        stale = getattr(st, "stale", None)
        if stale is not None:
            st = st.with_stale(stale._replace(
                age=gather_workers(stale.age, wg)))
    else:
        st = gather_workers(st, wg)
    return {f"{prefix}{k}": v for k, v in local(st).items()}


def portable_all(st, wg):
    """The state's checkpoint form, all K workers, as numpy leaves in
    its tree (the stacked reference's input)."""
    return tree_map(_np, gather_workers(_to_portable(st, wg), wg))


def run_resize(c: dict, inputs, init_method: str) -> dict:
    wg0 = group_of(c["K0"], c["M0"], init_method)
    opt0 = make_opt(c, c["K0"], wg0, inputs)
    st, out = None, {}
    if wg0.member:
        st = opt0.init(tree_from(inputs, "params", c["K0"]))
        st = stepped(opt0, st, inputs, c["K0"], 0, c["pre"], wg0)
        old = portable_all(st, wg0)
        if wg0.global_rank == 0:
            out["old"] = old
    wg1 = group_of(c["K1"], c["M1"])
    opt1 = make_opt(c, c["K1"], wg1, inputs)
    wg0.reset_counts()
    st = resize_state(st, opt1, strategy=c["strategy"], group=wg0)
    out.update(member=wg1.member, got_none=st is None,
               w=wg1.rank, m=wg1.model_rank,
               resize=wg0.collective_summary()["resize"])
    if not wg1.member:
        return out
    out["local"] = local(st)
    out.update(whole(st, wg1, "r_"))
    st = stepped(opt1, st, inputs, c["K1"], c["pre"], c["post"], wg1)
    out.update(whole(st, wg1, "a_"))
    return {k: v for k, v in out.items()
            if wg1.global_rank == 0 or not k.startswith(("r_", "a_"))}


# ------------------------------ trainer cases -------------------------------


def mlp_loss(p, batch):
    pred = batch["x"] @ p["w"] + p["bias"]
    return torch.mean((pred - batch["y"]) ** 2)


def mlp_params(inputs) -> dict:
    return {"bias": torch.zeros(inputs["mlp_y0"].shape[-1]),
            "w": torch.from_numpy(inputs["mlp_w"])}


def mlp_batches(inputs, sizes, t0: int = 0):
    """Step t's global batch of ``sizes[t]`` workers, from step ``t0``."""
    for t in range(t0, len(sizes)):
        K = sizes[t]
        yield {"x": torch.from_numpy(inputs[f"mlp_x{t}"][:K]),
               "y": torch.from_numpy(inputs[f"mlp_y{t}"][:K])}


def log_fields(log) -> dict:
    return {"loss": np.asarray(log.loss),
            "consensus": np.asarray(log.consensus),
            "evals": np.asarray(log.grad_evals),
            "comm_mb": np.asarray(log.comm_mb),
            "steps_total": log.steps_total,
            "comm_rounds_total": log.comm_rounds_total}


def run_trainer_resize(c: dict, inputs, init_method: str) -> dict:
    """The trainer's ``pre`` steps, ``trainer.resize`` on every rank of
    the world, ``share_log``, ``post`` steps; joiners build their trainer
    on the old (non-member) optimizer and pass ``None``."""
    wg0 = group_of(c["K0"], c["M0"], init_method)
    tr = DecentralizedTrainer(stacked_loss(mlp_loss),
                              make_opt(c, c["K0"], wg0, inputs),
                              damping=c.get("damping"))
    sizes = [c["K0"]] * c["pre"] + [c["K1"]] * c["post"]
    st, log = None, None
    if wg0.member:
        it = mlp_batches(inputs, sizes)
        st, log = tr.fit(tr.init(mlp_params(inputs)), it, c["pre"],
                         log_every=1)
    else:
        it = mlp_batches(inputs, sizes, c["pre"])
    wg1 = group_of(c["K1"], c["M1"])
    st = tr.resize(st, make_opt(c, c["K1"], wg1, inputs),
                   strategy=c["strategy"])
    out = {"member": wg1.member, "got_none": st is None}
    if not wg1.member:
        return out
    log = tr.share_log(log)
    st, log = tr.fit(st, it, c["post"], log_every=1, log=log)
    out.update(log_fields(log))
    for j, x in enumerate(tree_leaves(tr.opt.gather_params(st))):
        out[f"p{j}"] = _np(x)
    if c.get("damping"):
        out["level"] = _np(tr.damp_state.level)
        out["evals_total"] = int(tr.damp_state.evals)
    return out


class RecordingStore(ParamStore):
    """A store that keeps every published tree's leaves."""

    def __init__(self):
        super().__init__()
        self.trees = []

    def publish(self, params, *, like=None):
        self.trees.append([_np(x) for x in tree_leaves(params)])
        return super().publish(params, like=like)


def run_online(c: dict, inputs, init_method: str) -> dict:
    """``train_online`` on every rank of a (K, M) group: the publish
    history, every published tree, the log, and (rank 0) the final state's
    checkpoint form for the stacked publish."""
    wg = group_of(c["K"], c["M"], init_method)
    if not wg.member:
        return {"member": False}
    tr = DecentralizedTrainer(stacked_loss(mlp_loss),
                              make_opt(c, c["K"], wg, inputs))
    st = tr.init(mlp_params(inputs))
    store = RecordingStore()
    res = train_online(tr, st, mlp_batches(inputs, [c["K"]] * c["steps"]),
                       c["steps"], store=store,
                       publish_every=c["publish_every"], mode=c["mode"],
                       worker=c.get("worker", 0), log_every=1)
    out = {"member": True, "published": res.published,
           "trees": store.trees, "version": store.version,
           "log": log_fields(res.log)}
    final = portable_all(res.state, wg)
    if wg.global_rank == 0:
        out["final"] = final
    return out


def run_exchange(c: dict, inputs, init_method: str) -> dict:
    """A group of ``c["K"]`` ranks inside the world: each member sends its
    global rank's block to the next worker and takes the previous one's
    (global peer ranks name the right processes in a prefix group)."""
    wg = group_of(c["K"], 1, init_method)
    out = {"member": wg.member, "world": torch.distributed.get_world_size()}
    if wg.member:
        x = torch.full((3, 5), float(wg.global_rank))
        got = exchange(x, (wg.rank - 1) % wg.K, (wg.rank + 1) % wg.K, wg)
        barrier(wg)
        out["got"] = _np(got)
    return out


RUN = {"resize": run_resize, "trainer_resize": run_trainer_resize,
       "online": run_online, "exchange": run_exchange}


def world_rank(rank: int, init_method: str, cases: dict, path: str) -> dict:
    """Every case of ``cases`` in one world of :data:`WORLD` ranks (the
    first case's group opens it)."""
    with np.load(path) as data:
        inputs = {k: data[k] for k in data.files}
    out = {}
    for name, c in cases.items():
        out[name] = RUN[c["type"]](c, inputs, init_method)
    return out
