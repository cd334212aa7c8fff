"""The JAX side of the elastic-resize and online-publish parity tests under
``comm='axis'`` (tests/test_torch_elastic_axis.py,
tests/test_torch_online_axis.py), run as a script in a subprocess with 8
forced host devices:

    python tests/_jax_elastic_axis.py INPUTS.npz CASES.json OUT.npz

A membership change builds the new optimizer on a mesh over the first
K' x M' devices, each mesh an Auto-typed ``jax.sharding.Mesh`` (never
``jax.make_mesh``, whose Explicit axes break the JAX package's 2D path).
The cases are the dicts of ``tests/_elastic_ranks.py``, which runs the
same ones on the port; each writes its results under ``"<case>|<field>"``.
"""
import json
import os
import sys

# a larger thread pool and a longer collective wait than XLA's CPU
# defaults (one thread a core, 40 s), so that a loaded host does not abort
# the reference; neither changes a number
os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    "--xla_cpu_collective_call_terminate_timeout_seconds=300")
os.environ["PJRT_NPROC"] = "32"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.core import dadam as jdadam  # noqa: E402
from repro.core import make_optimizer  # noqa: E402
from repro.core.elastic import resize_state  # noqa: E402
from repro.kernels import pack as packing  # noqa: E402
from repro.serve.publish import ParamStore  # noqa: E402
from repro.train import DecentralizedTrainer  # noqa: E402
from repro.train.online import train_online  # noqa: E402

BACKEND = {"packed": "pallas", "reference": "reference"}
ORIGINAL_MASK = jdadam._arrival_mask


def mesh_of(K, M):
    devs = np.array(jax.devices()[:K * max(M, 1)])
    if M > 1:
        return Mesh(devs.reshape(K, M), ("worker", "model"))
    return Mesh(devs, ("worker",))


def g(x):
    return np.asarray(jax.device_get(x))


def tree(inputs, prefix, K):
    return {"b": jnp.asarray(inputs[prefix + "/b"][:K]),
            "nest": {"u": jnp.asarray(inputs[prefix + "/u"][:K])},
            "w": jnp.asarray(inputs[prefix + "/w"][:K])}


def dump(st, prefix):
    """The state's buffers (packed) or leaves (reference) by name."""
    out = {}
    leaves = jax.tree_util.tree_leaves
    if hasattr(st, "buf"):
        out.update(buf=g(st.buf), m=g(st.m), v=g(st.v), count=np.asarray(
            int(st.count)))
        if hasattr(st, "hat_buf"):
            out["hat"] = g(st.hat_buf)
            for i, h in enumerate(st.hat_nbr_bufs):
                out[f"nbr{i}"] = g(h)
    else:
        for name, t in (("p", st.params), ("m", st.moments.m),
                        ("v", st.moments.v)):
            for j, x in enumerate(leaves(t)):
                out[f"{name}{j}"] = g(x)
        out["count"] = np.asarray(int(st.moments.count))
    stale = getattr(st, "stale", None)
    if stale is not None:
        out["age"] = g(stale.age)
    return {f"{prefix}{k}": v for k, v in out.items()}


def set_masks(inputs, c):
    """The straggler arrivals of ``c`` (a numpy table per K), or JAX's own
    draw."""
    if not c.get("masks"):
        jdadam._arrival_mask = ORIGINAL_MASK
        return
    tables = {int(k): jnp.asarray(inputs[name])
              for k, name in c["masks"].items()}
    jdadam._arrival_mask = (
        lambda cfg, r, K, deg: jdadam._local_worker_rows(tables[K][r], cfg))


def make_opt(c, K, M):
    kw = dict(c.get("opt", {}))
    return make_optimizer(c["kind"], K=K, backend=BACKEND[c["backend"]],
                          comm="axis", mesh=mesh_of(K, M), **kw)


def stepped(opt, st, inputs, K, t0, n):
    step = jax.jit(opt.step)
    for t in range(t0, t0 + n):
        gr = jax.tree_util.tree_map(lambda x, n: 0.5 * x + 0.1 * n,
                                    opt.params_of(st),
                                    tree(inputs, f"noise{t}", K))
        if hasattr(st, "buf"):
            gr = packing.pack(gr, st.spec, dtype=st.buf.dtype)
        st = step(st, gr)
    return st


def run_resize(c, inputs):
    """``pre`` steps at (K0, M0), the resize to (K1, M1), ``post`` steps:
    the state after the resize (``r_``) and after the steps (``a_``)."""
    set_masks(inputs, c)
    opt0 = make_opt(c, c["K0"], c["M0"])
    st = stepped(opt0, opt0.init(tree(inputs, "params", c["K0"])), inputs,
                 c["K0"], 0, c["pre"])
    opt1 = make_opt(c, c["K1"], c["M1"])
    st = resize_state(st, opt1, strategy=c["strategy"])
    out = dump(st, "r_")
    st = stepped(opt1, st, inputs, c["K1"], c["pre"], c["post"])
    out.update(dump(st, "a_"))
    return out


# ------------------------------ trainer cases -------------------------------


def mlp_loss(p, batch):
    pred = batch["x"] @ p["w"] + p["bias"]
    return jnp.mean((pred - batch["y"]) ** 2)


def mlp_params(inputs):
    return {"bias": jnp.zeros((inputs["mlp_y0"].shape[-1],)),
            "w": jnp.asarray(inputs["mlp_w"])}


def mlp_batches(inputs, sizes):
    """Step t's global batch of ``sizes[t]`` workers."""
    for t, K in enumerate(sizes):
        yield {"x": jnp.asarray(inputs[f"mlp_x{t}"][:K]),
               "y": jnp.asarray(inputs[f"mlp_y{t}"][:K])}


def log_fields(log, prefix):
    return {f"{prefix}loss": np.asarray(log.loss),
            f"{prefix}consensus": np.asarray(log.consensus),
            f"{prefix}evals": np.asarray(log.grad_evals),
            f"{prefix}comm_mb": np.asarray(log.comm_mb)}


def run_trainer_resize(c, inputs):
    """A trainer's ``pre`` steps at (K0, M0), ``trainer.resize`` to
    (K1, M1), ``post`` steps; the log, the params and the damping level."""
    set_masks(inputs, c)
    opt0 = make_opt(c, c["K0"], c["M0"])
    tr = DecentralizedTrainer(mlp_loss, opt0, damping=c.get("damping"))
    st = tr.init(mlp_params(inputs))
    it = mlp_batches(inputs, [c["K0"]] * c["pre"] + [c["K1"]] * c["post"])
    st, log = tr.fit(st, it, c["pre"], log_every=1)
    st = tr.resize(st, make_opt(c, c["K1"], c["M1"]),
                   strategy=c["strategy"])
    if tr.damp_state is not None:
        # the JAX package's resize_damp leaves the damping state committed
        # to the old mesh's devices, and its next step then refuses the
        # new mesh's state; uncommitted copies take the same values
        tr.damp_state = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x)), tr.damp_state)
    st, log = tr.fit(st, it, c["post"], log_every=1, log=log)
    out = log_fields(log, "")
    for j, x in enumerate(jax.tree_util.tree_leaves(tr.opt.params_of(st))):
        out[f"p{j}"] = g(x)
    if c.get("damping"):
        out["level"] = g(tr.damp_state.level)
        out["evals_total"] = np.asarray(int(tr.damp_state.evals))
    return out


class RecordingStore(ParamStore):
    """A store that keeps every published tree's leaves."""

    def __init__(self):
        super().__init__()
        self.trees = []

    def publish(self, params, *, like=None):
        self.trees.append([g(x) for x in jax.tree_util.tree_leaves(params)])
        return super().publish(params, like=like)


def run_online(c, inputs):
    """``train_online`` at (K, M): the publish history, every published
    tree, the log."""
    opt = make_opt(c, c["K"], c["M"])
    tr = DecentralizedTrainer(mlp_loss, opt)
    st = tr.init(mlp_params(inputs))
    store = RecordingStore()
    res = train_online(tr, st, mlp_batches(inputs, [c["K"]] * c["steps"]),
                       c["steps"], store=store,
                       publish_every=c["publish_every"], mode=c["mode"],
                       worker=c.get("worker", 0), log_every=1)
    out = log_fields(res.log, "")
    out["published"] = np.asarray(res.published)
    for v, leaves in enumerate(store.trees):
        for j, x in enumerate(leaves):
            out[f"v{v + 1}_{j}"] = x
    return out


RUN = {"resize": run_resize, "trainer_resize": run_trainer_resize,
       "online": run_online}


def main():
    assert jax.device_count() == 8, jax.device_count()
    inputs = dict(np.load(sys.argv[1]))
    cases = json.loads(sys.argv[2])
    results = {}
    for name, c in cases.items():
        for key, val in RUN[c["type"]](c, inputs).items():
            results[f"{name}|{key}"] = val
    np.savez(sys.argv[3], **results)


if __name__ == "__main__":
    main()
