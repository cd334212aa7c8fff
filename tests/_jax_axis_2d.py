"""The JAX side of the 2D worker x model parity tests
(tests/test_torch_axis_2d.py), run as a script in a subprocess with 8
forced host devices:

    python tests/_jax_axis_2d.py INPUTS.npz CASES.json OUT.npz

Every case builds its mesh as ``jax.sharding.Mesh(devices.reshape(K, M),
("worker", "model"))``, whose axes are Auto: ``repro.launch.mesh
.make_worker_mesh`` calls ``jax.make_mesh``, which builds Explicit axes on
which the JAX package's 2D path fails with a ``ShardingTypeError``. The
inputs come from the test in numpy; each case writes its results under
``"<case>|<field>"``.
"""
import json
import os
import sys

# XLA's CPU client runs each host device's program on a pool of one thread
# a core, and a collective aborts the process when a device has not
# joined it within 40 s: on a loaded 8-core host the last of 8 devices
# can wait that long for a thread. A larger pool and a longer wait keep
# the reference from aborting there; neither changes a number.
os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    "--xla_cpu_collective_call_terminate_timeout_seconds=300")
os.environ["PJRT_NPROC"] = "32"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.core import make_optimizer  # noqa: E402
from repro.kernels import pack as packing  # noqa: E402
from repro.train import DecentralizedTrainer, row_parallel_dot  # noqa: E402


def mesh_of(K, M):
    devs = np.array(jax.devices()[:K * max(M, 1)])
    if M:
        return Mesh(devs.reshape(K, M), ("worker", "model"))
    return Mesh(devs, ("worker",))


def g(x):
    return np.asarray(jax.device_get(x))


# --------------------------------- losses -----------------------------------


def quad_loss(p, batch):
    return jnp.sum((p["x"] - batch) ** 2)


def mlp_loss(p, batch):
    pred = batch["x"] @ p["w"] + p["bias"]
    return jnp.mean((pred - batch["y"]) ** 2)


def sharded_mlp_loss(chunks, batch, ctx):
    h = row_parallel_dot(batch["x"], chunks["w"], batch["y"].shape[-1], ctx)
    pred = h + ctx.full_leaf(chunks["bias"], 0)
    return jnp.mean((pred - batch["y"]) ** 2)


def mean_quad_loss(p, batch):
    return jnp.mean((p["x"] - batch) ** 2)


def sharded_quad_loss(chunks, batch, ctx):
    bl = ctx.mirror({"x": batch})
    return ctx.psum(jnp.sum((chunks["x"] - bl["x"]) ** 2)) / batch.size


def two_layer_loss(p, batch):
    h = jnp.tanh(batch["x"] @ p["w1"])
    return jnp.mean((h @ p["w2"] - batch["y"]) ** 2)


D_H = 128   # the two-layer model's hidden width


def sharded_two_layer(chunks, batch, ctx):
    h = jnp.tanh(row_parallel_dot(batch["x"], chunks["w1"], D_H, ctx))
    pred = row_parallel_dot(h, chunks["w2"], batch["y"].shape[-1], ctx)
    return jnp.mean((pred - batch["y"]) ** 2)


LOSSES = {"quad": (quad_loss, None),
          "mean_quad": (mean_quad_loss, sharded_quad_loss),
          "mlp": (mlp_loss, sharded_mlp_loss),
          "two_layer": (two_layer_loss, sharded_two_layer)}


# --------------------------------- cases ------------------------------------


def tree(inputs, prefix, K):
    return {"b": jnp.asarray(inputs[prefix + "/b"][:K]),
            "nest": {"u": jnp.asarray(inputs[prefix + "/u"][:K])},
            "w": jnp.asarray(inputs[prefix + "/w"][:K])}


def dump_packed(st):
    out = {"buf": g(st.buf), "m": g(st.m), "v": g(st.v)}
    if hasattr(st, "hat_buf"):
        out["hat"] = g(st.hat_buf)
        for i, h in enumerate(st.hat_nbr_bufs):
            out[f"nbr{i}"] = g(h)
    return out


def make_opt(c, mesh):
    kw = dict(c.get("opt", {}))
    if c.get("scales"):
        kw["scales"] = c["scales"]
    if mesh is not None:
        kw.update(comm="axis", mesh=mesh)
    return make_optimizer(c["kind"], K=c["K"], backend=c["backend"], **kw)


def run_steps(c, inputs):
    """``c["steps"]`` ``opt.step`` calls, grads ``0.5 x + 0.1 noise_t``
    packed against the state's own layout."""
    mesh = mesh_of(c["K"], c["M"]) if c.get("axis", True) else None
    opt = make_opt(c, mesh)
    st = opt.init(tree(inputs, "params", c["K"]))
    step = jax.jit(opt.step)
    for t in range(c["steps"]):
        gr = jax.tree_util.tree_map(lambda x, n: 0.5 * x + 0.1 * n,
                                    opt.params_of(st),
                                    tree(inputs, f"noise{t}", c["K"]))
        st = step(st, packing.pack(gr, st.spec, dtype=st.buf.dtype))
    out = dump_packed(st)
    for j, x in enumerate(jax.tree_util.tree_leaves(opt.params_of(st))):
        out[f"p{j}"] = g(x)
    out["bytes"] = np.asarray(opt.comm_bytes_per_round(opt.params_of(st)))
    if c.get("save"):
        from repro.checkpoint import save
        save(c["save"], st, step=c["steps"])
        for j, x in enumerate(jax.tree_util.tree_leaves(st.unpacked())):
            out[f"u{j}"] = g(x)
    return out


def run_round(c, inputs):
    mesh = mesh_of(c["K"], c["M"])
    opt = make_opt(c, mesh)
    st = opt.init(tree(inputs, "params", c["K"]))
    batches = jnp.zeros((c["opt"]["period"], c["K"], 1))
    st = opt.round(st, lambda buf, batch: 0.5 * buf, batches)
    out = dump_packed(st)
    out["count"] = np.asarray(int(st.count))
    return out


def batches_of(inputs, name, K):
    t = 0
    while True:
        if name in ("quad", "mean_quad"):
            yield jnp.asarray(inputs["centers"][:K] + np.float32(0.01 * t))
        else:
            yield {"x": jnp.asarray(inputs[f"mlp_x{t}"][:K]),
                   "y": jnp.asarray(inputs[f"mlp_y{t}"][:K])}
        t += 1


def params_of_loss(inputs, name):
    if name in ("quad", "mean_quad"):
        return {"x": jnp.zeros((inputs["centers"].shape[1],))}
    if name == "mlp":
        return {"bias": jnp.zeros((inputs["mlp_y0"].shape[-1],)),
                "w": jnp.asarray(inputs["mlp_w"])}
    return {"w1": jnp.asarray(inputs["tl_w1"]),
            "w2": jnp.asarray(inputs["tl_w2"])}


def run_fit(c, inputs):
    """A trainer's ``c["steps"]`` steps: ``mode`` reference / packed
    (stacked), axis1d, axis2d; ``sharded`` adds the model-parallel loss."""
    mode = c["mode"]
    mesh = {"axis1d": lambda: mesh_of(c["K"], 0),
            "axis2d": lambda: mesh_of(c["K"], c["M"])}.get(mode,
                                                           lambda: None)()
    loss, sharded = LOSSES[c["loss"]]
    opt = make_opt(c, mesh)
    extra = {}
    if c.get("sharded"):
        extra["sharded_loss"] = sharded
    if c.get("microbatch", 1) > 1:
        extra["microbatch"] = c["microbatch"]
    if c.get("damping"):
        extra["damping"] = c["damping"]
    tr = DecentralizedTrainer(loss, opt, **extra)
    st = tr.init(params_of_loss(inputs, c["loss"]))
    st, log = tr.fit(st, batches_of(inputs, c["loss"], c["K"]), c["steps"],
                     log_every=c["log_every"])
    out = {"loss": np.asarray(log.loss),
           "consensus": np.asarray(log.consensus),
           "evals": np.asarray(log.grad_evals),
           "mode": np.asarray(tr.pipeline.mode)}
    for j, x in enumerate(jax.tree_util.tree_leaves(opt.params_of(st))):
        out[f"p{j}"] = g(x)
    if c.get("damping"):
        out["level"] = g(tr.damp_state.level)
    return out


def run_sign(c, inputs):
    """``sign_compress_stacked(reduce_axis='model')`` inside a 2D
    shard_map on each leaf's rows of the row-sharded layout (the call
    ``cdadam._comm_round_packed`` makes), and ``scales='worker'``'s
    whole-block call."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.kernels import ops

    K, M = c["K"], c["M"]
    mesh = mesh_of(K, M)
    x_tree, h_tree = (tree(inputs, "params", K),
                      tree(inputs, "noise0", K))
    spec = packing.make_spec(x_tree, stacked=True,
                             block_rows=packing.BLOCK_ROWS, leaf_align=True,
                             row_shards=M)
    x, hat = packing.pack(x_tree, spec), packing.pack(h_tree, spec)
    ranges = packing.leaf_row_ranges(spec)

    def leafwise(xl, hl):
        qs, ss, hs = [], [], []
        for (r0, r1), size in zip(ranges, spec.sizes):
            q, s, h = ops.sign_compress_stacked(
                xl[:, r0:r1], hl[:, r0:r1], n_true=size,
                reduce_axis="model")
            qs.append(q), ss.append(s), hs.append(h)
        return (jnp.concatenate(qs, 1), jnp.stack(ss, 1),
                jnp.concatenate(hs, 1))

    def whole(xl, hl):
        return ops.sign_compress_stacked(xl, hl, n_true=spec.n,
                                         reduce_axis="model")

    buf = P("worker", "model")
    out = {}
    for name, fn, sc in (("leaf", leafwise, P("worker")),
                         ("worker", whole, P("worker"))):
        q, s, h = shard_map(fn, mesh=mesh, in_specs=(buf, buf),
                            out_specs=(buf, sc, buf),
                            check_rep=False)(x, hat)
        out.update({f"{name}_q": g(q), f"{name}_scale": g(s),
                    f"{name}_hat": g(h)})
    out["x"], out["hat_in"] = g(x), g(hat)
    return out


RUN = {"steps": run_steps, "round": run_round, "fit": run_fit,
       "sign": run_sign}


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
