"""The JAX side of the sharding-plan parity test (tests/test_torch_plan.py),
run as a script in a subprocess with 4 forced host devices:

    python tests/_jax_plan.py TOKENS.npz OUT.npz STEPS [ARCH [TAU [none]]]

JAX's planned trainer: the reduced ARCH (llama3.2-1b by default; the
batches' ``patches<t>`` go with the tokens for the vision-language
family) at f32 compute, with Adam's tau (1e-6 by default; a last
argument ``none`` runs it without the plan), packed
D-Adam (``backend='pallas'``, interpret mode on the CPU) at p=2 on a
``Mesh(devices.reshape(2, 2), ("worker", "model"))`` (Auto axes: the 2D
path fails on ``jax.make_mesh``'s Explicit ones), with
``make_plan(arch, mesh, mode='axis')`` threaded into the loss as the JAX
CLI threads it; ``STEPS`` steps, the log point at each. Writes the losses,
the state's buffer and the params it drew (``param<keystr>``).
"""
import dataclasses
import os
import sys

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=4 "
    "--xla_cpu_collective_call_terminate_timeout_seconds=300")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_reduced  # noqa: E402
from repro.core import make_optimizer  # noqa: E402
from repro.launch.shardings import make_plan  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.train import DecentralizedTrainer  # noqa: E402

ETA, PERIOD = 1e-3, 2


def main():
    inputs, out, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
    arch = get_reduced(sys.argv[4] if len(sys.argv) > 4 else "llama3.2-1b")
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, compute_dtype=jnp.float32))
    api = build_model(arch.model)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("worker", "model"))
    tau = float(sys.argv[5]) if len(sys.argv) > 5 else 1e-6
    opt = make_optimizer("d-adam", K=2, backend="pallas", comm="axis",
                         mesh=mesh, eta=ETA, period=PERIOD, tau=tau)
    plan = (None if sys.argv[6:7] == ["none"]
            else make_plan(arch, mesh, multi_pod=False, mode="axis"))
    trainer = DecentralizedTrainer(lambda p, b: api.loss(p, b), opt,
                                   plan=plan)
    params = api.init(jax.random.PRNGKey(0))
    data = np.load(inputs)
    batches = [{k: jnp.asarray(data[f"{k}{t}"])
                for k in ("tokens", "patches") if f"{k}{t}" in data}
               for t in range(steps)]
    state = trainer.init(params)
    state, log = trainer.fit(state, iter(batches), steps, log_every=1)
    res = {"loss": np.asarray(log.loss),
           "buf": np.asarray(jax.device_get(state.buf))}
    for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        res["param" + jax.tree_util.keystr(path)] = np.asarray(x)
    np.savez(out, **res)


if __name__ == "__main__":
    main()
