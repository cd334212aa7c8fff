"""The port's example drivers on the CPU: ``repro_torch.launch.
decentralized_lm``, ``quickstart``, ``serve_lm`` and ``online_serve``, the
ports of ``examples/decentralized_lm.py``, ``quickstart.py``,
``serve_lm.py`` and ``online_serve.py``.

Its presets equal the JAX example's, field for field. The 7m preset
(4 x 4 x 128 tokens a step, K=4 ring, D-Adam p=4) trains 12 steps on the
packed backend (the kernels' plain versions on CPU tensors); its batches
are torch's draws, so the run is held to what it must show itself: finite
losses from near ln(2048), falling, comm rounds at steps 4, 8 and 12. At
the example's eta 1e-3 the loss of either package climbs over its first
tens of steps (the tokens are near-uniform: the skewed bands leave ~0.08
nats to learn, and Adam's first steps move every weight by ~3 eta); at
eta 1e-4 it falls.

The quickstart runs 40 steps beside the JAX example run as a script: the
same K, log steps, comm MB and averaged-model weight count, and losses
that fall. ``serve_lm`` serves version 2 after its hot swap, each padded
prompt's tokens equal to those of the prompt alone in a bucket of its
exact length. ``online_serve`` publishes at steps 20, 40 and 60.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch._tree import tree_leaves
from repro_torch.launch import (decentralized_lm, online_serve, quickstart,
                                serve_lm)

torch.set_num_threads(2)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
import decentralized_lm as jax_example  # noqa: E402

ARGS = ["--preset", "7m", "--device", "cpu", "--eta", "1e-4"]


def test_presets_match_the_jax_example():
    assert sorted(decentralized_lm.PRESETS) == sorted(jax_example.PRESETS)
    for name, cfg in decentralized_lm.PRESETS.items():
        want = jax_example.PRESETS[name]
        for f in dataclasses.fields(cfg):
            if f.name not in ("compute_dtype", "param_dtype"):
                assert getattr(cfg, f.name) == getattr(want, f.name), f.name
        assert cfg.tie_embeddings
        assert cfg.param_count() == want.param_count()


def test_lm_example_trains_the_7m_preset_and_the_loss_falls(capsys):
    log = decentralized_lm.main(ARGS + ["--steps", "12", "--log-every",
                                        "1"])
    out = capsys.readouterr().out
    assert out.startswith("model lm7m: 3.4M params, K=4 workers, d-adam p=4")
    assert out.count("\nstep ") == 12
    loss = np.asarray(log.loss)
    assert log.step == list(range(1, 13)) and np.isfinite(loss).all()
    assert abs(loss[0] - math.log(2048)) < 0.2
    assert loss[-1] < loss[0] and loss[-4:].mean() < loss[:4].mean()
    assert log.comm_rounds_total == 3 and log.comm_mb_total > 0



# ------------------------- quickstart, serve, online ------------------------


def run_jax_example(name: str, env: dict) -> str:
    """The JAX example's standard output, run as a user runs it."""
    script = Path(__file__).resolve().parents[1] / "examples" / name
    proc = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu", **env})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_quickstart_has_the_jax_examples_widths_and_comm_and_trains(capsys):
    jax_out = run_jax_example("quickstart.py", {"QUICKSTART_STEPS": "40"})
    log, averaged = quickstart.main(["--steps", "40", "--device", "cpu"])
    out = capsys.readouterr().out

    def fields(text):
        lines = [l.split() for l in text.splitlines()
                 if l.startswith("step ")]
        return ([int(l[1]) for l in lines], [l[7] for l in lines],
                text.strip().splitlines()[-1])

    steps, mb, last = fields(out)
    jax_steps, jax_mb, jax_last = fields(jax_out)
    assert quickstart.K == 8
    assert steps == jax_steps == [20, 40]
    assert mb == jax_mb and log.comm_rounds_total == 10
    # the same widths: the averaged model's weight count
    assert last == jax_last
    assert sum(x.numel() for x in tree_leaves(averaged)) == int(
        jax_last.split()[-2])
    loss = np.asarray(log.loss)
    assert np.isfinite(loss).all() and loss[-1] < loss[0]


def test_serve_lm_hot_swaps_and_padded_prompts_equal_exact_ones(capsys):
    from repro_torch.serve import DecodeEngine

    res = serve_lm.main(["--device", "cpu", "--new-tokens", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("v1: 5 prompts (lens [16, 9, 16, 12, 16])")
    assert out[1].startswith("v2: re-served after hot-swap")
    assert res.engine.last_version == 2 and res.store.version == 2
    assert res.engine.compile_counts == {"prefill": 2, "decode": 2}
    # each prompt alone in a bucket of its exact length, on version 2
    exact = DecodeEngine(res.engine.cfg, res.store, max_new_tokens=4,
                         buckets=tuple((1, L) for L in
                                       sorted(set(serve_lm.LENGTHS))))
    for p, got in zip(res.prompts, res.outs[1]):
        want = exact.generate_batch(p[None], 4)[0]
        assert torch.equal(got, want), p.numel()
    assert not all(torch.equal(a, b) for a, b in zip(*res.outs))


def test_online_serve_publishes_at_steps_20_40_60(capsys):
    result, a = online_serve.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert result.published == [(20, 1), (40, 2), (60, 3)]
    assert out[0] == "published versions: [1, 2, 3] (at steps [20, 40, 60])"
    assert out[1].startswith("serving v3:") and 0.5 < a < 1.0
    assert np.isfinite(result.log.loss).all()
