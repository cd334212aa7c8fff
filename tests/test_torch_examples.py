"""The port's example drivers on the CPU: ``repro_torch.launch.
decentralized_lm``, the port of ``examples/decentralized_lm.py``.

Its presets equal the JAX example's, field for field. The 7m preset
(4 x 4 x 128 tokens a step, K=4 ring, D-Adam p=4) trains 12 steps on the
packed backend (the kernels' plain versions on CPU tensors); its batches
are torch's draws, so the run is held to what it must show itself: finite
losses from near ln(2048), falling, comm rounds at steps 4, 8 and 12. At
the example's eta 1e-3 the loss of either package climbs over its first
tens of steps (the tokens are near-uniform: the skewed bands leave ~0.08
nats to learn, and Adam's first steps move every weight by ~3 eta); at
eta 1e-4 it falls.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.launch import decentralized_lm

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

