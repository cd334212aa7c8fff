"""The compressor study on the port, ``repro_torch.launch.compressed_comm``
(the port of ``examples/compressed_comm.py``), on the CPU.

Its four rows come in the JAX example's order and line format, and each
row's comm MB equals the JAX package's byte accounting for the same
compressor at the example's sizes (``comm_bytes_round_list`` on an
initialised JAX state, summed round by round as its trainer sums it; no
JAX training run). The batches and the init are torch's draws, so loss and
AUC are only held finite and in range. ``--backend packed`` runs the D-Adam
and sign rows on the packed path (the kernels' plain versions on CPU
tensors) and the top-k and quantize rows on the reference one, which its
labels say.
"""
import ast
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import make_optimizer as jax_make_optimizer
from repro.data import make_ctr_task
from repro.models.deepfm import init_deepfm as jax_init_deepfm
from repro.train.loop import stack_params as jax_stack_params
from repro_torch.core import api
from repro_torch.launch import compressed_comm, deepfm_ctr
from repro_torch.train.loop import TrainLog

torch.set_num_threads(2)

STEPS = 12
LINE = re.compile(r"^(.{24,}?) loss=(\d\.\d{4}) AUC=(\d\.\d{4}) "
                  r"comm=( *\d+\.\d\d) MB$")


def jax_example_rows():
    """The JAX example's rows as (kind, label, options), read from the
    ``run`` calls of its ``__main__`` block without running them."""
    tree = ast.parse((Path(__file__).resolve().parents[1] / "examples"
                      / "compressed_comm.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.If))
    rows = []
    for stmt in main.body:
        call = stmt.value
        assert call.func.id == "run"
        kind, label = (a.value for a in call.args)
        rows.append((kind, label, {
            k.arg: eval(compile(ast.Expression(k.value), "<row>", "eval"))
            for k in call.keywords}))
    return rows


def jax_comm_mb(kind, steps, **kw):
    """The JAX example's ``comm_mb`` after ``steps`` steps of a row: its
    per-round MB added once a round, in order."""
    task = make_ctr_task(seed=0, n_fields=compressed_comm.N_FIELDS,
                         features_per_field=compressed_comm.FEATURES_PER_FIELD)
    opt = jax_make_optimizer(kind, K=compressed_comm.K, eta=1e-3,
                             period=compressed_comm.PERIOD, **kw)
    params = jax_init_deepfm(jax.random.PRNGKey(0), task.n_features,
                             task.n_fields, hidden=compressed_comm.HIDDEN)
    state = opt.init(jax_stack_params(params, compressed_comm.K))
    per_round = [b / 1e6
                 for b in opt.comm_bytes_round_list(opt.params_of(state))]
    mb = 0.0
    for r in range(steps // opt.cfg.period):
        mb += per_round[r % len(per_round)]
    return mb


def test_the_rows_are_the_jax_examples():
    want = jax_example_rows()
    assert [(kind, label, kw) for label, kind, kw in
            compressed_comm.ROWS] == want
    assert compressed_comm.K == 8 and compressed_comm.PERIOD == 4
    assert compressed_comm.HIDDEN == (64, 64)
    assert compressed_comm.PER_WORKER == 32


@pytest.mark.parametrize("backend", ["reference", "packed"])
def test_four_rows_in_the_jax_line_format_with_jax_comm_mb(backend,
                                                            capsys,
                                                            monkeypatch):
    built = []
    make = api.make_optimizer

    def spy(kind, *a, **kw):
        opt = make(kind, *a, **kw)
        built.append((kind, kw.get("compressor"), opt.cfg.backend))
        return opt

    monkeypatch.setattr(deepfm_ctr, "make_optimizer", spy)
    rows = compressed_comm.main(["--device", "cpu", "--steps", str(STEPS),
                                 "--backend", backend])
    lines = capsys.readouterr().out.splitlines()
    assert len(rows) == len(lines) == 4
    packed = backend == "packed"
    assert built == [("d-adam", None, backend), ("cd-adam", "sign", backend),
                     ("cd-adam", "topk", "reference"),
                     ("cd-adam", "quantize", "reference")]
    for (label, kind, kw), row, line in zip(compressed_comm.ROWS, rows,
                                            lines):
        want_label = f"{label} [reference]" if packed and kw.get(
            "compressor") in ("topk", "quantize") else label
        m = LINE.match(line)
        assert m, line
        assert m.group(1).rstrip() == row.label == want_label
        mb = jax_comm_mb(kind, STEPS, **kw)
        assert row.comm_mb == mb
        assert m.group(4) == f"{mb:8.2f}"
        assert f"{row.loss:.4f}" == m.group(2)
        assert np.isfinite(row.loss) and 0.0 < row.auc < 1.0


def test_steps_default_to_the_environment(monkeypatch):
    """``--steps`` defaults to ``$COMPRESSED_COMM_STEPS``, else the
    example's 150."""
    seen = []

    def fake_run(name, model, kind, steps, **kw):
        seen.append(steps)
        return deepfm_ctr.RunResult(None, None, TrainLog(
            loss=[0.5], comm_mb=[0.0]), 0.5, None, None)

    monkeypatch.setattr(deepfm_ctr, "run", fake_run)
    monkeypatch.setenv("COMPRESSED_COMM_STEPS", "7")
    compressed_comm.main(["--device", "cpu"])
    monkeypatch.delenv("COMPRESSED_COMM_STEPS")
    compressed_comm.main(["--device", "cpu"])
    assert seen == [7] * 4 + [150] * 4
