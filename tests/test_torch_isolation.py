"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor the
JAX package, its entry points refuse to fall back to the CPU without CUDA,
its kernel build fails loudly without ``nvcc``, and ``chip_smoke.py``
fails without a card or without the rest of the repository.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import _build

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    roots = set(imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.core.api import make_optimizer
    from repro_torch.data.synthetic import ctr_teacher, make_ctr_task
    from repro_torch.launch import compressed_comm, decentralized_lm, \
        deepfm_ctr
    from repro_torch.models.deepfm import deepfm_loss
    from repro_torch.train.loop import DecentralizedTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    opt = make_optimizer("d-adam", 8, backend="packed")
    assert opt.device.type == "cuda"
    trainer = DecentralizedTrainer(deepfm_loss, opt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_optimizer("d-adam", 8, backend="packed")
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.init({"w": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="CUDA"):
        deepfm_ctr.run(steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        decentralized_lm.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        compressed_comm.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ctr_teacher(make_ctr_task(0, 2, 4))
    # asking for the CPU is the one way to run without a card
    assert make_optimizer("d-adam", 8, device="cpu").device.type == "cpu"


def test_build_raises_a_clear_error_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(root=tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_build_digest_follows_the_sources():
    d = _build.digest()
    assert len(d) == 16 and d == _build.digest()
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)


def _run_smoke(cwd: pathlib.Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=""))


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py runs for real there")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
