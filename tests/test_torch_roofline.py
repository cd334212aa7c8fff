"""The port's roofline and MFU (``repro_torch.analysis.roofline``) and
``ModelConfig.active_param_count``, against the JAX package on the CPU.

* ``Roofline`` given JAX's TPU figures (``repro.launch.mesh``) gives JAX's
  ``from_artifact(...).to_dict()`` on the same artifact; ``model_flops_for``
  is JAX's.
* ``param_count`` and ``active_param_count`` equal JAX's for all ten
  architectures, full and reduced.
* ``step_flops`` of a 2-layer llama prefill on the CPU (the flash kernel's
  plain version is aten products over the whole score matrix) equals the
  analytic count; with the card's dispatch stood in for, a flash launch
  adds ``flash_flops``, which the counter cannot see.
* The H100 figures, ``mfu`` and ``prefill_model_flops``.
"""
import dataclasses

import pytest
import torch

from repro.analysis.roofline import from_artifact as jfrom_artifact
from repro.analysis.roofline import model_flops_for as jmodel_flops_for
from repro.configs import get_arch as jget_arch
from repro.configs import get_reduced as jget_reduced
from repro.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS
from repro_torch.analysis.roofline import (H100_SXM, DeviceFigures, Roofline,
                                           attention_pairs, flash_flops, mfu,
                                           model_flops_for,
                                           prefill_model_flops, step_flops)
from repro_torch.configs import get_arch, get_reduced, list_archs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ops
from repro_torch.models.registry import build_model

torch.set_num_threads(2)

TPU = DeviceFigures(name="TPU v5e", hbm_bytes_per_s=HBM_BW,
                    flops_per_s={"bfloat16": PEAK_FLOPS},
                    link_bytes_per_s=ICI_BW, source="repro.launch.mesh")
ARTIFACTS = {
    "compute-bound": dict(arch="llama3.2-1b", shape="train_4k", mesh="16x16",
                          chips=256, cost={"flops": 3.1e14,
                                           "bytes accessed": 2.0e11},
                          collectives={"total": 1.5e9, "all-gather": 5e8,
                                       "all-reduce": 1e9},
                          model_flops=7.0e16),
    "memory-bound": dict(arch="rwkv6-3b", shape="decode_32k", mesh="4x4",
                         chips=16, cost={"flops": 1e11,
                                         "bytes accessed": 8.0e11},
                         collectives={"total": 0}, model_flops=2e11),
    "collective-bound": dict(arch="qwen1.5-32b", shape="train_4k",
                             mesh="2x16x16", chips=512,
                             cost={"flops": 2e12, "bytes accessed": 1e10},
                             collectives={"total": 9e10,
                                          "collective-permute": 9e10},
                             model_flops=0.0),
}


@pytest.mark.parametrize("name", ARTIFACTS)
def test_roofline_with_tpu_figures_equals_jax(name):
    art = ARTIFACTS[name]
    theirs = jfrom_artifact(art).to_dict()
    ours = Roofline(
        arch=art["arch"], shape=art["shape"], mesh=art["mesh"],
        chips=art["chips"], flops=art["cost"].get("flops", 0.0),
        hbm_bytes=art["cost"].get("bytes accessed", 0.0),
        coll_bytes=art["collectives"]["total"],
        model_flops=art.get("model_flops", 0.0),
        coll_breakdown=art["collectives"], figures=TPU).finalize().to_dict()
    assert set(ours) - set(theirs) == {"figures", "dtype"}
    assert {k: ours[k] for k in theirs} == theirs
    assert ours["bottleneck"] == name.split("-")[0]


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_model_flops_for_equals_jax(kind):
    assert model_flops_for(1_235_814_400, 4096, kind) == \
        jmodel_flops_for(1_235_814_400, 4096, kind)


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_equal_jax(arch):
    for ours, theirs in ((get_arch(arch), jget_arch(arch)),
                         (get_reduced(arch), jget_reduced(arch))):
        assert ours.model.param_count() == theirs.model.param_count()
        assert ours.model.active_param_count() == \
            theirs.model.active_param_count()
    moe = get_arch(arch).model.family == "moe"
    assert (get_arch(arch).model.active_param_count()
            < get_arch(arch).model.param_count()) == moe


def test_h100_figures_and_mfu():
    f = H100_SXM
    assert (f.hbm_bytes_per_s, f.peak("bfloat16"), f.peak("tf32"),
            f.peak("float32"), f.link_bytes_per_s) == \
        (3.35e12, 989e12, 495e12, 67e12, 450e9)
    assert f.peak("float32_3xtf32") == pytest.approx(495e12 / 3)
    assert "700 W" in f.source and "not measured" in f.source
    with pytest.raises(KeyError, match="fp8"):
        f.peak("fp8")
    assert mfu(989e12, 1.0) == 1.0
    # PERF.md's prediction for lm_train: 6 N tokens in a 289.4 ms step
    flops = model_flops_for(1.24e9, 4096, "train")
    assert mfu(flops, 0.2894) == pytest.approx(0.1065, abs=5e-4)
    r = Roofline("a", "s", "m", 1, flops=989e12, hbm_bytes=3.35e12 / 2,
                 coll_bytes=0.0, model_flops=0.0).finalize()
    assert (r.t_compute, r.t_memory, r.bottleneck) == (1.0, 0.5, "compute")


def test_prefill_model_flops():
    llama = get_reduced("llama3.2-1b").model
    assert prefill_model_flops(llama, 8, 1024) == \
        2 * llama.param_count() * 8 * 1024
    moe = get_reduced("phi3.5-moe-42b-a6.6b").model
    assert prefill_model_flops(moe, 2, 16) == \
        2 * moe.active_param_count() * 2 * 16
    vlm = get_reduced("phi-3-vision-4.2b").model
    assert prefill_model_flops(vlm, 2, 16) == \
        2 * vlm.param_count() * 2 * (16 + vlm.n_patches)
    whisper = get_reduced("whisper-large-v3").model
    emb = dataclasses.replace(whisper, n_layers=0,
                              n_encoder_layers=0).param_count()
    enc = dataclasses.replace(whisper, n_layers=0).param_count() - emb
    assert enc > 0
    assert prefill_model_flops(whisper, 2, 16) == 2 * (
        enc * 2 * whisper.n_audio_ctx + (whisper.param_count() - enc) * 32)


def test_attention_pairs():
    assert attention_pairs(16, 16, True, 0) == 16 * 17 // 2
    assert attention_pairs(8, 12, False, 0) == 96
    # a window of 4: row i keeps keys i-3 .. i
    assert attention_pairs(10, 10, True, 4) == 1 + 2 + 3 + 4 * 7
    assert flash_flops(2, 16, 16, 4, 32, True, 0) == \
        4 * 32 * 2 * 4 * attention_pairs(16, 16, True, 0)


def test_step_flops_of_a_llama_prefill_equals_the_analytic_count():
    cfg = dataclasses.replace(get_reduced("llama3.2-1b").model, n_layers=2)
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    B, S = 2, 16
    toks = torch.zeros((B, S), dtype=torch.int32)
    with torch.no_grad():
        got = step_flops(lambda: api.prefill(params, {"tokens": toks},
                                             attn_impl="kernel"))
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
    ffn = 3 * d * cfg.d_ff
    # projections and FFN over every token, the tied head over the last
    # position, and the plain flash version's two products over all S x S
    want = (2 * B * S * L * (attn + ffn) + 2 * B * d * cfg.vocab_size
            + L * 4 * B * cfg.n_heads * S * S * hd)
    assert got == want


def test_step_flops_adds_the_flash_kernels_work(monkeypatch):
    """On the card the flash kernel runs through ctypes, out of the
    counter's sight: each launch adds ``flash_flops`` of its shape."""
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(_fa, "flash_attention",
                        lambda q, k, v, causal=True, window=0:
                        torch.zeros_like(q))
    q = torch.zeros((2, 24, 8, 32))
    k = v = torch.zeros((2, 24, 2, 32))
    got = step_flops(lambda: [ops.flash_attention(q, k, v, causal=True,
                                                  window=w) for w in (0, 8)])
    assert got == (flash_flops(2, 24, 24, 8, 32, True, 0)
                   + flash_flops(2, 24, 24, 8, 32, True, 8))
