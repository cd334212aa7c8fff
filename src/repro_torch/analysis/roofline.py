"""The three-term roofline model and the model-FLOPs utilisation, the port
of ``repro.analysis.roofline``, with a card's figures as an argument:

    T_compute    = FLOPs / peak FLOP/s of the dtype
    T_memory     = HBM bytes / HBM bytes/s
    T_collective = collective bytes / link bytes/s

The JAX package takes its FLOPs and bytes from ``compiled.cost_analysis()``
and the TPU v5e's rates. The port compiles nothing: :func:`step_flops`
counts a step's FLOPs with ``torch.utils.flop_counter.FlopCounterMode``,
and :data:`H100_SXM` holds the card's rates, the one home of every rate
the port and ``chip_smoke.py`` use.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceFigures:
    """A card's peak rates: HBM bytes/s, FLOP/s by operand type (dense,
    no sparsity), and the bytes/s of one link direction."""
    name: str
    hbm_bytes_per_s: float
    flops_per_s: Mapping[str, float]
    link_bytes_per_s: float
    source: str

    def peak(self, dtype: str) -> float:
        if dtype not in self.flops_per_s:
            raise KeyError(f"{self.name} has no {dtype!r} rate; it has "
                           f"{sorted(self.flops_per_s)}")
        return self.flops_per_s[dtype]


_TF32 = 495e12
# NVIDIA's H100 data sheet for the SXM part (H100 80GB HBM3) at its 700 W
# power limit: none of these is measured. "float32_3xtf32" is an f32
# product as three TF32 products (the f32 flash kernel's design), "float32"
# the rate outside the tensor cores.
H100_SXM = DeviceFigures(
    name="NVIDIA H100 80GB HBM3",
    hbm_bytes_per_s=3.35e12,
    flops_per_s={"bfloat16": 989e12, "float16": 989e12, "tf32": _TF32,
                 "float32_3xtf32": _TF32 / 3, "float32": 67e12},
    link_bytes_per_s=450e9,
    source="NVIDIA H100 data sheet, SXM 80GB HBM3 at a 700 W power "
           "limit; dense rates; not measured")


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float              # per-device FLOPs
    hbm_bytes: float          # per-device bytes accessed
    coll_bytes: float         # per-device collective bytes
    model_flops: float        # 6 * N_active * tokens (whole step, global)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    coll_breakdown: Optional[Dict[str, int]] = None
    figures: DeviceFigures = H100_SXM
    dtype: str = "bfloat16"   # the operand type of the compute term

    def finalize(self) -> "Roofline":
        f = self.figures
        self.t_compute = self.flops / f.peak(self.dtype)
        self.t_memory = self.hbm_bytes / f.hbm_bytes_per_s
        self.t_collective = self.coll_bytes / f.link_bytes_per_s
        return self

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def usefulness(self) -> float:
        """MODEL_FLOPS / total FLOPs (global)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def step_time(self) -> float:
        """No-overlap estimate: max of the three terms (s)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self) -> Dict[str, Any]:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)}
        d.update(figures=self.figures.name, bottleneck=self.bottleneck,
                 usefulness=self.usefulness, step_time=self.step_time)
        return d


def model_flops_for(n_active_params: int, tokens: int, kind: str) -> float:
    """6ND for a train step (fwd+bwd), 2ND for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens


def prefill_model_flops(cfg: Any, batch: int, seq: int) -> float:
    """2ND of a prefill of ``batch`` prompts of ``seq`` tokens, N the
    active params (``ModelConfig.active_param_count``): a vlm's rows also
    carry its ``n_patches`` positions, and an audio model's encoder params
    run over its ``n_audio_ctx`` frames, the rest over the tokens."""
    if cfg.family == "audio":
        no_dec = dataclasses.replace(cfg, n_layers=0)
        enc = no_dec.param_count() - dataclasses.replace(
            no_dec, n_encoder_layers=0).param_count()
        return (model_flops_for(enc, batch * cfg.n_audio_ctx, "serve")
                + model_flops_for(cfg.param_count() - enc, batch * seq,
                                  "serve"))
    positions = seq + (cfg.n_patches if cfg.family == "vlm" else 0)
    return model_flops_for(cfg.active_param_count(), batch * positions,
                           "serve")


def mfu(model_flops: float, seconds: float,
        figures: DeviceFigures = H100_SXM, dtype: str = "bfloat16") -> float:
    """The share of the card's peak ``dtype`` rate that ``model_flops`` in
    ``seconds`` reach."""
    return model_flops / seconds / figures.peak(dtype)


def attention_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the masks keep, per batch row and head."""
    i = np.arange(S)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(S, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_flops(B: int, S: int, T: int, Hq: int, D: int, causal: bool,
                window: int) -> int:
    """The flash kernel's FLOPs: two products of D multiply-adds for each
    (query, key) pair the masks keep, in each batch row and query head."""
    return 4 * D * B * Hq * attention_pairs(S, T, causal, window)


def step_flops(fn: Callable, *args: Any) -> int:
    """The FLOPs of ``fn(*args)``: ``FlopCounterMode``'s count of the aten
    products (matmuls, convolutions, SDPA), the stand-in for
    ``cost_analysis``, plus :func:`flash_flops` for every launch of the
    CUDA flash kernel, which runs through ``ctypes`` where the counter
    cannot see it. On the CPU the flash kernel's plain version is aten
    products over the whole (S, T) score matrix, and counted as such.
    The other CUDA kernels (Adam, gossip, sign, WKV) are elementwise or
    scan work, which the counter leaves out of aten's too. Swaps the
    flash wrapper on its module for the call: not thread-safe."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flash_attention as fa

    kernel, extra = fa.flash_attention, [0]

    def counted(q, k, v, *, causal=True, window=0):
        out = kernel(q, k, v, causal=causal, window=window)
        B, S, Hq, D = q.shape
        extra[0] += flash_flops(B, S, k.shape[1], Hq, D, causal, window)
        return out

    fa.flash_attention = counted
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args)
    finally:
        fa.flash_attention = kernel
    return int(counter.get_total_flops()) + extra[0]
