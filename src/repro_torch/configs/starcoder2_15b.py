"""starcoder2-15b [dense] — GQA + RoPE + sliding window [arXiv:2402.19173].

40L, d_model=6144, 48 heads (GQA kv=4), d_ff=24576, vocab=49152.
StarCoder2 trains with a 4096 sliding window (its long-context mechanism),
LayerNorm + GELU MLP. The window makes long_500k natively sub-quadratic.
The port of ``repro.configs.starcoder2_15b``, equal field for field.
"""
import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

FULL = ArchConfig(
    model=ModelConfig(
        arch_id="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
        d_ff=24576, vocab_size=49152,
        rope_theta=100000.0, mlp_kind="gelu", norm_kind="layer",
        sliding_window=4096,
    ),
    parallel=ParallelConfig(worker_mode="stacked",
                            moment_dtype=torch.bfloat16),
    source="arXiv:2402.19173 (StarCoder2)",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        FULL,
        model=dataclasses.replace(
            FULL.model, n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
            d_ff=512, vocab_size=512, sliding_window=16),
        parallel=dataclasses.replace(FULL.parallel, moment_dtype=None),
    )
