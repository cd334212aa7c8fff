"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model=4096, 32 heads (GQA kv=8), expert d_ff=6400, vocab=32064,
MoE 16e top-2. Worker mode 'pods': 42B params + moments exceed a 16-chip
group, and expert-parallel sharding wants the whole in-pod 'model' axis.
The port of ``repro.configs.phi3_5_moe``, equal field for field.
"""
import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

FULL = ArchConfig(
    model=ModelConfig(
        arch_id="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab_size=32064,
        n_experts=16, experts_per_token=2,
        long_context_window=16384,
    ),
    parallel=ParallelConfig(worker_mode="pods", moment_dtype=torch.bfloat16),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        FULL,
        model=dataclasses.replace(
            FULL.model, n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
            d_ff=320, vocab_size=512, n_experts=4, experts_per_token=2,
            moe_group_size=64, long_context_window=64),
        parallel=dataclasses.replace(FULL.parallel, worker_mode="stacked",
                                     moment_dtype=None),
    )
