"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family].

48L, d_model=5120, 40 heads (GQA kv=8), expert d_ff=8192, vocab=202048,
MoE 128e top-1. ~770B total params: per-worker replicas are physically
impossible inside 512 v5e chips, so worker mode is 'global' (K=1 FSDP
Adam — the paper's centralized baseline) with bf16 moments; decentralized
D-Adam for this arch needs >= 2 full pods per worker (DESIGN.md §6).
long_500k uses an 8192-token chunked/rotating window (Llama-4 style
chunked attention).
The port of ``repro.configs.llama4_maverick``, equal field for field.
"""
import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

FULL = ArchConfig(
    model=ModelConfig(
        arch_id="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab_size=202048,
        n_experts=128, experts_per_token=1,
        rope_theta=500000.0,
        moe_group_size=512,
        long_context_window=8192,
    ),
    parallel=ParallelConfig(worker_mode="global", moment_dtype=torch.bfloat16,
                            remat="full"),
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family; maverick dims)",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        FULL,
        model=dataclasses.replace(
            FULL.model, n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
            d_ff=256, vocab_size=512, n_experts=4, experts_per_token=1,
            moe_group_size=64, long_context_window=64),
        parallel=dataclasses.replace(FULL.parallel, worker_mode="stacked",
                                     moment_dtype=None, remat="dots"),
    )
