"""qwen1.5-32b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B family scaled].

64L, d_model=5120, 40 heads (kv=40, MHA), d_ff=27392, vocab=152064,
QKV bias (the Qwen1.5 signature), rope theta 1e6.
Per-worker state ~32B params x (4+4+4)B exceeds a 16-chip group's HBM, so
the worker mode is 'pods' (gossip between pods, FSDP within).
The port of ``repro.configs.qwen1_5_32b``, equal field for field.
"""
import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

FULL = ArchConfig(
    model=ModelConfig(
        arch_id="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=27392, vocab_size=152064, qkv_bias=True,
        rope_theta=1000000.0,
        long_context_window=16384,
    ),
    parallel=ParallelConfig(worker_mode="pods", moment_dtype=torch.bfloat16),
    source="hf:Qwen/Qwen1.5-0.5B (arch family; 32B dims per brief)",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        FULL,
        model=dataclasses.replace(
            FULL.model, n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
            d_ff=640, vocab_size=512, long_context_window=64),
        parallel=dataclasses.replace(FULL.parallel, worker_mode="stacked",
                                     moment_dtype=None),
    )
