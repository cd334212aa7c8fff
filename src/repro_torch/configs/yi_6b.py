"""yi-6b [dense] — llama-arch GQA [arXiv:2403.04652].

32L, d_model=4096, 32 heads (GQA kv=4), d_ff=11008, vocab=64000,
rope theta 5e6 (Yi's long-base RoPE).
The port of ``repro.configs.yi_6b``, equal field for field.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

FULL = ArchConfig(
    model=ModelConfig(
        arch_id="yi-6b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab_size=64000,
        rope_theta=5000000.0,
        long_context_window=16384,
    ),
    parallel=ParallelConfig(worker_mode="stacked"),
    source="arXiv:2403.04652 (Yi-6B)",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        FULL,
        model=dataclasses.replace(
            FULL.model, n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
            d_ff=512, vocab_size=512, long_context_window=64),
    )
