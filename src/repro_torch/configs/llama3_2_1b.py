"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B].

16L, d_model=2048, 32 heads (GQA kv=8), d_ff=8192, vocab=128256,
head_dim=64, rope theta 500k, tied embeddings. The port of
``repro.configs.llama3_2_1b``, equal field for field.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

FULL = ArchConfig(
    model=ModelConfig(
        arch_id="llama3.2-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab_size=128256, head_dim=64,
        rope_theta=500000.0, tie_embeddings=True,
        long_context_window=16384,
    ),
    parallel=ParallelConfig(worker_mode="stacked"),
    source="hf:meta-llama/Llama-3.2-1B",
)


def reduced() -> ArchConfig:
    """<=2 layers, d_model<=512 CPU variant (same family and features)."""
    return dataclasses.replace(
        FULL,
        model=dataclasses.replace(
            FULL.model, n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
            head_dim=32, d_ff=512, vocab_size=512, long_context_window=64),
    )
