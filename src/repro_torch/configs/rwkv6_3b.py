"""rwkv6-3b [ssm] — Finch, data-dependent decay [arXiv:2404.05892].

32L, d_model=2560 (attention-free), channel-mix d_ff=8960, vocab=65536,
head_size=64 (40 WKV heads). O(1) state => native long_500k decode. The
port of ``repro.configs.rwkv6_3b``, equal field for field.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

FULL = ArchConfig(
    model=ModelConfig(
        arch_id="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=8960, vocab_size=65536,
        rwkv_head_size=64, rwkv_decay_rank=64,
    ),
    parallel=ParallelConfig(worker_mode="stacked"),
    source="arXiv:2404.05892 (RWKV-6 Finch 3B)",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        FULL,
        model=dataclasses.replace(
            FULL.model, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
            d_ff=448, vocab_size=512, rwkv_head_size=32, rwkv_decay_rank=16),
    )
