"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

81 Mamba2 layers (d_model=3584, ssm_state=64, expand 2 => d_inner=7168,
112 SSM heads) with one SHARED attention(32H, kv=32)+MLP(d_ff=14336) block
re-applied after every whole segment of 14 layers (Zamba2's weight
sharing; LoRA deltas omitted). That is 5 sites, not the 6 that the JAX
config's docstring says: the last segment has 11 layers and no block
(``models.hybrid.n_attn_sites``). O(1) SSM state => native long_500k
decode; the shared-attn KV sites use a 4096 window for long_500k.
The port of ``repro.configs.zamba2_7b``, equal field for field.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

FULL = ArchConfig(
    model=ModelConfig(
        arch_id="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_expand=2, ssm_conv=4,
        shared_attn_period=14,
        long_context_window=4096,
    ),
    parallel=ParallelConfig(worker_mode="stacked"),
    source="arXiv:2411.15242 (Zamba2-7B)",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        FULL,
        model=dataclasses.replace(
            FULL.model, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
            d_ff=256, vocab_size=512, ssm_state=16, ssm_heads=4,
            shared_attn_period=1, long_context_window=32),
    )
