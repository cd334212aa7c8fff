"""whisper-large-v3 [audio] — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].

32 decoder layers (+32 encoder layers over stubbed frame embeddings),
d_model=1280, 20 heads (kv=20), d_ff=5120, vocab=51866, LayerNorm + GELU.
The decoder's learned positions are allocated to 33,024 (the published
cap is 448: the JAX package's documented deviation, ``models.whisper``).
The port of ``repro.configs.whisper_large_v3``, equal field for field.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

FULL = ArchConfig(
    model=ModelConfig(
        arch_id="whisper-large-v3", family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab_size=51866,
        n_encoder_layers=32, n_audio_ctx=1500,
        mlp_kind="gelu", norm_kind="layer",
    ),
    parallel=ParallelConfig(worker_mode="stacked"),
    source="arXiv:2212.04356 (Whisper large-v3)",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        FULL,
        model=dataclasses.replace(
            FULL.model, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
            d_ff=256, vocab_size=512, n_encoder_layers=2, n_audio_ctx=16),
    )
