"""phi-3-vision-4.2b [vlm] — phi3-mini + CLIP (stubbed)
[hf:microsoft/Phi-3-vision-128k-instruct].

32L, d_model=3072, 32 heads (kv=32), d_ff=8192, vocab=32064; the CLIP
ViT-L/14 image encoder is a stub (the inputs carry (B, 576, 1024) patch
features); the 1024->3072 projector and the language backbone are real.
The port of ``repro.configs.phi3_vision``, equal field for field.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

FULL = ArchConfig(
    model=ModelConfig(
        arch_id="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32064,
        n_patches=576,
        long_context_window=16384,
    ),
    parallel=ParallelConfig(worker_mode="stacked"),
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        FULL,
        model=dataclasses.replace(
            FULL.model, n_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
            d_ff=512, vocab_size=512, n_patches=8, long_context_window=64),
    )
