"""Architecture config registry: ``get_arch(id)`` / ``get_reduced(id)``.

Lists every architecture of the JAX package: the dense (llama3.2-1b,
yi-6b, qwen1.5-32b, starcoder2-15b), MoE (phi3.5-moe, llama4-maverick),
ssm (rwkv6-3b), hybrid (zamba2-7b), vlm (phi-3-vision) and audio
(whisper-large-v3) families.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (ArchConfig, INPUT_SHAPES, InputShape,
                                      ModelConfig, ParallelConfig)

_MODULES: Dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
}
# the JAX package's architectures the port cannot build yet, by id
_NOT_PORTED: tuple = ()


def list_archs() -> List[str]:
    return sorted(_MODULES)


def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP queue 1: "
            f"model zoo); the port builds {list_archs()}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {list_archs()}")
    return importlib.import_module(_MODULES[arch_id])


def get_arch(arch_id: str) -> ArchConfig:
    return _module(arch_id).FULL


def get_reduced(arch_id: str) -> ArchConfig:
    return _module(arch_id).reduced()


__all__ = ["ArchConfig", "ModelConfig", "ParallelConfig", "InputShape",
           "INPUT_SHAPES", "list_archs", "get_arch", "get_reduced"]
