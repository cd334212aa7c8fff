"""Architecture config registry: ``get_arch(id)`` / ``get_reduced(id)``.

Lists only the architectures the port can build (llama3.2-1b, rwkv6-3b).
The JAX package's other configs (qwen1.5-32b, starcoder2-15b, phi3.5-moe,
whisper-large-v3, zamba2-7b, yi-6b, llama4-maverick, phi-3-vision) belong
to the model zoo, not ported yet: asking for one raises
``NotImplementedError`` (ROADMAP queue 1: model zoo).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (ArchConfig, INPUT_SHAPES, InputShape,
                                      ModelConfig, ParallelConfig)

_MODULES: Dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}
# the JAX package's other architectures, by id
_NOT_PORTED = ("qwen1.5-32b", "starcoder2-15b", "phi3.5-moe-42b-a6.6b",
               "whisper-large-v3", "zamba2-7b", "yi-6b",
               "llama4-maverick-400b-a17b", "phi-3-vision-4.2b")


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
