"""The device rule shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises ``RuntimeError`` when CUDA is asked for and absent;
    it never falls through to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; this entry point runs on the GPU unless "
            "it is given device='cpu'")
    return dev
