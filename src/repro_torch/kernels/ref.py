"""Plain-torch oracles: the simplest correct form of each kernel's math."""
from __future__ import annotations

from typing import Tuple

import torch


def fused_adam_ref(p, g, m, v, *, eta: float, beta1: float, beta2: float,
                   tau: float, weight_decay: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The paper's Alg. 1 lines 4-6 (no bias correction)."""
    g = g.to(m.dtype)
    if weight_decay:
        g = g + weight_decay * p.to(m.dtype)
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * g * g
    p_new = p - (eta * m_new / (torch.sqrt(v_new) + tau)).to(p.dtype)
    return p_new, m_new, v_new


def sign_compress_ref(x, hat, *, gamma_scale: float = 1.0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CHOCO error-feedback sign compression:
        delta = x - hat
        scale = mean(|delta|)
        q     = int8 sign(delta)
        hat'  = hat + scale * q
    Returns (q int8, scale f32 scalar, hat')."""
    delta = (x - hat).to(torch.float32)
    scale = torch.mean(torch.abs(delta)) * gamma_scale
    q = torch.sign(delta).to(torch.int8)
    hat_new = (hat.to(torch.float32)
               + scale * q.to(torch.float32)).to(hat.dtype)
    return q, scale, hat_new
