"""Kernel dispatch by the operand's device.

A CPU tensor gets the plain PyTorch version; a CUDA tensor gets the CUDA
kernel, built at first use, or an error. There is no fallback from the
kernel to the plain version and no switch that selects it on the card.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_adam as _adam
from repro_torch.kernels import gossip as _gossip
from repro_torch.kernels import rwkv_scan as _wkv
from repro_torch.kernels import sign_compress as _sc

KERNELS = {k.__name__: k for k in (
    _adam.fused_adam, _gossip.gossip_mix, _gossip.gossip_adam_mix,
    _gossip.consensus_mix, _sc.sign_compress_stacked, _sc.sign_compress,
    _gossip.payload_mix, _fa.flash_attention, _wkv.rwkv_scan)}
# the two-launch reduce_axis form of sign_compress_stacked, counted apart
KERNELS["sign_compress_stacked_reduce"] = _sc._stacked_reduce


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def fused_adam(p, g, m, v, *, eta, beta1=0.9, beta2=0.999, tau=1e-6,
               weight_decay=0.0):
    fn = _adam.fused_adam_plain if _on_cpu(p) else _adam.fused_adam
    return fn(p, g, m, v, eta=eta, beta1=beta1, beta2=beta2, tau=tau,
              weight_decay=weight_decay)


def gossip_mix(x, offsets, offset_weights, self_weight):
    fn = _gossip.gossip_mix_plain if _on_cpu(x) else _gossip.gossip_mix
    return fn(x, offsets, offset_weights, self_weight)


def gossip_adam_mix(p, g, m, v, offsets, offset_weights, self_weight, *,
                    eta, beta1=0.9, beta2=0.999, tau=1e-6,
                    weight_decay=0.0):
    fn = (_gossip.gossip_adam_mix_plain if _on_cpu(p)
          else _gossip.gossip_adam_mix)
    return fn(p, g, m, v, offsets, offset_weights, self_weight, eta=eta,
              beta1=beta1, beta2=beta2, tau=tau, weight_decay=weight_decay)


def payload_mix(x, payloads, offset_weights, self_weight):
    fn = _gossip.payload_mix_plain if _on_cpu(x) else _gossip.payload_mix
    return fn(x, payloads, offset_weights, self_weight)


def consensus_mix(x, hat_self, hat_nbrs, offset_weights, gamma):
    fn = (_gossip.consensus_mix_plain if _on_cpu(x)
          else _gossip.consensus_mix)
    return fn(x, hat_self, hat_nbrs, offset_weights, gamma)


def sign_compress_stacked(x, hat, *, n_true=None, row_ranges=None,
                          reduce_axis=None):
    fn = (_sc.sign_compress_stacked_plain if _on_cpu(x)
          else _sc.sign_compress_stacked)
    return fn(x, hat, n_true=n_true, row_ranges=row_ranges,
              reduce_axis=reduce_axis)


def sign_compress(x, hat):
    fn = _sc.sign_compress_plain if _on_cpu(x) else _sc.sign_compress
    return fn(x, hat)


def flash_attention(q, k, v, *, causal=True, window=0):
    """Prefill attention. Neither version has a backward (the TPU kernel
    has none), so a call that autograd would record raises instead of
    returning a result without a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward; call it under torch.no_grad() "
            "or take sdpa's 'naive' / 'chunked' impl for training")
    fn = _fa.flash_attention_plain if _on_cpu(q) else _fa.flash_attention
    return fn(q, k, v, causal=causal, window=window)


def rwkv_scan(r, k, v, w, u, state):
    """The RWKV6 WKV recurrence. Neither version has a backward (the TPU
    kernel has none), so a call that autograd would record raises."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, w, u, state)):
        raise RuntimeError(
            "rwkv_scan has no backward; call it under torch.no_grad() or "
            "take rwkv6's wkv_impl='scan' for training")
    fn = _wkv.rwkv_scan_plain if _on_cpu(r) else _wkv.rwkv_scan
    return fn(r, k, v, w, u, state)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launches`."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
