"""Mamba2 (SSD) block, the substrate of the zamba2-7b hybrid: the port of
``repro.models.mamba2``.

Per layer (n_groups = 1, as in JAX):

  [z, xBC, dt] = x @ W_in
  xBC = silu(causal_depthwise_conv(xBC, k=4))
  x_s (H, P), B (N), C (N);  dt = softplus(dt + dt_bias);  a = exp(-exp(A)dt)
  h_t = a_t * h_{t-1} + (dt_t * x_t) (x) B_t          h: (H, P, N)
  y_t = h_t . C_t + D * x_t
  out = W_out( rmsnorm(y) * silu(z) )

JAX's rounding points: the projections, the conv and the gates in the
compute dtype, the scan in f32. The conv is JAX's loop of k shifted adds
in the compute dtype (a grouped ``conv1d`` would sum in another order).

JAX's scan is ``lax.scan`` over the S steps. A Python loop over the steps
would make ~S x 81 iterations a zamba2-7b prefill, so :func:`ssd_scan`
computes the same recurrence in the chunked (SSD) form in torch ops, in
f32: within a chunk of Q steps ``y = (C B^T o L)(dt x) + C (decay o
h_in)`` with ``L[i, j] = exp(sum_{j<t<=i} log a_t)``, each such sum added
up step by step (no difference of two cumulative sums), and a short pass
over the chunks carries h. ``log a = -exp(A_log) dt`` is taken as it is,
never as the log of a rounded ``a``. One step (decode) is the recurrence
step itself. The leaves in ``F32_LEAVES`` are read in f32 wherever they
are used, so a compute-dtype copy of the params keeps them as they are.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common

PyTree = Any
# per-layer leaves every use reads in f32 (the decay, the skip, the dt
# bias): a compute-dtype copy of them would move the decays
F32_LEAVES = ("A_log", "D", "dt_bias")
# steps per chunk of the chunked scan
SSD_CHUNK = 64


def init_layer(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """One layer's params, drawn from ``gen`` at JAX's init scales (in
    JAX's order: in_proj, conv_w, out_proj)."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = cfg.resolved_ssm_heads
    dt, dev = cfg.param_dtype, gen.device
    in_proj = common.dense_init(gen, d, 2 * di + 2 * N + H, dt)
    conv_w = (torch.randn((cfg.ssm_conv, di + 2 * N), generator=gen,
                          device=dev, dtype=torch.float32) * 0.1).to(dt)
    out_proj = common.dense_init(gen, di, d, dt)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "norm": torch.ones((d,), dtype=dt, device=dev),
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di + 2 * N,), dtype=dt, device=dev),
        "A_log": torch.zeros((H,), **f32),      # a = exp(-exp(A_log)*dt)
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "gn": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": out_proj,
    }


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, k-1, di + 2N): trailing conv inputs
    ssm: torch.Tensor    # (B, H, P, N) f32


def init_state(cfg: ModelConfig, batch: int,
               device: "str | torch.device" = "cpu") -> MambaState:
    di, N = cfg.d_inner, cfg.ssm_state
    H = cfg.resolved_ssm_heads
    return MambaState(
        torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N),
                    dtype=cfg.compute_dtype, device=device),
        torch.zeros((batch, H, di // H, N), dtype=torch.float32,
                    device=device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x: (B, S, C); w: (k, C); prev: (B, k-1,
    C). Returns (out (B, S, C), new_prev), k shifted adds in x's dtype."""
    k = w.shape[0]
    S = x.shape[1]
    xp = torch.cat([prev.to(x.dtype), x], dim=1)     # (B, S+k-1, C)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :].to(x.dtype)
    new_prev = xp[:, -(k - 1):, :] if k > 1 else prev
    return out + b.to(x.dtype), new_prev


def _segsum(la: torch.Tensor) -> torch.Tensor:
    """la (..., Q) -> (..., Q, Q): ``sum_{j<t<=i} la_t`` at [i, j] for
    j <= i, each added up from t = j+1 on; -inf above the diagonal."""
    Q = la.shape[-1]
    ones = torch.ones((Q, Q), dtype=torch.bool, device=la.device)
    x = la[..., :, None].expand(*la.shape, Q)        # x[..., i, j] = la_i
    x = x.masked_fill(~torch.tril(ones, -1), 0.0)
    seg = torch.cumsum(x, dim=-2)
    return seg.masked_fill(~torch.tril(ones), float("-inf"))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, log_a: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor,
             chunk: int = SSD_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence ``h_t = a_t h_{t-1} + (dt_t x_t) (x) B_t``, ``y_t =
    h_t . C_t``, in f32, with ``a = exp(log_a)``.

    x: (B, S, H, P); dt, log_a: (B, S, H); Bm, Cm: (B, S, N); state: (B,
    H, P, N), any float dtype. Returns (y (B, S, H, P), the final state
    (B, H, P, N)), both f32. One step runs JAX's step; longer sequences
    the chunked form over chunks of ``chunk`` steps, the last one padded
    with steps that change nothing (dt = 0, log a = 0)."""
    f32 = torch.float32
    x, dt, log_a, Bm, Cm, h = (t.to(f32) for t in (x, dt, log_a, Bm, Cm,
                                                    state))
    B, S, H, P = x.shape
    if S == 1:
        upd = (dt[:, 0, :, None] * x[:, 0])[..., None] \
            * Bm[:, 0, None, None, :]
        h = torch.exp(log_a[:, 0])[..., None, None] * h + upd
        return torch.einsum("bhpn,bn->bhp", h, Cm[:, 0])[:, None], h
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        x, dt, log_a, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                                for t in (x, dt, log_a, Bm, Cm))
    N = Bm.shape[-1]
    x = x.reshape(B, nc, Q, H, P)
    Bc, Cc = Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N)
    u = dt.reshape(B, nc, Q, H)[..., None] * x                # dt x
    la = log_a.reshape(B, nc, Q, H).transpose(2, 3)           # (B,nc,H,Q)
    seg = _segsum(la)                                         # (B,nc,H,Q,Q)
    # within each chunk: y_i = sum_{j<=i} L[i,j] (C_i . B_j) u_j
    scores = torch.exp(seg) * torch.einsum("bcin,bcjn->bcij", Cc, Bc
                                           )[:, :, None]
    y = torch.einsum("bchij,bcjhp->bcihp", scores, u)
    # each chunk's own state from zero, and its decay over the chunk
    to_end = torch.exp(seg[..., -1, :]).transpose(2, 3)       # (B,nc,Q,H)
    states = torch.einsum("bcjhp,bcjn->bchpn", u * to_end[..., None], Bc)
    decay = torch.exp(torch.cumsum(la, dim=-1))               # (B,nc,H,Q)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, c, :, -1, None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)                           # (B,nc,H,P,N)
    y = y + torch.einsum("bcin,bchpn->bcihp", Cc, h_in) \
        * decay.transpose(2, 3)[..., None]
    return y.reshape(B, nc * Q, H, P)[:, :S], h


def layer_forward(layer: PyTree, h: torch.Tensor, cfg: ModelConfig,
                  state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """Pre-norm residual Mamba2 block. h: (B, S, d). Returns (h, the new
    state: the conv inputs in h's dtype, the SSM state in f32)."""
    B, S, d = h.shape
    di, N = cfg.d_inner, cfg.ssm_state
    H = cfg.resolved_ssm_heads
    P = di // H
    dtype = h.dtype
    f32 = torch.float32

    hn = common.rms_norm(h, layer["norm"], cfg.norm_eps)
    zxbcdt = hn @ layer["in_proj"].to(dtype)
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * N]
    dt_raw = zxbcdt[..., -H:]

    xBC, new_conv = _causal_conv(xBC, layer["conv_w"], layer["conv_b"],
                                 state.conv)
    xBC = F.silu(xBC.to(f32)).to(dtype)
    x_s = xBC[..., :di].reshape(B, S, H, P)
    Bm = xBC[..., di:di + N]
    Cm = xBC[..., di + N:]

    dt_v = F.softplus(dt_raw.to(f32) + layer["dt_bias"].to(f32)[None, None])
    log_a = -torch.exp(layer["A_log"].to(f32))[None, None, :] * dt_v

    y, new_ssm = ssd_scan(x_s, dt_v, log_a, Bm, Cm, state.ssm)
    y = y + layer["D"].to(f32)[None, None, :, None] * x_s.to(f32)
    y = y.reshape(B, S, di)
    y = common.rms_norm(y.to(dtype), layer["gn"], cfg.norm_eps)
    y = y * F.silu(z.to(f32)).to(dtype)
    out = y @ layer["out_proj"].to(dtype)
    return h + out, MambaState(new_conv, new_ssm)
