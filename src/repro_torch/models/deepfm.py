"""The paper's own experiment models, DeepFM [8], Wide&Deep [6] and
ResNet20 [9], on stacked params.

The port of ``repro.models.deepfm``. Widths follow Section 6.1: embedding
dim 10, MLP 400-400-400, dropout 0.5 (exposed as the rate; off unless keep
masks are given). Every function takes the params of all K workers stacked
on a leading dim and returns one value per worker: the worker dim is
written out, not mapped over.

ResNet20's leaves keep the JAX package's layouts: conv weights HWIO
``(K, k, k, c_in, c_out)`` and images NHWC ``(K, B, 32, 32, 3)``, so the
packed layout and the checkpoints are the JAX package's element for
element. Inside the forward all K workers run as one grouped convolution
per conv (``groups=K``) on ``(B, K*C, H, W)`` activations, and one group
norm per norm, with XLA's "SAME" padding.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

PyTree = Any


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``repro.models.common.dense_init``: N(0, 1/d_in) in f32."""
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32) * (1.0 / math.sqrt(d_in))
    return w.to(dtype)


def init_deepfm(gen: torch.Generator, n_features: int, n_fields: int,
                embed_dim: int = 10,
                hidden: Tuple[int, ...] = (400, 400, 400)) -> PyTree:
    """One worker's params, drawn from ``gen`` on ``gen.device``."""
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.01

    p: Dict[str, Any] = {
        "embed": normal(n_features, embed_dim),
        "linear": normal(n_features),
        "bias": torch.zeros((), device=dev),
    }
    d_in = n_fields * embed_dim
    mlp = []
    for h in hidden:
        mlp.append({"w": dense_init(gen, d_in, h),
                    "b": torch.zeros((h,), device=dev)})
        d_in = h
    mlp.append({"w": dense_init(gen, d_in, 1),
                "b": torch.zeros((1,), device=dev)})
    p["mlp"] = mlp
    return p


def init_widedeep(gen: torch.Generator, n_features: int, n_fields: int,
                  embed_dim: int = 10,
                  hidden: Tuple[int, ...] = (400, 400, 400)) -> PyTree:
    # wide part = 'linear'; deep part = 'mlp'; no FM term
    return init_deepfm(gen, n_features, n_fields, embed_dim, hidden)


def _gather(table: torch.Tensor, feat_ids: torch.Tensor) -> torch.Tensor:
    """``table[k][feat_ids[k]]`` for every worker k: one gather over the
    stacked ``(K, n_features, ...)`` table."""
    K = feat_ids.shape[0]
    kidx = torch.arange(K, device=feat_ids.device).view(K, 1, 1)
    return table[kidx, feat_ids.long()]


def _deep(params: PyTree, emb: torch.Tensor,
          dropout_masks: Optional[Sequence[torch.Tensor]] = None,
          dropout_rate: float = 0.5) -> torch.Tensor:
    """The MLP; after each hidden layer's ReLU, with keep masks given (one
    ``(K, B, h)`` bool tensor per hidden layer, true with probability ``1 -
    rate``), ``h * mask / (1 - rate)`` as the JAX package's dropout. JAX
    draws the masks from a key, so they do not cross packages: hand JAX's
    masks in to reproduce its dropout."""
    h = emb.reshape(emb.shape[0], emb.shape[1], -1)
    layers = params["mlp"]
    if dropout_masks is not None and len(dropout_masks) != len(layers) - 1:
        raise ValueError(f"{len(dropout_masks)} dropout masks for "
                         f"{len(layers) - 1} hidden layers")
    for i, layer in enumerate(layers):
        h = torch.bmm(h, layer["w"]) + layer["b"][:, None, :]
        if i < len(layers) - 1:
            h = torch.relu(h)
            if dropout_masks is not None:
                h = h * dropout_masks[i] / (1 - dropout_rate)
    return h[..., 0]


def deepfm_logits(params: PyTree, feat_ids: torch.Tensor,
                  dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                  dropout_rate: float = 0.5) -> torch.Tensor:
    """feat_ids: (K, B, n_fields) int — one active feature per field;
    ``dropout_masks``: one (K, B, h) keep mask per hidden layer, or None
    (no dropout). Returns (K, B) logits."""
    emb = _gather(params["embed"], feat_ids)              # (K, B, F, E)
    first = torch.sum(_gather(params["linear"], feat_ids), dim=-1) \
        + params["bias"][:, None]
    # FM second order: 0.5 * ((sum e)^2 - sum e^2)
    s = torch.sum(emb, dim=2)
    s2 = torch.sum(emb * emb, dim=2)
    second = 0.5 * torch.sum(s * s - s2, dim=-1)
    return first + second + _deep(params, emb, dropout_masks, dropout_rate)


def _logloss(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Per-worker mean of the stable log-loss (``deepfm.py:80-81``)."""
    y = label.to(torch.float32)
    return torch.mean(torch.clamp_min(logits, 0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))), dim=-1)


def deepfm_loss(params: PyTree, batch: PyTree,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """batch: {'feat_ids': (K, B, F), 'label': (K, B) in {0, 1}}.
    Returns the (K,) per-worker losses."""
    return _logloss(deepfm_logits(params, batch["feat_ids"], dropout_masks),
                    batch["label"])


def widedeep_logits(params: PyTree, feat_ids: torch.Tensor,
                    dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                    dropout_rate: float = 0.5) -> torch.Tensor:
    emb = _gather(params["embed"], feat_ids)
    wide = torch.sum(_gather(params["linear"], feat_ids), dim=-1) \
        + params["bias"][:, None]
    return wide + _deep(params, emb, dropout_masks, dropout_rate)


def widedeep_loss(params: PyTree, batch: PyTree,
                  dropout_masks: Optional[Sequence[torch.Tensor]] = None
                  ) -> torch.Tensor:
    return _logloss(widedeep_logits(params, batch["feat_ids"],
                                    dropout_masks), batch["label"])


# ------------------------------- ResNet20 ------------------------------------


def _conv_init(gen: torch.Generator, k: int, c_in: int,
               c_out: int) -> torch.Tensor:
    """He init of one HWIO conv weight ``(k, k, c_in, c_out)``."""
    return torch.randn((k, k, c_in, c_out), generator=gen,
                       device=gen.device) * math.sqrt(2.0 / (k * k * c_in))


def init_resnet20(gen: torch.Generator, n_classes: int = 10,
                  width: int = 16) -> PyTree:
    """He et al.'s CIFAR ResNet: 3 stages x 3 blocks x 2 convs + stem + fc,
    one worker's params drawn from ``gen`` on ``gen.device``, with the JAX
    package's tree."""
    dev = gen.device
    p: Dict[str, Any] = {"stem": _conv_init(gen, 3, 3, width)}
    c_in = width
    stages = []
    for c_out in (width, 2 * width, 4 * width):
        blocks = []
        for _ in range(3):
            blk = {
                "conv1": _conv_init(gen, 3, c_in, c_out),
                "conv2": _conv_init(gen, 3, c_out, c_out),
                "scale1": torch.ones((c_out,), device=dev),
                "bias1": torch.zeros((c_out,), device=dev),
                "scale2": torch.ones((c_out,), device=dev),
                "bias2": torch.zeros((c_out,), device=dev),
            }
            if c_in != c_out:
                blk["proj"] = _conv_init(gen, 1, c_in, c_out)
            blocks.append(blk)
            c_in = c_out
        stages.append(blocks)
    p["stages"] = stages
    p["fc_w"] = dense_init(gen, c_in, n_classes)
    p["fc_b"] = torch.zeros((n_classes,), device=dev)
    return p


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: the total that keeps
    ``ceil(size / stride)`` outputs, the odd element on the high side
    (a 3x3 stride-2 conv on 32 pads (0, 1), not torch's (1, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Every worker's conv in one grouped call: ``x`` is ``(B, K*c_in, H,
    W)`` with worker k's channels at ``[k*c_in, (k+1)*c_in)``, ``w`` the
    stacked HWIO ``(K, k, k, c_in, c_out)``, permuted here to the grouped
    OIHW ``(K*c_out, c_in, k, k)``."""
    K, kh, kw, c_in, c_out = w.shape
    weight = w.permute(0, 4, 3, 1, 2).reshape(K * c_out, c_in, kh, kw)
    (top, bottom), (left, right) = (_same_pad(x.shape[2], kh, stride),
                                    _same_pad(x.shape[3], kw, stride))
    if top == bottom and left == right:
        return F.conv2d(x, weight, stride=stride, padding=(top, left),
                        groups=K)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, weight, stride=stride, groups=K)


def _norm_act(x: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """The JAX package's GroupNorm stand-in for BatchNorm, for all K
    workers: ``min(8, C)`` groups of contiguous channels per worker (so K
    times as many over the ``K*C`` channels), the biased variance, eps
    1e-5, the per-channel scale and bias, then ReLU."""
    K, C = scale.shape
    return torch.relu(F.group_norm(x, K * min(8, C), scale.reshape(-1),
                                   bias.reshape(-1), eps=1e-5))


def resnet20_logits(params: PyTree, images: torch.Tensor) -> torch.Tensor:
    """images: (K, B, 32, 32, 3) float32 (NHWC per worker). Returns the
    (K, B, n_classes) logits."""
    K, B, H, W, C = images.shape
    x = images.permute(1, 0, 4, 2, 3).reshape(B, K * C, H, W)
    x = _conv(x, params["stem"])
    for stage, blocks in enumerate(params["stages"]):
        for b, blk in enumerate(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            h = _conv(x, blk["conv1"], stride)
            h = _norm_act(h, blk["scale1"], blk["bias1"])
            h = _conv(h, blk["conv2"])
            sc = _conv(x, blk["proj"], stride) if "proj" in blk else x
            x = _norm_act(h + sc, blk["scale2"], blk["bias2"])
    x = x.mean(dim=(2, 3)).reshape(B, K, -1).transpose(0, 1)  # (K, B, C)
    return torch.bmm(x, params["fc_w"]) + params["fc_b"][:, None, :]


def resnet20_loss(params: PyTree, batch: PyTree) -> torch.Tensor:
    """batch: {'images': (K, B, 32, 32, 3), 'label': (K, B) int}. Returns
    the (K,) per-worker mean cross-entropies."""
    logits = resnet20_logits(params, batch["images"])
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["label"].long()[..., None])[..., 0]
    return torch.mean(logz - gold, dim=-1)
