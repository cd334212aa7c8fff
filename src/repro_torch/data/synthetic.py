"""Synthetic non-IID data, the port of ``repro.data.synthetic``'s LM token
streams, CTR generator and CIFAR-shaped images.

K workers, each with its own data distribution D^(k) (Section 3.1):

* token streams for LM training (:func:`lm_batch`,
  :func:`lm_batches_stacked`): uniform tokens of which a share is moved
  into the worker's own vocab band. The draws (the uniform ``base`` tokens
  and the band ``mask``) come from a ``torch.Generator`` or are given:
  handed JAX's draws, the tokens equal JAX's;
* sparse categorical CTR fields with a planted factorization-machine
  teacher, so AUC is meaningful. :func:`make_ctr_task` is numpy and equal
  to the JAX package's; the batches are drawn from a ``torch.Generator``
  on the target device with the same non-IID skew formula, so they are
  not the JAX package's bits;
* CIFAR-shaped images (:func:`image_batch`, :func:`image_batch_stacked`):
  class-conditional patterns plus noise, with the labels skewed towards
  each worker's own classes. The draws (the labels, the noise and the
  class patterns) come from ``torch.Generator`` s or are given: handed
  JAX's draws, the batch equals JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device

# (t, worker) -> (base, mask): the draws of step t's batch of one worker
LMDraws = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]
# worker -> (label, noise): the draws of one worker's image batch
ImageDraws = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]


# ----------------------------- LM token streams -----------------------------


def lm_draws(gen: torch.Generator, batch: int, seq_len: int, vocab: int,
             skew: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One worker's draws on ``gen.device``: ``base`` (batch, seq_len+1)
    int64 uniform in [0, vocab) and ``mask`` of the same shape, true with
    probability ``0.5 * min(skew, 1)`` (JAX's ``randint`` and
    ``bernoulli``, from torch's stream)."""
    shape = (batch, seq_len + 1)
    base = torch.randint(0, vocab, shape, generator=gen, device=gen.device)
    mask = torch.rand(shape, generator=gen,
                      device=gen.device) < 0.5 * min(skew, 1.0)
    return base, mask


def lm_tokens(base: torch.Tensor, mask: torch.Tensor, vocab: int,
              worker: int = 0, n_workers: int = 1,
              skew: float = 1.0) -> torch.Tensor:
    """The tokens of ``lm_batch`` from its draws: where ``mask`` holds, the
    base token moves into the worker's band ``[worker * band, (worker + 1)
    * band)``, ``band = vocab // n_workers``; IID (``base``) when ``skew <=
    0`` or with one worker. int32, as JAX's."""
    if skew <= 0 or n_workers <= 1:
        return base.to(torch.int32)
    band = vocab // n_workers
    banded = worker * band + torch.remainder(base, max(band, 1))
    return torch.where(mask, banded, base).to(torch.int32)


def lm_batch(gen: Optional[torch.Generator], batch: int, seq_len: int,
             vocab: int, worker: int = 0, n_workers: int = 1,
             skew: float = 1.0, *, base: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(batch, seq_len+1) int32 tokens of one worker: JAX's ``lm_batch``.
    The draws come from ``gen`` (:func:`lm_draws`) unless ``base`` and
    ``mask`` are given."""
    if base is None or mask is None:
        base, mask = lm_draws(gen, batch, seq_len, vocab, skew)
    if tuple(base.shape) != (batch, seq_len + 1) or \
            tuple(mask.shape) != tuple(base.shape):
        raise ValueError(f"draws of shape {tuple(base.shape)} / "
                         f"{tuple(mask.shape)}, expected "
                         f"{(batch, seq_len + 1)}")
    return lm_tokens(base, mask, vocab, worker, n_workers, skew)


def lm_batches_stacked(gen: Optional[torch.Generator], p: int, K: int,
                       per_worker: int, seq_len: int, vocab: int,
                       skew: float = 1.0, *,
                       draws: Optional[LMDraws] = None) -> torch.Tensor:
    """(p, K, per_worker, seq_len+1) int32: one communication round of
    batches, step by step and worker by worker, as JAX's. ``draws(t, k)``
    gives the (base, mask) of step t and worker k; by default they come
    from ``gen``, in that order."""
    out = []
    for t in range(p):
        row = []
        for k in range(K):
            base, mask = (draws(t, k) if draws is not None else
                          lm_draws(gen, per_worker, seq_len, vocab, skew))
            row.append(lm_batch(None, per_worker, seq_len, vocab, k, K,
                                skew, base=base, mask=mask))
        out.append(torch.stack(row))
    return torch.stack(out)


# --------------------------- CTR sparse features -----------------------------


@dataclasses.dataclass(frozen=True)
class CTRTask:
    """A planted DeepFM-style teacher over sparse categorical fields."""
    n_features: int
    n_fields: int
    embed_dim: int
    teacher_embed: np.ndarray   # (n_features, embed_dim)
    teacher_linear: np.ndarray  # (n_features,)
    field_offsets: np.ndarray   # (n_fields,) feature-id range starts
    field_sizes: np.ndarray


def make_ctr_task(seed: int, n_fields: int = 13,
                  features_per_field: int = 100,
                  embed_dim: int = 10) -> CTRTask:
    rng = np.random.default_rng(seed)
    n_features = n_fields * features_per_field
    return CTRTask(
        n_features=n_features,
        n_fields=n_fields,
        embed_dim=embed_dim,
        teacher_embed=rng.normal(0, 0.3, (n_features, embed_dim)),
        teacher_linear=rng.normal(0, 0.3, (n_features,)),
        field_offsets=np.arange(n_fields) * features_per_field,
        field_sizes=np.full(n_fields, features_per_field),
    )


@dataclasses.dataclass(frozen=True)
class CTRTeacher:
    """A task's teacher as f32 tensors on one device, copied there once."""
    n_fields: int
    embed: torch.Tensor
    linear: torch.Tensor
    offsets: torch.Tensor
    sizes: torch.Tensor


def ctr_teacher(task: CTRTask, device: "str | torch.device" = "cuda"
                ) -> CTRTeacher:
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return CTRTeacher(
        n_fields=task.n_fields, embed=f32(task.teacher_embed),
        linear=f32(task.teacher_linear),
        offsets=torch.as_tensor(task.field_offsets, dtype=torch.int32,
                                device=dev),
        sizes=f32(task.field_sizes))


def _draw(teacher: CTRTeacher, gen: torch.Generator, batch: int,
          centers: Optional[torch.Tensor], n_rows: int, skew: float
          ) -> Dict[str, torch.Tensor]:
    """``n_rows`` workers' batches; ``centers`` (n_rows,) are the workers'
    preferred positions in each field's range (None: IID)."""
    dev = teacher.embed.device
    shape = (n_rows, batch, teacher.n_fields)
    u = torch.rand(shape, generator=gen, device=dev)
    if centers is not None:
        noise = torch.randn(shape, generator=gen, device=dev)
        # workers concentrate on different parts of each field's range
        u = (1 - skew) * u + skew * torch.clamp(
            centers.view(-1, 1, 1) + 0.15 * noise, 0, 0.999)
    ids = teacher.offsets + (u * teacher.sizes).to(torch.int32)
    # teacher logit: FM(ids)
    emb = teacher.embed[ids.long()]
    lin = torch.sum(teacher.linear[ids.long()], dim=-1)
    s = torch.sum(emb, dim=2)
    s2 = torch.sum(emb * emb, dim=2)
    logit = lin + 0.5 * torch.sum(s * s - s2, dim=-1)
    label = torch.bernoulli(torch.sigmoid(logit), generator=gen)
    return {"feat_ids": ids, "label": label.to(torch.int32)}


def ctr_batch(teacher: CTRTeacher, gen: torch.Generator, batch: int,
              worker: int = 0, n_workers: int = 1, skew: float = 0.5
              ) -> Dict[str, torch.Tensor]:
    """{'feat_ids': (B, F) int32, 'label': (B,) int32}. Non-IID: each
    worker draws field values near its own slice of every field's range."""
    centers = None
    if n_workers > 1 and skew > 0:
        centers = torch.tensor([(worker + 0.5) / n_workers],
                               device=teacher.embed.device)
    out = _draw(teacher, gen, batch, centers, 1, skew)
    return {k: x[0] for k, x in out.items()}


def ctr_batch_stacked(teacher: CTRTeacher, gen: torch.Generator, K: int,
                      per_worker: int, skew: float = 0.5
                      ) -> Dict[str, torch.Tensor]:
    """All K workers' batches at once: (K, per_worker, F) ids and
    (K, per_worker) labels."""
    centers = None
    if K > 1 and skew > 0:
        centers = (torch.arange(K, device=teacher.embed.device) + 0.5) / K
    return _draw(teacher, gen, per_worker, centers, K, skew)


# ------------------------------ vision images --------------------------------

IMAGE_SHAPE = (32, 32, 3)
# the JAX package draws the class patterns from PRNGKey(7); the port's
# come from a generator seeded 7
PATTERN_SEED = 7


def class_logits(n_classes: int, worker: int, skew: float,
                 device: "str | torch.device" = "cpu") -> torch.Tensor:
    """Worker ``worker``'s label logits: classes near ``worker %
    n_classes`` (cyclically) over-sampled, ``-2 skew d**2`` at cyclic
    distance d, in f32 as JAX computes them."""
    d = torch.remainder(
        torch.arange(n_classes, device=device, dtype=torch.int32)
        - (worker % n_classes) + n_classes / 2, n_classes) - n_classes / 2
    return -skew * 2.0 * torch.square(d)


def class_patterns(gen: torch.Generator, n_classes: int = 10
                   ) -> torch.Tensor:
    """``(n_classes, 32, 32, 3)`` class-mean patterns, N(0, 0.25), on
    ``gen.device``."""
    return torch.randn((n_classes,) + IMAGE_SHAPE, generator=gen,
                       device=gen.device) * 0.5


def image_draws(gen: torch.Generator, batch: int, n_classes: int = 10,
                worker: int = 0, n_workers: int = 1, skew: float = 0.5
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One worker's draws on ``gen.device``: the labels, ``(batch,)`` int64
    from the categorical over :func:`class_logits` (uniform when IID: one
    worker or ``skew <= 0``), and the noise ``(batch, 32, 32, 3)`` N(0, 1)
    (JAX's ``categorical`` / ``randint`` and ``normal``, from torch's
    stream)."""
    dev = gen.device
    if n_workers > 1 and skew > 0:
        probs = torch.softmax(class_logits(n_classes, worker, skew, dev), 0)
        label = torch.multinomial(probs, batch, replacement=True,
                                  generator=gen)
    else:
        label = torch.randint(0, n_classes, (batch,), generator=gen,
                              device=dev)
    noise = torch.randn((batch,) + IMAGE_SHAPE, generator=gen, device=dev)
    return label, noise


def image_batch(gen: Optional[torch.Generator], batch: int,
                n_classes: int = 10, worker: int = 0, n_workers: int = 1,
                skew: float = 0.5, *, label: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                patterns: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """CIFAR-shaped synthetic classification with class-prior skew per
    worker: ``{'images': (batch, 32, 32, 3) f32, 'label': (batch,)
    int32}``, the images ``patterns[label] + noise``. The label and noise
    come from ``gen`` (:func:`image_draws`) unless given, the patterns
    from a generator seeded ``PATTERN_SEED`` on the draws' device unless
    given."""
    if label is None or noise is None:
        label, noise = image_draws(gen, batch, n_classes, worker,
                                   n_workers, skew)
    if tuple(label.shape) != (batch,) or \
            tuple(noise.shape) != (batch,) + IMAGE_SHAPE:
        raise ValueError(f"draws of shape {tuple(label.shape)} / "
                         f"{tuple(noise.shape)}, expected {(batch,)} / "
                         f"{(batch,) + IMAGE_SHAPE}")
    if patterns is None:
        patterns = class_patterns(torch.Generator(
            device=noise.device).manual_seed(PATTERN_SEED), n_classes)
    return {"images": patterns[label.long()] + noise,
            "label": label.to(torch.int32)}


def image_batch_stacked(gen: Optional[torch.Generator], K: int,
                        per_worker: int, skew: float = 0.5, *,
                        draws: Optional[ImageDraws] = None,
                        patterns: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
    """All K workers' batches, 10 classes: ``(K, per_worker, 32, 32, 3)``
    images and ``(K, per_worker)`` labels. ``draws(k)`` gives worker k's
    (label, noise); by default they come from ``gen``, worker by worker."""
    batches = []
    for k in range(K):
        label, noise = (draws(k) if draws is not None else
                        image_draws(gen, per_worker, 10, k, K, skew))
        batches.append(image_batch(None, per_worker, 10, k, K, skew,
                                   label=label, noise=noise,
                                   patterns=patterns))
    return {name: torch.stack([b[name] for b in batches])
            for name in ("images", "label")}
