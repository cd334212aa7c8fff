"""Evaluation metrics used by the paper: ACC (CIFAR) and AUC (CTR), the
port of ``repro.train.metrics`` (``auc`` a numpy copy)."""
from __future__ import annotations

import numpy as np
import torch


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> float:
    """Share of rows whose arg-max logit is the label (one host sync)."""
    return float(torch.mean((torch.argmax(logits, -1) == labels)
                            .to(torch.float32)))


def auc(scores, labels) -> float:
    """Area under the ROC curve (rank-based, ties handled by midranks)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # midranks for ties
    s_sorted = scores[order]
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + j) + 1
        i = j + 1
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[labels == 1].sum()
                  - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
