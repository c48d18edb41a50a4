"""Evaluation metrics (counterpart of istvt_tpu/train/metrics.py):
threshold-at-0 predictions, accuracy, the confusion counts and ROC AUC,
label 1 = fake (the positive class)."""
from __future__ import annotations

from typing import Dict

import torch


def binary_predictions(logits):
    """Threshold the single logit at 0 (reference train_CNN.py:527)."""
    return (logits.reshape(-1) > 0).to(torch.int32)


def accuracy(logits, labels):
    preds = binary_predictions(logits)
    return (preds == labels.reshape(-1).to(torch.int32)).float().mean()


def confusion_counts(logits, labels) -> Dict[str, torch.Tensor]:
    """tp / fp / tn / fn as f32 sums."""
    preds = binary_predictions(logits)
    y = labels.reshape(-1).to(torch.int32)
    pos = (y == 1).float()
    neg = (y == 0).float()
    pp = (preds == 1).float()
    return {"tp": (pos * pp).sum(), "fn": (pos * (1 - pp)).sum(),
            "fp": (neg * pp).sum(), "tn": (neg * (1 - pp)).sum()}


def auc(scores, labels):
    """ROC AUC via the Mann-Whitney U statistic with average tie ranks, in
    f32, as metrics.auc computes it."""
    s = scores.reshape(-1).float()
    y = labels.reshape(-1).float()
    order = torch.argsort(s, stable=True)
    s_sorted, y_sorted = s[order], y[order]
    n = s.shape[0]
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=s.device),
                        s_sorted[1:] != s_sorted[:-1]])
    seg = torch.cumsum(is_new.to(torch.int64), 0) - 1
    ranks1 = torch.arange(1, n + 1, dtype=torch.float32, device=s.device)
    seg_sum = torch.zeros(n, device=s.device).index_add_(0, seg, ranks1)
    seg_cnt = torch.zeros(n, device=s.device).index_add_(0, seg,
                                                         torch.ones_like(s))
    r = (seg_sum / seg_cnt)[seg]
    n_pos = y_sorted.sum()
    n_neg = (1 - y_sorted).sum()
    u = (r * y_sorted).sum() - n_pos * (n_pos + 1) / 2.0
    return u / (n_pos * n_neg).clamp_min(1.0)


class Welford:
    """Host-side streaming mean for the loss / accuracy running averages."""

    def __init__(self):
        self.n, self.total = 0, 0.0

    def update(self, value, count: int = 1):
        self.total += float(value) * count
        self.n += count

    @property
    def mean(self) -> float:
        return self.total / max(self.n, 1)
