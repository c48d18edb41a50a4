"""Evaluation metrics (counterpart of istvt_tpu/train/metrics.py):
threshold-at-0 predictions, accuracy, the confusion counts, OULU's
APCER / BPCER / ACER, ROC AUC, per-manipulation accuracy and top-k
accuracy, label 1 = fake (the positive class)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def binary_predictions(logits):
    """Threshold the single logit at 0 (reference train_CNN.py:527)."""
    return (logits.reshape(-1) > 0).to(torch.int32)


def accuracy(logits, labels):
    preds = binary_predictions(logits)
    return (preds == labels.reshape(-1).to(torch.int32)).float().mean()


def confusion_counts(logits, labels, mask=None) -> Dict[str, torch.Tensor]:
    """tp / fp / tn / fn as f32 sums; mask (0 / 1 per clip) leaves clips
    out."""
    preds = binary_predictions(logits)
    y = labels.reshape(-1).to(torch.int32)
    m = torch.ones_like(y, dtype=torch.float32) if mask is None else \
        mask.reshape(-1).float()
    pos = (y == 1).float() * m
    neg = (y == 0).float() * m
    pp = (preds == 1).float()
    return {"tp": (pos * pp).sum(), "fn": (pos * (1 - pp)).sum(),
            "fp": (neg * pp).sum(), "tn": (neg * (1 - pp)).sum()}


def acer(counts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """OULU-NPU presentation-attack metrics (reference train_CNN.py:885-893):
    APCER = attacks accepted as live / attacks, BPCER = live rejected /
    live, ACER = their mean; label 1 = attack."""
    n_attack = counts["tp"] + counts["fn"]
    n_live = counts["tn"] + counts["fp"]
    apcer = counts["fn"] / n_attack.clamp_min(1.0)
    bpcer = counts["fp"] / n_live.clamp_min(1.0)
    return {"apcer": apcer, "bpcer": bpcer, "acer": 0.5 * (apcer + bpcer)}


def per_type_accuracy(logits, labels, fake_types, num_types: int = 5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(accuracy, count) per manipulation type (reference
    train_CNN.py:976-982; 0 pristine, 1 Deepfakes, 2 NeuralTextures,
    3 FaceSwap, 4 Face2Face). A type outside [0, num_types) counts
    nowhere, as jax.nn.one_hot gives it a zero row."""
    preds = binary_predictions(logits)
    y = labels.reshape(-1).to(torch.int32)
    correct = (preds == y).float()
    t = fake_types.reshape(-1).to(torch.int64)
    onehot = (t[:, None] == torch.arange(num_types, device=t.device)
              ).float()
    per_correct = correct @ onehot
    per_count = onehot.sum(0)
    return per_correct / per_count.clamp_min(1.0), per_count


def topk_accuracy(logits, labels, ks=(1, 5)) -> Dict[str, torch.Tensor]:
    """Top-k accuracies (reference resnet3d/utils/util.py:60-71)."""
    labels = labels.reshape(-1).to(torch.int64)
    order = torch.argsort(-logits, dim=-1, stable=True)
    return {f"top{k}": (order[:, :k] == labels[:, None]).any(-1).float()
            .mean() for k in ks}


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
