"""The ISTVT criterion (counterpart of istvt_tpu/train/losses.py).

Only `bce_with_logits` is ported: the rest of the JAX loss library serves
other models and training modes (ROADMAP.md queue 1, 'Training').
"""
from __future__ import annotations

import torch


def bce_with_logits(logits, labels):
    """nn.BCEWithLogitsLoss (mean), in f32, in the JAX package's stable
    form max(x, 0) - x y + log1p(exp(-|x|)) (train/losses.py:26-34)."""
    x = logits.reshape(-1).float()
    y = labels.reshape(-1).float()
    per = torch.clamp_min(x, 0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return per.mean()
