"""Learning-rate schedules (counterpart of istvt_tpu/train/schedule.py).

Step-indexed functions step -> lr with optax's count semantics: the
optimizer's k-th update (k = 0, 1, ...) uses schedule(k), so the first
update under a warmup has lr 0. Values are computed in float32, term for
term as optax computes them, and returned as Python floats.
"""
from __future__ import annotations

import numpy as np

_F = np.float32


def reference_epoch_schedule(base_lr: float = 5e-4, warmup_epochs: int = 20,
                             steps_per_epoch: int = 1000):
    """The reference's manual per-epoch rule (train_CNN.py:209-211):
    (e + 1) * base_lr while e < warmup_epochs, then max(e, 1) ** -1.5."""

    def schedule(step: int) -> float:
        e = step // steps_per_epoch
        if e < warmup_epochs:
            return float(_F(e + 1) * _F(base_lr))
        return float(np.power(max(_F(e), _F(1.0)), _F(-1.5)))

    return schedule


def _cosine_decay(init_value: float, decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule."""

    def schedule(step: int) -> float:
        count = _F(min(step, decay_steps))
        cos = _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * count
                                          / _F(decay_steps)))
        return float(_F(init_value) * ((_F(1.0) - _F(alpha)) * cos
                                        + _F(alpha)))

    return schedule


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup_steps: int = 0, min_lr: float = 0.0):
    """Warmup + cosine decay (optax.warmup_cosine_decay_schedule from 0 to
    base_lr over warmup_steps, then cosine to min_lr at total_steps), or
    plain cosine decay without warmup."""
    if warmup_steps <= 0:
        return _cosine_decay(base_lr, max(total_steps, 1),
                             min_lr / max(base_lr, 1e-12))
    decay_steps = max(total_steps, warmup_steps + 1)
    alpha = 0.0 if base_lr == 0 else min_lr / base_lr
    decay = _cosine_decay(base_lr, decay_steps - warmup_steps, alpha)

    def schedule(step: int) -> float:
        if step < warmup_steps:   # optax.linear_schedule(0, base_lr)
            frac = _F(1.0) - _F(step) / _F(warmup_steps)
            return float(-_F(base_lr) * frac + _F(base_lr))
        return decay(step - warmup_steps)

    return schedule


def constant_schedule(lr: float):
    return lambda step: lr
