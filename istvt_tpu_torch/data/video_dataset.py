"""Clip datasets (counterpart of istvt_tpu/data/video_dataset.py).

Only `SyntheticVideoDataset` is ported, as a numpy copy: the JAX package's
module imports jax-side packages, and the port imports nothing of it.
tests/test_torch_train_step.py holds its items equal to the JAX class's.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticVideoDataset:
    """Deterministic synthetic clips (video_dataset.py:293-361, its default
    recipe): 'fake' clips (odd index, label 1) carry per-frame independent
    noise in a moving patch over a rolled base frame; real clips (label 0)
    only the smooth motion. Items: {'clips': (T, S, S, 3) f32, 'labels':
    int32, 'fake_types': int32}. The static-patch and graded-amplitude
    variants serve interpretation tests (ROADMAP.md queue 1,
    'Interpretation')."""

    def __init__(self, num_clips: int = 64, seq_len: int = 6,
                 size: int = 300, seed: int = 0):
        self.num_clips = num_clips
        self.seq_len = seq_len
        self.size = size
        self.seed = seed

    def __len__(self):
        return self.num_clips

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng((self.seed, index))
        label = index % 2
        base = rng.normal(0, 0.3, (self.size, self.size, 3)).astype(np.float32)
        clip = np.stack([base] * self.seq_len)
        for t in range(self.seq_len):
            clip[t] = np.roll(clip[t], shift=t, axis=1)
        if label == 1:
            ps = max(self.size // 8, 2)
            for t in range(self.seq_len):
                y = int(rng.integers(0, self.size - ps))
                x = int(rng.integers(0, self.size - ps))
                clip[t, y:y + ps, x:x + ps] += rng.normal(
                    0, 1.0, (ps, ps, 3)).astype(np.float32)
        return {"clips": clip, "labels": np.int32(label),
                "fake_types": np.int32(label)}
