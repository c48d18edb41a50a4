"""Clip datasets (counterpart of istvt_tpu/data/video_dataset.py).

Only `SyntheticVideoDataset` is ported, as a numpy copy: the JAX package's
module imports jax-side packages, and the port imports nothing of it.
tests/test_torch_train_step.py holds its items equal to the JAX class's.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticVideoDataset:
    """Deterministic synthetic clips (video_dataset.py:293-353): 'fake'
    clips (odd index, label 1) carry per-frame independent noise in a
    moving patch over a rolled base frame; real clips (label 0) only the
    smooth motion. Items: {'clips': (T, S, S, 3) f32, 'labels': int32,
    'fake_types': int32}.

    static_patch=True pins the patch to one (per-clip random) place in
    every frame, so that relevance maps have a localizable ground truth;
    the item then also holds 'patch_yx', the patch's top-left corner
    ((-1, -1) for real clips). patch_size overrides the default extent
    size // 8. amp_range=(lo, hi) scales a fake clip's noise by an
    amplitude drawn uniformly from it, given as the item's 'amp' (0 for
    real clips)."""

    def __init__(self, num_clips: int = 64, seq_len: int = 6,
                 size: int = 300, seed: int = 0,
                 static_patch: bool = False, patch_size: int | None = None,
                 amp_range: tuple | None = None):
        self.num_clips = num_clips
        self.seq_len = seq_len
        self.size = size
        self.seed = seed
        self.static_patch = static_patch
        self.patch_size = patch_size
        self.amp_range = amp_range

    def __len__(self):
        return self.num_clips

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng((self.seed, index))
        label = index % 2
        base = rng.normal(0, 0.3, (self.size, self.size, 3)).astype(np.float32)
        clip = np.stack([base] * self.seq_len)
        for t in range(self.seq_len):
            clip[t] = np.roll(clip[t], shift=t, axis=1)
        y = x = -1
        amp = 1.0
        if label == 1:
            ps = self.patch_size or max(self.size // 8, 2)
            if self.amp_range is not None:
                amp = float(rng.uniform(*self.amp_range))
            y = x = None
            for t in range(self.seq_len):
                if y is None or not self.static_patch:
                    y = int(rng.integers(0, self.size - ps))
                    x = int(rng.integers(0, self.size - ps))
                clip[t, y:y + ps, x:x + ps] += (amp * rng.normal(
                    0, 1.0, (ps, ps, 3))).astype(np.float32)
        out = {"clips": clip, "labels": np.int32(label),
               "fake_types": np.int32(label)}
        if self.amp_range is not None:
            out["amp"] = np.float32(amp if label == 1 else 0.0)
        if self.static_patch:
            out["patch_yx"] = np.array([y, x], np.int32)
        return out
