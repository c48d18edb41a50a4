"""Serving: a bucketed batch predictor (counterpart of istvt_tpu/serve.py).

`Predictor` wraps a port model (an nn.Module mapping clips to logits):
  * fixed bucket sizes, so the card sees a few batch shapes only;
  * partial batches padded with zeros and the pad sliced off;
  * probability outputs (sigmoid over the BCE logit) and threshold-at-0
    `preds` (reference train_CNN.py:527);
  * `compute_dtype` puts the float parameters AND the inputs in that
    dtype (the float serving path, e.g. bf16); `input_dtype` casts ONLY the
    inputs: int8 serving keeps the deployed dtypes of the weights (bf16
    floats, int8 q8 copies, f32 scales).
Every forward runs the model in eval mode (the Predictor puts it there,
as the JAX Predictor applies train=False, serve.py:76) under
torch.inference_mode on the given device: a model handed over in train
mode gives the eval logits and keeps its BatchNorm statistics.
The JAX package's data-parallel mesh mode is not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from istvt_tpu_torch.core import tree


class Predictor:
    def __init__(self, model, device: torch.device,
                 batch_sizes: Sequence[int] = (1, 8, 16),
                 compute_dtype: Optional[torch.dtype] = None,
                 input_dtype: Optional[torch.dtype] = None):
        """compute_dtype: the floating-point parameters and the inputs in
        this dtype. The JAX Predictor casts the params on every call; here
        the model's parameters are cast once, in place, when the Predictor
        is built (core/tree.cast: buffers such as the BN statistics and the
        int8 copies keep their dtypes). Weight copies derived from the
        parameters (quantize_params, pack_params) are built from the cast
        parameters before the Predictor, as cli/serve.build_predictor does.
        input_dtype: cast only the inputs."""
        self.model = model
        self.device = torch.device(device)
        self.batch_sizes = sorted(batch_sizes)
        self.compute_dtype = compute_dtype
        self.input_dtype = input_dtype
        if compute_dtype is not None:
            tree.cast(model, compute_dtype)
        self.n_forwards = 0   # model calls made by predict()

    def _forward(self, x: torch.Tensor) -> np.ndarray:
        t = x.to(self.device)
        dtype = self.compute_dtype or self.input_dtype
        if dtype is not None:
            t = t.to(dtype)
        self.model.eval()
        with torch.inference_mode():
            logits = self.model(t)
        self.n_forwards += 1
        return logits.reshape(x.shape[0], -1)[:, 0].float().cpu().numpy()

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def predict(self, clips) -> Dict[str, np.ndarray]:
        """clips: (N, ...) normalized inputs, a numpy array or a tensor (a
        batch that data/loader.device_feed put on the card is used where
        it lies) -> {'logits', 'probs', 'preds'} numpy arrays of length N,
        batched over the bucket sizes."""
        if not isinstance(clips, torch.Tensor):
            clips = torch.from_numpy(np.ascontiguousarray(clips))
        n = clips.shape[0]
        logits: List[np.ndarray] = []
        i = 0
        while i < n:
            take = min(self._bucket(n - i), n - i)
            bucket = self._bucket(take)
            chunk = clips[i:i + take]
            if take < bucket:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (bucket - take,) + tuple(chunk.shape[1:]))])
            logits.append(self._forward(chunk)[:take])
            i += take
        logits = np.concatenate(logits)
        return {
            "logits": logits,
            "probs": 1.0 / (1.0 + np.exp(-logits)),
            "preds": (logits > 0).astype(np.int32),
        }
