"""Device selection (counterpart of istvt_tpu/core/platform.py).

There is no CPU fallback: a caller that needs the card asks for it and
fails loudly when it is missing. Code that runs on the CPU on purpose
(the tests, the plain reference run) passes `torch.device("cpu")`.
"""
from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device, or RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the istvt_tpu_torch serving path needs an "
            "NVIDIA GPU (pass device=torch.device('cpu') explicitly for "
            "the plain reference run)")
    return torch.device("cuda")
