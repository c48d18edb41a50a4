"""Model registry (counterpart of istvt_tpu/models/registry.py).

The `istvt` key and `resnet_3d`, the reference's registry key for the same
model (istvt_tpu/models/zoo.py:34-37), are ported; the rest of the zoo is
ROADMAP.md work.
"""
from __future__ import annotations

from typing import Optional

import torch

from istvt_tpu_torch.core.config import ISTVTConfig


# 'istvt' is the canonical name; 'resnet_3d' is the reference's registry key
# for the trained ISTVT (reference models.py:180)
_ISTVT_KEYS = ("istvt", "resnet_3d")


def available_models():
    return list(_ISTVT_KEYS)


def model_selection(modelname: str, num_out_classes: int = 1,
                    dropout: float = 0.5, *, device: torch.device,
                    cfg: Optional[ISTVTConfig] = None, seed: int = 0):
    """A randomly initialised model from `seed` on `device` (eval mode).
    `dropout` is accepted for signature parity; the serving path has none."""
    if modelname not in _ISTVT_KEYS:
        raise NotImplementedError(
            f"model '{modelname}' is not ported yet; available: "
            f"{available_models()} (ROADMAP.md queue 1, "
            f"'Rest of the model zoo')")
    from istvt_tpu_torch.models import istvt
    cfg = cfg or ISTVTConfig(num_classes=num_out_classes)
    return istvt.init(cfg, torch.Generator().manual_seed(seed), device)
