"""Model registry (counterpart of istvt_tpu/models/registry.py).

Only the `istvt` key is ported; the rest of the zoo is ROADMAP.md work.
"""
from __future__ import annotations

from typing import Optional

import torch

from istvt_tpu_torch.core.config import ISTVTConfig


def available_models():
    return ["istvt"]


def model_selection(modelname: str, num_out_classes: int = 1,
                    dropout: float = 0.5, *, device: torch.device,
                    cfg: Optional[ISTVTConfig] = None, seed: int = 0):
    """A randomly initialised model from `seed` on `device` (eval mode).
    `dropout` is accepted for signature parity; the serving path has none."""
    if modelname != "istvt":
        raise NotImplementedError(
            f"model '{modelname}' is not ported yet; available: "
            f"{available_models()} (ROADMAP.md queue 1, "
            f"'Rest of the model zoo')")
    from istvt_tpu_torch.models import istvt
    cfg = cfg or ISTVTConfig(num_classes=num_out_classes)
    return istvt.init(cfg, torch.Generator().manual_seed(seed), device)
