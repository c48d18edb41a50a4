"""Parameter utilities (counterpart of istvt_tpu/core/tree.py)."""
from __future__ import annotations

import torch
from torch import nn


def cast(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the floating-point PARAMETERS of `module` to `dtype`, in place.

    Buffers are left alone: the BN running statistics stay f32 and the
    int8 q8 codes with their f32 scales keep their deployed dtypes, as
    `istvt_tpu.core.tree.cast` over the params tree (not the state) leaves
    them in istvt_tpu/cli/serve.py:80-82."""
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module
