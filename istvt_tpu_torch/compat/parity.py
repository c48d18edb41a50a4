"""Layer-by-layer cross-framework parity harness (the port's copy of
istvt_tpu/compat/parity.py).

Generalization of the reference's one good testing idea
(network/resnet3d/utils/layer_by_layer.py:1-98: fixed-seed input through
the caffe2 graph and the PyTorch port, activations compared per stage).
Here the two sides are any list of named (name, fn) stages; the harness
threads the same input through both and reports per-stage max-abs /
rel-err, stopping at the first divergence above tolerance. Activations
are compared as numpy arrays: torch tensors through
`.detach().cpu().numpy()` (bf16 and f8 by way of f32), anything else
through np.asarray.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class StageReport:
    name: str
    max_abs: float
    max_rel: float
    shape: Tuple[int, ...]
    ok: bool


def to_numpy(x) -> np.ndarray:
    """A tensor (any device, any dtype numpy lacks by way of f32) or an
    array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.is_floating_point() and x.dtype not in (
                torch.float16, torch.float32, torch.float64):
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def compare_stages(
    stages_a: Sequence[Tuple[str, Callable]],
    stages_b: Sequence[Tuple[str, Callable]],
    x0_a,
    x0_b,
    to_numpy_a: Callable = to_numpy,
    to_numpy_b: Callable = to_numpy,
    atol: float = 1e-3,
    rtol: float = 1e-3,
    stop_on_fail: bool = True,
) -> List[StageReport]:
    """Run paired stages, comparing activations after each.

    stages_a/b: same-length lists of (name, fn); fn maps the framework's
    activation to the next. x0_a/x0_b: the same logical input in each
    framework's layout. to_numpy_*: activation -> np.ndarray in a COMMON
    layout (e.g. NHWC) so comparisons align.
    """
    assert len(stages_a) == len(stages_b), "stage lists must align"
    reports: List[StageReport] = []
    act_a, act_b = x0_a, x0_b
    for (name_a, fa), (name_b, fb) in zip(stages_a, stages_b):
        act_a = fa(act_a)
        act_b = fb(act_b)
        na = to_numpy_a(act_a).astype(np.float64)
        nb = to_numpy_b(act_b).astype(np.float64)
        assert na.shape == nb.shape, \
            f"{name_a}: shape {na.shape} vs {nb.shape}"
        diff = np.abs(na - nb)
        max_abs = float(diff.max()) if diff.size else 0.0
        denom = np.maximum(np.abs(nb), 1e-8)
        max_rel = float((diff / denom).max()) if diff.size else 0.0
        ok = bool(np.allclose(na, nb, atol=atol, rtol=rtol))
        reports.append(StageReport(name_a, max_abs, max_rel, na.shape, ok))
        if not ok and stop_on_fail:
            break
    return reports


def format_report(reports: List[StageReport]) -> str:
    lines = [f"{'stage':<24} {'shape':<22} {'max_abs':>10} {'max_rel':>10}  ok"]
    for r in reports:
        lines.append(f"{r.name:<24} {str(r.shape):<22} "
                     f"{r.max_abs:>10.2e} {r.max_rel:>10.2e}  "
                     f"{'PASS' if r.ok else 'FAIL'}")
    return "\n".join(lines)
