"""NaN and finiteness debugging (counterpart of istvt_tpu/utils/debug.py).

  * `debug_nans()`: a context manager, the counterpart of JAX's
    jax_debug_nans mode: every operator's floating output is checked for
    NaN and the check raises FloatingPointError naming the operator;
  * `finite_fraction(tree)` / `assert_finite(tree, name)`: the share of
    finite values over a dict / list / tuple tree of tensors, and a host
    assertion on it.

What debug_nans checks, and where:

  * forward and backward operators: a TorchDispatchMode checks the
    outputs of every aten operator and every `istvt::` kernel op
    (kernels/ops.py) as it returns. NaN only, as jax_debug_nans: the
    attention masks hold -inf on purpose. Views and the operators that
    hand out unwritten memory (torch.empty and its kin) are not checked:
    such a buffer may hold any bits before a kernel writes it;
  * backward functions: torch.autograd.detect_anomaly(check_nan=True)
    names the backward function that returned NaN;
  * the kernels that are ctypes calls, not operators (the backward kernels
    #12, #13, #19, #23, #21's h1-stash forward and fused_ff #22): each
    wrapper checks what it returns (`check_outputs`, kernels/attention.py,
    linear.py, mlp.py), so their NaNs are caught at their
    autograd.Function's outputs, named by the wrapper, not by the CUDA
    kernel inside it (one wrapper launches several).

The int8 path's f8 stem store turns |x| > 464 into NaN (models/xception
`to_store`, as JAX's cast does), so the check fires on an overflowing
stem in both packages; that is the model, not a divergence.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

# operators whose outputs are not checked: they allocate memory that no
# one has written yet, or alias their input
_UNWRITTEN = ("empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "resize_", "set_")


def _has_nan(t) -> bool:
    if not isinstance(t, torch.Tensor) or not t.is_floating_point() \
            or t.numel() == 0 or t.is_meta:
        return False
    if t.element_size() == 1:      # float8: isnan is not defined on it
        t = t.float()
    return bool(torch.isnan(t).any())


class _NanCheck(TorchDispatchMode):
    """Raises FloatingPointError when an operator's output holds NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket.__name__ in _UNWRITTEN:
            return out
        if any(_has_nan(t) for t in pytree.tree_leaves(out)):
            raise FloatingPointError(
                f"invalid value (nan) encountered in {func}")
        return out


def nan_check_active() -> bool:
    """Whether a debug_nans() region is active on this thread."""
    return any(isinstance(m, _NanCheck)
               for m in _get_current_dispatch_mode_stack())


def check_outputs(where: str, *outs):
    """Inside debug_nans(): FloatingPointError naming `where` if an output
    holds NaN. A kernel that is not an operator calls it on what it
    returns; outside debug_nans() it checks nothing."""
    if nan_check_active() and any(_has_nan(t) for t in outs):
        raise FloatingPointError(
            f"invalid value (nan) encountered in {where}")


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Check every operator's output for NaN inside the block (see the
    module docstring); the state before it comes back on exit, on an
    exception too. enable=False enters nothing."""
    if not enable:
        yield
        return
    with torch.autograd.set_detect_anomaly(True, check_nan=True), \
            _NanCheck():
        try:
            yield
        except RuntimeError as e:
            # the anomaly check's error: the backward function that
            # returned NaN
            if "returned nan values" in str(e):
                raise FloatingPointError(str(e)) from e
            raise


def finite_fraction(tree: Any) -> torch.Tensor:
    """Fraction of finite scalars across the floating leaves of a dict /
    list / tuple tree of tensors (a 0-dim f32 tensor on the first leaf's
    device; 1.0 where there is no floating leaf)."""
    leaves = [t for t in pytree.tree_leaves(tree)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not leaves:
        return torch.tensor(1.0)
    dev = leaves[0].device
    total = sum(t.numel() for t in leaves)
    finite = sum(torch.isfinite(t.float() if t.element_size() == 1 else t)
                 .sum().to(dev) for t in leaves)
    return finite.float() / total


def assert_finite(tree: Any, name: str = "tree"):
    """Host-side assertion (fetches one scalar)."""
    frac = float(finite_fraction(tree))
    if frac < 1.0:
        raise FloatingPointError(
            f"{name}: {100 * (1 - frac):.4f}% non-finite values")
    return True
