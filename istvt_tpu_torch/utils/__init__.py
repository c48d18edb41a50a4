"""Auxiliary subsystems: tracing/profiling, NaN debugging (counterpart of
istvt_tpu/utils)."""
from istvt_tpu_torch.utils.profiling import StepTimer, trace  # noqa: F401
from istvt_tpu_torch.utils.debug import assert_finite, debug_nans  # noqa: F401
