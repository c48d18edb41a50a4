"""Tracing and step timing (counterpart of istvt_tpu/utils/profiling.py).

  * `trace(log_dir)`: a context manager around torch.profiler that writes
    the run's chrome-trace JSON into log_dir (as jax.profiler writes its
    .xplane.pb); `utils/trace_summary.py` totals its device time by the
    operator that launched each kernel;
  * `annotate(name)`: a named region inside a trace;
  * `StepTimer`: per-step wall-clock accounting with a warm-up skip and
    percentile summaries, the generalization of the reference's
    test_time.py.
"""
from __future__ import annotations

import contextlib
import os
import socket
import tempfile
import time
from typing import Dict, List, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the body with torch.profiler (CPU activity, and CUDA where a
    card is available) and write `<host>_<pid>.<ns>.pt.trace.json` into
    log_dir (default: torch-trace under the temporary directory); yields
    log_dir. The trace is written when the body ends, also on an
    exception."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{socket.gethostname()}_{os.getpid()}."
                     f"{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """Named region inside a trace (torch.profiler.record_function)."""
    import torch
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock per-step timer: `with timer.step(): ...`.

    Skips `warmup` steps (the first calls build and compile), reports
    mean/p50/p90 and items/sec when `items_per_step` is set. It reads the
    host clock only: CUDA work is asynchronous, so a step that launches
    kernels must end in a synchronize (or a host read of its result)
    inside the `with` block for the time to be the step's.
    """

    def __init__(self, warmup: int = 1, items_per_step: Optional[int] = None):
        self.warmup = warmup
        self.items_per_step = items_per_step
        self.times: List[float] = []
        self._seen = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        out = {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[min(int(n * 0.9), n - 1)],
        }
        if self.items_per_step:
            out["items_per_sec"] = self.items_per_step / out["mean_s"]
        return out
