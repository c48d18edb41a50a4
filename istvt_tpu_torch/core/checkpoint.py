"""Checkpoint / resume with torch files (counterpart of
istvt_tpu/core/checkpoint.py, which saves through Orbax).

A checkpoint is one torch file per step, `<directory>/<step>.pt`, holding
a nest of tensors and plain values (the trainer's: the model's state_dict
under the port's names, BN running statistics included, the optimizer's
state_dict, the step, the dropout generator's state), beside
`<step>.json` with the step's metric. Each is written under a temporary
name and moved into place with os.replace, so a kill in mid-write never
leaves a file that `latest_step` would pick. Files load with
torch.load(weights_only=True).

Retention follows the Orbax manager's options that the JAX package sets
(best_fn = the metric, keep_checkpoints_without_metrics): a step saved
without a metric is always kept; of the steps with one, the best
`max_to_keep` by `best_mode`.
"""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, List, Optional

import torch

_STEP = re.compile(r"^(\d+)\.pt$")


def _cpu_copy(tree: Any) -> Any:
    """The nest with every tensor copied to the CPU (detached)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_copy(v) for v in tree)
    return tree


def _atomic_write(path: str, write) -> None:
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class CheckpointManager:
    """Save-per-step with best-metric tracking, on one background writer
    thread when async_save."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 best_mode: str = "max", async_save: bool = False):
        """async_save: save() takes a CPU copy of the state and returns;
        the file is written on a background thread, overlapping the next
        epoch's compute. Every later save, wait, restore and close joins
        that thread first (and raises what it raised)."""
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode={best_mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_mode = best_mode
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int, ext: str = "pt") -> str:
        return os.path.join(self.directory, f"{int(step)}.{ext}")

    def save(self, step: int, state: Any, metric: Optional[float] = None,
             wait: Optional[bool] = None):
        """wait: override the constructor's async_save for this call."""
        self.wait()
        blocking = (not self.async_save) if wait is None else wait
        if blocking:
            self._write(int(step), state, metric)
            return
        snapshot = _cpu_copy(state)
        self._thread = threading.Thread(
            target=self._write_in_thread, args=(int(step), snapshot, metric),
            name=f"checkpoint-{int(step)}", daemon=False)
        self._thread.start()

    def _write_in_thread(self, step, state, metric):
        try:
            self._write(step, state, metric)
        except BaseException as e:          # raised again by wait()
            self._error = e

    def _write(self, step: int, state: Any, metric: Optional[float]):
        meta = {"step": step,
                "metric": None if metric is None else float(metric)}
        _atomic_write(self._path(step, "json"),
                      lambda f: f.write(json.dumps(meta).encode()))
        _atomic_write(self._path(step), lambda f: torch.save(state, f))
        self._retain()

    def _retain(self):
        infos = [(s, self._metric(s)) for s in self.all_steps()]
        scored = sorted((i for i in infos if i[1] is not None),
                        key=lambda i: i[1],
                        reverse=self.best_mode == "min")
        for step, _ in scored[:max(len(scored) - self.max_to_keep, 0)]:
            for ext in ("pt", "json"):
                try:
                    os.remove(self._path(step, ext))
                except FileNotFoundError:
                    pass

    def _metric(self, step: int) -> Optional[float]:
        try:
            with open(self._path(step, "json")) as f:
                return json.load(f).get("metric")
        except (FileNotFoundError, ValueError):
            return None

    def wait(self):
        """Block until any in-flight async save has been written."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      map(_STEP.match, os.listdir(self.directory)) if m)

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Optional[Dict]:
        """The saved nest of `step` (default: the latest), its tensors on
        map_location (default: where they were saved from, the CPU for an
        async save), or None if no step is saved."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The step with the best metric; None if no step has one."""
        scored = [(s, m) for s in self.all_steps()
                  if (m := self._metric(s)) is not None]
        if not scored:
            return None
        pick = max if self.best_mode == "max" else min
        best = pick(m for _, m in scored)
        return [s for s, m in scored if m == best][-1]

    def close(self):
        self.wait()


def save_pytree(path: str, tree: Any):
    """One-shot save of a nest of tensors (the analog of
    torch.save(state_dict); the visualize CLI reads {'params', 'state'})."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _atomic_write(path, lambda f: torch.save(_cpu_copy(tree), f))


def load_pytree(path: str, map_location=None) -> Any:
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)
