"""Metrics logging (counterpart of istvt_tpu/train/logging.py): an
append-only JSONL metrics writer, always available and machine readable,
with TensorBoard scalars beside it when the tensorboard package imports.

The scalars are the records torch.utils.tensorboard.SummaryWriter writes
(an `events.out.tfevents.*` file of Event protos holding Summary
simple_values), written here with tensorboard's own protos and record
framing: SummaryWriter imports TensorFlow whenever it is installed, which
costs every process that builds a logger seconds."""
from __future__ import annotations

import json
import os
import socket
import time
from typing import Dict


class _EventFile:
    """One TensorBoard event file of scalar summaries."""

    def __init__(self, log_dir: str):
        from tensorboard.compat.proto import event_pb2, summary_pb2
        from tensorboard.summary.writer.record_writer import RecordWriter
        self._event, self._summary = event_pb2.Event, summary_pb2.Summary
        name = (f"events.out.tfevents.{int(time.time()):010d}."
                f"{socket.gethostname()}.{os.getpid()}")
        self._rec = RecordWriter(open(os.path.join(log_dir, name), "wb"))
        self._write(self._event(wall_time=time.time(),
                                file_version="brain.Event:2"))

    def _write(self, event):
        self._rec.write(event.SerializeToString())
        self._rec.flush()

    def scalars(self, step: int, values: Dict[str, float]):
        value = [self._summary.Value(tag=k, simple_value=v)
                 for k, v in values.items()]
        self._write(self._event(wall_time=time.time(), step=step,
                                summary=self._summary(value=value)))

    def close(self):
        self._rec.close()


class MetricsLogger:
    """Append-only `<log_dir>/metrics.jsonl` + TensorBoard scalars when the
    tensorboard package imports."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        try:
            self._tb = _EventFile(log_dir)
        except ImportError:
            self._tb = None

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        """One record {'step', 'time', prefix + key: float value, ...};
        values that do not convert to float are left out."""
        values: Dict[str, float] = {}
        for k, v in metrics.items():
            try:
                values[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        if self._tb is not None:
            self._tb.scalars(int(step), values)
        rec = {"step": int(step), "time": time.time(), **values}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
