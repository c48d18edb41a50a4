"""Median train-step time of the port's float fused path on one NVIDIA
GPU, in bf16 over f32 masters (the default) or in f32.

    python3 tools/torch_train_ms.py [--root DIR] [--f32]

Imports istvt_tpu_torch from DIR (default: the checkout holding this
script), builds a trainer through cli/train.py's code path (check_args,
build: --dataset synthetic --use_pallas --bf16 --dropout 0, the paper
geometry 300^2 x 6, depth 12, B=16, -o a temporary directory (the
checkpoint directory the Trainer makes; no step is saved); with --f32 the
same without --bf16,
also at B=16: an out-of-memory error fails the run) and times TRAIN_STEPS
steps after one warm-up step (`warm_up`) with `train_times`, the timing
chip_smoke.py's train phase also calls: the host clock around each step,
ending in the loss read. Then `device_step_ms`: the card's time in kernels
over PROFILED_STEPS more steps under torch.profiler, a step's share (the
host clock spreads more between runs than the device does), in all and by
kernel family (`kernel_families`: the port's kernels by template name, the
rest as 'other'). Prints one JSON line: root, dtype, batch, the step
times, their median, the device ms a step and its families, the peak
device memory, the losses and the card's name and power limit. Run parent, change, change, parent in one call to compare
two commits on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TRAIN_FLAGS = ["--dataset", "synthetic", "--use_pallas", "--bf16",
               "--dropout", "0"]
TRAIN_BATCH, TRAIN_STEPS, PROFILED_STEPS = 16, 5, 2


def build_trainer(cli_train, flags, checkpoint_dir, bf16=True):
    """(trainer, loader, extra) of cli_train.build for TRAIN_FLAGS + flags
    (without --bf16 unless bf16) and -o checkpoint_dir, after its
    check_args. A package whose CLI has no checkpoints (its -o defaults to
    '') gets no -o."""
    parser = cli_train.build_parser()
    if parser.parse_args([]).checkpoint_dir:
        flags = flags + ["-o", checkpoint_dir]
    args = parser.parse_args(
        [f for f in TRAIN_FLAGS if bf16 or f != "--bf16"] + flags)
    cli_train.check_args(args)
    return cli_train.build(args)


def paper_trainer(cli_train, checkpoint_dir, bf16=True):
    """A B=TRAIN_BATCH trainer (bf16 over f32 masters, or f32), its state
    and TRAIN_STEPS + 1 batches made before any step."""
    trainer, loader, _ = build_trainer(
        cli_train, ["--batch_size", str(TRAIN_BATCH), "--epochs", "1",
                    "--dataset_len", str(TRAIN_BATCH * (TRAIN_STEPS + 1))],
        checkpoint_dir, bf16)
    return trainer, trainer.init_state(), list(loader)


def warm_up(trainer, ts, batch):
    """One untimed step; peak memory is counted from after it."""
    float(trainer.step_fn(ts, batch)["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def train_times(trainer, ts, batches):
    """(ms per step, losses) of one step per batch: the host clock around
    the step and its loss read. Raises on a non-finite loss or gradient
    norm."""
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        m = trainer.step_fn(ts, batch)
        losses.append(float(m["loss"]))       # waits for the step's kernels
        times.append(1e3 * (time.perf_counter() - t0))
        if not np.isfinite([losses[-1], float(m["grad_norm"])]).all():
            raise SystemExit(f"train step {ts.step}: non-finite {m}")
    torch.cuda.synchronize()
    return times, losses


def kernel_families(prof) -> dict:
    """{family: device ms} of a torch.profiler run: the port's kernels by
    their template's name, every other CUDA kernel and copy under
    'other'."""
    fam = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        name = (e.key.split("istvt::", 1)[1].split("<")[0].split("(")[0]
                if "istvt::" in e.key else "other")
        fam[name] = fam.get(name, 0.0) + us / 1e3
    return fam


def device_step_ms(trainer, ts, batches):
    """(ms of CUDA kernel time a step, {kernel family: ms a step}) over one
    step per batch under torch.profiler (its self device time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            float(trainer.step_fn(ts, batch)["loss"])
        torch.cuda.synchronize()
    fam = {k: v / len(batches) for k, v in kernel_families(prof).items()}
    return sum(fam.values()), fam


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--f32", action="store_true",
                    help="train in f32 (no --bf16)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    from istvt_tpu_torch.cli import train as cli_train

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the GPU")
    with tempfile.TemporaryDirectory() as ck:
        trainer, ts, batches = paper_trainer(cli_train, ck,
                                             bf16=not args.f32)
        warm_up(trainer, ts, batches[0])
        times, losses = train_times(trainer, ts, batches[1:])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        dev_ms, fam = device_step_ms(trainer, ts,
                                     batches[1:1 + PROFILED_STEPS])
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"root": os.path.relpath(root, here),
                      "dtype": "f32" if args.f32 else "bf16",
                      "batch": TRAIN_BATCH, "ms": times,
                      "median_ms": float(np.median(times)),
                      "device_ms": dev_ms, "device_ms_by_family": {
                          k: round(v, 3) for k, v in sorted(
                              fam.items(), key=lambda kv: -kv[1])},
                      "peak_gib": peak,
                      "losses": losses, "card": card}), flush=True)


if __name__ == "__main__":
    main()
