"""Median B=16 forward time of a port serving path on one NVIDIA GPU.

    python3 tools/torch_forward_ms.py [--root DIR]
                                      [--path int8|float|float32]
                                      [--mode MODE] [--batch N,...]

Imports istvt_tpu_torch from DIR (default: the checkout holding this
script), builds the path's paper-geometry model (300^2 x 6, depth 12,
seed 0) with its cli/serve.build_predictor (flags --int8, --bf16 for the
float path, none for the float path in f32, whose inputs are then f32),
switches an int8 model to the A/B mode MODE (`set_mode`: the
ISTVTConfig q8_ff / q8_attn pair of INT8_MODES; default 'ingest', the
CLI's) and times it with `forward_times`, the one B=16 timing that
chip_smoke.py's timing phase also calls (--batch: other batches, e.g.
16,1: at B=1 the host's share of a forward shows). Prints one JSON line a
(mode, batch): root, path, mode, batch, median and quartile ms, clips/s,
and the card's name and power limit. Run parent, change, change, parent
in one call to compare two commits on one card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, ITERS, WARMUP = 16, 20, 2
# the int8 path's A/B modes: (q8_ff, q8_attn); 'ingest' is cli/serve.py's
INT8_MODES = {"ingest": ("full", "ingest"), "boundary": ("full", "boundary"),
              "mixed": ("mixed", "ingest"), "bf16_ff": ("bf16", "ingest"),
              "layer": ("full", "layer"), "ff_int8": ("int8", "ingest")}
# the modes (and the float paths) whose model reads pack_params' copies
PACKED = ("float", "float32", "mixed", "bf16_ff")
# each path's cli/serve.py flags and input dtype
PATH_FLAGS = {"int8": ["--int8"], "float": ["--bf16"], "float32": []}


def set_mode(model, mode):
    """Switch an int8 model (quantize_params done) to an A/B mode in place,
    packing the float copies its feed-forward reads."""
    from istvt_tpu_torch.models import istvt
    q8_ff, q8_attn = INT8_MODES[mode]
    model.cfg = dataclasses.replace(model.cfg, q8_ff=q8_ff, q8_attn=q8_attn)
    if mode in PACKED:
        istvt.pack_params(model)


def input_dtype(path):
    """The dtype of a path's inputs: f32 for the f32 float path, else
    bf16."""
    import torch
    return torch.float32 if path == "float32" else torch.bfloat16


def forward_times(model, clip, dtype=None, batch=BATCH):
    """ms of ITERS calls `model(x)` on `batch` clips (CUDA events), after
    WARMUP warm-up calls, each on a distinct input in `dtype` (default
    bf16) drawn on the card from seed 2 outside the timed span. Raises on
    non-finite logits."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    times = []
    with torch.inference_mode():
        for i in range(WARMUP + ITERS):
            x = torch.randn(batch, *clip, generator=g,
                            device=dev).to(dtype or torch.bfloat16)
            e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
            e0.record()
            logits = model(x)
            e1.record()
            e1.synchronize()
            if i >= WARMUP:
                times.append(e0.elapsed_time(e1))
    if not torch.isfinite(logits).all():
        raise SystemExit("non-finite logits")
    return times


@contextlib.contextmanager
def gc_pauses():
    """Yields a list that fills, while the block runs, with the
    interpreter's garbage collections: (generation, ms) each."""
    pauses, start = [], []

    def watch(phase, info):
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            pauses.append((info["generation"],
                           (time.perf_counter() - start.pop()) * 1e3))

    gc.callbacks.append(watch)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(watch)


# the caching allocator's counters of calls into the driver: cudaMalloc,
# cudaFree, and the times it freed its cache to retry an allocation
ALLOC_COUNTERS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def alloc_counters():
    """The card's ALLOC_COUNTERS now (torch.cuda.memory_stats)."""
    st = torch.cuda.memory_stats()
    return {k: st.get(k, 0) for k in ALLOC_COUNTERS}


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--path", choices=tuple(PATH_FLAGS), default="int8")
    ap.add_argument("--batch", default=str(BATCH),
                    help="batch sizes, comma-separated, timed in turn")
    ap.add_argument("--mode", default="ingest",
                    help="the int8 path's A/B modes, comma-separated, timed "
                         f"in turn on one model ({', '.join(INT8_MODES)})")
    args = ap.parse_args()
    modes = args.mode.split(",")
    if any(m not in INT8_MODES for m in modes):
        ap.error(f"--mode: each of {', '.join(INT8_MODES)}")
    if args.path != "int8" and modes != ["ingest"]:
        ap.error("--mode is the int8 path's")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    from istvt_tpu_torch.cli import serve as cli_serve

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the GPU")
    cli = cli_serve.build_parser().parse_args(PATH_FLAGS[args.path])
    model = cli_serve.build_predictor(cli, torch.device("cuda")).model
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for mode in modes:
        if args.path == "int8":
            set_mode(model, mode)
        for batch in map(int, args.batch.split(",")):
            times = forward_times(
                model, (cli.seq_len, cli.input_size, cli.input_size, 3),
                input_dtype(args.path), batch)
            q1, med, q3 = np.percentile(times, [25, 50, 75])
            print(json.dumps({"root": os.path.relpath(root, here),
                              "path": args.path,
                              "mode": mode if args.path == "int8" else None,
                              "batch": batch, "median_ms": med,
                              "q1_ms": q1, "q3_ms": q3,
                              "clips_per_s": batch * 1e3 / med,
                              "card": card}),
                  flush=True)


if __name__ == "__main__":
    main()
