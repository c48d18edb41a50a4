"""Median times of port kernels at the serving slice on one NVIDIA GPU.

    python3 tools/kernel_ms.py [--root DIR] [--cases NAME,...]

Imports istvt_tpu_torch from DIR (default: the checkout holding this
script), builds its kernels and times each case of its
kernels/selfcheck.slice_cases (default: the kernels that run the spatial
attention core or its backward: #2, #9, #10, #13 packed and unpacked, #14,
#15) in bf16 and in f32 on the case's seeded inputs: the smaller of two
medians of 20 CUDA-event timings (chip_smoke.py's phase-3 timing), the
warm-up outside them. Prints one JSON line per case and dtype: root, case,
dtype, ms, and the card's name and power limit. Run parent, change,
change, parent in one call to compare two commits on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

SPATIAL_CASES = ("mm_q8_ln_qkv_q8_spatial_attention", "st_layer_q8",
                 "spatial_attention_packed", "spatial_attention_packed/bwd",
                 "fused_frame_attention_bwd", "fused_frame_attention",
                 "fused_frame_attention_mh")


def median_ms(fn, iters=20, warmup=3):
    """Median ms of `iters` calls of fn, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--cases", default=",".join(SPATIAL_CASES))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    from istvt_tpu_torch.kernels import _lib, selfcheck

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the GPU")
    _lib.load()
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cases = selfcheck.slice_cases(torch.device("cuda"))
    for name in args.cases.split(","):
        kern, _, make = cases[name]
        for dt in (torch.bfloat16, torch.float32):
            call_args = make(dt)
            ms = min(median_ms(lambda: kern(*call_args)) for _ in range(2))
            print(json.dumps({"root": os.path.relpath(root, here),
                              "case": name, "dtype": str(dt)[6:], "ms": ms,
                              "card": card}), flush=True)


if __name__ == "__main__":
    main()
