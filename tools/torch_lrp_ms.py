"""Time of one B=1 f32 generate_lrp call of the port on one NVIDIA GPU.

    python3 tools/torch_lrp_ms.py [--root DIR]

Imports istvt_tpu_torch from DIR (default: the checkout holding this
script), builds the paper-geometry model (300^2 x 6, depth 12, seed 0, f32)
and clip as chip_smoke.py's interpretability phase does and, with TF32 off,
for use_pallas True then False: a warm-up call of generate_lrp
(transformer_attribution), CALLS calls timed by the host clock (each ending
in a synchronize), then PROFILED calls under torch.profiler: the device ms
a call, summed over every CUDA kernel and copy, and by family (the port's
kernels by their template's name, cuBLAS's matrix products, which the
plain PyTorch code calls, under 'library GEMM', every other kernel and
copy under 'other'). Prints one JSON line per use_pallas value: root,
use_pallas, the host ms, their median, the device ms a call, the families
and the card's name and power limit. Run parent, change, change, parent in one call to
compare two commits on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CALLS, PROFILED = 3, 2
# words in the names of cuBLAS's matrix-product kernels
LIBRARY_GEMM = ("gemm", "xmma", "cutlass", "cublas")


def device_ms_by_family(fn, calls):
    """(device ms a call, {family: ms a call}) of `calls` calls of fn under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    fam = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if "istvt::" in e.key:
            name = e.key.split("istvt::", 1)[1].split("<")[0].split("(")[0]
        elif any(w in e.key.lower() for w in LIBRARY_GEMM):
            name = "library GEMM"
        else:
            name = "other"
        fam[name] = fam.get(name, 0.0) + us / 1e3 / calls
    return sum(fam.values()), dict(sorted(fam.items(), key=lambda kv: -kv[1]))


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    from istvt_tpu_torch.core.config import ISTVTConfig
    from istvt_tpu_torch.core.precision import highest
    from istvt_tpu_torch.interpret import generate_lrp
    from istvt_tpu_torch.models import istvt

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the GPU")
    dev = torch.device("cuda")
    paper = ISTVTConfig()
    model = istvt.init(paper, torch.Generator().manual_seed(0), dev)
    clip = torch.from_numpy(np.random.RandomState(2).randn(
        1, paper.num_frames, paper.image_size, paper.image_size, 3).astype(
            np.float32)).to(dev)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    with highest():
        for up in (True, False):
            model.cfg = dataclasses.replace(paper, use_pallas=up)

            def call():
                return generate_lrp(model, clip)

            call()
            torch.cuda.synchronize()
            times = []
            for _ in range(CALLS):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            dev_ms, fam = device_ms_by_family(call, PROFILED)
            print(json.dumps({"root": os.path.relpath(root, here),
                              "use_pallas": up, "ms": times,
                              "median_ms": float(np.median(times)),
                              "device_ms": dev_ms,
                              "families": {k: round(v, 3)
                                           for k, v in fam.items()},
                              "card": card}), flush=True)


if __name__ == "__main__":
    main()
