"""Median times of port kernels at the serving slice on one NVIDIA GPU.

    python3 tools/kernel_ms.py [--root DIR] [--cases NAME,...|spatial|gemm]
                               [--gemm] [--batch B]

Imports istvt_tpu_torch from DIR (default: the checkout holding this
script), builds its kernels and times each case of its
kernels/selfcheck.slice_cases (`spatial`, the default: the kernels that run
the spatial attention core or its backward: #2, #9, #10, #13 packed and
unpacked, #14, #15; `gemm`: the kernels that run the float GEMM, #6, #18-#23)
in bf16 and in f32 on the case's seeded inputs: the smaller of two medians
of 20 CUDA-event timings of one call (chip_smoke.py's phase-3 timing), the
warm-up outside them, and `device_ms`, the device time of one call with the
host's launch overhead hidden. Prints one JSON line per case and dtype:
root, case, dtype, ms, device_ms, and the card's name and power limit.

With --gemm it times instead the float GEMM alone (kernels/linear.gemm) at
every caller's shape (selfcheck.gemm_shapes, taken from this script's
checkout, so that a parent's package can be timed on the same operands) for
B clips (default 2, the slice; 16 for the B=16 forward and step), and
torch.matmul on the same operands as the yardstick: one JSON line per
shape with device ms, TFLOP/s and the bound (with --nt, an nn shape also
timed with its weight stored (N, K), as layout nt: what the weight's
layout costs). Run parent, change, change, parent in one call to compare
two commits on one card.
"""
from __future__ import annotations

import argparse
import importlib.util
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
GEMM_CASES = ("ln_matmul", "matmul_bias_residual", "matmul_bias_residual/no_r",
              "ln_ff_residual", "ln_ff_residual/h1", "ln_ff_residual/bwd",
              "ln_matmul/bwd", "fused_ff", "ln_ff_residual_q8")
CASE_SETS = {"spatial": SPATIAL_CASES, "gemm": GEMM_CASES}
# published H100 SXM peaks: bf16 dense operations/s, bytes/s
PEAK_BF16, HBM_BPS = 989e12, 3.35e12
# the card's spin ahead of a device_ms run: about 2 ms at 1.7 GHz
SPIN_CYCLES = 3_500_000


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


def device_ms(fn, reps=10, iters=10):
    """Median device ms of one call of fn: `reps` calls enqueued back to
    back behind a spin of the card (torch.cuda._sleep), so that the host
    has queued them all before the first starts and its launch overhead
    does not count, timed by two CUDA events; the median over `iters`."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return float(np.median(times))


def gemm_selfcheck():
    """This checkout's kernels/selfcheck.py, loaded by path: its GEMM table
    and operands (the kernels it calls are those of whichever
    istvt_tpu_torch is on sys.path)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "istvt_tpu_torch", "kernels", "selfcheck.py")
    spec = importlib.util.spec_from_file_location("_gemm_selfcheck", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gemm_rows(sc, device, batch=2, nt=False):
    """Yields (name, layout, m, n, k, kernel device ms, torch.matmul device
    ms, TFLOP/s, bound ms, operands, nt ms) for each GEMM shape of `batch`
    clips (the operands made afresh for each shape); with nt, an nn shape
    (but the stash, which only nn takes) is also timed as the same product
    with its weight stored (N, K), layout nt (else nt ms is None)."""
    for name, (layout, m, n, k, epi, dt) in sc.gemm_shapes(
            {**sc.SLICE, "b": batch}).items():
        ops = sc.gemm_operands(layout, m, n, k, epi, dt, device)
        a = ops["a"].t() if layout == "tn" else ops["a"]
        b = ops["b"].t() if layout == "nt" else ops["b"]
        ms = device_ms(lambda: sc.run_gemm(ops))
        mm = device_ms(lambda: torch.matmul(a, b))
        nt_ms = None
        if nt and layout == "nn" and epi != "stash":
            ops_nt = {**ops, "b": ops["b"].t().contiguous(), "layout": "nt"}
            nt_ms = device_ms(lambda: sc.run_gemm(ops_nt))
        flops, nbytes = sc.gemm_flops_bytes(ops)
        bound = 1e3 * max(flops / PEAK_BF16, nbytes / HBM_BPS)
        yield (name, layout, m, n, k, ms, mm, flops / ms / 1e9, bound, ops,
               nt_ms)


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--cases", default="spatial")
    ap.add_argument("--gemm", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--nt", action="store_true",
                    help="with --gemm: time each nn shape also with its "
                         "weight stored (N, K), as layout nt")
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
    tag = os.path.relpath(root, here)
    if args.gemm:
        for name, layout, m, n, k, ms, mm, tflops, bound, _, nt_ms in \
                gemm_rows(gemm_selfcheck(), torch.device("cuda"), args.batch,
                          args.nt):
            print(json.dumps({"root": tag, "gemm": name, "batch": args.batch,
                              "layout": layout, "mnk": [m, n, k], "ms": ms,
                              "matmul_ms": mm, "tflops": tflops,
                              "bound_ms": bound, "nt_ms": nt_ms,
                              "card": card}), flush=True)
        return
    cases = selfcheck.slice_cases(torch.device("cuda"))
    names = CASE_SETS.get(args.cases, args.cases.split(","))
    for name in names:
        kern, _, make = cases[name]
        for dt in (torch.bfloat16, torch.float32):
            call_args = make(dt)
            ms = min(median_ms(lambda: kern(*call_args)) for _ in range(2))
            dms = device_ms(lambda: kern(*call_args))
            print(json.dumps({"root": tag, "case": name, "dtype": str(dt)[6:],
                              "ms": ms, "device_ms": dms, "card": card}),
                  flush=True)


if __name__ == "__main__":
    main()
