"""Median times of port kernels at the serving slice on one NVIDIA GPU.

    python3 tools/kernel_ms.py [--root DIR]
                               [--cases NAME,...|spatial|gemm|temporal]
                               [--gemm | --gemm-q8 | --layer-phases]
                               [--dtype bf16|f32] [--batch B] [--library]

Imports istvt_tpu_torch from DIR (default: the checkout holding this
script), builds its kernels and times each case of its
kernels/selfcheck.slice_cases (`spatial`, the default: the kernels that run
the spatial attention core or its backward: #2, #9, #10, #13 packed and
unpacked, #14, #15; `gemm`: the kernels that run the float GEMM, #6,
#18-#23; `temporal`: the temporal core #11, its backward #12 and #1, which
runs the core after its GEMM) in bf16 and in f32 (or in --dtype alone) on
the case's seeded inputs, for B clips (default 2, the slice; 16 for the
B=16 forward's shapes; #24's cases take the stem's 6 B frames): the
smaller of two medians
of 20 CUDA-event timings of one call (chip_smoke.py's phase-3 timing), the
warm-up outside them, and `device_ms`, the device time of one call with the
host's launch overhead hidden; with --library also the device ms of the
case's PyTorch yardstick on the same inputs (selfcheck.library_call, in
f32 under highest(): TF32 off) and its bound (selfcheck.case_bound_ms: in
f32 the spatial cores', GEMMs' and #24's pointwise products as three TF32
products), and for #24 the device ms of its composition yardstick, the
stem's cuDNN route (selfcheck.sepconv_cudnn, cudnn_ms). Prints
one JSON line per case and dtype: root, case, dtype, batch, ms, device_ms
(library_ms, cudnn_ms, bound_ms, bound_by), and the card's name and power
limit. #24 at its four units, parent against change:
    --root DIR --cases sepconv_bn,sepconv_bn@block1.0,sepconv_bn@block1.1,\
        sepconv_bn@block3.0 --library [--batch 16]

With --layer-phases it times the 14 phases of the one-launch int8 layer #9
(kernels/quant.st_layer_q8) at the slice and at B=16, in bf16 and f32: the
kernel's stamped instantiation (`stamps=`), in which block 0 reads
%globaltimer at the start and after every grid barrier, run 10 times after
a warm-up; one JSON line per batch and dtype with each phase's median µs
(LAYER_PHASES, a phase's time including its closing barrier), their sum,
and the unstamped call's device ms beside it.

With --gemm it times instead the float GEMM alone (kernels/linear.gemm) at
every caller's shape (selfcheck.gemm_shapes, taken from this script's
checkout, so that a parent's package can be timed on the same operands) for
B clips (default 2, the slice; 16 for the B=16 forward and step), with
inputs in --dtype (bf16, the default, or f32: the three-TF32-product GEMM;
the operands and shapes from selfcheck.gemm_operands / gemm_shapes of
this checkout), and torch.matmul on the same operands as the yardstick (in
f32 with TF32 off): one JSON line per shape with device ms, TFLOP/s, the
bound and what sets it (selfcheck.gemm_bound_ms: in f32 three TF32
products at 495 TFLOP/s, and the FMA pipes' time beside it) and, in f32,
the worst error against the plain f32 product by selfcheck.gemm_f32_close
(with --nt, an nn shape also timed with its weight stored (N, K), as
layout nt: what the weight's layout costs). With --gemm-q8 it times the int8 GEMM alone the same way,
at every int8 caller's shape (selfcheck.gemm_q8_shapes: #1-#8's QKV,
out-projections, fc1 and fc2 with their epilogues), on operands made by
this checkout's selfcheck and quant helpers: the GEMM of the package
under DIR (quant.gemm_q8 on the padded codes and the K-major weight copy;
for a package without it, the mma.sync GEMM's quant._gemm on dense codes
and the (K, N) weight), with torch._int_mm on the same codes and weight
as the yardstick, and the share of outputs equal bit for bit to the plain
version. Run parent, change, change, parent in one call to compare two
commits on one card.

With --save PATH the cases' outputs (each case and dtype, on the host) are
written to PATH as well; `--compare A B` reads two such files and prints,
per case and dtype, whether the outputs are equal bit for bit and their
largest difference: the cases' outputs of two commits on the same seeded
inputs.
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
TEMPORAL_CASES = ("temporal_attention_packed", "temporal_attention_packed/bwd",
                  "ln_qkv_q8_temporal_attention")
CASE_SETS = {"spatial": SPATIAL_CASES, "gemm": GEMM_CASES,
             "temporal": TEMPORAL_CASES}
# #9's phases in the order of csrc/q8_layer.cu
LAYER_PHASES = ("1 LN + quant x", "2 QKV_t GEMM", "3 temporal core",
                "4 quant a_t", "5 out_t GEMM + b", "6 LN + quant y",
                "7 QKV_s GEMM", "8 spatial core", "9 quant a_s",
                "10 out_s GEMM + b + x", "11 LN + quant y",
                "12 fc1 GEMM + GELU", "13 quant hidden", "14 fc2 GEMM + y")
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


def _own_module(name):
    """This checkout's istvt_tpu_torch/kernels/<name>.py, loaded by path
    (what it imports comes from whichever istvt_tpu_torch is on
    sys.path)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "istvt_tpu_torch", "kernels", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_own_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def own_selfcheck():
    """This checkout's kernels/selfcheck.py: its GEMM tables, operands and
    yardsticks (the kernels it calls are those of whichever istvt_tpu_torch
    is on sys.path)."""
    return _own_module("selfcheck")


def int_mm_ms(ops):
    """torch._int_mm's device ms on an int8 GEMM case's codes (a dense
    (M, K) copy) and its weight, int32 out, no epilogue: the faster of the
    weight as stored, (K, N) row-major, and column-major (the K-major
    copy's layout); (ms, "row-major" or "column-major"), or (None, None)
    where this torch refuses both."""
    a = ops["q"].contiguous()
    best = (None, None)
    for layout, b in (("row-major", ops["wq"]),
                      ("column-major", ops["wq"].t().contiguous().t())):
        try:
            torch._int_mm(a, b)
        except RuntimeError:
            continue
        ms = device_ms(lambda: torch._int_mm(a, b))
        if best[0] is None or ms < best[0]:
            best = (ms, layout)
    return best


def gemm_q8_rows(sc, device, batch=2, run=None):
    """Yields (name, (M, N, K, out dtype, residual dtype, bias, gelu),
    kernel device ms, int_mm_ms(ops), TOP/s, bound ms, operands) for each
    int8 GEMM shape of `batch` clips (the operands made afresh for each
    shape; ops["out"] then holds the kernel's result).
    run(ops) gives the call to time (default: sc.run_gemm_q8)."""
    for name, shape in sc.gemm_q8_shapes({**sc.SLICE, "b": batch}).items():
        ops = sc.gemm_q8_operands(*shape, device)
        call = run(ops) if run else (lambda: sc.run_gemm_q8(ops))
        ms = device_ms(call)
        lib_ms = int_mm_ms(ops)
        n_ops, n_bytes = sc.gemm_q8_ops_bytes(ops)
        bound = sc.bound_ms({"int8": n_ops}, n_bytes)[0]
        yield name, shape, ms, lib_ms, n_ops / ms / 1e9, bound, ops


def package_gemm_q8(quant, lib):
    """run(ops) for gemm_q8_rows: the int8 GEMM of the package whose
    kernels/quant is `quant` (and kernels/_lib `lib`)."""
    if hasattr(quant, "gemm_q8"):
        return lambda ops: lambda: quant.gemm_q8(
            ops["q"], ops["wk"], ops["rs"], ops["ws"], ops["out"],
            bias=ops.get("bias"), res=ops.get("res"),
            gelu=ops.get("gelu", False))

    def run(ops):
        q = ops["q"].contiguous()
        return lambda: quant._gemm(lib.load(), lib.stream(), q, ops["wq"],
                                   ops["rs"], ops["ws"], ops.get("bias"),
                                   ops.get("res"), ops["out"],
                                   gelu=ops.get("gelu", False))
    return run


def layer_phase_us(kern, args, reps=10):
    """Median µs of each of #9's phases over `reps` stamped launches of
    kern (st_layer_q8 with its K-major copies) on args, after a warm-up."""
    from istvt_tpu_torch.kernels import quant
    stamps = torch.zeros(quant.LAYER_STAMPS, dtype=torch.int64,
                         device=args[0].device)
    kern(*args, stamps=stamps)
    runs = []
    for _ in range(reps):
        kern(*args, stamps=stamps)
        runs.append(np.diff(stamps.cpu().numpy()) / 1e3)
    return np.median(np.stack(runs), axis=0)


def gemm_rows(sc, device, batch=2, nt=False, dtype=torch.bfloat16):
    """Yields (name, layout, m, n, k, kernel device ms, torch.matmul device
    ms, TFLOP/s, sc.gemm_bound_ms(ops), operands, nt ms) for each GEMM shape
    of `batch` clips with inputs of `dtype` (the operands made afresh for
    each shape; torch.matmul with TF32 off); with nt, an nn shape (but the
    stash, which only nn takes) is also timed as the same product with its
    weight stored (N, K), layout nt (else nt ms is None)."""
    from istvt_tpu_torch.core.precision import highest
    for name, (layout, m, n, k, epi, dt) in sc.gemm_shapes(
            {**sc.SLICE, "b": batch}, dtype).items():
        ops = sc.gemm_operands(layout, m, n, k, epi, dt, device, dtype=dtype)
        a = ops["a"].t() if layout == "tn" else ops["a"]
        b = ops["b"].t() if layout == "nt" else ops["b"]
        ms = device_ms(lambda: sc.run_gemm(ops))
        with highest():
            mm = device_ms(lambda: torch.matmul(a, b))
        nt_ms = None
        if nt and layout == "nn" and epi != "stash":
            ops_nt = {**ops, "b": ops["b"].t().contiguous(), "layout": "nt"}
            nt_ms = device_ms(lambda: sc.run_gemm(ops_nt))
        flops, _ = sc.gemm_flops_bytes(ops)
        yield (name, layout, m, n, k, ms, mm, flops / ms / 1e9,
               sc.gemm_bound_ms(ops), ops, nt_ms)


def batch_geometry(geometry, batch):
    """`geometry` at B clips: b = B, and 6 B frames for #24's units (the
    stem runs each clip's 6 frames)."""
    return {**geometry, "b": batch, "frames": 6 * batch}


def _yardstick(sc, name, args, out, dtype, highest):
    """{library_ms, bound_ms, bound_by} of a case by this checkout's
    selfcheck `sc`: the device ms of its one-call yardstick (library_call;
    None where it has none; under highest() in f32) and its bound for
    activations of dtype (case_bound_ms); for #24 also cudnn_ms, the
    device ms of its composition yardstick (sepconv_cudnn)."""
    counter = sc.counter(name)
    row = {}
    with highest():
        lib = sc.library_call(counter, args)
        row["library_ms"] = None if lib is None else device_ms(lib)
        if counter == "sepconv_bn":
            row["cudnn_ms"] = device_ms(sc.sepconv_cudnn(args))
    row["bound_ms"], row["bound_by"] = sc.case_bound_ms(counter, args, out,
                                                        dtype)
    return row


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--cases", default="spatial")
    ap.add_argument("--gemm", action="store_true")
    ap.add_argument("--gemm-q8", action="store_true",
                    help="time the int8 GEMM alone at its callers' shapes")
    ap.add_argument("--layer-phases", action="store_true",
                    help="time each phase of the one-launch int8 layer #9 "
                         "at the slice and at B=16")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--nt", action="store_true",
                    help="with --gemm: time each nn shape also with its "
                         "weight stored (N, K), as layout nt")
    ap.add_argument("--library", action="store_true",
                    help="with the cases: time each case's PyTorch "
                         "yardstick and give its bound too")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default=None,
                    help="the inputs' dtype (--gemm: bf16 unless given; "
                         "the cases: both unless given)")
    ap.add_argument("--save", default=None,
                    help="with the cases: write their outputs to this file")
    ap.add_argument("--compare", nargs=2, default=None,
                    help="two --save files: print per case whether their "
                         "outputs are equal bit for bit")
    args = ap.parse_args()
    if args.compare:
        a, b = (torch.load(f) for f in args.compare)
        for key in a:
            pairs = list(zip(a[key], b.get(key, ())))
            equal = bool(pairs) and all(torch.equal(x, y) for x, y in pairs)
            diff = max(((x.float() - y.float()).abs().max().item()
                        for x, y in pairs), default=None)
            print(json.dumps({"case": key, "bit_equal": equal,
                              "max_abs_diff": diff}), flush=True)
        return
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    from istvt_tpu_torch.core.precision import highest
    from istvt_tpu_torch.kernels import _lib, quant, selfcheck

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the GPU")
    _lib.load()
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    tag = os.path.relpath(root, here)
    if args.gemm_q8:
        sc = own_selfcheck()
        sc.quant = _own_module("quant")   # operands and plain version
        for name, (m, n, k, *_), ms, (lib_ms, lib_layout), tops, bound, \
                ops in gemm_q8_rows(sc, torch.device("cuda"), args.batch,
                                    package_gemm_q8(quant, _lib)):
            share = sc.bit_equal_share(ops["out"], sc.gemm_q8_plain(ops))
            print(json.dumps({"root": tag, "gemm_q8": name,
                              "batch": args.batch, "mnk": [m, n, k],
                              "ms": ms, "int_mm_ms": lib_ms,
                              "int_mm_layout": lib_layout, "tops": tops,
                              "bound_ms": bound, "bit_equal": share,
                              "card": card}), flush=True)
        return
    if args.gemm:
        sc = own_selfcheck()
        dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
        for name, layout, m, n, k, ms, mm, tflops, (bound, by, fma), ops, \
                nt_ms in gemm_rows(sc, torch.device("cuda"), args.batch,
                                   args.nt, dtype):
            err = None
            if dtype == torch.float32:
                with highest():
                    want = sc.gemm_plain(ops)
                err = sc.gemm_f32_close(ops, sc.gemm_results(ops), want)[1]
            print(json.dumps({"root": tag, "gemm": name, "batch": args.batch,
                              "dtype": args.dtype or "bf16", "layout": layout,
                              "mnk": [m, n, k], "ms": ms, "matmul_ms": mm,
                              "tflops": tflops, "bound_ms": bound,
                              "bound_by": by, "fma_ms": fma,
                              "share": bound / ms, "err": err,
                              "nt_ms": nt_ms, "card": card}), flush=True)
        return
    if args.layer_phases:
        for batch in (2, 16):
            kern, _, make = selfcheck.slice_cases(
                torch.device("cuda"), {**selfcheck.SLICE, "b": batch})[
                    "st_layer_q8"]
            for dt in (torch.bfloat16, torch.float32):
                call_args = make(dt)
                us = layer_phase_us(kern, call_args)
                dms = device_ms(lambda: kern(*call_args))
                print(json.dumps({
                    "root": tag, "layer_phases": dict(zip(
                        LAYER_PHASES, us.round(3).tolist())),
                    "batch": batch, "dtype": str(dt)[6:],
                    "sum_us": float(us.sum()), "device_ms": dms,
                    "card": card}), flush=True)
        return
    cases = selfcheck.slice_cases(torch.device("cuda"), batch_geometry(
        selfcheck.SLICE, args.batch))
    names = CASE_SETS.get(args.cases, args.cases.split(","))
    dtypes = {None: (torch.bfloat16, torch.float32),
              "bf16": (torch.bfloat16,), "f32": (torch.float32,)}[args.dtype]
    saved = {}
    for name in names:
        kern, _, make = cases[name]
        for dt in dtypes:
            call_args = make(dt)
            if args.save:
                saved[f"{name} {str(dt)[6:]}"] = [
                    t.cpu() for t in selfcheck.outputs(kern(*call_args))]
            ms = min(median_ms(lambda: kern(*call_args)) for _ in range(2))
            dms = device_ms(lambda: kern(*call_args))
            row = {"root": tag, "case": name, "dtype": str(dt)[6:],
                   "batch": args.batch, "ms": ms, "device_ms": dms}
            if args.library:
                row.update(_yardstick(own_selfcheck(), name, call_args,
                                      kern(*call_args), dt, highest))
            print(json.dumps({**row, "card": card}), flush=True)
    if args.save:
        torch.save(saved, args.save)


if __name__ == "__main__":
    main()
