"""A serving path's exported program against its live model on one NVIDIA
GPU: forward times and where the device time goes.

    python3 tools/torch_artifact_ms.py [--path int8|float|float32]
                                       [--batch N,...] [--profile FILE]
                                       [--pyprofile FILE]

Builds the path's paper-geometry model (300^2 x 6, depth 12, seed 0) with
cli/serve.build_predictor, exports it with serve_export.save_artifact
(buckets 1 and 16, into a temporary directory) and times, in turns
(program, loaded, live, twice), `forward_times` of the exported program's
module as export returns it, of the artifact as load_artifact returns it
and of the live model, all from f32 clips cast inside, at each batch.
Prints one JSON line a (batch, run): path, batch, run, median and
quartile ms, the interpreter's garbage collections over the timed calls
(count and ms by generation), the caching allocator's calls into the
driver over them (cudaMalloc, cudaFree, retries after freeing its cache)
and the card's name and power limit. With --profile, appends
torch.profiler tables of one forward of each at each batch (device time
by CUDA kernel, and host time by op) to FILE and prints each one's
device ms and host ms (the profiler's self CPU total, the final
synchronize's wait taken out). With --pyprofile, appends cProfile's
statistics of three B=16 forwards of each (the Python functions by their
own time) to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

from torch_forward_ms import (PATH_FLAGS, alloc_counters,  # noqa: E402
                              forward_times, gc_pauses)
from torch_train_ms import kernel_families  # noqa: E402


def _profile(fn, x, title, out, rows=30):
    """Profile one call fn(x) after a warm-up one: (device ms of every
    kernel and copy, host ms outside the final synchronize)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        fn(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(x)
            torch.cuda.synchronize()
    fam = kernel_families(prof)
    ka = prof.key_averages()
    host = sum(e.self_cpu_time_total for e in ka
               if e.key != "cudaDeviceSynchronize") / 1e3
    with open(out, "a") as f:
        f.write(f"== {title}: device ms, all kernels and copies "
                f"{sum(fam.values()):.3f}, host ms {host:.3f}; by family "
                + json.dumps(
                    {k: round(v, 3) for k, v in sorted(
                        fam.items(), key=lambda kv: -kv[1])}) + "\n")
        f.write(ka.table(sort_by="cuda_time_total", row_limit=rows) + "\n")
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=rows)
                + "\n")
    return sum(fam.values()), host


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=tuple(PATH_FLAGS), default="int8")
    ap.add_argument("--batch", default="16,1")
    ap.add_argument("--profile", default=None)
    ap.add_argument("--pyprofile", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the GPU")

    import tempfile

    from istvt_tpu_torch.cli import serve as cli_serve
    from istvt_tpu_torch.serve_export import (export_program, load_artifact,
                                              save_artifact)

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cli = cli_serve.build_parser().parse_args(PATH_FLAGS[args.path])
    live = cli_serve.build_predictor(cli, torch.device("cuda"))
    clip = (cli.seq_len, cli.input_size, cli.input_size, 3)
    dt = live.compute_dtype or live.input_dtype
    program = export_program(live.model, input_shape=clip, max_batch=16,
                             input_dtype=dt)
    with tempfile.TemporaryDirectory() as tmp:
        save_artifact(tmp, live.model, input_shape=clip,
                      batch_sizes=(1, 16), input_dtype=dt)
        loaded = load_artifact(tmp)
    runs = {"program": program.module(), "loaded": loaded._fn,
            "live": lambda x: live.model(x if dt is None else x.to(dt))}
    batches = list(map(int, args.batch.split(",")))
    for batch in batches:
        for _ in range(2):
            for name, fn in runs.items():
                before = alloc_counters()
                with gc_pauses() as pauses:
                    times = forward_times(fn, clip, torch.float32, batch)
                allocs = {k: v - before[k]
                          for k, v in alloc_counters().items()}
                q1, med, q3 = np.percentile(times, [25, 50, 75])
                gcs = {g: [sum(1 for p in pauses if p[0] == g),
                           sum(ms for p_, ms in pauses if p_ == g)]
                       for g in range(3)}
                print(json.dumps({"path": args.path, "batch": batch,
                                  "run": name, "median_ms": med,
                                  "q1_ms": q1, "q3_ms": q3,
                                  "gc_count_ms": gcs, "allocator": allocs,
                                  "card": card}),
                      flush=True)
    if args.pyprofile:
        import cProfile
        import io
        import pstats
        x = torch.randn(16, *clip, device="cuda")
        for name, fn in runs.items():
            with torch.inference_mode():
                fn(x)
                torch.cuda.synchronize()
                prof = cProfile.Profile()
                prof.enable()
                for _ in range(3):
                    fn(x)
                torch.cuda.synchronize()
                prof.disable()
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(
                40)
            with open(args.pyprofile, "a") as f:
                f.write(f"== {card}, {args.path} path, 3 B=16 forwards, "
                        f"{name}\n{buf.getvalue()}\n")
    if args.profile:
        for batch in batches:
            x = torch.randn(batch, *clip, device="cuda")
            for name, fn in runs.items():
                dev, host = _profile(
                    fn, x, f"{card}, {args.path} path, B={batch}, {name}",
                    args.profile)
                print(json.dumps({"path": args.path, "batch": batch,
                                  "run": name, "profiled_device_ms": dev,
                                  "profiled_host_ms": host, "card": card}),
                      flush=True)


if __name__ == "__main__":
    main()
