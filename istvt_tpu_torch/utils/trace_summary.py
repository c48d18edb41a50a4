"""Trace summary by operator: the counterpart of istvt_tpu/utils/xplane.py.

`utils/profiling.trace` (torch.profiler) writes chrome-trace JSON, not an
XSpace, so this module reads that JSON with the standard library and
totals the device's events as xplane.aggregate totals a TPU trace's:

  * each kernel is filed under the operator that launched it, where the
    trace links them: the kernel's correlation id names its CUDA runtime
    call (cudaLaunchKernel, cudaMemcpyAsync, ...), and that call lies
    inside operator events on its CPU thread; the key is the outermost
    dispatcher operator around it (`aten::conv2d`, `aten::batch_norm`,
    `aten::_foreach_add_`, `aten::to`, `istvt::ln_matmul`, ...: events
    named `namespace::name`);
  * a kernel that no operator launched keeps its own name, without
    `void `, template arguments or parameter list: the port's ctypes
    kernels (the backward kernels, #21's h1 forward) then appear as
    `istvt::gemm_bf16_wgmma_kernel`, `istvt::temporal_attn_bwd_kernel`,
    ...;
  * copies and memsets (`gpu_memcpy`, `gpu_memset`) are flagged
    `asynchronous` and never summed into busy time, as xplane keeps the
    TPU's DMA windows apart.

Usage:
    from istvt_tpu_torch.utils import trace_summary
    rows = trace_summary.aggregate(trace_summary.parse_file(path))
    print(trace_summary.format_table(rows))

or `python -m istvt_tpu_torch.utils.trace_summary PATH [--top N]`, PATH a
trace file or a `trace()` log directory (its newest trace).
"""
from __future__ import annotations

import bisect
import dataclasses
import glob
import json
import os
import re
from typing import Dict, List, Sequence, Tuple

#: event categories of the device: kernels, and the copies and memsets
#: that are not busy time
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ASYNC_CATS = ("gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
_OPERATOR = re.compile(r"^[A-Za-z_]\w*::[\w.]+$")


def parse_file(path: str) -> List[dict]:
    """The trace's events (its `traceEvents`)."""
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def find_traces(log_dir: str) -> List[str]:
    """All chrome traces under a trace() log dir (newest last)."""
    hits = glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"),
                     recursive=True)
    return sorted(hits, key=os.path.getmtime)


def kernel_name(name: str) -> str:
    """`void ns::kernel<T, 4>(Params)` -> `ns::kernel`."""
    if name.startswith("void "):
        name = name[len("void "):]
    for sep in ("<", "("):
        i = name.find(sep)
        if i > 0:
            name = name[:i]
    return name.strip()


def _outermost_operators(events) -> Dict[Tuple, Tuple[list, list]]:
    """{(pid, tid): (starts, [(end, name)])} of the operator events that no
    other operator event on their thread encloses, sorted by start."""
    by_thread: Dict[Tuple, list] = {}
    for ev in events:
        if ev.get("cat") == "cpu_op" and _OPERATOR.match(ev.get("name", "")):
            by_thread.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (float(ev["ts"]), -float(ev.get("dur", 0)), ev["name"]))
    out = {}
    for key, ops in by_thread.items():
        ops.sort()
        starts, spans, end = [], [], -float("inf")
        for ts, neg_dur, name in ops:
            if ts < end:
                continue        # inside the current outermost operator
            end = ts - neg_dur
            starts.append(ts)
            spans.append((end, name))
        out[key] = (starts, spans)
    return out


def launchers(events) -> Dict[int, str]:
    """{correlation id: the outermost operator around the runtime call}."""
    tops = _outermost_operators(events)
    out = {}
    for ev in events:
        if ev.get("cat") not in _RUNTIME_CATS:
            continue
        corr = (ev.get("args") or {}).get("correlation")
        starts, spans = tops.get((ev.get("pid"), ev.get("tid")), ([], []))
        i = bisect.bisect_right(starts, float(ev["ts"])) - 1
        if corr is not None and i >= 0 and float(ev["ts"]) <= spans[i][0]:
            out[corr] = spans[i][1]
    return out


@dataclasses.dataclass
class Row:
    prefix: str
    count: int
    total_ms: float
    mean_us: float
    asynchronous: bool


def aggregate(events: List[dict],
              cat_filter: Sequence[str] = DEVICE_CATS) -> List[Row]:
    """Totals of the events whose category is in cat_filter, busiest
    first. Device events are keyed by the operator that launched them
    (else their kernel name); any other event (e.g. cat_filter=('cpu_op',))
    by its own name. Copies and memsets are `asynchronous`."""
    owner = launchers(events)
    acc: Dict[Tuple[str, bool], List[float]] = {}
    for ev in events:
        cat = ev.get("cat")
        if cat not in cat_filter or ev.get("ph") != "X":
            continue
        if cat in DEVICE_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            key = owner.get(corr) or kernel_name(ev.get("name", ""))
        else:
            key = ev.get("name", "")
        cell = acc.setdefault((key, cat in ASYNC_CATS), [0, 0.0])
        cell[0] += 1
        cell[1] += float(ev.get("dur", 0)) / 1e3  # us -> ms
    rows = [Row(prefix=k[0], count=int(c), total_ms=t,
                mean_us=(t / c * 1e3 if c else 0.0), asynchronous=k[1])
            for k, (c, t) in acc.items()]
    rows.sort(key=lambda r: -r.total_ms)
    return rows


def format_table(rows: List[Row], top: int = 25) -> str:
    out = [f"{'prefix':40s} {'count':>7s} {'total ms':>10s} "
           f"{'mean us':>9s}  async"]
    for r in rows[:top]:
        out.append(f"{r.prefix[:40]:40s} {r.count:7d} {r.total_ms:10.3f} "
                   f"{r.mean_us:9.1f}  {'Y' if r.asynchronous else ''}")
    busy = sum(r.total_ms for r in rows if not r.asynchronous)
    out.append(f"-- busy (non-async) total: {busy:.3f} ms over "
               f"{sum(r.count for r in rows if not r.asynchronous)} events")
    return "\n".join(out)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser("istvt_tpu_torch.utils.trace_summary")
    p.add_argument("path", help="chrome trace (.pt.trace.json) or a "
                                "trace() log dir")
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)
    path = args.path
    if os.path.isdir(path):
        traces = find_traces(path)
        if not traces:
            raise SystemExit(f"no .pt.trace.json under {path}")
        path = traces[-1]
        print(f"# {path}")
    print(format_table(aggregate(parse_file(path)), top=args.top))


if __name__ == "__main__":
    main()
