"""Smoke run of the PyTorch / CUDA port (istvt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PATH]

Drives the port's two ISTVT serving paths at the paper geometry (300^2 x 6
frames, depth 12, 8 heads x 64, dim 728, FF 2912) with random weights from
a seed: the int8 W8A8 path (`cli/serve.py --int8`) and the float fused
path in bf16 (`cli/serve.py --bf16`). In phases; any failure raises and
exits non-zero:

  1. device   - a CUDA device is required; prints nvidia-smi's name and
                power limit and the torch / CUDA versions
  2. build    - nvcc builds every kernel from istvt_tpu_torch/kernels/csrc
  3. kernels  - each of the eight kernels (nine cases: #20 with and
                without its residual) vs its plain PyTorch version on the
                card at the slice's shapes (2 clips, T+1 = 7, S = 368,
                n_valid = 362): f32 at atol = rtol = 2e-3 (int8 kernels)
                or 1e-5 (float kernels), bf16 at rel-L2 < 1e-2 and
                max|diff| < 0.02 max|plain|; median kernel / plain /
                library-call ms and the card's least time (bound)
  then for each path, int8 first:
  4. serving  - the model behind the HTTP ServeDaemon: float32 and uint8
                POSTs, a 16-clip batch and two concurrent requests, all
                HTTP 200 with finite logits; counted from 0 just before,
                each kernel of the path must have launched exactly its
                launches per forward times the forwards, every other 0
  5. e2e      - 1-clip logits on the card (kernels, bf16) vs the same model
                on the CPU (plain versions, f32): |dlogit| <= 5e-2
  6. timing   - B=16 forward, median ms and clips/s
                (tools/torch_forward_ms.forward_times: CUDA events, a
                distinct input per iteration)

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. With --profile PATH, torch.profiler tables
of one B=16 forward of each path are written to PATH.
"""
from __future__ import annotations

import argparse
import copy
import http.client
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tools")]

from istvt_tpu_torch.cli import serve as cli_serve  # noqa: E402
from istvt_tpu_torch.core import tree  # noqa: E402
from istvt_tpu_torch.core.config import ISTVTConfig  # noqa: E402
from istvt_tpu_torch.core.device import require_cuda  # noqa: E402
from istvt_tpu_torch.core.precision import highest  # noqa: E402
from istvt_tpu_torch.kernels import _lib, selfcheck  # noqa: E402
from istvt_tpu_torch.models import istvt  # noqa: E402
from istvt_tpu_torch.serve_daemon import ServeDaemon  # noqa: E402
from torch_forward_ms import forward_times  # noqa: E402

# the two paths, by their cli/serve.py flags, at the CLI's default paper
# geometry (300^2 x 6, depth 12)
PATHS = {"int8": ["--int8"], "float": ["--bf16"]}
PAPER = ISTVTConfig()
DEPTH = PAPER.depth
CLIP = (PAPER.num_frames, PAPER.image_size, PAPER.image_size, 3)
_CSRC = "istvt_tpu_torch/kernels/csrc/"

# kernel (launch-count name): (source, TPU kernel it replaces, path,
# launches per layer)
KERNELS = {
    "ln_qkv_q8_temporal_attention": (
        _CSRC + "q8_attention.cu", "istvt_tpu/kernels/quant.py:559",
        "int8", 1),
    "mm_q8_ln_qkv_q8_spatial_attention": (
        _CSRC + "q8_attention.cu", "istvt_tpu/kernels/quant.py:635",
        "int8", 1),
    "matmul_q8_res_ln_ff_q8_full": (
        _CSRC + "q8_rows_gemm.cu", "istvt_tpu/kernels/quant.py:422",
        "int8", 1),
    "temporal_attention_packed": (
        _CSRC + "q8_attention.cu", "istvt_tpu/kernels/attention.py:324",
        "float", 1),
    "spatial_attention_packed": (
        _CSRC + "q8_attention.cu", "istvt_tpu/kernels/attention.py:190",
        "float", 1),
    "ln_matmul": (
        _CSRC + "float_gemm.cu", "istvt_tpu/kernels/linear.py:82",
        "float", 2),
    "matmul_bias_residual": (
        _CSRC + "float_gemm.cu", "istvt_tpu/kernels/linear.py:248",
        "float", 1),
    "matmul_bias_residual/no_r": (
        _CSRC + "float_gemm.cu", "istvt_tpu/kernels/linear.py:248",
        "float", 1),
    "ln_ff_residual": (
        _CSRC + "float_gemm.cu", "istvt_tpu/kernels/mlp.py:102",
        "float", 1),
}

# published H100 SXM peaks (hopper-kernels guide section 1): bytes/s, and
# dense operations/s by the type of the inputs
HBM_BPS = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# 3. kernels vs plain


def _median_ms(fn, iters=20, warmup=3):
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


def _ops(name, args):
    """{input type: operations} the kernel's products need on these inputs
    (multiply-adds count 2; elementwise work is left out). Masked keys
    (>= n_valid) are not counted: the data does not need them."""
    if name == "ln_qkv_q8_temporal_attention":
        x, wq, heads = args[0], args[3], args[5]
        b, t1, s, d = x.shape
        inner = wq.shape[1] // 3
        return {"int8": 2 * x.numel() // d * d * 3 * inner,
                "bf16": 4 * b * s * t1 * t1 * inner}
    if name == "mm_q8_ln_qkv_q8_spatial_attention":
        a, woq, wq, n_valid = args[0], args[1], args[6], args[9]
        g, s, d_in = a.shape
        d, inner = woq.shape[1], wq.shape[1] // 3
        return {"int8": 2 * g * s * (d_in * d + d * 3 * inner),
                "bf16": 4 * g * s * n_valid * inner}
    if name == "matmul_q8_res_ln_ff_q8_full":
        a, wqo, w1q = args[0], args[2], args[7]
        rows = a.numel() // a.shape[-1]
        d, hid = wqo.shape[1], w1q.shape[1]
        return {"int8": 2 * rows * (a.shape[-1] * d + 2 * d * hid)}
    if name == "temporal_attention_packed":
        b, t1, s, i3 = args[0].shape
        return {"bf16": 4 * b * s * t1 * t1 * (i3 // 3)}
    if name == "spatial_attention_packed":
        g, s, i3 = args[0].shape
        return {"bf16": 4 * g * s * args[2] * (i3 // 3)}
    rows = args[0].numel() // args[0].shape[-1]
    if name == "ln_ff_residual":
        return {"bf16": 4 * rows * args[3].shape[0] * args[3].shape[1]}
    # ln_matmul, matmul_bias_residual(/no_r): one (rows, K) @ (K, N) product
    return {"bf16": 2 * rows * args[-1 if name == "ln_matmul" else 1].numel()}


def _bound_ms(name, args, out):
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, the output written once) over
    the memory rate and its operations over the peak rate of their type."""
    tensors = [t for t in args if torch.is_tensor(t)] + [out]
    t_bytes = sum(t.numel() * t.element_size() for t in tensors) / HBM_BPS
    t_ops = sum(n / PEAK_OPS[k] for k, n in _ops(name, args).items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _library_call(name, args):
    """One PyTorch call computing the same function, timed as a yardstick
    only (the port never calls it), or None where there is none."""
    if name == "spatial_attention_packed":
        qkv, heads, n_valid = args
        g, s, i3 = qkv.shape
        q, k, v = (t.view(g, s, heads, -1).transpose(1, 2)
                   for t in qkv.split(i3 // 3, dim=-1))
        mask = torch.zeros(1, 1, 1, s, dtype=qkv.dtype, device=qkv.device)
        mask[..., n_valid:] = -1e30
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask)
    if name == "matmul_bias_residual/no_r":
        x, w, b = args
        return lambda: F.linear(x, w.t(), b)
    return None


def check_kernels(dev):
    """Every case vs its plain version in f32 and bf16, then bf16 times.
    Returns {case: JSON fields}."""
    rows = {}
    for name, (kern, plain, make) in selfcheck.slice_cases(dev).items():
        args = make(torch.float32)
        with highest():
            got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        ok32, err32 = selfcheck.f32_close(name, got, want)
        args16 = make(torch.bfloat16)
        out16 = kern(*args16)
        ok16, rel, mx, scale = selfcheck.bf16_close(out16, plain(*args16))
        torch.cuda.synchronize()
        ms_plain_a = _median_ms(lambda: plain(*args16))
        ms_kern_a = _median_ms(lambda: kern(*args16))
        ms_kern_b = _median_ms(lambda: kern(*args16))
        ms_plain_b = _median_ms(lambda: plain(*args16))
        ms, plain_ms = min(ms_kern_a, ms_kern_b), min(ms_plain_a, ms_plain_b)
        lib = _library_call(name, args16)
        lib_ms = None if lib is None else _median_ms(lib)
        bound_ms, bound_by = _bound_ms(name, args16, out16)
        phase("kernels", f"{name}: f32 max|diff| {err32:.3e} "
              f"({'ok' if ok32 else 'FAIL'} at {selfcheck.f32_tol(name)}); "
              f"bf16 rel-L2 {rel:.3e} "
              f"max|diff| {mx:.3e} vs max|plain| {scale:.3e} "
              f"({'ok' if ok16 else 'FAIL'}); bf16 median ms kernel "
              f"{ms_kern_a:.4f}/{ms_kern_b:.4f} plain "
              f"{ms_plain_a:.4f}/{ms_plain_b:.4f} library {lib_ms} "
              f"bound {bound_ms:.4f} ({bound_by})")
        if not (ok32 and ok16):
            raise SystemExit(f"kernel {name} disagrees with its plain version")
        rows[name] = {"max_abs_err": err32, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": lib_ms}
    return rows


# ---------------------------------------------------------------------------
# 4. serving through the HTTP daemon


def _post(port, arr):
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/predict", body=buf.getvalue(),
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _expect(status, body, n, what):
    if status != 200:
        raise SystemExit(f"{what}: HTTP {status} {body}")
    logits = np.asarray(body["logits"], np.float64)
    if logits.shape != (n,) or not np.all(np.isfinite(logits)):
        raise SystemExit(f"{what}: bad logits {body['logits']}")
    phase("serving", f"{what}: HTTP 200, logits {np.round(logits, 5).tolist()}")


def serve_phase(path, predictor):
    """HTTP requests through ServeDaemon; returns the launches they made."""
    rng = np.random.RandomState(0)
    for b in predictor.batch_sizes:                       # warm every bucket
        predictor.predict(np.zeros((b,) + CLIP, np.float32))
    torch.cuda.synchronize()
    _lib.reset_launches()
    predictor.n_forwards = 0
    daemon = ServeDaemon(predictor, CLIP, host="127.0.0.1", port=0,
                         max_batch=16, max_wait_ms=5.0).start()
    try:
        _expect(*_post(daemon.port, rng.randn(*CLIP).astype(np.float32)), 1,
                "1 float32 clip")
        _expect(*_post(daemon.port, rng.randint(0, 256, (3,) + CLIP)
                       .astype(np.uint8)), 3, "3 uint8 clips")
        _expect(*_post(daemon.port, rng.randn(16, *CLIP).astype(np.float32)),
                16, "16-clip batch")
        singles = [rng.randn(*CLIP).astype(np.float32) for _ in range(2)]
        replies = [None, None]

        def client(i):
            replies[i] = _post(daemon.port, singles[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise SystemExit("concurrent request did not finish")
        for i, r in enumerate(replies):
            _expect(*r, 1, f"concurrent clip {i}")
    finally:
        daemon.close()
    torch.cuda.synchronize()
    counts = dict(_lib.LAUNCHES)
    want = {n: per_layer * DEPTH * predictor.n_forwards if p == path else 0
            for n, (_, _, p, per_layer) in KERNELS.items()}
    phase("serving", f"{path}: {predictor.n_forwards} card forwards; "
          f"launches {counts} (want {want})")
    if counts != want:
        raise SystemExit(f"the {path} serving path did not launch each of "
                         f"its kernels its count per forward")
    return counts


def e2e_phase(path, predictor):
    """Card (kernels, bf16) vs CPU (plain versions, f32) on one clip."""
    clip = np.random.RandomState(1).randn(1, *CLIP).astype(np.float32)
    card_logit = predictor.predict(clip)["logits"]
    cpu_model = tree.cast(copy.deepcopy(predictor.model).to("cpu"),
                          torch.float32)
    if path == "float":
        istvt.pack_params(cpu_model)   # the (in, out) copies, now in f32
    t0 = time.perf_counter()
    with highest(), torch.inference_mode():
        cpu_logit = cpu_model(torch.from_numpy(clip)).reshape(-1).numpy()
    delta = float(np.abs(card_logit - cpu_logit).max())
    phase("e2e", f"{path}: card {card_logit.tolist()} vs CPU plain f32 "
          f"{cpu_logit.tolist()}: |dlogit| {delta:.3e} (limit 5e-2; CPU "
          f"forward {time.perf_counter() - t0:.1f} s)")
    if not delta <= 5e-2:
        raise SystemExit(f"{path}: card logits disagree with the CPU "
                         f"reference")


def timing_phase(path, model, dev, card, profile):
    """B=16 forward (tools/torch_forward_ms.forward_times); optional
    profile of one more."""
    ms = float(np.median(forward_times(model, CLIP)))
    phase("timing", f"{path}: B=16 forward median {ms:.3f} ms = "
          f"{16e3 / ms:.2f} clips/s on {card} (informative)")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        x = torch.randn(16, *CLIP, device=dev).to(torch.bfloat16)
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            with torch.inference_mode():
                model(x)
            torch.cuda.synchronize()
        with open(profile, "a") as f:
            f.write(f"{card}, {path} path, B=16 forward\n")
            f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=40) + "\n")
        phase("timing", f"{path}: profile table appended to {profile}")


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler table of a B=16 forward here")
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke needs an NVIDIA GPU")
    dev = require_cuda()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    phase("device", f"{kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    _lib.load()
    phase("build", f"nvcc sm_90a build + load {time.perf_counter() - t0:.1f} s "
          f"(log: {os.path.relpath(_lib.BUILD_DIR / 'build.log')})")

    # 3. kernels
    rows = check_kernels(dev)
    if args.profile:
        open(args.profile, "w").close()

    # 4-6 per path, at the paper geometry
    launches = {}
    for path in PATHS:
        t0 = time.perf_counter()
        predictor = cli_serve.build_predictor(
            cli_serve.build_parser().parse_args(PATHS[path]), dev)
        phase("serving", f"{path}: model built in "
              f"{time.perf_counter() - t0:.1f} s")
        counts = serve_phase(path, predictor)
        launches.update({n: counts[n] for n, k in KERNELS.items()
                         if k[2] == path})
        e2e_phase(path, predictor)
        timing_phase(path, predictor.model, dev, card, args.profile)
        del predictor
        torch.cuda.empty_cache()

    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": KERNELS[n][0],
         "replaces": KERNELS[n][1], "launches": launches[n], **rows[n]}
        for n in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
