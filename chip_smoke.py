"""Smoke run of the PyTorch / CUDA port (istvt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PATH]

Drives the port's int8 ISTVT serving path at the paper geometry (300^2 x 6
frames, depth 12, 8 heads x 64, dim 728, FF 2912) with random weights from
a seed, in phases; any failure raises and exits non-zero:

  1. device   - a CUDA device is required; prints nvidia-smi's name and
                power limit and the torch / CUDA versions
  2. build    - nvcc builds the three kernels from istvt_tpu_torch/kernels/csrc
  3. kernels  - each kernel vs its plain PyTorch version on the card at the
                slice's shapes (2 clips, T+1 = 7, S = 368, n_valid = 362):
                f32 at atol = rtol = 2e-3, bf16 at rel-L2 < 1e-2 and
                max|diff| < 0.02 max|plain|; median kernel / plain ms
  4. serving  - bf16 + int8 model behind the HTTP ServeDaemon: float32 and
                uint8 POSTs, a 16-clip batch and two concurrent requests, all
                HTTP 200 with finite logits; each kernel must have launched
                12 times per forward of that run
  5. e2e      - 1-clip logits on the card (kernels, bf16) vs the same model
                on the CPU (plain versions, f32): |dlogit| <= 5e-2
  6. timing   - B=16 forward, median ms and clips/s (CUDA events, a
                distinct input per iteration)

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. With --profile PATH, a torch.profiler table
of one B=16 forward is written to PATH.
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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from istvt_tpu_torch.core import tree  # noqa: E402
from istvt_tpu_torch.core.config import ISTVTConfig  # noqa: E402
from istvt_tpu_torch.core.device import require_cuda  # noqa: E402
from istvt_tpu_torch.core.precision import highest  # noqa: E402
from istvt_tpu_torch.kernels import _lib, quant, selfcheck  # noqa: E402
from istvt_tpu_torch.models import istvt  # noqa: E402
from istvt_tpu_torch.models.registry import model_selection  # noqa: E402
from istvt_tpu_torch.serve import Predictor  # noqa: E402
from istvt_tpu_torch.serve_daemon import ServeDaemon  # noqa: E402

PAPER = ISTVTConfig(use_pallas=True, quantize="int8")   # 300^2 x 6, depth 12
CLIP = (PAPER.num_frames, PAPER.image_size, PAPER.image_size, 3)

KERNELS = {
    "ln_qkv_q8_temporal_attention": (
        "istvt_tpu_torch/kernels/csrc/q8_attention.cu",
        "istvt_tpu/kernels/quant.py:559"),
    "mm_q8_ln_qkv_q8_spatial_attention": (
        "istvt_tpu_torch/kernels/csrc/q8_attention.cu",
        "istvt_tpu/kernels/quant.py:635"),
    "matmul_q8_res_ln_ff_q8_full": (
        "istvt_tpu_torch/kernels/csrc/q8_rows_gemm.cu",
        "istvt_tpu/kernels/quant.py:422"),
}


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


def check_kernels(dev):
    rows = {}
    for name, (kern, plain, make) in selfcheck.slice_cases(dev).items():
        args = make(torch.float32)
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        ok32, err32 = selfcheck.f32_close(got, want)
        args16 = make(torch.bfloat16)
        ok16, rel, mx, scale = selfcheck.bf16_close(kern(*args16),
                                                    plain(*args16))
        torch.cuda.synchronize()
        ms_plain_a = _median_ms(lambda: plain(*args16))
        ms_kern_a = _median_ms(lambda: kern(*args16))
        ms_kern_b = _median_ms(lambda: kern(*args16))
        ms_plain_b = _median_ms(lambda: plain(*args16))
        ms, plain_ms = min(ms_kern_a, ms_kern_b), min(ms_plain_a, ms_plain_b)
        phase("kernels", f"{name}: f32 max|diff| {err32:.3e} "
              f"({'ok' if ok32 else 'FAIL'}); bf16 rel-L2 {rel:.3e} "
              f"max|diff| {mx:.3e} vs max|plain| {scale:.3e} "
              f"({'ok' if ok16 else 'FAIL'}); bf16 median ms kernel "
              f"{ms_kern_a:.4f}/{ms_kern_b:.4f} plain "
              f"{ms_plain_a:.4f}/{ms_plain_b:.4f}")
        if not (ok32 and ok16):
            raise SystemExit(f"kernel {name} disagrees with its plain version")
        rows[name] = {"max_abs_err": err32, "ms": ms, "plain_ms": plain_ms}
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


def serve_phase(predictor):
    rng = np.random.RandomState(0)
    for b in predictor.batch_sizes:                       # warm every bucket
        predictor.predict(np.zeros((b,) + CLIP, np.float32))
    torch.cuda.synchronize()
    quant.reset_launch_counts()
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
    counts = dict(quant.launch_counts)
    want = PAPER.depth * predictor.n_forwards
    phase("serving", f"{predictor.n_forwards} card forwards; launches "
          f"{counts} (want {want} each)")
    if any(c != want for c in counts.values()):
        raise SystemExit("the serving path did not run every kernel "
                         f"{PAPER.depth} times per forward")
    return counts


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

    # 4. serving at the paper geometry
    t0 = time.perf_counter()
    model = model_selection("istvt", cfg=PAPER, device=dev, seed=0)
    tree.cast(model, torch.bfloat16)
    istvt.quantize_params(model)
    predictor = Predictor(model, dev, batch_sizes=(1, 8, 16),
                          input_dtype=torch.bfloat16)
    phase("serving", f"model built in {time.perf_counter() - t0:.1f} s")
    counts = serve_phase(predictor)

    # 5. card (kernels, bf16) vs CPU (plain versions, f32) on one clip
    clip = np.random.RandomState(1).randn(1, *CLIP).astype(np.float32)
    card_logit = predictor.predict(clip)["logits"]
    cpu_model = tree.cast(copy.deepcopy(model).to("cpu"), torch.float32)
    t0 = time.perf_counter()
    with highest(), torch.inference_mode():
        cpu_logit = cpu_model(torch.from_numpy(clip)).reshape(-1).numpy()
    delta = float(np.abs(card_logit - cpu_logit).max())
    phase("e2e", f"card {card_logit.tolist()} vs CPU plain f32 "
          f"{cpu_logit.tolist()}: |dlogit| {delta:.3e} (limit 5e-2; CPU "
          f"forward {time.perf_counter() - t0:.1f} s)")
    if not delta <= 5e-2:
        raise SystemExit("card logits disagree with the CPU reference")

    # 6. timing: B=16 forward, distinct input per iteration
    g = torch.Generator(device=dev).manual_seed(2)
    inputs = iter([torch.randn(16, *CLIP, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(13)])

    def fwd():
        with torch.inference_mode():
            return model(next(inputs))

    ms = _median_ms(fwd, iters=10, warmup=2)
    phase("timing", f"B=16 forward median {ms:.3f} ms = "
          f"{16e3 / ms:.2f} clips/s on {card} (informative)")
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd()
            torch.cuda.synchronize()
        with open(args.profile, "w") as f:
            f.write(f"{card}\n")
            f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=40))
        phase("timing", f"profile table written to {args.profile}")

    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": KERNELS[n][0],
         "replaces": KERNELS[n][1], "launches": counts[n], **rows[n]}
        for n in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
