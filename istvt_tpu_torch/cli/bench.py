"""Per-model latency/throughput bench - `python -m istvt_tpu_torch.cli.bench`
(counterpart of istvt_tpu/cli/bench.py, same flags and JSON keys).

Generalization of the reference timing harness (reference test_time.py:1-9:
10k bs=1 DualNet forwards, wall-clock average) with honest measurement
(distinct inputs, a host fetch). Modes, each printing one JSON line:

  * forward (default): a warm-up call, then --iters calls, each on its own
    input x + 0.01 i and ending in a host read of the output's sum; the
    median;
  * --chained: the --iters forwards enqueued back to back on perturbed
    inputs, summed into one device scalar read once at the end (device
    throughput; JAX runs them as one device program, the port as eager
    launches, with no CUDA graph);
  * --train_step: the port's optimizer and train step (--grad_accum,
    --remat), two untimed steps, then --iters steps and one loss read: the
    mean;
  * --quantize int8: the int8 W8A8 serving forward (istvt / resnet_3d,
    forward modes, on the card only);
  * --pipeline: disk JPEGs -> ClipLoader -> device_feed -> the int8
    forward (on the CPU the float one), with the host decode, the
    host->device copy, the device and the end to end each measured alone,
    and their overlap.

On the card (the default; `--device cpu` runs the plain versions, as the
JAX CLI on a CPU) the model runs its kernels (use_pallas) with bf16
parameters, as JAX's on a TPU; the forward casts its input to the
parameters' dtype (--dtype is the input's). The weights are random, from
seed 0.

    python -m istvt_tpu_torch.cli.bench --quantize int8 -bs 16 --chained
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import tempfile
import time


def build_parser():
    p = argparse.ArgumentParser("istvt_tpu_torch.bench")
    p.add_argument("--model_name", "-mn", default="istvt")
    p.add_argument("--batch_size", "-bs", type=int, default=1)
    p.add_argument("--input_size", "-is", type=int, default=300)
    p.add_argument("--seq_len", "-sl", type=int, default=6)
    p.add_argument("--depth", type=int, default=12,
                   help="ST-layer count for the istvt-family configs"
                        " (paper model: 12; 1-2 for quick drives)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="istvt forward only: measure the int8 W8A8 serving"
                        " path (kernels/quant.py) instead of float. On the"
                        " card only.")
    p.add_argument("--chained", action="store_true",
                   help="forward only: enqueue all iters back to back over"
                        " perturbed inputs and read one scalar at the end,"
                        " so the per-call host fetch is paid once (device"
                        " throughput). Default per-call timing reports what"
                        " a caller sees (reference test_time.py semantics).")
    p.add_argument("--train_step", action="store_true",
                   help="bench the full train step instead of forward")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="gradient-accumulation microbatches (train_step)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize ST layers + stem (train_step)")
    p.add_argument("--pipeline", action="store_true",
                   help="end-to-end input pipeline: disk JPEG -> ClipLoader"
                        " -> device_feed -> int8 forward (aggregate clips/s"
                        " + host/device overlap)")
    p.add_argument("--data_root", default=None,
                   help="--pipeline: FF++-style frame tree root (a synthetic"
                        " one is generated under the temporary directory"
                        " when omitted)")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--no_native", action="store_true",
                   help="--pipeline: force the PIL decode path. The default"
                        " uint8 ingest decodes via PIL anyway (the native"
                        " decoder only has a normalized-f32 output), so"
                        " this flag matters only with --f32_ingest.")
    p.add_argument("--f32_ingest", action="store_true",
                   help="--pipeline: ship normalized f32 clips instead of"
                        " the default uint8-with-device-normalize ingest"
                        " (4x the host->device bytes)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu: the kernels' plain versions, no int8 path")
    return p


# registry keys taking (B, T, H, W, 3) clips instead of (B, H, W, 3) images
CLIP_MODELS = ("istvt", "resnet_3d", "vivit", "vanilla_tr", "i3d",
               "resnet3d")


def _ensure_frame_tree(root, size, videos=32, frames=12, quality=90):
    """Synthetic FF++-style JPEG tree (hq/{original,Deepfakes}/vid/frame.jpg)
    so the pipeline bench has real disk decode work without real data."""
    import numpy as np
    from PIL import Image
    flag = os.path.join(root, ".complete")
    if os.path.exists(flag):
        return root
    rng = np.random.RandomState(0)
    for m in ("original", "Deepfakes"):
        for v in range(videos // 2):
            d = os.path.join(root, "hq", m, f"{v:03d}")
            os.makedirs(d, exist_ok=True)
            for f in range(frames):
                img = rng.randint(0, 255, (size, size, 3), dtype=np.uint8)
                Image.fromarray(img).save(os.path.join(d, f"{f:04d}.jpg"),
                                          quality=quality)
    open(flag, "w").close()
    return root


def _device(args):
    import torch
    from istvt_tpu_torch.core.device import require_cuda
    return require_cuda() if args.device == "cuda" else torch.device("cpu")


def build_model(name, args, dev, quant: bool, depth: int):
    """The registry's model `name` for args on dev, eval mode, seed 0: on
    the card the kernels (use_pallas) and bf16 parameters, with quant the
    int8 weights (quantize_params), else the float path's packed copies."""
    import torch
    from istvt_tpu_torch.core import tree
    from istvt_tpu_torch.core.config import ISTVTConfig
    from istvt_tpu_torch.models import istvt
    from istvt_tpu_torch.models.registry import model_selection

    card = dev.type == "cuda"
    cfg = ISTVTConfig(num_frames=args.seq_len, image_size=args.input_size,
                      feat_hw=istvt.infer_feat_hw(args.input_size),
                      depth=depth, use_pallas=card,
                      quantize="int8" if quant else "none",
                      remat=args.remat)
    model = model_selection(name, num_out_classes=1, cfg=cfg, device=dev)
    if card:
        tree.cast(model, torch.bfloat16)
    if quant:
        istvt.quantize_params(model)
    elif card:
        istvt.pack_params(model)
    return model


def forward_fn(model):
    """clips -> logits of the eval forward, the input cast to the
    parameters' dtype, no autograd graph."""
    import torch
    dtype = next(model.parameters()).dtype

    def fwd(clips):
        with torch.no_grad():
            return model(clips.to(dtype))
    return fwd


def chained(fwd, x, n: int):
    """The f32 device scalar sum over i < n of sum(fwd(x + 0.01 (i + 1))),
    every forward enqueued before any is read."""
    import torch
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        acc = acc + fwd(x + 0.01 * (i + 1)).float().sum()
    return acc


def run_pipeline(args, dev):
    """Disk -> ClipLoader(threaded decode) -> device_feed -> int8 forward.

    The reference's analog seam is DataLoader(bs=16, workers=8) feeding
    the CUDA forward (reference train_CNN.py:176-177). Reports the
    end-to-end aggregate clips/s plus each side measured alone, so the
    bottleneck (host decode vs device compute) is explicit. Forwards are
    asynchronous (one read at the end): decode of batch N+1 overlaps the
    device's work on batch N exactly as in serving. The model has the
    paper's depth, as JAX's pipeline builds it."""
    import numpy as np
    import torch

    from istvt_tpu_torch.core.config import ISTVTConfig
    from istvt_tpu_torch.data import (ClipLoader, Transform, VideoSeqDataset,
                                      device_feed, device_normalize)

    card = dev.type == "cuda"
    size, T, B = args.input_size, args.seq_len, args.batch_size
    root = args.data_root or _ensure_frame_tree(
        os.path.join(tempfile.gettempdir(), f"istvt_bench_tree_{size}"),
        size)

    uint8 = not args.f32_ingest
    n_batches = max(args.iters, 4)
    ds = VideoSeqDataset(root=root, quality="hq", size=size, mode="Test",
                         transform=Transform(size, raw_uint8=uint8),
                         seq_len=T, use_native=not args.no_native,
                         dataset_len=n_batches * B)
    native_used = ds._native_fast_path(
        ds._pick_clip(ds.entries[0], ds._rng(0)), {}) is not None

    def make_loader():
        return ClipLoader(ds, batch_size=B, shuffle=True, drop_last=True,
                          num_workers=args.num_workers, prefetch=2)

    # ---- host side alone: decode+collate rate (steady-state: skip batch
    # 0); batches are kept for the h2d leg below so the dataset is not
    # decoded a third time
    n = 0
    host_batches = []
    with contextlib.closing(iter(make_loader())) as it:
        next(it)
        t0 = time.perf_counter()
        for b in it:
            n += b["labels"].shape[0]
            host_batches.append(b)
        host_cps = n / (time.perf_counter() - t0)

    # ---- device side alone + end-to-end
    model = build_model("istvt", args, dev, quant=card,
                        depth=ISTVTConfig().depth)
    cd = next(model.parameters()).dtype      # bf16 on the card, as JAX's

    def fwd(clips):
        with torch.no_grad():
            x = device_normalize(clips, dtype=cd) \
                if clips.dtype == torch.uint8 else clips.to(cd)
            return model(x).float().sum()

    warm = torch.zeros((B, T, size, size, 3),
                       dtype=torch.uint8 if uint8 else torch.float32,
                       device=dev)
    float(fwd(warm))

    with contextlib.closing(device_feed(make_loader(), dev)) as feed:
        first = next(feed)               # spin up the producer
        float(fwd(first["clips"]))
        outs, n = [], 0
        t0 = time.perf_counter()
        for b in feed:
            outs.append(fwd(b["clips"]))             # enqueued
            n += int(b["labels"].shape[0])
        for o in outs:
            float(o)                                 # wait for everything
        e2e_cps = n / (time.perf_counter() - t0)

    # transfer alone: copies of PRE-DECODED host batches, each perturbed
    # per batch so that no payload equals one the e2e loop already sent
    def _perturb(c, j):
        if c.dtype == np.uint8:
            return c + np.uint8(1 + j % 251)   # wraps; bytes differ
        return c + np.float32(1e-3 * (j + 1))
    puts = [torch.from_numpy(_perturb(b["clips"], j))
            for j, b in enumerate(host_batches)]
    t0 = time.perf_counter()
    put = [c.to(dev) for c in puts]
    if card:
        torch.cuda.synchronize(dev)
    h2d_cps = sum(b["labels"].shape[0] for b in host_batches) \
        / (time.perf_counter() - t0)
    del put, puts, host_batches

    # device alone: same batch count, resident input, a call per batch like
    # the e2e loop, each on its own input (uint8 perturbs in uint8, the
    # modulus above any realistic iters; i + 1 so that call 0 differs from
    # the warm-up on the same batch)
    x = first["clips"]
    salt = (lambda i: x + (1 + i % 251)) if x.dtype == torch.uint8 \
        else (lambda i: x + 0.01 * (i + 1))
    outs = []
    t0 = time.perf_counter()
    for i in range(n_batches - 1):
        outs.append(fwd(salt(i)))
    for o in outs:
        float(o)
    dev_cps = (n_batches - 1) * B / (time.perf_counter() - t0)

    out = {
        "mode": "pipeline",
        "model": "istvt",
        "batch": B,
        "batches": n_batches - 1,
        "platform": "gpu" if card else "cpu",
        "native_decode": bool(native_used),
        "ingest": "uint8+device_norm" if uint8 else "f32",
        "h2d_mb_per_batch": round(
            B * T * size * size * 3 * (1 if uint8 else 4) / 1e6, 1),
        "num_workers": args.num_workers,
        "host_decode_clips_per_sec": round(host_cps, 2),
        "h2d_transfer_clips_per_sec": round(h2d_cps, 2),
        "device_clips_per_sec": round(dev_cps, 2),
        "e2e_clips_per_sec": round(e2e_cps, 2),
        # 1.0 = perfect overlap (e2e time == slowest stage alone);
        # 0.0 = fully serial (e2e time == sum of all three stages).
        # h2d_cps already includes decode overlapped upstream, so the
        # serial model is decode + transfer-given-decode + device.
        "overlap_fraction": round(max(0.0, min(1.0, (
            (1 / host_cps + 1 / h2d_cps + 1 / dev_cps) - 1 / e2e_cps
        ) / (
            (1 / host_cps + 1 / h2d_cps + 1 / dev_cps)
            - max(1 / host_cps, 1 / h2d_cps, 1 / dev_cps)
        ))), 3),
    }
    print(json.dumps(out))
    return out


def run_train_step(args, model, x, dev):
    """Two untimed steps, then --iters steps on x + 0.01 i with zero labels,
    timed to one loss read at the end: the mean."""
    import torch
    from istvt_tpu_torch.core.config import TrainConfig
    from istvt_tpu_torch.train import step as S
    from istvt_tpu_torch.train.schedule import cosine_schedule

    opt = S.make_optimizer(TrainConfig(), cosine_schedule(1e-4, 1000))
    ts = S.create_train_state(model, opt)
    step_fn = S.make_train_step(
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else None,
        grad_accum=args.grad_accum)
    # f32 clips as JAX's; without a compute dtype they enter in the
    # parameters' dtype
    xf = x.float() if args.dtype == "bfloat16" else \
        x.to(next(model.parameters()).dtype)
    labels = torch.zeros((args.batch_size,), dtype=torch.int32, device=dev)

    def dispatch(i):
        return step_fn(ts, {"clips": xf + 0.01 * i, "labels": labels})

    float(dispatch(0)["loss"])
    float(dispatch(1)["loss"])       # warm-up, steady state
    t0 = time.perf_counter()
    for i in range(args.iters):
        m = dispatch(i + 2)
    float(m["loss"])                 # waits for every step's kernels
    return (time.perf_counter() - t0) / args.iters


def main(argv=None):
    """Run the CLI; prints and returns its JSON record."""
    args = build_parser().parse_args(argv)
    if args.pipeline:
        return run_pipeline(args, _device(args))
    quant = args.quantize == "int8"
    if quant and (args.model_name not in ("istvt", "resnet_3d")
                  or args.train_step or args.device != "cuda"):
        raise SystemExit("--quantize int8 measures the istvt serving "
                         "forward and requires the card (the int8 kernels "
                         "never engage elsewhere)")
    dev = _device(args)

    import torch

    platform = "gpu" if dev.type == "cuda" else "cpu"
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    is_clip = any(args.model_name.startswith(k) for k in CLIP_MODELS)
    model = build_model(args.model_name, args, dev, quant, args.depth)

    shape = (args.batch_size, args.seq_len, args.input_size,
             args.input_size, 3) if is_clip else \
        (args.batch_size, args.input_size, args.input_size, 3)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)) \
        .to(dtype).to(dev)

    if args.train_step:
        mean = run_train_step(args, model, x, dev)
        out = {
            "model": args.model_name,
            "mode": "train_step",
            "batch": args.batch_size,
            "grad_accum": args.grad_accum,
            "remat": args.remat,
            # MEAN over chained steps (a median needs a read per step)
            "mean_ms": round(mean * 1000, 2),
            "items_per_sec": round(args.batch_size / mean, 2),
            "platform": platform,
        }
    elif args.chained:
        fwd = forward_fn(model)
        x = x + (time.time() % 997) / 1e4
        float(chained(fwd, x, 1))          # warm-up
        t0 = time.perf_counter()
        float(chained(fwd, x, args.iters))
        mean = (time.perf_counter() - t0) / args.iters
        out = {
            "model": args.model_name,
            "mode": "forward_chained",
            "batch": args.batch_size,
            "input_size": args.input_size,
            "quantize": args.quantize,
            "mean_ms": round(mean * 1000, 2),
            "items_per_sec": round(args.batch_size / mean, 2),
            "platform": platform,
        }
    else:
        fwd = forward_fn(model)

        def run(i):
            return float(fwd(x + 0.01 * i).sum())

        run(0)  # warm-up
        times = []
        for i in range(args.iters):
            t0 = time.perf_counter()
            run(i + 1)
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        out = {
            "model": args.model_name,
            "mode": "forward",
            "batch": args.batch_size,
            "median_ms": round(med * 1000, 2),
            "items_per_sec": round(args.batch_size / med, 2),
            "platform": platform,
        }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
