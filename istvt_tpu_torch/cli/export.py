"""Serving artifact export CLI - `python -m istvt_tpu_torch.cli.export`
(counterpart of istvt_tpu/cli/export.py, the same flags and defaults, and
--device).

Freezes the port's model (optionally checkpoint-restored, int8-quantized
or cast to bf16) into a self-contained serving artifact directory
(serve_export.save_artifact): one torch.export program over the batch
buckets, its kernels as istvt:: ops, and its weights, beside a manifest.
Consumers score with `serve_export.load_artifact(dir)` (or `cli.serve
--artifact dir`) without importing the model zoo. The artifact runs on
the device type it was exported on: the card by default, the CPU with
`--device cpu` (the kernels' plain versions; the tests use it).
"""
from __future__ import annotations

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser("istvt_tpu_torch.export")
    p.add_argument("--model_name", "-mn", default="istvt")
    p.add_argument("--seq_len", "-sl", type=int, default=6)
    p.add_argument("--input_size", "-is", type=int, default=300)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--checkpoint_dir", "-o", default=None,
                   help="train checkpoint dir (latest step restored)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 serving path for the ST-layer GEMMs; the "
                        "artifact stores int8 weights + f32 scales")
    p.add_argument("--batch_sizes", type=int, nargs="+", default=[1, 16])
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--selftest", action="store_true",
                   help="reload the artifact and compare logits against "
                        "the live model on random inputs")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the device the artifact is exported on and runs "
                        "on (cpu: the kernels' plain versions)")
    return p


def export(args) -> dict:
    """The CLI's work on parsed arguments: {'predictor': the live
    Predictor, 'manifest', 'export_s' (build excluded), 'bytes' (the
    directory's), and with --selftest 'scorer' (the reloaded artifact),
    'load_s', 'delta' (max |logit delta| over min(largest bucket, 4)
    clips, inf where the artifact gave a non-finite logit)}."""
    import time

    import numpy as np
    import torch

    from istvt_tpu_torch.cli.serve import build_predictor
    from istvt_tpu_torch.core.device import require_cuda
    from istvt_tpu_torch.serve_export import load_artifact, save_artifact

    # reuse the serve CLI's model / restore / quantize wiring verbatim;
    # the Predictor has already cast the parameters to its compute_dtype
    args.buckets = sorted(set(args.batch_sizes))
    args.max_batch = max(args.buckets)
    device = (require_cuda() if args.device == "cuda"
              else torch.device("cpu"))
    predictor = build_predictor(args, device)
    clip_shape = (args.seq_len, args.input_size, args.input_size, 3)
    t0 = time.perf_counter()
    manifest = save_artifact(
        args.out, predictor.model, input_shape=clip_shape,
        batch_sizes=predictor.batch_sizes,
        input_dtype=predictor.compute_dtype or predictor.input_dtype,
        device=device,
        extra_meta={"int8": bool(args.int8), "bf16": bool(args.bf16),
                    "checkpoint_dir": args.checkpoint_dir})
    out = {"predictor": predictor, "manifest": manifest,
           "export_s": time.perf_counter() - t0,
           "bytes": sum(os.path.getsize(os.path.join(args.out, f))
                        for f in os.listdir(args.out))}
    if args.selftest:
        t0 = time.perf_counter()
        scorer = load_artifact(args.out, device)
        out.update(scorer=scorer, load_s=time.perf_counter() - t0)
        rng = np.random.default_rng(0)
        n = min(predictor.batch_sizes[-1], 4)
        clips = rng.standard_normal((n,) + clip_shape).astype(np.float32)
        got = scorer.predict(clips)["logits"]
        want = predictor.predict(clips)["logits"]
        out.update(n_clips=n, delta=float(np.max(np.abs(got - want)))
                   if np.all(np.isfinite(got)) else float("inf"))
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = export(args)
    print(json.dumps({k: out["manifest"][k] for k in
                      ("model_name", "batch_sizes", "input_shape",
                       "platforms", "custom_ops")}))
    print(f"exported {args.out} in {out['export_s']:.1f} s "
          f"({out['bytes']} bytes)")
    if args.selftest:
        delta = out["delta"]
        print(f"selftest: reloaded in {out['load_s']:.1f} s, max |logit "
              f"delta| = {delta:.3e} over {out['n_clips']} clips")
        if not delta <= 1e-3:
            raise SystemExit(f"selftest FAILED (delta {delta})")


if __name__ == "__main__":
    main()
