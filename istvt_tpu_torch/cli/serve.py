"""Serving daemon CLI — `python -m istvt_tpu_torch.cli.serve --bf16`
(counterpart of istvt_tpu/cli/serve.py, same flag spellings).

Stands up the HTTP batch-scoring daemon (serve_daemon.ServeDaemon) on the
port's ISTVT on the GPU: the int8 W8A8 serving path with --int8, else the
float fused path (bf16 with --bf16, f32 otherwise), with the weights of
the latest train checkpoint under --checkpoint_dir (cli/train.py -o), or
random-init weights without it; or, with --artifact DIR, a serving
artifact of cli/export.py (serve_export.load_artifact: no model code, the
buckets and clip shape from its manifest, on the device type it was
exported on).
"""
from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("istvt_tpu_torch.serve")
    p.add_argument("--model_name", "-mn", default="istvt")
    p.add_argument("--seq_len", "-sl", type=int, default=6)
    p.add_argument("--input_size", "-is", type=int, default=300)
    p.add_argument("--checkpoint_dir", "-o", default=None,
                   help="serve the latest train checkpoint under this dir")
    p.add_argument("--artifact", default=None,
                   help="serve a cli/export artifact directory instead of "
                        "building a model (model/checkpoint/quantize flags "
                        "are ignored; buckets and clip shape come from the "
                        "manifest)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8753)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 serving path for the ST-layer GEMMs")
    p.add_argument("--max_batch", type=int, default=16,
                   help="coalesced device batch (also the largest bucket)")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="linger for batch coalescing")
    p.add_argument("--buckets", type=int, nargs="+", default=None,
                   help="bucket sizes (default: 1, max_batch/2, max_batch)")
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the warmup pass over the buckets")
    p.add_argument("--verbose", action="store_true")
    return p


def build_predictor(args, device=None):
    """Model + Predictor on `device` (the GPU when None; there is no CPU
    fallback), its weights restored from --checkpoint_dir's latest step
    when there is one (before any cast): with --int8, bf16 parameters +
    quantize_params and bf16 inputs; else the float fused model in bf16
    (--bf16) or f32, its weights packed (pack_params) after the cast."""
    import torch

    from istvt_tpu_torch.core import tree
    from istvt_tpu_torch.core.config import ISTVTConfig
    from istvt_tpu_torch.core.device import require_cuda
    from istvt_tpu_torch.models import istvt
    from istvt_tpu_torch.models.registry import model_selection
    from istvt_tpu_torch.serve import Predictor

    if getattr(args, "artifact", None):
        raise ValueError("--artifact: an artifact is served as it was "
                         "exported (serve_export.load_artifact), not built "
                         "into a model")
    device = require_cuda() if device is None else torch.device(device)
    cfg = ISTVTConfig(num_frames=args.seq_len, image_size=args.input_size,
                      feat_hw=istvt.infer_feat_hw(args.input_size),
                      depth=args.depth, use_pallas=True,
                      quantize="int8" if args.int8 else "none")
    model = model_selection(args.model_name, num_out_classes=1, cfg=cfg,
                            device=device)
    if args.checkpoint_dir:
        from istvt_tpu_torch.core.checkpoint import CheckpointManager
        mgr = CheckpointManager(args.checkpoint_dir)
        restored = mgr.restore(map_location=device)
        if restored is not None:
            model.load_state_dict(restored["model"])
            print(f"restored step {mgr.latest_step()}")
    buckets = args.buckets or sorted({1, max(args.max_batch // 2, 1),
                                      args.max_batch})
    if args.int8:
        tree.cast(model, torch.bfloat16)
        istvt.quantize_params(model)
        return Predictor(model, device, batch_sizes=buckets,
                         input_dtype=torch.bfloat16)
    dtype = torch.bfloat16 if args.bf16 else None
    if dtype is not None:
        tree.cast(model, dtype)
    istvt.pack_params(model)
    return Predictor(model, device, batch_sizes=buckets, compute_dtype=dtype)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from istvt_tpu_torch.serve_daemon import ServeDaemon

    if args.artifact:
        from istvt_tpu_torch.serve_export import load_artifact
        predictor = load_artifact(args.artifact)
        clip_shape = tuple(predictor.manifest["input_shape"])
        args.model_name = predictor.manifest.get("model_name",
                                                 args.model_name)
    else:
        predictor = build_predictor(args)
        clip_shape = (args.seq_len, args.input_size, args.input_size, 3)
    if not args.no_warmup:
        for b in predictor.batch_sizes:
            predictor.predict(np.zeros((b,) + clip_shape, np.float32))
            print(f"warm bucket {b}")
    daemon = ServeDaemon(predictor, clip_shape, host=args.host,
                         port=args.port, max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms, verbose=args.verbose)
    print(f"serving {args.model_name} on http://{args.host}:{daemon.port} "
          f"(buckets {predictor.batch_sizes})", flush=True)
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        daemon.close()


if __name__ == "__main__":
    main()
