"""Batch scoring CLI - `python -m istvt_tpu_torch.cli.score` (counterpart
of istvt_tpu/cli/score.py, same flag spellings).

Scores a face-crop frame tree (docs/DATA.md layout) with the port's ISTVT
on the GPU: one JSON line per clip (index, logit, prob, pred, label) in
--out, then a summary line with accuracy and AUC, and APCER / BPCER / ACER
with --acer. The model is the serving one (cli/serve.build_predictor):
with --int8 the W8A8 path (bf16 parameters, quantize_params, bf16 inputs),
else the float fused path in bf16 (--bf16) or f32, its kernels on the
card; random weights from seed 0, or the latest train checkpoint under
--checkpoint_dir / -o (cli/train.py -o). Clips come from a ClipLoader (8
threads) through data/loader.device_feed (pinned copies on a side stream,
one batch ahead). The model has the paper's depth, 12, as JAX's CLI
builds it; `--device cpu` runs the kernels' plain versions.

    python -m istvt_tpu_torch.cli.score --int8 --data_root /data/ffpp
"""
from __future__ import annotations

import argparse
import contextlib
import json


def build_parser():
    p = argparse.ArgumentParser("istvt_tpu_torch.score")
    p.add_argument("--model_name", "-mn", default="istvt")
    p.add_argument("--data_root", required=False, default="")
    p.add_argument("--dataset", "-d", default="ff++",
                   choices=["ff++", "celeb", "synthetic"])
    p.add_argument("--quality", "-q", default="hq")
    p.add_argument("--seq_len", "-sl", type=int, default=6)
    p.add_argument("--input_size", "-is", type=int, default=300)
    p.add_argument("--batch_size", "-bs", type=int, default=16)
    p.add_argument("--checkpoint_dir", "-o", default=None,
                   help="train checkpoint dir (latest step restored)")
    p.add_argument("--out", default="scores.jsonl")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 serving path for the ST-layer GEMMs "
                        "(models/istvt.quantize_params)")
    p.add_argument("--acer", action="store_true")
    p.add_argument("--max_clips", type=int, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu: the kernels' plain versions (tests only)")
    return p


def make_dataset(args):
    """The JAX CLI's dataset for the args: Test-mode clips through a plain
    Transform at --input_size."""
    from istvt_tpu_torch.data import (Celeb, SyntheticVideoDataset,
                                      Transform, VideoSeqDataset)
    if args.dataset == "synthetic":
        return SyntheticVideoDataset(args.max_clips or 32, args.seq_len,
                                     args.input_size)
    if args.dataset == "celeb":
        return Celeb(root=args.data_root, mode="Test", size=args.input_size,
                     seq_len=args.seq_len,
                     transform=Transform(args.input_size),
                     dataset_len=args.max_clips)
    return VideoSeqDataset(root=args.data_root, quality=args.quality,
                           transform=Transform(args.input_size),
                           size=args.input_size, mode="Test",
                           seq_len=args.seq_len, return_fake_type=True,
                           dataset_len=args.max_clips)


def build(args):
    """(predictor, loader) for parsed args: cli/serve.build_predictor's
    model with one bucket of --batch_size, and the unshuffled loader."""
    import torch

    from istvt_tpu_torch.cli import serve as cli_serve
    from istvt_tpu_torch.core.device import require_cuda
    from istvt_tpu_torch.data import ClipLoader

    dev = require_cuda() if args.device == "cuda" else torch.device("cpu")
    serve_args = argparse.Namespace(
        model_name=args.model_name, seq_len=args.seq_len,
        input_size=args.input_size, depth=12,
        checkpoint_dir=args.checkpoint_dir, artifact=None, bf16=args.bf16,
        int8=args.int8, buckets=[args.batch_size],
        max_batch=args.batch_size)
    predictor = cli_serve.build_predictor(serve_args, dev)
    loader = ClipLoader(make_dataset(args), batch_size=args.batch_size,
                        shuffle=False)
    return predictor, loader


def score(predictor, loader, out_path: str, acer: bool = False) -> dict:
    """Every clip of the loader through the predictor, fed by device_feed:
    one JSON line per clip in out_path; returns the summary."""
    import numpy as np
    import torch

    from istvt_tpu_torch.data import device_feed
    from istvt_tpu_torch.train import metrics as M

    all_logits, all_labels = [], []
    with open(out_path, "w") as f, contextlib.closing(
            device_feed(loader, predictor.device)) as feed:
        idx = 0
        for batch in feed:
            out = predictor.predict(batch["clips"])
            labels = batch["labels"].cpu().numpy()
            for j in range(len(out["logits"])):
                f.write(json.dumps({
                    "index": idx,
                    "logit": float(out["logits"][j]),
                    "prob": float(out["probs"][j]),
                    "pred": int(out["preds"][j]),
                    "label": int(labels[j]),
                }) + "\n")
                idx += 1
            all_logits.append(out["logits"])
            all_labels.append(labels)
    logits = torch.from_numpy(np.concatenate(all_logits))
    labels = torch.from_numpy(np.concatenate(all_labels))
    summary = {
        "n": int(labels.numel()),
        "accuracy": float(((logits > 0) == (labels == 1)).float().mean()),
        "auc": float(M.auc(logits, labels)),
    }
    if acer:
        c = M.confusion_counts(logits, labels)
        summary.update({k: float(v) for k, v in M.acer(c).items()})
    return summary


def main(argv=None) -> dict:
    """Run the CLI; prints and returns the summary."""
    args = build_parser().parse_args(argv)
    if args.model_name != "istvt":
        raise SystemExit(f"--model_name {args.model_name} is not ported yet "
                         f"(ROADMAP.md queue 1, 'Rest of the model zoo')")
    predictor, loader = build(args)
    summary = score(predictor, loader, args.out, acer=args.acer)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
