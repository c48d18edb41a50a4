"""Train CLI — `python -m istvt_tpu_torch.cli.train` (counterpart of
istvt_tpu/cli/train.py, same flag spellings).

Trains ISTVT on the GPU on the synthetic clips, f32 or bf16 over f32
masters (`--bf16`): the reference's default recipe (the XLA-math forward
with dropout 0.5, checkpoints under ./output) is

    python -m istvt_tpu_torch.cli.train --dataset synthetic

and `--use_pallas` runs the float fused path (its kernels; with dropout >
0 the feed-forward is plain torch, as in JAX). Implemented: --dataset
synthetic, --use_pallas, --bf16, --dropout, --remat, --optimizer, --lr,
--epochs, --batch_size, --dataset_len, --grad_accum, --depth, --seed,
--reference_schedule, the geometry (--seq_len, --input_size), and the
checkpoints: --checkpoint_dir / -o (default ./output; "" saves nothing),
--continue_train (resume the latest), --test_mode (restore the latest,
evaluate the val loader, exit), --recal_bn N (recalibrate BatchNorm over N
train batches after the last epoch). --model_path is parsed and never
read, as in the JAX CLI. Every other flag or value exits naming its
ROADMAP.md item. The card is the default; `--device cpu` runs the plain
versions of the kernels (the tests use it).
"""
from __future__ import annotations

import argparse

_Q1 = "ROADMAP.md queue 1"

# flags of the JAX CLI not ported yet: any value but the default exits
# with the named item
_NOT_PORTED = {
    "quality": "'Training' (the real datasets)",
    "data_root": "'Training' (the real datasets)",
    "transform": "'Training' (the real datasets)",
    "num_workers": "'Training' (loader workers)",
    "mesh_model": "'Parallelism'",
    "mesh_pipe": "'Parallelism'",
    "microbatches": "'Parallelism'",
    "use_native_decode": "'Training' (the real datasets)",
    "boxes": "'Training' (the real datasets)",
    "dump_attns_every": "'Interpretation'",
    "distill_from": "'Distillation and certification'",
    "teacher_depth": "'Distillation and certification'",
    "teacher_input_size": "'Distillation and certification'",
    "teacher_optimizer": "'Distillation and certification'",
    "distill_alpha": "'Distillation and certification'",
    "distill_T": "'Distillation and certification'",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("istvt_tpu_torch.train")
    p.add_argument("--model_name", "-mn", default="istvt")
    p.add_argument("--seq_len", "-sl", type=int, default=6)
    p.add_argument("--input_size", "-is", type=int, default=300)
    p.add_argument("--batch_size", "-bs", type=int, default=16)
    p.add_argument("--epochs", "-e", type=int, default=40)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--optimizer", choices=["adamw", "sgd"], default="adamw")
    p.add_argument("--quality", "-q", choices=["hq", "lq"], default="hq")
    p.add_argument("--dataset", "-d", default="ff++",
                   choices=["ff++", "celeb", "oulu", "dfdc", "synthetic",
                            "ff++video"])
    p.add_argument("--data_root", default="")
    p.add_argument("--transform", "-tf", default="300")
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--num_workers", type=int, default=0,
                   help="loader workers (not ported: items are made in "
                        "the calling thread)")
    p.add_argument("--checkpoint_dir", "-o", default="./output",
                   help="checkpoints and metrics.jsonl ('' saves nothing)")
    p.add_argument("--continue_train", action="store_true",
                   help="resume from the latest checkpoint")
    p.add_argument("--model_path", "-mp", default=None,
                   help="parsed and never read, as in the JAX CLI")
    p.add_argument("--test_mode", action="store_true",
                   help="restore the latest checkpoint and evaluate only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--mesh_pipe", type=int, default=1)
    p.add_argument("--microbatches", type=int, default=None)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer "
                        "step (must divide batch_size)")
    p.add_argument("--recal_bn", type=int, default=0, metavar="N",
                   help="after training, recalibrate BatchNorm running "
                        "stats over N train batches")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 forward/backward vs f32 master params")
    p.add_argument("--remat", action="store_true",
                   help="recompute each ST layer in the backward pass")
    p.add_argument("--use_pallas", action="store_true",
                   help="the fused kernels (hand-written CUDA here)")
    p.add_argument("--reference_schedule", action="store_true",
                   help="the reference's manual lr rule "
                        "(train_CNN.py:209-211) instead of cosine")
    p.add_argument("--dataset_len", type=int, default=None)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--use_native_decode", action="store_true")
    p.add_argument("--boxes", default=None)
    p.add_argument("--dump_attns_every", type=int, default=0)
    p.add_argument("--distill_from", default=None)
    p.add_argument("--teacher_depth", type=int, default=12)
    p.add_argument("--teacher_input_size", type=int, default=None)
    p.add_argument("--teacher_optimizer", choices=["adamw", "sgd"],
                   default="adamw")
    p.add_argument("--distill_alpha", type=float, default=0.5)
    p.add_argument("--distill_T", type=float, default=2.0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu: the kernels' plain versions (tests only)")
    return p


def check_args(args, parser=None):
    """SystemExit naming the ROADMAP item of the first flag or value this
    port does not implement."""
    defaults = (parser or build_parser()).parse_args([])
    for name, item in _NOT_PORTED.items():
        if getattr(args, name) != getattr(defaults, name):
            raise SystemExit(f"--{name} is not ported yet ({_Q1}, {item})")
    if args.model_name != "istvt":
        raise SystemExit(f"--model_name {args.model_name} is not ported yet "
                         f"({_Q1}, 'Rest of the model zoo')")
    if args.dataset != "synthetic":
        raise SystemExit(f"--dataset {args.dataset} is not ported yet "
                         f"({_Q1}, 'Training': the real datasets)")


def build(args):
    """(trainer, train_loader, val_loader) for parsed, checked args: the
    code path `main` runs, also driven by chip_smoke.py's train phase."""
    import torch

    from istvt_tpu_torch.core.config import (DataConfig, ISTVTConfig,
                                             TrainConfig)
    from istvt_tpu_torch.core.device import require_cuda
    from istvt_tpu_torch.data import ClipLoader, SyntheticVideoDataset
    from istvt_tpu_torch.models.istvt import infer_feat_hw
    from istvt_tpu_torch.models.registry import model_selection
    from istvt_tpu_torch.train.trainer import Trainer

    dev = require_cuda() if args.device == "cuda" else torch.device("cpu")
    cfg = ISTVTConfig(num_frames=args.seq_len, image_size=args.input_size,
                      feat_hw=infer_feat_hw(args.input_size),
                      depth=args.depth, dropout=args.dropout,
                      use_pallas=args.use_pallas, remat=args.remat)
    model = model_selection(args.model_name, num_out_classes=1,
                            dropout=args.dropout, device=dev, cfg=cfg,
                            seed=args.seed)
    tc = TrainConfig(model_name=args.model_name, num_epochs=args.epochs,
                     base_lr=args.lr, optimizer=args.optimizer,
                     seed=args.seed, checkpoint_dir=args.checkpoint_dir,
                     compute_dtype="bfloat16" if args.bf16 else "float32")
    dc = DataConfig(root=args.data_root, quality=args.quality,
                    seq_len=args.seq_len, input_size=args.input_size,
                    batch_size=args.batch_size, dataset=args.dataset,
                    dataset_len=args.dataset_len)
    train_ds = SyntheticVideoDataset(args.dataset_len or 64, args.seq_len,
                                     args.input_size, seed=args.seed)
    val_ds = SyntheticVideoDataset(16, args.seq_len, args.input_size,
                                   seed=args.seed + 1)
    train_loader = ClipLoader(train_ds, batch_size=args.batch_size,
                              shuffle=True, seed=args.seed)
    val_loader = ClipLoader(val_ds, batch_size=args.batch_size,
                            shuffle=False)
    trainer = Trainer(model, tc, dc,
                      steps_per_epoch=max(len(train_loader), 1),
                      use_reference_schedule=args.reference_schedule,
                      grad_accum=args.grad_accum,
                      recal_bn_batches=args.recal_bn)
    return trainer, train_loader, val_loader


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    check_args(args, parser)
    trainer, train_loader, val_loader = build(args)
    ts = trainer.init_state()
    if args.continue_train or args.test_mode:
        ts = trainer.restore(ts)
    if args.test_mode:
        from istvt_tpu_torch.train.trainer import evaluate
        ev = evaluate(trainer.model, val_loader)
        print(args.quality, {k: round(v, 4) if isinstance(v, float) else v
                             for k, v in ev.items()})
        return
    trainer.fit(train_loader, val_loader, ts=ts)


if __name__ == "__main__":
    main()
