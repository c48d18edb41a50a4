"""Train CLI - `python -m istvt_tpu_torch.cli.train` (counterpart of
istvt_tpu/cli/train.py, same flag spellings).

Trains ISTVT on the GPU, f32 or bf16 over f32 masters (`--bf16`), on a
face-crop frame tree (docs/DATA.md): the reference's default recipe (the
XLA-math forward with dropout 0.5, checkpoints under ./output) is

    python -m istvt_tpu_torch.cli.train --data_root /data/ffpp

and `--use_pallas` runs the float fused path (its kernels; with dropout >
0 the feed-forward is plain torch, as in JAX). The datasets (`make_datasets`,
as JAX's): ff++ (--quality hq|lq, --transform preset, --use_native_decode:
the C++ frame decoder), celeb, dfdc (a Celeb-style tree), oulu, ff++video
(raw videos decoded and face-cropped on the fly, --boxes: external crop
boxes) and synthetic. The loader makes batches on --num_workers threads,
two ahead, and the Trainer feeds them to the card through pinned copies
(data/loader.py). Also implemented: --use_pallas, --bf16, --dropout,
--remat, --optimizer, --lr, --epochs, --batch_size, --dataset_len,
--grad_accum, --depth, --seed, --reference_schedule, the geometry
(--seq_len, --input_size), and the checkpoints: --checkpoint_dir / -o
(default ./output; "" saves nothing), --continue_train (resume the
latest), --test_mode (restore the latest and evaluate: hq and lq for ff++
with a --data_root, ACER for oulu), --recal_bn N (recalibrate BatchNorm
over N train batches after the last epoch). --model_path is parsed and
never read, as in the JAX CLI. Distillation (train/distill.py):
--distill_from DIR restores a teacher from the newest checkpoint under
DIR (its model state only, so any --teacher_optimizer restores) at
--teacher_depth and --teacher_input_size, and the student trains on
losses.distillation_bce (--distill_alpha, --distill_T) against its
logits; with a --teacher_input_size other than -is the train clips load
at the teacher's size and the student gets them resized, the val clips
at the student's. The parallelism and --dump_attns_every flags exit
naming their ROADMAP.md items. The card is the default; `--device cpu`
runs the plain versions of the kernels (the tests use it).
"""
from __future__ import annotations

import argparse
import copy

_Q1 = "ROADMAP.md queue 1"

# flags of the JAX CLI not ported yet: any value but the default exits
# with the named item
_NOT_PORTED = {
    "mesh_model": "'Parallelism'",
    "mesh_pipe": "'Parallelism'",
    "microbatches": "'Parallelism'",
    "dump_attns_every": "'Interpretation'",
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
    p.add_argument("--transform", "-tf", default="300",
                   help="preset: 299|256|300|aug|shuffle "
                        "(train_CNN.py:154-161)")
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--num_workers", type=int, default=8,
                   help="loader threads making each batch's clips")
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
    p.add_argument("--use_native_decode", action="store_true",
                   help="the C++ frame decoder (pixels differ slightly "
                        "from PIL's on downscale: opt-in)")
    p.add_argument("--boxes", default=None, metavar="MANIFEST_JSON",
                   help="ff++video only: external detector crop boxes "
                        "{video: {frame: [y0,x0,h,w]}} (docs/DATA.md)")
    p.add_argument("--dump_attns_every", type=int, default=0)
    p.add_argument("--distill_from", default=None, metavar="CKPT_DIR",
                   help="knowledge distillation (train/distill.py): "
                        "checkpoint dir of a TEACHER (same model_name; its "
                        "depth via --teacher_depth). Teacher logits are "
                        "injected per batch and the loss becomes "
                        "losses.distillation_bce: train a shallower --depth "
                        "student that serves proportionally faster")
    p.add_argument("--teacher_depth", type=int, default=12,
                   help="--distill_from: the teacher's ST-layer count")
    p.add_argument("--teacher_input_size", type=int, default=None,
                   help="--distill_from: the teacher's input size when it "
                        "differs from the student's -is (cross-geometry "
                        "distillation: train clips are loaded at the "
                        "TEACHER size, the teacher scores them, and the "
                        "student sees their bilinear downscale)")
    p.add_argument("--teacher_optimizer", choices=["adamw", "sgd"],
                   default="adamw",
                   help="--distill_from: optimizer the teacher ckpt was "
                        "trained with (its moments are not restored, so "
                        "either value restores)")
    p.add_argument("--distill_alpha", type=float, default=0.5,
                   help="hard-label loss weight (1-alpha on the soft "
                        "teacher term); 0 = learn from the teacher only")
    p.add_argument("--distill_T", type=float, default=2.0,
                   help="distillation temperature")
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


def make_datasets(args):
    """(train, val) datasets for the parsed args, as JAX's make_datasets
    (cli/train.py:112-173). One departure: where the --transform preset's
    frame size gives another feature grid than --input_size (say the
    default preset '300' with -is 72), the preset's transforms resize to
    --input_size instead; JAX feeds such frames as they are, to a model
    that cannot take them."""
    from istvt_tpu_torch.data import (OULU, Celeb, SyntheticVideoDataset,
                                      VideoSeqDataset, select_transform)
    from istvt_tpu_torch.models.istvt import infer_feat_hw
    tf = select_transform(args.transform)
    if infer_feat_hw(tf["train"].size) != infer_feat_hw(args.input_size):
        tf = {k: copy.copy(t) for k, t in tf.items()}
        for t in tf.values():
            t.size = args.input_size
    if args.dataset == "synthetic":
        train = SyntheticVideoDataset(args.dataset_len or 64, args.seq_len,
                                      args.input_size, seed=args.seed)
        val = SyntheticVideoDataset(16, args.seq_len, args.input_size,
                                    seed=args.seed + 1)
        return train, val
    if args.dataset == "oulu":
        train = OULU(root=args.data_root, mode="Train", size=args.input_size,
                     seq_len=args.seq_len, transform=tf["train"],
                     dataset_len=args.dataset_len)
        val = OULU(root=args.data_root, mode="Test", size=args.input_size,
                   seq_len=args.seq_len, transform=tf["val"])
        return train, val
    if args.dataset in ("celeb", "dfdc"):
        train = Celeb(root=args.data_root, mode="Train", size=args.input_size,
                      seq_len=args.seq_len, transform=tf["train"],
                      dataset_len=args.dataset_len)
        val = Celeb(root=args.data_root, mode="Test", size=args.input_size,
                    seq_len=args.seq_len, transform=tf["val"])
        return train, val
    use_native = args.use_native_decode
    if args.dataset == "ff++video":
        # the backend is pinned, not picked: cv2 by default, the native
        # decoder with --use_native_decode (their scalers differ)
        from istvt_tpu_torch.data.video_frontend import RawVideoDataset
        train = RawVideoDataset(root=args.data_root, quality=args.quality,
                                mode="Train", size=args.input_size,
                                seq_len=args.seq_len,
                                dataset_len=args.dataset_len,
                                seed=args.seed, use_native=use_native,
                                boxes=args.boxes)
        val = RawVideoDataset(root=args.data_root, quality=args.quality,
                              mode="Test", size=args.input_size,
                              seq_len=args.seq_len, return_fake_type=True,
                              use_native=use_native, boxes=args.boxes)
        return train, val
    train = VideoSeqDataset(root=args.data_root, quality=args.quality,
                            transform=tf["train"], size=args.input_size,
                            mode="Train", seq_len=args.seq_len,
                            dataset_len=args.dataset_len, seed=args.seed,
                            use_native=use_native)
    val = VideoSeqDataset(root=args.data_root, quality=args.quality,
                          transform=tf["val"], size=args.input_size,
                          mode="Test", seq_len=args.seq_len,
                          return_fake_type=True, use_native=use_native)
    return train, val


def build(args):
    """(trainer, train_loader, val_loader) for parsed, checked args: the
    code path `main` runs, also driven by chip_smoke.py's train phase."""
    import torch

    from istvt_tpu_torch.core.config import (DataConfig, ISTVTConfig,
                                             TrainConfig)
    from istvt_tpu_torch.core.device import require_cuda
    from istvt_tpu_torch.data import ClipLoader
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
    cross_geo = bool(args.distill_from and args.teacher_input_size
                     and args.teacher_input_size != args.input_size)
    if cross_geo:
        # train clips load at the teacher's size (the batch hook resizes
        # them for the student after the teacher scores them); val clips
        # at the student's: eval runs the student alone
        targs = copy.copy(args)
        targs.input_size = args.teacher_input_size
        train_ds, _ = make_datasets(targs)
        _, val_ds = make_datasets(args)
    else:
        train_ds, val_ds = make_datasets(args)
    if getattr(train_ds, "entries", True) in ([], None):
        raise SystemExit(f"--dataset {args.dataset}: no videos of "
                         f"{args.seq_len} frames under --data_root "
                         f"'{args.data_root}' (the docs/DATA.md layout)")
    train_loader = ClipLoader(train_ds, batch_size=args.batch_size,
                              shuffle=True, num_workers=args.num_workers,
                              seed=args.seed)
    val_loader = ClipLoader(val_ds, batch_size=args.batch_size,
                            shuffle=False, num_workers=args.num_workers)
    loss_fn, batch_hook = (distill_setup(args, cfg, dev, cross_geo)
                           if args.distill_from else (None, None))
    trainer = Trainer(model, tc, dc,
                      steps_per_epoch=max(len(train_loader), 1),
                      use_reference_schedule=args.reference_schedule,
                      grad_accum=args.grad_accum,
                      recal_bn_batches=args.recal_bn, loss_fn=loss_fn,
                      batch_hook=batch_hook)
    return trainer, train_loader, val_loader


def load_teacher(args, cfg, dev):
    """The --distill_from teacher: the student's cfg at --teacher_depth
    and --teacher_input_size, dropout 0, its model state restored from the
    newest checkpoint under --distill_from (its optimizer moments are not
    read), in eval mode on dev."""
    import dataclasses
    import os

    from istvt_tpu_torch.core.checkpoint import CheckpointManager
    from istvt_tpu_torch.models.istvt import infer_feat_hw
    from istvt_tpu_torch.models.registry import model_selection

    tsize = args.teacher_input_size or args.input_size
    tcfg = dataclasses.replace(cfg, depth=args.teacher_depth, dropout=0.0,
                               image_size=tsize, feat_hw=infer_feat_hw(tsize))
    restored = None
    if os.path.isdir(args.distill_from):
        restored = CheckpointManager(args.distill_from).restore(
            map_location="cpu")
    if restored is None:
        raise SystemExit(f"--distill_from: no checkpoint under "
                         f"{args.distill_from}")
    teacher = model_selection(args.model_name, num_out_classes=1,
                              dropout=0.0, device=dev, cfg=tcfg)
    teacher.load_state_dict(restored["model"])
    return teacher.eval()


def distill_setup(args, cfg, dev, cross_geo: bool):
    """(loss_fn, batch_hook) of --distill_from (JAX cli/train.py:222-255):
    the teacher's logits injected into every train batch, the loss
    losses.make_distill_loss(--distill_alpha, --distill_T)."""
    from istvt_tpu_torch.train import distill as D
    from istvt_tpu_torch.train import losses as L

    teacher = load_teacher(args, cfg, dev)
    hook = D.augment_with_teacher(
        D.make_teacher_fn(teacher),
        student_size=args.input_size if cross_geo else None)
    print(f"distilling from {args.distill_from} (teacher depth "
          f"{args.teacher_depth}, size {teacher.cfg.image_size}, "
          f"alpha={args.distill_alpha}, T={args.distill_T})")
    return L.make_distill_loss(args.distill_alpha, args.distill_T), hook


def test(args, trainer, val_loader):
    """--test_mode: evaluate each quality, hq and lq for ff++ with a
    --data_root (the reference's per-quality loop, train_CNN.py:843-984),
    with ACER for oulu, printing one line per quality."""
    from istvt_tpu_torch.data import ClipLoader, VideoSeqDataset
    from istvt_tpu_torch.train.trainer import evaluate

    qualities = [args.quality]
    if args.dataset == "ff++" and args.data_root:
        qualities = ["hq", "lq"]
    for q in qualities:
        loader = val_loader
        if q != args.quality:
            ds = VideoSeqDataset(
                root=args.data_root, quality=q,
                transform=val_loader.dataset.transform,
                size=args.input_size, mode="Test", seq_len=args.seq_len,
                return_fake_type=True)
            if len(ds.entries) == 0:
                continue
            loader = ClipLoader(ds, batch_size=args.batch_size,
                                shuffle=False, num_workers=args.num_workers)
        ev = evaluate(trainer.model, loader,
                      compute_acer=args.dataset == "oulu")
        print(q, {k: round(v, 4) if isinstance(v, float) else v
                  for k, v in ev.items()})


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    check_args(args, parser)
    trainer, train_loader, val_loader = build(args)
    ts = trainer.init_state()
    if args.continue_train or args.test_mode:
        ts = trainer.restore(ts)
    if args.test_mode:
        test(args, trainer, val_loader)
        return
    trainer.fit(train_loader, val_loader, ts=ts)


if __name__ == "__main__":
    main()
