"""Serving-recipe accuracy certification CLI -
`python -m istvt_tpu_torch.cli.certify` (counterpart of
istvt_tpu/cli/certify.py, the same flags and defaults).

Runs train/certify.certify_recipe (full-geometry teacher -> cross-
geometry distilled student -> int8 serving path -> LRP localization, all
scored on a disjoint val split) on the card and prints the result as
JSON, with 'backend' and each leg's wall time and peak device memory
under 'legs'; --out also writes it. Exits 0 only when every criterion
passes. `--cpu` runs everything on the CPU through the kernels' plain
versions (the tests use it). --export DIR also exports the certified
int8 student as a serving artifact (serve_export) and holds the reloaded
artifact's val logits to the certified ones (criterion artifact_matches).
"""
from __future__ import annotations

import argparse
import json


def _amp_range(text: str):
    """--train_amp: 'none', or exactly two floats 'lo,hi' with lo <= hi."""
    if text.lower() == "none":
        return None
    try:
        vals = tuple(float(v) for v in text.split(","))
    except ValueError:
        vals = ()
    if len(vals) != 2 or vals[0] > vals[1]:
        raise argparse.ArgumentTypeError(
            f"want 'lo,hi' with lo <= hi, or 'none'; got {text!r}")
    return vals


def build_parser():
    p = argparse.ArgumentParser("istvt_tpu_torch.certify")
    p.add_argument("--teacher_size", type=int, default=300)
    p.add_argument("--teacher_depth", type=int, default=12)
    p.add_argument("--student_size", type=int, default=224)
    p.add_argument("--student_depth", type=int, default=6)
    p.add_argument("--seq_len", "-sl", type=int, default=6)
    p.add_argument("--train_clips", type=int, default=48)
    p.add_argument("--val_clips", type=int, default=32)
    p.add_argument("--batch_size", "-bs", type=int, default=8)
    p.add_argument("--patch_size", type=int, default=None)
    p.add_argument("--teacher_epochs", type=int, default=15)
    p.add_argument("--distill_epochs", type=int, default=15)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--alpha", type=float, default=0.5,
                   help="hard-label loss weight (cli.train default)")
    p.add_argument("--distill_T", type=float, default=2.0)
    p.add_argument("--attn_weight", type=float, default=1.0,
                   help="attention-transfer weight (0 = logit-only "
                        "distillation; see train/losses.make_distill_loss)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train_amp", type=_amp_range, default="0.3,1.5",
                   help="graded artifact-amplitude range 'lo,hi' for the "
                        "TRAIN set ('none' = fixed amplitude). Graded "
                        "difficulty is what keeps gradient-weighted LRP "
                        "localized at full geometry (train/certify.py "
                        "data note); production default 0.3,1.5")
    p.add_argument("--temporal_aug", type=int, default=1,
                   help="subset-frame-fake batches added to the distill "
                        "set (temporal boundary transfer; 0 disables)")
    p.add_argument("--cam_chunk", type=int, default=None,
                   help="teacher-LRP batch chunk (device memory relief at "
                        "full geometry; a ragged last chunk is one more)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute for the two training loops")
    p.add_argument("--no_int8", action="store_true")
    p.add_argument("--no_lrp", action="store_true")
    p.add_argument("--no_teacher_lrp", action="store_true",
                   help="skip the teacher's own LRP localization "
                        "diagnostic (teacher_lrp_* fields)")
    p.add_argument("--teacher_ckpt", default=None,
                   help="teacher checkpoint path: restored if it exists "
                        "(its seed, patch, amplitudes and geometry must "
                        "match), written after training otherwise")
    p.add_argument("--int8_delta_max", type=float, default=1.0)
    p.add_argument("--out", default=None, help="JSON artifact path")
    p.add_argument("--export", default=None, metavar="DIR",
                   help="also export the certified int8 student as a "
                        "serving artifact (serve_export) and selftest it "
                        "against the certification's own val logits "
                        "(criterion artifact_matches)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU: the kernels' plain versions")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from istvt_tpu_torch.core.device import require_cuda
    from istvt_tpu_torch.train.certify import certify_recipe

    dev = torch.device("cpu") if args.cpu else require_cuda()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[certify] backend: {dev.type} ({name})")
    legs = {}
    result = certify_recipe(
        teacher_size=args.teacher_size, teacher_depth=args.teacher_depth,
        student_size=args.student_size, student_depth=args.student_depth,
        seq_len=args.seq_len, train_clips=args.train_clips,
        val_clips=args.val_clips, batch_size=args.batch_size,
        patch_size=args.patch_size, teacher_epochs=args.teacher_epochs,
        train_amp_range=args.train_amp,
        distill_epochs=args.distill_epochs, lr=args.lr, seed=args.seed,
        alpha=args.alpha, temperature=args.distill_T,
        attn_weight=args.attn_weight, temporal_aug=args.temporal_aug,
        cam_chunk=args.cam_chunk,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        int8_delta_max=args.int8_delta_max,
        run_int8=not args.no_int8, run_lrp=not args.no_lrp,
        diag_teacher_lrp=not args.no_teacher_lrp,
        export_dir=args.export, teacher_ckpt=args.teacher_ckpt, device=dev,
        legs=legs)
    result["backend"] = dev.type
    result["legs"] = legs
    blob = json.dumps(result, indent=2, default=float)
    print(blob)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob + "\n")
        print(f"[certify] wrote {args.out}")
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
