"""Saliency visualization CLI — `python -m istvt_tpu_torch.cli.visualize`
(counterpart of istvt_tpu/cli/visualize.py, same flag spellings and file
names).

For each clip, the spatial and temporal relevance maps of the LRP rollout
(or of full epsilon-rule LRP, --method full_lrp) are written as
`<frame>_s.png` / `<frame>_t.png` overlays (JET over the frame, 19x19 maps
upsampled x16 to 304x304), beside the plain frame `<frame>.png`;
--mode features writes the gradient x input relevance as
`<frame>_feat.png`. The model is ISTVTConfig(...) with the JAX CLI's
defaults (use_pallas=False: the XLA-math forward, exact-erf GELU), random
weights from seed 0, or with --model_path those of a train checkpoint
directory's latest step (cli/train.py -o) or of a bare save_pytree file
{'params', 'state'} (core/checkpoint.py):

    python -m istvt_tpu_torch.cli.visualize --dataset synthetic

--dataset ff++ (the default) explains the clips of a face-crop frame tree
(--data_root, --quality; docs/DATA.md) in Vis mode: centred clips whose
files name the PNGs, the clip's own frames under the overlays; --dataset
synthetic needs no disk. The card is the default; `--device cpu` runs on
the CPU. --mode channels exits naming its ROADMAP.md item.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

_Q1 = "ROADMAP.md queue 1"


def build_parser():
    p = argparse.ArgumentParser("istvt_tpu_torch.visualize")
    p.add_argument("--model_name", "-mn", default="istvt")
    p.add_argument("--seq_len", "-sl", type=int, default=6)
    p.add_argument("--input_size", "-is", type=int, default=300)
    p.add_argument("--quality", "-q", default="hq")
    p.add_argument("--data_root", default="")
    p.add_argument("--dataset", "-d", default="ff++",
                   choices=["ff++", "synthetic"])
    p.add_argument("--model_path", "-mp", default=None,
                   help="a train checkpoint dir or a save_pytree file")
    p.add_argument("--out_dir", default="./visualize")
    p.add_argument("--method", default="transformer_attribution",
                   choices=["transformer_attribution", "rollout",
                            "last_layer", "full_lrp"])
    p.add_argument("--index", type=int, default=0,
                   help="class logit to attribute (visualize_rel.py:257)")
    p.add_argument("--max_clips", type=int, default=1000,
                   help="stop after this many clips (visualize_rel.py:295)")
    p.add_argument("--mode", default="lrp",
                   choices=["lrp", "features", "channels"],
                   help="lrp: relevance overlays (visualize_rel.py); "
                        "features: grad*input relevance; channels: DualNet "
                        "feature-map channels (not ported yet)")
    p.add_argument("--max_channels", type=int, default=64,
                   help="channels mode: how many of the 4096 channels")
    p.add_argument("--depth", type=int, default=12,
                   help="transformer depth (12 = paper model)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu: run on the CPU (the tests use it)")
    return p


def check_args(args):
    """SystemExit naming the ROADMAP item of the first option this port
    does not implement."""
    if args.mode == "channels":
        raise SystemExit(f"--mode channels (DualNet) is not ported yet "
                         f"({_Q1}, 'Rest of the model zoo')")
    if args.model_name != "istvt":
        raise SystemExit(f"--model_name {args.model_name} is not ported yet "
                         f"({_Q1}, 'Rest of the model zoo')")


def restore(model, path: str):
    """Load a trainer checkpoint directory's latest state, or a bare
    save_pytree file {'params', 'state'}, into model (JAX's _restore)."""
    from istvt_tpu_torch.core.checkpoint import (CheckpointManager,
                                                 load_pytree)

    if not os.path.exists(path):
        raise SystemExit(f"--model_path {path}: no checkpoint there")
    dev = next(model.parameters()).device
    if os.path.isdir(path):
        mgr = CheckpointManager(path)
        if mgr.latest_step() is not None:
            model.load_state_dict(mgr.restore(map_location=dev)["model"])
            print(f"restored trainer step {mgr.latest_step()}")
            return
    tree = load_pytree(path, map_location=dev)
    model.load_state_dict({**tree["params"], **tree["state"]})


def build(args):
    """(model, dataset) for parsed, checked args: the JAX CLI's config
    with random weights from seed 0, or --model_path's, on args.device."""
    import torch

    from istvt_tpu_torch.core.config import ISTVTConfig
    from istvt_tpu_torch.core.device import require_cuda
    from istvt_tpu_torch.data import (SyntheticVideoDataset, Transform,
                                      VideoSeqDataset)
    from istvt_tpu_torch.models import istvt

    dev = require_cuda() if args.device == "cuda" else torch.device("cpu")
    cfg = ISTVTConfig(num_frames=args.seq_len, image_size=args.input_size,
                      feat_hw=istvt.infer_feat_hw(args.input_size),
                      depth=args.depth)
    model = istvt.init(cfg, torch.Generator().manual_seed(0), dev)
    if args.model_path:
        restore(model, args.model_path)
    if args.dataset == "synthetic":
        ds = SyntheticVideoDataset(min(args.max_clips, 8), args.seq_len,
                                   args.input_size)
    else:
        ds = VideoSeqDataset(root=args.data_root, quality=args.quality,
                             transform=Transform(args.input_size),
                             size=args.input_size, mode="Vis",
                             seq_len=args.seq_len)
        if len(ds) == 0:
            raise SystemExit(
                f"--dataset {args.dataset}: no clips of {args.seq_len} "
                f"frames under '{args.data_root}' (quality "
                f"'{args.quality}'): the real datasets read a face-crop "
                f"frame tree, docs/DATA.md")
    return model, ds


def render_clip(model, item, i: int, args) -> list:
    """One clip through the relevance method and into PNGs under
    args.out_dir (cli/visualize.py's loop body). Returns the paths."""
    import torch

    from istvt_tpu_torch.interpret import (generate_feature_relevance,
                                           generate_full_lrp, generate_lrp,
                                           render_saliency, save_png)

    dev = next(model.parameters()).device
    clips = torch.from_numpy(np.asarray(item["clips"])[None]).to(dev)
    frames01 = np.asarray(item["clips"]) * 0.5 + 0.5  # un-normalize
    names = [os.path.basename(p) for p in item["paths"]] \
        if "paths" in item else [f"clip{i:05d}_f{t}" for t in
                                 range(args.seq_len)]
    written = []

    def save(name, img):
        path = os.path.join(args.out_dir, name)
        save_png(path, img)
        written.append(path)

    if args.mode == "features":
        rel = generate_feature_relevance(model, clips,
                                         index=args.index)[0].cpu().numpy()
        for t in range(args.seq_len):
            m = rel[t] / (rel[t].max() + 1e-12)
            save(f"{names[t]}_feat.png", np.uint8(255 * m))
        return written
    if args.method == "full_lrp":
        cam_s, cam_t = generate_full_lrp(model, clips, index=args.index)
    else:
        cam_s, cam_t = generate_lrp(model, clips, index=args.index,
                                    method=args.method)
    cam_s, cam_t = cam_s[0].cpu().numpy(), cam_t[0].cpu().numpy()
    grid = model.cfg.feat_hw
    for t in range(args.seq_len):
        frame = frames01[t]
        save(f"{names[t]}_s.png", render_saliency(cam_s[t], frame, grid=grid))
        save(f"{names[t]}_t.png", render_saliency(cam_t[t], frame, grid=grid))
        # the plain frame alongside, like the reference (visualize_rel.py:276)
        save(f"{names[t]}.png", np.uint8(255 * np.clip(frame, 0, 1)))
    print(f"clip {i}: wrote {2 * args.seq_len} saliency overlays to "
          f"{args.out_dir}")
    return written


def main(argv=None) -> list:
    """Run the CLI; returns the paths of the PNGs written."""
    args = build_parser().parse_args(argv)
    check_args(args)
    model, ds = build(args)
    written = []
    for i in range(min(len(ds), args.max_clips)):
        written += render_clip(model, ds[i], i, args)
    return written


if __name__ == "__main__":
    main()
