"""Offline video preprocessing: raw .mp4 tree -> face-cropped frame tree
(counterpart of istvt_tpu/cli/preprocess.py, same flags).

The paper's preprocessing stage (the reference's `dataset` package reads
frames that a detector-crop pipeline extracted; call site reference
train_CNN.py:172-173). The output is in the docs/DATA.md layout, which
VideoSeqDataset / Celeb / OULU and the train CLI read as it is:

    python -m istvt_tpu_torch.cli.preprocess --root /raw/ffpp \
        --out /data/ffpp --quality hq --every-n 5 --size 300 --margin 1.3

Videos are processed in parallel on a thread pool (the native decoder and
cv2 release the GIL). A run where some videos fail exits 0 and names
them; a run where all fail exits 1.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", required=True,
                   help="raw video tree: root/[quality/]method/*.mp4")
    p.add_argument("--out", required=True, help="output frame tree root")
    p.add_argument("--quality", "-q", default=None,
                   help="quality level subdir to scan (hq/lq); omit if flat")
    p.add_argument("--every-n", type=int, default=1,
                   help="keep every n-th frame")
    p.add_argument("--size", type=int, default=300, help="output frame size")
    p.add_argument("--margin", type=float, default=1.3,
                   help="face-crop margin (box side multiplier; "
                        "skin mode only — center/none ignore it)")
    p.add_argument("--crop-mode", default="skin",
                   choices=["skin", "center", "none"],
                   help="face localization: skin-prior box (re-detected "
                        "every --redetect-every sampled frames), fixed "
                        "center box, or no crop")
    p.add_argument("--redetect-every", type=int, default=25,
                   help="sampled frames per face-box re-localization")
    p.add_argument("--limit-frames", type=int, default=None,
                   help="cap frames per video")
    p.add_argument("--boxes", default=None,
                   help="JSON manifest of external detector boxes "
                        "(dlib/MTCNN/...): {video: {frame: [y0,x0,h,w]}}. "
                        "Covered videos use these boxes EXACTLY instead "
                        "of the skin-prior localizer; uncovered ones "
                        "fall back to --crop-mode.")
    p.add_argument("--workers", type=int, default=os.cpu_count() or 8)
    p.add_argument("--use-native", action="store_true", default=None,
                   help="force the native libav decoder (default: auto)")
    p.add_argument("--no-native", dest="use_native", action="store_false")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from istvt_tpu_torch.data.manifest import FFPP_METHODS
    from istvt_tpu_torch.data.video_frontend import (BoxManifest,
                                                     extract_frames,
                                                     scan_ffpp_videos)

    args = parse_args(argv)
    boxes = BoxManifest(args.boxes) if args.boxes else None
    entries = scan_ffpp_videos(args.root, args.quality)
    if not entries:
        print(f"no videos found under {args.root}", file=sys.stderr)
        return 1
    method_names = {v: k for k, v in FFPP_METHODS.items()}

    def job(entry):
        vid = os.path.splitext(os.path.basename(entry["path"]))[0]
        method = method_names[entry["fake_type"]]
        parts = [args.out]
        if entry["quality"]:
            parts.append(entry["quality"])
        parts += [method, vid]
        out_dir = os.path.join(*parts)
        try:
            n = extract_frames(entry["path"], out_dir,
                               every_n=args.every_n,
                               size=args.size, margin=args.margin,
                               crop_mode=args.crop_mode,
                               limit=args.limit_frames,
                               use_native=args.use_native,
                               redetect_every=args.redetect_every,
                               boxes=boxes)
        except Exception as e:  # one broken video must not kill the run
            return entry["path"], None, f"{type(e).__name__}: {e}"
        return entry["path"], n, None

    t0 = time.time()
    total, failed = 0, 0
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        for path, n, err in pool.map(job, entries):
            if err is not None:
                failed += 1
                print(f"{path}: SKIPPED ({err})", file=sys.stderr)
                continue
            total += n
            print(f"{path}: {n} frames")
    dt = time.time() - t0
    print(f"done: {len(entries) - failed}/{len(entries)} videos, "
          f"{total} frames in {dt:.1f}s "
          f"({total / max(dt, 1e-9):.0f} frames/s)"
          + (f"; {failed} failed" if failed else ""))
    # partial success exits 0 (big corpora always have a few broken
    # files); TOTAL failure must not look like success to a pipeline
    return 1 if failed == len(entries) else 0


if __name__ == "__main__":
    raise SystemExit(main())
