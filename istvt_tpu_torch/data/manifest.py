"""Dataset manifests: scan face-crop frame directories into a clip index
(counterpart of istvt_tpu/data/manifest.py, copied). The layout
(docs/DATA.md):

    root/
      <quality>/                 # 'hq' (c23) | 'lq' (c40) | 'raw' (optional)
        <method>/                # 'original' + manipulations
          <video_id>/
            0000.png|jpg ...

FaceForensics++ manipulation types (reference train_CNN.py:977):
    original(0), Deepfakes(1), NeuralTextures(2), FaceSwap(3), Face2Face(4)

Flat layouts (root/<method>/<video>/frames) are detected; Celeb-DF and
OULU-NPU use two class directories (`scan_binary_tree`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

FFPP_METHODS: Dict[str, int] = {
    "original": 0,
    "Deepfakes": 1,
    "NeuralTextures": 2,
    "FaceSwap": 3,
    "Face2Face": 4,
}
# method index -> binary label (0 real / 1 fake)
FAKE_TYPE_TO_LABEL = {0: 0, 1: 1, 2: 1, 3: 1, 4: 1}


@dataclasses.dataclass(frozen=True)
class VideoEntry:
    video_id: str
    frames: Tuple[str, ...]       # sorted frame paths
    label: int                    # 0 real, 1 fake
    fake_type: int                # FFPP_METHODS index (0 = pristine)
    quality: str                  # 'hq' | 'lq' | '' when flat


def _is_frame(name: str) -> bool:
    return name.lower().endswith(IMAGE_EXTS)


def _scan_video_dir(path: str) -> Tuple[str, ...]:
    try:
        names = sorted(n for n in os.listdir(path) if _is_frame(n))
    except NotADirectoryError:
        return ()
    return tuple(os.path.join(path, n) for n in names)


def scan_ffpp(root: str, quality: Optional[str] = None,
              methods: Optional[Sequence[str]] = None,
              min_frames: int = 1) -> List[VideoEntry]:
    """An FF++-style tree as VideoEntry list. quality: one level ('hq' /
    'lq'); None takes every level, or the flat layout when there is none.
    A method directory outside FFPP_METHODS is an extra fake type."""
    entries: List[VideoEntry] = []
    if not os.path.isdir(root):
        return entries
    top = sorted(os.listdir(root))
    has_quality = any(t in ("hq", "lq", "raw", "c23", "c40", "c0") for t in top)

    def quality_dirs():
        if has_quality:
            for q in top:
                if quality is not None and q != quality:
                    continue
                qp = os.path.join(root, q)
                if os.path.isdir(qp):
                    yield q, qp
        else:
            yield "", root

    wanted = set(methods) if methods is not None else None
    for q, qpath in quality_dirs():
        for method in sorted(os.listdir(qpath)):
            mpath = os.path.join(qpath, method)
            if not os.path.isdir(mpath):
                continue
            if wanted is not None and method not in wanted:
                continue
            ftype = FFPP_METHODS.get(method)
            if ftype is None:
                ftype = len(FFPP_METHODS)
            label = FAKE_TYPE_TO_LABEL.get(ftype, 1)
            for vid in sorted(os.listdir(mpath)):
                vpath = os.path.join(mpath, vid)
                if not os.path.isdir(vpath):
                    continue
                frames = _scan_video_dir(vpath)
                if len(frames) >= min_frames:
                    entries.append(VideoEntry(
                        video_id=f"{method}/{vid}", frames=frames,
                        label=label, fake_type=ftype, quality=q))
    return entries


def scan_binary_tree(root: str, real_dirs=("real", "Celeb-real", "live",
                                           "original", "REAL"),
                     fake_dirs=("fake", "Celeb-synthesis", "spoof",
                                "attack", "FAKE"),
                     min_frames: int = 1) -> List[VideoEntry]:
    """A two-class tree (Celeb-DF / OULU): root/<class_dir>/<video_id>/
    frames; other directories are skipped."""
    entries: List[VideoEntry] = []
    if not os.path.isdir(root):
        return entries
    for d in sorted(os.listdir(root)):
        dpath = os.path.join(root, d)
        if not os.path.isdir(dpath):
            continue
        if d in real_dirs:
            label = 0
        elif d in fake_dirs:
            label = 1
        else:
            continue
        for vid in sorted(os.listdir(dpath)):
            vpath = os.path.join(dpath, vid)
            if not os.path.isdir(vpath):
                continue
            frames = _scan_video_dir(vpath)
            if len(frames) >= min_frames:
                entries.append(VideoEntry(
                    video_id=f"{d}/{vid}", frames=frames, label=label,
                    fake_type=label, quality=""))
    return entries


def split_train_val(entries: List[VideoEntry], val_fraction: float = 0.2,
                    seed: int = 0) -> Tuple[List[VideoEntry], List[VideoEntry]]:
    """Deterministic split by video (no video straddles the two)."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(entries))
    n_val = int(len(entries) * val_fraction)
    val_ids = set(idx[:n_val].tolist())
    train = [e for i, e in enumerate(entries) if i not in val_ids]
    val = [e for i, e in enumerate(entries) if i in val_ids]
    return train, val
