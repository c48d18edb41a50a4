"""Raw-video front end: container decode + face crop with margin
(counterpart of istvt_tpu/data/video_frontend.py, copied; the native
decoder is the port's own build of native/videodecode.cpp).

  * `decode_clip` - frames at given indices from one container pass
    (native libavformat / libavcodec, or cv2);
  * `face_box` - skin-prior face localization (YCbCr ellipse test) ->
    robust percentile box -> square crop grown by `margin` (the paper's
    crop with margin), the centred box where no skin region is found;
  * `BoxManifest` - external detector boxes that override it;
  * `RawVideoDataset` - clips over a tree of .mp4 / .avi videos in the FF++
    layout (docs/DATA.md with videos in place of frame directories),
    decoded and cropped on the fly;
  * `extract_frames` - one video -> cropped JPEG frames in the docs/DATA.md
    layout (driven by cli/preprocess.py).

The native and cv2 decoders differ in the downscale's filter phase
(SWS_AREA at conversion vs INTER_AREA after it), so the backend is an
explicit argument (`use_native`), native only where it is available when
None; pass False to pin cv2.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from istvt_tpu_torch import native
from istvt_tpu_torch.data import manifest as mf
from istvt_tpu_torch.data.video_dataset import ClipDataset

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


# ---------------------------------------------------------------------------
# decode


def probe(path: str) -> Tuple[int, int, int, float]:
    """-> (n_frames, width, height, fps). Containers that carry no frame
    count (some mkv/webm) fall back to a full decode-and-count pass so
    n_frames is ALWAYS > 0 for a non-empty, openable video."""
    n = -1
    w = h = 0
    fps = 0.0
    native_ok = native.video_available()
    if native_ok:
        n, w, h, fps = native.video_probe(path)
        if n > 0:
            return n, w, h, fps
    if _HAS_CV2 and n <= 0:
        cap = cv2.VideoCapture(path)
        try:
            if cap.isOpened():
                n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
                w = w or int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
                h = h or int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
                fps = fps or float(cap.get(cv2.CAP_PROP_FPS))
                if n <= 0:  # metadata absent: decode-and-count
                    n = 0
                    while cap.grab():
                        n += 1
        finally:
            cap.release()
    if n <= 0 and native_ok:
        # metadata absent everywhere (or cv2 missing/codec-less):
        # exact native decode-and-count on the lib that opened the file
        n = native.video_count_frames(path)
    if n <= 0 or not w or not h:
        raise IOError(f"cannot determine frame count/geometry of {path}")
    return n, w, h, fps


def _decode_cv2(path: str, indices: np.ndarray, out_size: int,
                crops: Optional[np.ndarray], mean: float,
                std: float) -> Tuple[np.ndarray, int]:
    if not _HAS_CV2:
        raise RuntimeError("no video backend (native build failed, no cv2)")
    cap = cv2.VideoCapture(path)
    out = np.zeros((len(indices), out_size, out_size, 3), np.float32)
    try:
        frame_no, next_i = 0, 0
        while next_i < len(indices):
            ok, bgr = cap.read()
            if not ok:
                break
            while next_i < len(indices) and indices[next_i] == frame_no:
                img = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
                if crops is not None:
                    # same clamp/degenerate-crop fallback as the native
                    # decoder (videodecode.cpp) so the backends stay
                    # interchangeable on edge boxes
                    fh, fw = img.shape[:2]
                    y0, x0, ch, cw = (int(v) for v in crops[next_i])
                    y0 = max(y0, 0) & ~1
                    x0 = max(x0, 0) & ~1
                    ch = min(ch, fh - y0)
                    cw = min(cw, fw - x0)
                    if ch < 2 or cw < 2:
                        y0, x0, ch, cw = 0, 0, fh, fw
                    img = img[y0:y0 + ch, x0:x0 + cw]
                img = cv2.resize(img.astype(np.float32),
                                 (out_size, out_size),
                                 interpolation=cv2.INTER_AREA)
                out[next_i] = (img / 255.0 - mean) / std
                next_i += 1
            frame_no += 1
    finally:
        cap.release()
    return out, next_i


def decode_clip(path: str, indices: Sequence[int], out_size: int,
                crops: Optional[np.ndarray] = None, mean: float = 0.5,
                std: float = 0.5,
                use_native: Optional[bool] = None) -> np.ndarray:
    """Frames at `indices` -> (n, out_size, out_size, 3) f32 normalized
    (x/255 - mean)/std, rows in the ORDER GIVEN. crops: optional (n, 4)
    (y0, x0, h, w) source-pixel face boxes, aligned with `indices`
    (decode happens in ascending order internally; crops and output rows
    are permuted to match)."""
    idx_in = np.asarray(indices, np.int32)
    order = np.argsort(idx_in, kind="stable")
    idx = np.ascontiguousarray(idx_in[order])
    cr = None
    if crops is not None:
        cr = np.ascontiguousarray(np.asarray(crops, np.int32)[order])
    if use_native is None:
        use_native = native.video_available()
    if use_native:
        out, filled = native.video_decode_indices(path, idx, out_size, cr,
                                                  mean, std,
                                                  return_filled=True)
    else:
        out, filled = _decode_cv2(path, idx, out_size, cr, mean, std)
    if filled < len(idx):
        # container metadata overestimated the frame count (probe() falls
        # back to duration*fps rounding on some files) and the highest
        # indices ran past EOF: repeat the last REAL frame instead of
        # silently returning all-black rows (training on black frames
        # corrupts the temporal-difference signal without any error)
        if filled == 0:
            raise IOError(f"decode_clip({path}): no frames decoded "
                          f"(requested indices {idx[0]}..{idx[-1]})")
        warnings.warn(
            f"decode_clip({path}): only {filled}/{len(idx)} requested "
            f"frames exist (frame-count metadata overestimates); "
            f"repeating the last real frame", stacklevel=2)
        out[filled:] = out[filled - 1]
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    return out[inv]


# ---------------------------------------------------------------------------
# external crop boxes (detector output ingestion)


class BoxManifest:
    """Externally produced face boxes (dlib/MTCNN/RetinaFace/...) that
    OVERRIDE the in-tree skin-prior localization wherever a video is
    covered — the escape hatch docs/DATA.md's placeholder warning points
    real-data users at: run any detector offline, write one JSON file,
    and the frontend honors its boxes exactly (no code changes).

    Manifest format — one JSON object for a whole tree:

        {"<video key>": {"<frame index>": [y0, x0, h, w], ...}, ...}

    Boxes are integer SOURCE-pixel (y0, x0, h, w), the same convention
    `decode_clip` consumes (degenerate/out-of-range boxes get the same
    clamp the native decoder applies). A video is matched by, in order:
    the exact path handed to the dataset, its absolute path, its path
    relative to the manifest file's directory, its basename, its stem.
    Frames with no annotation take the NEAREST annotated frame's box
    (sparse detector output — every Nth frame — is the common case);
    annotated frames are honored exactly (tests/test_video_frontend.py).
    """

    def __init__(self, source: Union[str, os.PathLike, Dict]):
        if isinstance(source, (str, os.PathLike)):
            self._dir = os.path.dirname(os.path.abspath(source))
            with open(source) as f:
                raw = json.load(f)
        else:
            self._dir, raw = "", dict(source)
        self._videos: Dict[str, Dict[int, Tuple[int, int, int, int]]] = {}
        for key, frames in raw.items():
            boxes = {int(fi): tuple(int(v) for v in box)
                     for fi, box in frames.items()}
            for box in boxes.values():
                if len(box) != 4:
                    raise ValueError(
                        f"BoxManifest['{key}']: box must be "
                        f"[y0, x0, h, w], got {box}")
            self._videos[key] = boxes

    def lookup(self, video_path: str
               ) -> Optional[Dict[int, Tuple[int, int, int, int]]]:
        base = os.path.basename(video_path)
        cands = [video_path, os.path.abspath(video_path)]
        if self._dir:
            cands.append(os.path.relpath(os.path.abspath(video_path),
                                         self._dir))
        cands += [base, os.path.splitext(base)[0]]
        for c in cands:
            if c in self._videos:
                return self._videos[c]
        return None

    def boxes_for(self, video_path: str,
                  indices: Sequence[int]) -> Optional[np.ndarray]:
        """(len(indices), 4) int32 crops aligned with `indices` (order
        given), or None when the manifest does not cover this video."""
        entry = self.lookup(video_path)
        if not entry:
            return None
        ann = np.asarray(sorted(entry), np.int64)
        out = np.empty((len(indices), 4), np.int32)
        for i, fi in enumerate(indices):
            nearest = int(ann[np.argmin(np.abs(ann - int(fi)))])
            out[i] = entry[nearest]
        return out


def _as_manifest(boxes: Optional[Union[str, os.PathLike, Dict,
                                       "BoxManifest"]]
                 ) -> Optional["BoxManifest"]:
    if boxes is None or isinstance(boxes, BoxManifest):
        return boxes
    return BoxManifest(boxes)


# ---------------------------------------------------------------------------
# face localization (landmark-lite)


def _skin_bbox(frame: np.ndarray):
    """Raw (un-squared, un-margined) face bbox from the YCbCr skin prior:
    2nd..98th percentile extent of skin pixels -> (y_lo, x_lo, bh, bw)
    floats, or None when fewer than 1% of pixels are skin-like."""
    f = frame.astype(np.float32)
    # Recover [0,1] RGB by inverting the KNOWN normalizations rather than
    # min-max stretching: a data-dependent stretch rescales chroma with
    # the frame's dynamic range and pushed borderline skin outside the
    # Cr/Cb gates (measured: 7.9% skin pixels -> 0.7% on a probe frame,
    # collapsing detection to the center fallback).
    if f.max() > 2.0:          # uint8-ranged
        f = f / 255.0
    elif f.min() < -0.05:      # (x - 0.5)/0.5 symmetric normalization
        f = f * 0.5 + 0.5      # (decode_clip's probe convention)
    f = np.clip(f, 0.0, 1.0)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    # BT.601 YCbCr
    cb = 128.0 + 255.0 * (-0.168736 * r - 0.331264 * g + 0.5 * b)
    cr = 128.0 + 255.0 * (0.5 * r - 0.418688 * g - 0.081312 * b)
    mask = (cr > 135) & (cr < 180) & (cb > 85) & (cb < 135)
    if mask.mean() < 0.01:
        return None
    ys, xs = np.nonzero(mask)
    y_lo, y_hi = np.percentile(ys, [2, 98])
    x_lo, x_hi = np.percentile(xs, [2, 98])
    return y_lo, x_lo, y_hi - y_lo, x_hi - x_lo


def face_box(frame: np.ndarray, margin: float = 1.3,
             mode: str = "skin") -> Tuple[int, int, int, int]:
    """Locate a square face crop (y0, x0, h, w) in an RGB frame.

    frame: (H, W, 3) uint8 or normalized float (any affine of [0,1]).
    mode 'skin': YCbCr skin-prior mask -> 2nd..98th percentile bbox of the
    skin pixels -> square box grown by `margin` about its center (the
    paper's crop-with-margin); falls back to 'center' when fewer than 1%
    of pixels are skin-like. mode 'center': the centered short-side
    square — a fixed-box baseline with no face to expand, so `margin`
    is ignored in this mode.
    """
    h, w = frame.shape[:2]
    if mode == "skin":
        raw = _skin_bbox(frame)
        if raw is not None:
            y_lo, x_lo, bh, bw = raw
            cy, cx = y_lo + bh / 2, x_lo + bw / 2
            side = max(bh, bw) * margin
            side = int(min(max(side, 16), min(h, w)))
            y0 = int(np.clip(cy - side / 2, 0, h - side))
            x0 = int(np.clip(cx - side / 2, 0, w - side))
            return y0, x0, side, side
    # center fallback / fixed-box mode
    side = min(h, w)
    return (h - side) // 2, (w - side) // 2, side, side


def _detect_box(path: str, frame_idx: int, src_hw: Tuple[int, int],
                margin: float, mode: str, probe_size: int,
                use_native: Optional[bool],
                small: Optional[np.ndarray] = None
                ) -> Tuple[int, int, int, int]:
    """One SQUARE face box in source pixels from a low-res decode of one
    frame (shared by clip_face_crops and extract_frames so the online and
    offline crop paths stay numerically identical).

    The probe decode resizes the full frame to probe_size x probe_size
    (aspect-squashed), so probe coordinates map back through DIFFERENT
    y/x scale factors. The RAW (un-squared) skin bbox is mapped extent-by-
    extent into source pixels first, and only then squared with `margin`
    about its center — squaring in probe coordinates first (or scaling a
    probe-square's sides naively) mis-sizes the box by up to w/h
    (~1.33-1.78x on typical videos; measured IoU 0.35 vs 0.80 on the
    synthetic ground-truth sweep in tests/test_video_frontend.py)."""
    h, w = src_hw
    short = min(h, w)
    center = ((h - short) // 2, (w - short) // 2, short, short)
    if mode == "center":
        # short-side square directly from source geometry (computing it
        # via face_box on the SQUARE probe frame degenerates to the full
        # frame, making 'center' behave like 'none')
        return center
    if small is None:
        try:
            small = decode_clip(path, [frame_idx], probe_size, mean=0.5,
                                std=0.5, use_native=use_native)[0]
        except IOError:
            # probe frame past EOF (frame-count metadata overestimate):
            # fall back to the fixed center box rather than failing the clip
            return center
    raw = _skin_bbox(small)
    if raw is None:
        # <1% skin pixels: centered short-side square, source coordinates
        return center
    y_lo, x_lo, bh, bw = raw
    sy, sx = h / probe_size, w / probe_size
    cy, cx = (y_lo + bh / 2.0) * sy, (x_lo + bw / 2.0) * sx
    side = int(round(min(max(max(bh * sy, bw * sx) * margin, 16), short)))
    y0 = int(np.clip(cy - side / 2.0, 0, h - side))
    x0 = int(np.clip(cx - side / 2.0, 0, w - side))
    return y0, x0, side, side


def clip_face_crops(path: str, indices: Sequence[int], margin: float = 1.3,
                    mode: str = "skin", probe_size: int = 128,
                    use_native: Optional[bool] = None,
                    src_hw: Optional[Tuple[int, int]] = None,
                    boxes: Optional["BoxManifest"] = None) -> np.ndarray:
    """One face box for a whole clip, from its MIDDLE frame (faces move
    little within 6 consecutive frames; one box keeps the crop temporally
    stable, which the self-subtract attention requires — per-frame boxes
    would alias crop jitter into the frame-difference signal).

    boxes: optional BoxManifest of external detector output; when it
    covers this video its per-frame boxes are returned EXACTLY (aligned
    with `indices`, nearest-annotated fill) and no detection runs —
    detector pipelines emit temporally smoothed tracks, so the stability
    law above is theirs to enforce. Uncovered videos fall through to the
    in-tree localizer.

    -> (len(indices), 4) int32 (y0, x0, h, w) in source pixels."""
    if boxes is not None:
        ext = boxes.boxes_for(path, list(indices))
        if ext is not None:
            return ext
    idx = sorted(indices)
    mid = idx[len(idx) // 2]
    if src_hw is None:
        _, w, h, _ = probe(path)
    else:
        h, w = src_hw
    if mode == "none":
        box = (0, 0, h, w)
    else:
        box = _detect_box(path, mid, (h, w), margin, mode, probe_size,
                          use_native)
    return np.tile(np.asarray(box, np.int32), (len(idx), 1))


# ---------------------------------------------------------------------------
# dataset over raw videos


def _is_video(name: str) -> bool:
    return name.lower().endswith(VIDEO_EXTS)


def scan_ffpp_videos(root: str, quality: Optional[str] = None,
                     methods: Optional[Sequence[str]] = None) -> List[Dict]:
    """FF++-layout scan with VIDEOS in place of frame dirs:
    root/[quality/]method/*.mp4 -> [{'path', 'label', 'fake_type',
    'quality'}]. Flat trees (no quality level) are detected like
    manifest.scan_ffpp."""
    entries: List[Dict] = []
    quals = [quality] if quality and \
        os.path.isdir(os.path.join(root, quality)) else [None]
    for q in quals:
        base = os.path.join(root, q) if q else root
        if not os.path.isdir(base):
            continue
        for method, ftype in mf.FFPP_METHODS.items():
            if methods and method not in methods:
                continue
            mdir = os.path.join(base, method)
            if not os.path.isdir(mdir):
                continue
            for name in sorted(os.listdir(mdir)):
                if _is_video(name):
                    entries.append({
                        "path": os.path.join(mdir, name),
                        "label": mf.FAKE_TYPE_TO_LABEL[ftype],
                        "fake_type": ftype,
                        "quality": q or "",
                    })
    return entries


class RawVideoDataset(ClipDataset):
    """Clips straight from a directory of raw videos (FF++ layout with
    .mp4s): per item, sample `seq_len` consecutive frames (random start in
    Train, centered otherwise), face-crop with margin, decode + resize +
    normalize in one native container pass. Replaces the reference's
    offline preprocessing + frame-dir dataset with an online path."""

    def __init__(self, root: str, quality: Optional[str] = None,
                 subset: Optional[str] = None, seq_len: int = 6,
                 size: int = 300, mode: str = "Train", margin: float = 1.3,
                 crop_mode: str = "skin", frame_stride: int = 1,
                 mean: float = 0.5, std: float = 0.5,
                 dataset_len: Optional[int] = None, seed: int = 0,
                 return_fake_type: bool = False,
                 use_native: Optional[bool] = None,
                 boxes: Optional[Union[str, Dict, "BoxManifest"]] = None):
        methods = ["original", subset] if subset else None
        self.entries = scan_ffpp_videos(root, quality, methods)
        if not self.entries:
            raise FileNotFoundError(f"no videos under {root}")
        self.seq_len = seq_len
        self.size = size
        self.mode = mode
        self.margin = margin
        self.crop_mode = crop_mode
        self.frame_stride = frame_stride
        self.mean, self.std = mean, std
        self.seed = seed
        self.return_fake_type = return_fake_type
        self.use_native = use_native
        self.boxes = _as_manifest(boxes)
        self._len = dataset_len or len(self.entries)
        self._nframes: Dict[str, int] = {}

    def __len__(self):
        return self._len

    def _probe_cached(self, path: str) -> Tuple[int, int, int]:
        if path not in self._nframes:
            n, w, h, _ = probe(path)
            self._nframes[path] = (n, w, h)
        return self._nframes[path]

    def __getitem__(self, index: int) -> Dict:
        entry = self.entries[index % len(self.entries)]
        rng = np.random.default_rng((self.seed, index))
        n, w, h = self._probe_cached(entry["path"])
        span = (self.seq_len - 1) * self.frame_stride + 1
        if n <= span:
            idxs = [min(i * self.frame_stride, n - 1)
                    for i in range(self.seq_len)]
        elif self.mode == "Train":
            start = int(rng.integers(0, n - span + 1))
            idxs = list(range(start, start + span, self.frame_stride))
        else:
            start = (n - span) // 2
            idxs = list(range(start, start + span, self.frame_stride))
        crops = clip_face_crops(entry["path"], idxs, margin=self.margin,
                                mode=self.crop_mode,
                                use_native=self.use_native,
                                src_hw=(h, w), boxes=self.boxes)
        clip = decode_clip(entry["path"], idxs, self.size, crops=crops,
                           mean=self.mean, std=self.std,
                           use_native=self.use_native)
        item = {"clips": clip, "labels": np.int32(entry["label"])}
        if self.return_fake_type:
            item["fake_types"] = np.int32(entry["fake_type"])
        return item


# ---------------------------------------------------------------------------
# offline extraction (docs/DATA.md layout)


def extract_frames(video_path: str, out_dir: str, every_n: int = 1,
                   size: int = 300, margin: float = 1.3,
                   crop_mode: str = "skin", limit: Optional[int] = None,
                   use_native: Optional[bool] = None,
                   redetect_every: int = 25,
                   probe_size: int = 128,
                   boxes: Optional["BoxManifest"] = None) -> int:
    """Decode every `every_n`-th frame of one video, face-crop with
    margin, resize to `size`, save as JPEGs '0000.jpg'.. in out_dir
    (the docs/DATA.md frame layout). Returns frames written.

    The face is RE-LOCALIZED every `redetect_every` sampled frames (one
    clip_face_crops-style stable box per chunk): a single whole-video box
    would drift off a moving subject, while per-frame boxes would alias
    crop jitter into the temporal signal the model reads.

    boxes: optional BoxManifest of external detector output — when it
    covers this video, its per-frame boxes are honored exactly
    (nearest-annotated fill for unannotated frames) and no in-tree
    detection runs."""
    from PIL import Image

    n, w, h, _ = probe(video_path)
    idxs = list(range(0, n, every_n))
    if limit:
        idxs = idxs[:limit]
    if not idxs:
        return 0
    ext = boxes.boxes_for(video_path, idxs) if boxes is not None else None
    if ext is not None:
        crops = ext
    elif crop_mode == "none":
        crops = np.tile(np.asarray((0, 0, h, w), np.int32),
                        (len(idxs), 1))
    else:
        chunks = [idxs[i:i + redetect_every]
                  for i in range(0, len(idxs), redetect_every)]
        mids = [c[len(c) // 2] for c in chunks]
        # one low-res decode pass serves every chunk's detector frame
        small = decode_clip(video_path, mids, probe_size, mean=0.5,
                            std=0.5, use_native=use_native)
        boxes = []
        for frame, chunk, mid in zip(small, chunks, mids):
            box = _detect_box(video_path, mid, (h, w), margin, crop_mode,
                              probe_size, use_native, small=frame)
            boxes += [box] * len(chunk)
        crops = np.asarray(boxes, np.int32)
    # mean 0, std 1/255 -> raw [0, 255] pixel values
    frames = decode_clip(video_path, idxs, size, crops=crops, mean=0.0,
                         std=1.0 / 255.0, use_native=use_native)
    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(frames):
        img = Image.fromarray(np.clip(f, 0, 255).astype(np.uint8))
        img.save(os.path.join(out_dir, f"{i:04d}.jpg"), quality=95)
    return len(frames)
