"""Clip datasets (counterpart of istvt_tpu/data/video_dataset.py, a numpy
copy: the port imports nothing of the JAX package).

`VideoSeqDataset` (FF++ frame trees), `Celeb` (Celeb-DF and DFDC) and
`OULU` read face-crop frame trees in the docs/DATA.md layout
(data/manifest.py); `SyntheticVideoDataset` makes clips with no disk. Every
item is deterministic in (seed, index): its draws come from
np.random.default_rng((seed, index)) in the JAX class's order, so that the
loader's threads make the same items in any order, and the port's items
equal JAX's bit for bit (tests/test_torch_data.py).

Options that no entry point of the JAX package reaches (the triplet and
jigsaw-index items, random JPEG compression, diverse quality, Celeb's
paired and random-quality returns, MixedVideoDataset) raise
NotImplementedError naming ROADMAP.md queue 1 'Training' (item 5, whose
losses and branch steps would consume them).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from istvt_tpu_torch import native
from istvt_tpu_torch.data import manifest as mf
from istvt_tpu_torch.data.transforms import Transform

try:
    from PIL import Image
    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False

_ITEM5 = "ROADMAP.md queue 1 'Training' (item 5: the losses and branch steps)"


def _not_live(what: str):
    raise NotImplementedError(f"{what} is not ported yet ({_ITEM5})")


def _load_frame(path: str) -> np.ndarray:
    if not _HAS_PIL:
        raise RuntimeError("PIL unavailable; cannot decode frames")
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class ClipDataset:
    """Base: len() + indexable items, deterministic per (seed, index)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int) -> Dict:
        raise NotImplementedError


class VideoSeqDataset(ClipDataset):
    """FF++-style clips (reference call site train_CNN.py:172-173): `seq_len`
    consecutive frames of a video (a random start in Train, the centre in
    Test / Vis), each through the transform with the clip's shared
    parameters. Items: {'clips': (T, S, S, 3) f32 (uint8 with a raw_uint8
    transform), 'labels': int32, 'fake_types': int32 (return_fake_type),
    'paths': list of str (mode 'Vis')}. dataset_len > the number of videos
    wraps around them.

    use_native=True decodes a clip with the native clipdecode library
    (native/) when no augmentation runs and the normalization is Xception's;
    its 2-tap bilinear downscale differs from PIL's antialiased BILINEAR,
    so it is opt-in, and PIL decodes when the library is unavailable."""

    def __init__(self, root: str = "", quality: str = "hq",
                 transform: Optional[Transform] = None,
                 get_triplet: Optional[str] = None,
                 subset: Optional[str] = None,
                 num_multi: int = 3,
                 shuffle_min_slice: int = 1,
                 require_idx: bool = False,
                 random_compress: bool = False,
                 compress_param: Optional[Sequence[int]] = None,
                 size: int = 300, mode: str = "Train",
                 dataset_len: Optional[int] = None,
                 frame_type: str = "face",
                 diverse_quality: bool = False,
                 return_fake_type: bool = False,
                 seq_len: int = 6,
                 entries: Optional[List[mf.VideoEntry]] = None,
                 seed: int = 0,
                 use_native: bool = False):
        for what, on in (("get_triplet", get_triplet),
                         ("require_idx", require_idx),
                         ("random_compress", random_compress),
                         ("compress_param", compress_param),
                         ("diverse_quality", diverse_quality)):
            if on:
                _not_live(f"VideoSeqDataset({what}=...)")
        self.root = root
        self.quality = quality
        self.transform = transform or Transform(size)
        self.size = size
        self.mode = mode
        self.seq_len = seq_len
        self.return_fake_type = return_fake_type
        self.seed = seed
        self.use_native = use_native
        methods = None
        if subset and subset in mf.FFPP_METHODS:
            methods = ["original", subset]
        self.entries = entries if entries is not None else mf.scan_ffpp(
            root, quality=quality if quality else None, methods=methods,
            min_frames=seq_len)
        self._len = dataset_len if dataset_len else len(self.entries)

    def __len__(self):
        return self._len

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, index))

    def _pick_clip(self, entry: mf.VideoEntry, rng) -> List[str]:
        n = len(entry.frames)
        t = self.seq_len
        if n <= t:
            idxs = list(range(n)) + [n - 1] * (t - n)
        elif self.mode == "Train":
            start = int(rng.integers(0, n - t + 1))
            idxs = list(range(start, start + t))
        else:
            start = (n - t) // 2
            idxs = list(range(start, start + t))
        return [entry.frames[i] for i in idxs]

    def _native_fast_path(self, paths, params) -> Optional[np.ndarray]:
        """The whole clip through clipdecode (libjpeg / libpng + resize +
        normalize in C++), or None where it does not apply: not asked for,
        an augmentation or raw_uint8 in the transform, another mean / std,
        or the library unavailable."""
        if not self.use_native:
            return None
        t = self.transform
        if params or t.shuffle_grid or t.compress_range or t.augment \
                or t.raw_uint8:
            return None
        if tuple(t.mean) != (0.5, 0.5, 0.5) or tuple(t.std) != (0.5, 0.5, 0.5):
            return None
        try:
            if not native.available():
                return None
            n_threads = min(len(paths), os.cpu_count() or 1)
            return native.decode_frames(paths, t.size, 0.5, 0.5,
                                        n_threads=n_threads)
        except Exception:
            return None

    def __getitem__(self, index: int) -> Dict:
        entry = self.entries[index % len(self.entries)]
        rng = self._rng(index)
        paths = self._pick_clip(entry, rng)
        params = self.transform.sample_params(rng)
        clip = self._native_fast_path(paths, params)
        if clip is None:
            frames = []
            for p in paths:
                out = self.transform(_load_frame(p), params)
                if isinstance(out, tuple):   # the jigsaw permutation
                    out = out[0]
                frames.append(out)
            clip = np.stack(frames)
            if clip.dtype != np.uint8:       # raw_uint8 ingest stays u8
                clip = clip.astype(np.float32)
            native.count_clip("per_frame")
        else:
            native.count_clip("clipdecode")
        item: Dict = {"clips": clip, "labels": np.int32(entry.label)}
        if self.return_fake_type:
            item["fake_types"] = np.int32(entry.fake_type)
        if self.mode == "Vis":
            item["paths"] = paths
        return item


class Celeb(VideoSeqDataset):
    """Celeb-DF (reference call site train_CNN.py:166-170), and DFDC in the
    train CLI: a two-class real / synthesis tree
    (manifest.scan_binary_tree)."""

    def __init__(self, root: str = "", num_multi: int = 3, mode: str = "Train",
                 shuffle_min_slice: int = 1, require_idx: bool = False,
                 compress_param: Optional[Sequence[int]] = None,
                 pair_return: bool = False, fixed_qual: bool = False,
                 random_test_qual: bool = False, size: int = 300,
                 seq_len: int = 6, transform: Optional[Transform] = None,
                 entries=None, seed: int = 0, dataset_len=None):
        for what, on in (("pair_return", pair_return),
                         ("random_test_qual", random_test_qual)):
            if on:
                _not_live(f"Celeb({what}=...)")
        ent = entries if entries is not None else mf.scan_binary_tree(
            root, min_frames=seq_len)
        super().__init__(root=root, transform=transform, size=size, mode=mode,
                         seq_len=seq_len, require_idx=require_idx,
                         compress_param=compress_param, entries=ent,
                         seed=seed, dataset_len=dataset_len)


class OULU(VideoSeqDataset):
    """OULU-NPU presentation attacks (reference call site
    train_CNN.py:163-164; ACER at :885-893): live = 0, attack = 1."""

    def __init__(self, root: str = "", num_multi: int = 3, mode: str = "Train",
                 shuffle_min_slice: int = 1, size: int = 300,
                 seq_len: int = 6, transform: Optional[Transform] = None,
                 entries=None, seed: int = 0, dataset_len=None):
        ent = entries if entries is not None else mf.scan_binary_tree(
            root, min_frames=seq_len)
        super().__init__(root=root, transform=transform, size=size, mode=mode,
                         seq_len=seq_len, entries=ent, seed=seed,
                         dataset_len=dataset_len)


class MixedVideoDataset(ClipDataset):
    """The multi-source eval set with a switchable quality (JAX
    video_dataset.py:254-283): no entry point reaches it."""

    def __init__(self, *args, **kwargs):
        _not_live("MixedVideoDataset")


class SyntheticVideoDataset:
    """Deterministic synthetic clips (video_dataset.py:293-353): 'fake'
    clips (odd index, label 1) carry per-frame independent noise in a
    moving patch over a rolled base frame; real clips (label 0) only the
    smooth motion. Items: {'clips': (T, S, S, 3) f32, 'labels': int32,
    'fake_types': int32}.

    static_patch=True pins the patch to one (per-clip random) place in
    every frame, so that relevance maps have a localizable ground truth;
    the item then also holds 'patch_yx', the patch's top-left corner
    ((-1, -1) for real clips). patch_size overrides the default extent
    size // 8. amp_range=(lo, hi) scales a fake clip's noise by an
    amplitude drawn uniformly from it, given as the item's 'amp' (0 for
    real clips)."""

    def __init__(self, num_clips: int = 64, seq_len: int = 6,
                 size: int = 300, seed: int = 0,
                 static_patch: bool = False, patch_size: int | None = None,
                 amp_range: tuple | None = None):
        self.num_clips = num_clips
        self.seq_len = seq_len
        self.size = size
        self.seed = seed
        self.static_patch = static_patch
        self.patch_size = patch_size
        self.amp_range = amp_range

    def __len__(self):
        return self.num_clips

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng((self.seed, index))
        label = index % 2
        base = rng.normal(0, 0.3, (self.size, self.size, 3)).astype(np.float32)
        clip = np.stack([base] * self.seq_len)
        for t in range(self.seq_len):
            clip[t] = np.roll(clip[t], shift=t, axis=1)
        y = x = -1
        amp = 1.0
        if label == 1:
            ps = self.patch_size or max(self.size // 8, 2)
            if self.amp_range is not None:
                amp = float(rng.uniform(*self.amp_range))
            y = x = None
            for t in range(self.seq_len):
                if y is None or not self.static_patch:
                    y = int(rng.integers(0, self.size - ps))
                    x = int(rng.integers(0, self.size - ps))
                clip[t, y:y + ps, x:x + ps] += (amp * rng.normal(
                    0, 1.0, (ps, ps, 3))).astype(np.float32)
        out = {"clips": clip, "labels": np.int32(label),
               "fake_types": np.int32(label)}
        if self.amp_range is not None:
            out["amp"] = np.float32(amp if label == 1 else 0.0)
        if self.static_patch:
            out["patch_yx"] = np.array([y, x], np.int32)
        return out
