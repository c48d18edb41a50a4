"""Host-side image transforms in numpy / PIL (counterpart of
istvt_tpu/data/transforms.py, copied: the port imports nothing of the JAX
package). The presets of the reference's external transform module
(reference train_CNN.py:18, selected at :154-161):

  * xception_default_data_transforms      - resize 299, normalize mean/std 0.5
  * xception_default_data_transforms_256  - resize 256
  * xception_default_data_transforms_300  - resize 300
  * data_transform_aug                    - + flip / brightness augmentation
  * data_transforms_shuffle               - + patch shuffle (jigsaw pretext)

Each preset is {'train', 'val', 'test'} of Transform; a Transform maps one
HWC uint8 RGB frame to a float32 HWC normalized frame, (x/255 - 0.5) / 0.5
(reference network/xception.py:12-14, 30-31). All randomness comes from the
np.random.Generator handed to `sample_params`, so an item is deterministic
in (seed, index) on any loader thread.
"""
from __future__ import annotations

import io
from typing import Dict, Optional, Tuple

import numpy as np

try:
    from PIL import Image
    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False


def resize(img: np.ndarray, size: int) -> np.ndarray:
    """HWC uint8 -> (size, size): PIL's BILINEAR, or nearest neighbour
    where PIL does not import (the JAX module's two branches)."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    if _HAS_PIL:
        return np.asarray(
            Image.fromarray(img).resize((size, size), Image.BILINEAR))
    ys = (np.arange(size) * img.shape[0] / size).astype(np.int64)
    xs = (np.arange(size) * img.shape[1] / size).astype(np.int64)
    return img[ys][:, xs]


def normalize(img: np.ndarray,
              mean: Tuple[float, ...] = (0.5, 0.5, 0.5),
              std: Tuple[float, ...] = (0.5, 0.5, 0.5)) -> np.ndarray:
    x = img.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def jpeg_compress(img: np.ndarray, quality: int) -> np.ndarray:
    """Re-encode through PIL at the given JPEG quality (the reference's
    compress_param augmentation); the frame as it is without PIL."""
    if not _HAS_PIL:
        return img
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=int(quality))
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGB"))


def hflip(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1]


def shuffle_patches(img: np.ndarray, grid: int,
                    rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Split into grid x grid patches and permute them: (shuffled image,
    permutation), the jigsaw pretext input (reference loss_fn.py:262-278)."""
    h, w, c = img.shape
    ph, pw = h // grid, w // grid
    img = img[: ph * grid, : pw * grid]
    patches = img.reshape(grid, ph, grid, pw, c).transpose(0, 2, 1, 3, 4)
    patches = patches.reshape(grid * grid, ph, pw, c)
    perm = rng.permutation(grid * grid)
    shuffled = patches[perm].reshape(grid, grid, ph, pw, c)
    shuffled = shuffled.transpose(0, 2, 1, 3, 4).reshape(ph * grid, pw * grid, c)
    return shuffled, perm


class Transform:
    """Composable frame transform. The per-clip random decisions come from
    `sample_params` and are shared by every frame of a clip."""

    def __init__(self, size: int = 299,
                 mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                 augment: bool = False,
                 shuffle_grid: Optional[int] = None,
                 compress_range: Optional[Tuple[int, int]] = None,
                 raw_uint8: bool = False):
        """raw_uint8=True skips the host normalization and returns the
        resized uint8 frame: a quarter of the host->card bytes, with
        `loader.device_normalize` applying (x/255 - mean)/std on the card.
        Brightness jitter needs float frames, so raw_uint8 is for the
        deterministic (Test / serving) transforms; the native decoder
        emits normalized f32 only, so raw_uint8 decodes through PIL."""
        self.size = size
        self.mean, self.std = mean, std
        self.augment = augment
        self.shuffle_grid = shuffle_grid
        self.compress_range = compress_range
        self.raw_uint8 = raw_uint8
        assert not (raw_uint8 and augment), \
            "raw_uint8 is a serving-ingest mode; augmentation needs floats"

    def sample_params(self, rng: np.random.Generator) -> Dict:
        """Per-clip random decisions, drawn in the JAX module's order."""
        p: Dict = {}
        if self.augment:
            p["flip"] = bool(rng.random() < 0.5)
            p["brightness"] = float(rng.uniform(0.9, 1.1))
        if self.compress_range is not None:
            lo, hi = self.compress_range
            p["quality"] = int(rng.integers(lo, hi + 1))
        if self.shuffle_grid:
            p["perm_rng"] = rng
        return p

    def __call__(self, img: np.ndarray, params: Optional[Dict] = None):
        params = params or {}
        perm = None
        if "quality" in params:
            img = jpeg_compress(img, params["quality"])
        img = resize(img, self.size)
        if params.get("flip"):
            img = hflip(img)
        if self.shuffle_grid and "perm_rng" in params:
            img, perm = shuffle_patches(img, self.shuffle_grid,
                                        params["perm_rng"])
        if self.raw_uint8:
            return (img, perm) if perm is not None else img
        x = normalize(img, self.mean, self.std)
        if "brightness" in params:
            x = x * params["brightness"]
        if perm is not None:
            return x, perm
        return x


def _preset(size: int, augment_train: bool = False,
            shuffle_grid: Optional[int] = None):
    return {
        "train": Transform(size, augment=augment_train,
                           shuffle_grid=shuffle_grid),
        "val": Transform(size),
        "test": Transform(size),
    }


xception_default_data_transforms = _preset(299)
xception_default_data_transforms_256 = _preset(256)
xception_default_data_transforms_300 = _preset(300)
data_transform_aug = _preset(299, augment_train=True)
data_transforms_shuffle = _preset(299, shuffle_grid=3)

PRESETS: Dict[str, Dict[str, Transform]] = {
    "299": xception_default_data_transforms,
    "256": xception_default_data_transforms_256,
    "300": xception_default_data_transforms_300,
    "aug": data_transform_aug,
    "shuffle": data_transforms_shuffle,
}


def select_transform(name: str) -> Dict[str, Transform]:
    """The preset by its -tf name (reference train_CNN.py:154-161)."""
    if name not in PRESETS:
        raise KeyError(f"unknown transform preset '{name}'; have {sorted(PRESETS)}")
    return PRESETS[name]
