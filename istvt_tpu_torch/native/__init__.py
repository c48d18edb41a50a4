"""Native (C++) host decoders, loaded through ctypes (counterpart of
istvt_tpu/native/__init__.py; the sources are the port's own copies).

`clipdecode` - libjpeg / libpng frame decode + bilinear resize + normalize
over an internal pthread pool (clipdecode.cpp).

`videodecode` - libavformat / libavcodec container decode + face crop +
SWS_AREA resize + normalize for the raw-video front end (videodecode.cpp).

Each library is built with g++ at its first use into `build/` beside this
file (not committed). A failed build leaves the library unavailable, and
the callers decode through PIL / cv2 instead. `CLIPS` counts the clips each
frame decoder made (data/video_dataset.py adds to it), so that a run can
say which one ran.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
_SRC = os.path.join(_DIR, "clipdecode.cpp")
_SO = os.path.join(BUILD_DIR, "libclipdecode.so")
_VSRC = os.path.join(_DIR, "videodecode.cpp")
_VSO = os.path.join(BUILD_DIR, "libvideodecode.so")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_VLIB: Optional[ctypes.CDLL] = None
_VTRIED = False

# clips made by each frame decoder of VideoSeqDataset: 'clipdecode' (this
# module's library) and 'per_frame' (the dataset's frame loader, PIL)
CLIPS: Dict[str, int] = {"clipdecode": 0, "per_frame": 0}
_CLIPS_LOCK = threading.Lock()


def count_clip(decoder: str):
    """One more clip made by `decoder` (a key of CLIPS); thread-safe, as
    the loader's workers make clips at once."""
    with _CLIPS_LOCK:
        CLIPS[decoder] += 1


def reset_clips():
    with _CLIPS_LOCK:
        for k in CLIPS:
            CLIPS[k] = 0


def _build_so(src: str, so: str, libs: List[str], force: bool) -> bool:
    """g++ src -> so, written under a temporary name and moved into place,
    so that processes building at once never load a half-written file."""
    if os.path.exists(so) and not force and \
            os.path.getmtime(so) >= os.path.getmtime(src):
        return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           src, "-o", tmp] + libs + ["-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def build(force: bool = False) -> bool:
    """Compile the frame decoder. Returns whether it is there."""
    return _build_so(_SRC, _SO, ["-ljpeg", "-lpng"], force)


def build_video(force: bool = False) -> bool:
    """Compile the video decoder. Returns whether it is there."""
    return _build_so(_VSRC, _VSO,
                     ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"],
                     force)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
            lib.decode_frames.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ]
            lib.decode_frames.restype = ctypes.c_int
            _LIB = lib
        except OSError:
            _LIB = None
        return _LIB


def _load_video() -> Optional[ctypes.CDLL]:
    global _VLIB, _VTRIED
    with _LOCK:
        if _VLIB is not None or _VTRIED:
            return _VLIB
        _VTRIED = True
        if not build_video():
            return None
        try:
            lib = ctypes.CDLL(_VSO)
            c_int_p = ctypes.POINTER(ctypes.c_int)
            lib.video_probe.argtypes = [ctypes.c_char_p, c_int_p, c_int_p,
                                        c_int_p,
                                        ctypes.POINTER(ctypes.c_double)]
            lib.video_probe.restype = ctypes.c_int
            lib.video_decode_indices.argtypes = [
                ctypes.c_char_p, c_int_p, ctypes.c_int, c_int_p,
                ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float), c_int_p,
            ]
            lib.video_decode_indices.restype = ctypes.c_int
            lib.video_count_frames.argtypes = [ctypes.c_char_p]
            lib.video_count_frames.restype = ctypes.c_int
            _VLIB = lib
        except OSError:
            _VLIB = None
        return _VLIB


def available() -> bool:
    return _load() is not None


def video_available() -> bool:
    return _load_video() is not None


def decode_frames(paths: List[str], out_size: int, mean: float = 0.5,
                  std: float = 0.5, n_threads: int = 8,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode + resize + normalize frame files natively: (len(paths),
    out_size, out_size, 3) float32; a frame that fails to decode comes
    back zeroed, with a warning."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native clipdecode unavailable (build failed)")
    n = len(paths)
    if out is None:
        out = np.empty((n, out_size, out_size, 3), np.float32)
    assert out.shape == (n, out_size, out_size, 3) and \
        out.dtype == np.float32 and out.flags["C_CONTIGUOUS"]
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    ok = lib.decode_frames(
        arr, n, out_size, ctypes.c_float(mean), ctypes.c_float(std),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    if ok != n:
        warnings.warn(f"clipdecode: {n - ok}/{n} frames failed to decode")
    return out


def video_probe(path: str) -> Tuple[int, int, int, float]:
    """(n_frames, width, height, fps); n_frames -1 when the container
    carries no frame count."""
    lib = _load_video()
    if lib is None:
        raise RuntimeError("native videodecode unavailable (build failed)")
    nf, w, h = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    fps = ctypes.c_double()
    rc = lib.video_probe(path.encode(), ctypes.byref(nf), ctypes.byref(w),
                         ctypes.byref(h), ctypes.byref(fps))
    if rc < 0:
        raise IOError(f"video_probe({path}) failed rc={rc}")
    return nf.value, w.value, h.value, fps.value


def video_decode_indices(path: str, indices: np.ndarray, out_size: int,
                         crops: Optional[np.ndarray] = None,
                         mean: float = 0.5, std: float = 0.5,
                         out: Optional[np.ndarray] = None,
                         return_filled: bool = False):
    """Decode ascending presentation-order `indices` of one video.

    crops: optional (n, 4) int32 (y0, x0, h, w) source-pixel boxes applied
    before the SWS_AREA resize. -> (n, out_size, out_size, 3) f32
    (x/255 - mean)/std; indices past the end come back zeroed, and with
    return_filled=True the count of frames decoded comes too."""
    lib = _load_video()
    if lib is None:
        raise RuntimeError("native videodecode unavailable (build failed)")
    idx = np.ascontiguousarray(indices, np.int32)
    n = idx.size
    if out is None:
        out = np.empty((n, out_size, out_size, 3), np.float32)
    assert out.shape == (n, out_size, out_size, 3) and \
        out.dtype == np.float32 and out.flags["C_CONTIGUOUS"]
    c_int_p = ctypes.POINTER(ctypes.c_int)
    cr = None
    if crops is not None:
        cr = np.ascontiguousarray(crops, np.int32)
        assert cr.shape == (n, 4), cr.shape
        cr = cr.ctypes.data_as(c_int_p)
    got = lib.video_decode_indices(
        path.encode(), idx.ctypes.data_as(c_int_p), n, cr, out_size,
        ctypes.c_float(mean), ctypes.c_float(std),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), None)
    if got < 0:
        raise IOError(f"video_decode_indices({path}) failed rc={got}")
    return (out, int(got)) if return_filled else out


def video_count_frames(path: str) -> int:
    """Exact frame count by a whole native decode; -1 when the file does
    not open."""
    lib = _load_video()
    if lib is None:
        raise RuntimeError("native videodecode unavailable (build failed)")
    return lib.video_count_frames(path.encode())
