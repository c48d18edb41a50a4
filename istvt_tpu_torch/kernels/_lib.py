"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

At first use, nvcc compiles every source under csrc/ for sm_90a into one
shared library with a plain C interface under kernels/build/ (listed in
.gitignore), and ctypes loads it. Nothing is built or imported when this
module is imported: the CPU tests import every module and never build.
A failed build raises; there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
LIB_PATH = BUILD_DIR / "libistvt_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each wrapper's CUDA kernels, by wrapper name (and variant);
# the wrapper adds one where it launches and nowhere else (the plain path
# never counts).
LAUNCHES: Dict[str, int] = dict.fromkeys([
    "ln_qkv_q8_temporal_attention",        # kernels/quant.py
    "mm_q8_ln_qkv_q8_spatial_attention",
    "matmul_q8_res_ln_ff_q8_full",
    "temporal_attention_packed",           # kernels/attention.py
    "spatial_attention_packed",
    "ln_matmul",                           # kernels/linear.py
    "matmul_bias_residual",                # with a residual
    "matmul_bias_residual/no_r",           # r=None
    "ln_ff_residual",                      # kernels/mlp.py
], 0)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, x_dt, s, b, y, R, D, stream
    "istvt_ln_rows": [_P, _I, _P, _P, _P, _I, _I, _P],
    # a, w, dt, bias, res, out, gelu, M, N, K, stream
    "istvt_gemm": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, x_dt, s, b, q, rs, R, D, stream
    "istvt_ln_quant_rows": [_P, _I, _P, _P, _P, _P, _I, _I, _P],
    # x, x_dt, q, rs, R, D, stream
    "istvt_quant_rows": [_P, _I, _P, _P, _I, _I, _P],
    # a, w, rs, ws, bias, res, res_dt, out, out_dt, gelu, M, N, K, stream
    "istvt_gemm_q8": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    # qkv, out, dt, B, T1, S, H, inner, scale, stream
    "istvt_temporal_attn": [_P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # qkv, out, dt, G, S, H, inner, n_valid, scale, stream
    "istvt_spatial_attn": [_P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the istvt_tpu_torch "
                       "CUDA kernels are built from csrc/ at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built
               for p in list(_sources()) + list(CSRC.glob("*.cuh")))


def build(force: bool = False) -> Path:
    """Compile csrc/*.cu into LIB_PATH (if stale). Returns the path; the
    compiler's output, ptxas register/shared-memory report included, is
    kept in build/build.log."""
    if not force and not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{LIB_PATH.stem}.{os.getpid()}.so"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
           "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load():
    """The bound library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, what: str):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def ptr(t) -> int:
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def f32(t):
    return t.to(torch.float32).contiguous()


def check_act(t, name):
    """Raise unless `t` is an activation the kernels take: float32 or
    bfloat16, contiguous, 16-byte aligned."""
    if t.dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: activation dtype {t.dtype} (kernels take "
                        f"float32 or bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernels take contiguous tensors")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
