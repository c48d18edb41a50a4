"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

At first use, nvcc compiles every source under csrc/ for sm_90a (one
compiler per source, all at once) and links them into one shared library
with a plain C interface under kernels/build/ (listed in .gitignore), and
ctypes loads it. Nothing is built or imported when this
module is imported: the CPU tests import every module and never build.
A failed build raises; there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import os
import re
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
    # the int8 A/B modes (q8_attn='boundary', q8_ff='mixed' / 'bf16')
    "ln_matmul_q8",                        # kernels/quant.py
    "matmul_q8_ln_matmul_q8",
    "matmul_q8_bias_residual",             # with a residual
    "matmul_q8_bias_residual/no_r",        # r=None
    "ln_ff_residual_q8",
    # the last int8 modes (q8_attn='layer'; q8_ff outside full/mixed/bf16)
    "st_layer_q8",                         # kernels/quant.py
    "ln_ff_residual_q8_full",
    "temporal_attention_packed",           # kernels/attention.py
    "spatial_attention_packed",
    "ln_matmul",                           # kernels/linear.py
    "matmul_bias_residual",                # with a residual
    "matmul_bias_residual/no_r",           # r=None
    "ln_ff_residual",                      # kernels/mlp.py
    # the training slice: backward kernels and the h1-stash forward
    "temporal_attention_packed/bwd",       # kernels/attention.py
    "spatial_attention_packed/bwd",
    "ln_matmul/bwd",                       # kernels/linear.py
    "ln_ff_residual/h1",                   # kernels/mlp.py
    "ln_ff_residual/bwd",
    # the attention-map path
    "fused_ff",                            # kernels/mlp.py
    # the kernel API (istvt_tpu_torch.kernels, kernels/conv.py): on no
    # model path, as in the JAX package
    "fused_frame_attention",               # kernels/attention.py
    "fused_frame_attention_mh",
    "fused_frame_attention_bwd",           # the unpacked entry of #13
    "fused_temporal_attention",
    "fused_temporal_attention_bwd",
    "sepconv_bn",                          # kernels/conv.py
], 0)


# K-major int8 weight copies (kernels/quant.kmajor) that an int8 wrapper
# built on the card within a call, for want of the prebuilt ones a model
# holds; a model path builds none.
KMAJOR_BUILDS: Dict[str, int] = {"q8_kmajor": 0}


def reset_launches():
    """Zero every launch counter, and KMAJOR_BUILDS."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    KMAJOR_BUILDS["q8_kmajor"] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, x_dt, s, b, y, R, D, stream
    "istvt_ln_rows": [_P, _I, _P, _P, _P, _I, _I, _P],
    # a, b, dt, layout, out, out_f32, bias, res, gelu, out2, aux, part, mode,
    # M, N, K, splits, kslice, ws, planes, stream
    "istvt_gemm": [_P, _P, _I, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                   _I, _I, _I, _P, _P, _P],
    # x, dt, s, dy, res, dx, part, R, D, blocks, stream
    "istvt_ln_bwd_rows": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # part, nout, P, N, out, stream
    "istvt_colsum": [_P, _I, _I, _I, _P, _P],
    # x, x_dt, s, b, q, ldq, rs, R, D, stream
    "istvt_ln_quant_rows": [_P, _I, _P, _P, _P, _I, _P, _I, _I, _P],
    # x, x_dt, q, ldq, rs, R, D, stream
    "istvt_quant_rows": [_P, _I, _P, _I, _P, _I, _I, _P],
    # a, lda, w (K-major), ldw, rs, ws, bias, res, res_dt, out, out_dt, gelu,
    # M, N, K, stream
    "istvt_gemm_q8": [_P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                      _I, _P],
    # ptrs (host array of 30 pointers), dt, B, T1, S, D, H, inner, hid,
    # n_valid, scale, stamps (or null), stream
    "istvt_st_layer_q8": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          ctypes.c_float, _P, _P],
    # qkv, out, dt, B, T1, S, H, inner, scale, vec, lanes, chunks, scratch
    # (or null), stream
    "istvt_temporal_attn": [_P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                            _I, _I, _I, _P, _P],
    # dt, backward, B, T1, S, H, vec, lanes, chunks, bytes (out)
    "istvt_temporal_scratch": [_I, _I, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.POINTER(ctypes.c_longlong)],
    # qkv, out, dt, G, S, H, inner, n_valid, scale, stream
    "istvt_spatial_attn": [_P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # qkv, dout, dqkv, dt, B, T1, S, H, inner, scale, vec, lanes, chunks,
    # scratch (or null), stream
    "istvt_temporal_attn_bwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                ctypes.c_float, _I, _I, _I, _P, _P],
    # qkv, dout, dqkv, stats, dt, G, S, H, inner, n_valid, scale, stream
    "istvt_spatial_attn_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P],
    # q, k, v, out, dt, G, S, H, inner, scale, stream
    "istvt_frame_attn": [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
                         _P],
    # q, k, v, dout, dq, dk, dv, stats, dt, G, S, H, inner, n_valid, scale,
    # stream
    "istvt_frame_attn_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, ctypes.c_float, _P],
    # q, k, v, out, dt, B, T1, S, H, dh, scale, stream
    "istvt_temporal_unpacked": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                ctypes.c_float, _P],
    # q, k, v, dout, dq, dk, dv, dt, B, T1, S, H, dh, scale, stream
    "istvt_temporal_unpacked_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, ctypes.c_float, _P],
    # x, dw, pw, a, b, out, dt, N, H, W, Cin, Cout, relu_in, th, tw,
    # per_split, kc, smem (kernels/conv._sepconv_plan), stream
    "istvt_sepconv_bn": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _P],
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
    """Compile csrc/*.cu into LIB_PATH (if stale): one nvcc per source, all
    started together, then one link. Returns the path; the compilers'
    output, ptxas register/shared-memory report included, is kept in
    build/build.log."""
    if not force and not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f".{src.stem}.{tag}.o"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-lineinfo", "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-4000:]}")
    objs = [obj for _, obj, _ in jobs]
    if not failed:
        tmp = BUILD_DIR / f".{LIB_PATH.stem}.{tag}.so"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


# SASS opcodes of the tensor cores' float products: HMMA (mma.sync) and HGMMA
# (wgmma, bf16 or TF32); the int8 ones, IMMA (mma.sync) and IGMMA (wgmma), are
# not among them
TENSOR_OPS = ("HMMA.", "HGMMA.")


def tensor_ops_of_sass(sass: str, ops=TENSOR_OPS) -> Dict[str, int]:
    """{kernel function (mangled name): its instructions of the opcodes
    `ops`} in `cuobjdump -sass` output: each op a literal substring of the
    line or a compiled regular expression searched in it (by default every
    bf16 or TF32 tensor-core product, HMMA and HGMMA; ("HGMMA.",) counts
    wgmma alone, (selfcheck.TF32_WGMMA_OP,) its TF32 form)."""
    counts: Dict[str, int] = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts.setdefault(fn, 0)
        elif fn is not None and any(
                op in line if isinstance(op, str) else op.search(line)
                for op in ops):
            counts[fn] += 1
    return counts


def sass_text(lib: Path = LIB_PATH) -> str:
    """`cuobjdump -sass` of the built library (cuobjdump beside nvcc)."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """{function (mangled name): {"registers", "stack_frame",
    "spill_stores", "spill_loads"}} from nvcc's `-Xptxas -v` report
    (build/build.log): each kernel's registers, its bytes of local-memory
    stack frame, and the bytes it spills there and loads back; a
    non-inlined device function has no "registers"."""
    out: Dict[str, Dict[str, int]] = {}
    entry = props = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props is not None:
            out.setdefault(props, {}).update(stack_frame=int(m.group(1)),
                                             spill_stores=int(m.group(2)),
                                             spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


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


def needs_grad(*tensors) -> bool:
    """True where autograd records this call: grad mode is on and an input
    requires grad. Wrappers with a backward kernel go through their
    autograd.Function only then, so serving runs the plain forward."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


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
