"""LayerNorm -> GEMM and GEMM + bias (+ residual)
(counterpart of istvt_tpu/kernels/linear.py).

  ln_matmul(x, s, b, w)             LayerNorm(x) @ w  (TPU: _ln_matmul_impl)
  matmul_bias_residual(x, w, b, r)  x @ w + b (+ r)   (TPU: _matmul_bias_impl)

Weights are in the JAX (in, out) layout and are cast to x's dtype; the
products accumulate in f32 and the f32 epilogue rounds once to x's dtype,
in the JAX order. A CUDA tensor runs the hand-written kernels of
csrc/float_gemm.cu (LN rows, then the GEMM with its fused epilogue); a CPU
tensor runs the plain version beside each wrapper.
"""
from __future__ import annotations

import torch

from istvt_tpu_torch.kernels import _lib

_EPS = 1e-5


def _ln(xf, scale, bias):
    """f32 LayerNorm, two-pass variance, eps 1e-5 (kernels/linear._ln).

    The two statistics are summed in float64 and rounded to f32, and the
    reciprocal is 1 / sqrt (both IEEE), so this version and the CUDA
    kernels (csrc/common.cuh row_ln_stats) get the same f32 values whatever
    their summation order: a last-ulp difference here would flip int8
    codes downstream on the int8 path."""
    mean = xf.double().mean(dim=-1, keepdim=True).float()
    xc = xf - mean
    var = (xc * xc).double().mean(dim=-1, keepdim=True).float()
    return xc * (1.0 / torch.sqrt(var + _EPS)) * scale + bias


def ln_matmul_plain(x, s, b, w):
    """Plain version of ln_matmul (_ln_matmul_reference)."""
    dt = x.dtype
    y = _ln(x.float(), s.float(), b.float()).to(dt)
    return (y.float() @ w.to(dt).float()).to(dt)


def matmul_bias_residual_plain(x, w, b, r=None):
    """Plain version of matmul_bias_residual (_matmul_bias_reference)."""
    dt = x.dtype
    o = x.float() @ w.to(dt).float() + b.to(dt).float()
    if r is not None:
        o = o + r.float()
    return o.to(dt)


def ln_matmul(x, s, b, w):
    """LayerNorm(x) @ w: x (..., N, D), w (D, K) -> (..., N, K) in x.dtype.
    CPU tensors take the plain version."""
    if not x.is_cuda:
        return ln_matmul_plain(x, s, b, w)
    lead, d = x.shape[:-1], x.shape[-1]
    _lib.check_act(x, "x")
    y = ln_rows(x.reshape(-1, d), _lib.f32(s), _lib.f32(b))
    out = torch.empty(lead + (w.shape[1],), dtype=x.dtype, device=x.device)
    gemm(y, w, None, None, out, gelu=False)
    _lib.LAUNCHES["ln_matmul"] += 1
    return out


def matmul_bias_residual(x, w, b, r=None):
    """x @ w + b (+ r): x (..., N, D), w (D, K), b (K,), r (..., N, K) or
    None -> (..., N, K) in x.dtype. CPU tensors take the plain version."""
    if not x.is_cuda:
        return matmul_bias_residual_plain(x, w, b, r)
    lead, k = x.shape[:-1], w.shape[1]
    _lib.check_act(x, "x")
    if r is not None:
        _lib.check_act(r, "r")
        if r.dtype != x.dtype or r.shape != lead + (k,):
            raise ValueError(f"residual {tuple(r.shape)} {r.dtype} does not "
                             f"match x {tuple(x.shape)} {x.dtype}, K={k}")
    out = torch.empty(lead + (k,), dtype=x.dtype, device=x.device)
    gemm(x.reshape(-1, x.shape[-1]), w, _lib.f32(b.to(x.dtype)), r, out,
         gelu=False)
    _lib.LAUNCHES["matmul_bias_residual" if r is not None
                  else "matmul_bias_residual/no_r"] += 1
    return out


# ---------------------------------------------------------------------------
# launch plumbing, shared with kernels/mlp.py (counts nothing)


def ln_rows(x, s32, b32):
    """LayerNorm of the rows of a CUDA (R, D) x into x's dtype."""
    rows, d = x.shape
    y = torch.empty_like(x)
    _lib.check(_lib.load().istvt_ln_rows(
        x.data_ptr(), _lib.DTYPE_CODE[x.dtype], s32.data_ptr(),
        b32.data_ptr(), y.data_ptr(), rows, d, _lib.stream()), "ln_rows")
    return y


def gemm(a, w, bias32, res, out, gelu: bool):
    """out = epilogue(a (M, K) @ w (K, N)) on the card: f32 accumulation,
    + bias32 (f32), tanh-GELU, + res, cast to out's dtype (= a's)."""
    m, k = a.shape
    w = w.to(a.dtype).contiguous()
    if w.shape[0] != k or k % 8 or w.shape[1] % 8:
        raise ValueError(f"GEMM takes a (M, K) @ w (K, N) with K and N "
                         f"divisible by 8 (got {tuple(a.shape)} @ "
                         f"{tuple(w.shape)})")
    if not w.is_cuda or w.data_ptr() % 16:
        raise ValueError("GEMM weights must be 16-byte aligned CUDA tensors")
    _lib.check(_lib.load().istvt_gemm(
        a.data_ptr(), w.data_ptr(), _lib.DTYPE_CODE[a.dtype],
        _lib.ptr(bias32), _lib.ptr(res), out.data_ptr(), int(gelu), m,
        w.shape[1], k, _lib.stream()), "gemm")
