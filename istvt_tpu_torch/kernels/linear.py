"""LayerNorm -> GEMM and GEMM + bias (+ residual), forward and backward
(counterpart of istvt_tpu/kernels/linear.py).

  ln_matmul(x, s, b, w)             LayerNorm(x) @ w  (TPU: _ln_matmul_impl;
                                    backward _ln_matmul_bwd_impl)
  matmul_bias_residual(x, w, b, r)  x @ w + b (+ r)   (TPU: _matmul_bias_impl;
                                    backward plain math, as in JAX)

Weights are in the JAX (in, out) layout and are cast to x's dtype; the
products accumulate in f32 and the f32 epilogue rounds once to x's dtype,
in the JAX order. A CUDA tensor runs the hand-written kernels of
csrc/float_gemm.cu (LN rows, the GEMM with its fused epilogue, and for the
backward the LN-backward rows and column sums); a CPU tensor runs the
plain version beside each wrapper. Each forward is a dispatcher op
(kernels/ops.py, istvt::<wrapper name>) that chooses so by the device of
its tensors. Where autograd records the call, both wrappers are
torch.autograd.Functions whose forward calls the same op and whose
backward runs the same way.
The GEMM runs bf16 inputs on the bf16 tensor cores and f32 inputs as three
TF32 products on them (split_tf32), within f32's rounding of the plain
f32 product.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.utils.debug import check_outputs

# the dispatcher ops of kernels/ops.py (resolved at call time; the package's
# __init__ registers them)
_ops = torch.ops.istvt

_EPS = 1e-5


def _ln_stats(xf):
    """(xhat, rstd) of f32 rows, two-pass variance, eps 1e-5
    (kernels/linear._ln_stats).

    The two statistics are summed in float64 and rounded to f32, and the
    reciprocal is 1 / sqrt (both IEEE), so this version and the CUDA
    kernels (csrc/common.cuh row_ln_stats) get the same f32 values whatever
    their summation order: a last-ulp difference here would flip int8
    codes downstream on the int8 path."""
    mean = xf.double().mean(dim=-1, keepdim=True).float()
    xc = xf - mean
    var = (xc * xc).double().mean(dim=-1, keepdim=True).float()
    rstd = 1.0 / torch.sqrt(var + _EPS)
    return xc * rstd, rstd


def _ln(xf, scale, bias):
    """f32 LayerNorm (kernels/linear._ln): xhat * scale + bias."""
    return _ln_stats(xf)[0] * scale + bias


def _ln_bwd_rows(dy, xhat, s, rstd):
    """LayerNorm input-grad for row-local stats, f32 (_ln_bwd_rows)."""
    dxhat = dy * s
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * rstd


def ln_matmul_plain(x, s, b, w):
    """Plain version of ln_matmul (_ln_matmul_reference)."""
    dt = x.dtype
    y = _ln(x.float(), s.float(), b.float()).to(dt)
    return (y.float() @ w.to(dt).float()).to(dt)


def ln_matmul_bwd_plain(x, s, b, w, g):
    """Plain version of ln_matmul_bwd (the math of _ln_matmul_bwd_kernel):
    x (R, D), w (D, K) in x's dtype, g (R, K) -> dx (R, D) in x's dtype,
    ds, db (D,) and dw (D, K) in f32. dy = g w^T stays f32."""
    dt = x.dtype
    xhat, rstd = _ln_stats(x.float())
    sf = s.float()
    y = (xhat * sf + b.float()).to(dt)
    dy = g.float() @ w.to(dt).float().t()
    dx = _ln_bwd_rows(dy, xhat, sf, rstd).to(dt)
    return (dx, (dy * xhat).sum(0), dy.sum(0), y.float().t() @ g.float())


def matmul_bias_residual_plain(x, w, b, r=None):
    """Plain version of matmul_bias_residual (_matmul_bias_reference)."""
    dt = x.dtype
    o = x.float() @ w.to(dt).float() + b.to(dt).float()
    if r is not None:
        o = o + r.float()
    return o.to(dt)


# ---------------------------------------------------------------------------
# kernel wrappers (count their launches)


def _ln_matmul_cuda(x, s, b, w):
    """#18 on the card (its op's CUDA implementation)."""
    lead, d = x.shape[:-1], x.shape[-1]
    _lib.check_act(x, "x")
    y = ln_rows(x.reshape(-1, d), _lib.f32(s), _lib.f32(b))
    out = torch.empty(lead + (w.shape[1],), dtype=x.dtype, device=x.device)
    gemm(y, w, out)
    _lib.LAUNCHES["ln_matmul"] += 1
    return out


def ln_matmul_bwd(x, s, b, w, g):
    """The backward of LayerNorm(x) @ w (#19): x (R, D), w (D, K), g (R, K)
    -> dx (R, D) in x.dtype; ds, db (D,), dw (D, K) in f32. CPU tensors
    take the plain version."""
    if not x.is_cuda:
        return ln_matmul_bwd_plain(x, s, b, w, g)
    _lib.check_act(x, "x")
    _lib.check_act(g, "g")
    w = w.to(x.dtype).contiguous()
    s32 = _lib.f32(s)
    y = ln_rows(x, s32, _lib.f32(b))
    dy = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    gemm(g, w, dy, layout="nt")
    dx, (ds, db) = ln_bwd(x, s32, dy)
    dw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
    gemm(y, g, dw, layout="tn")
    _lib.LAUNCHES["ln_matmul/bwd"] += 1
    check_outputs("ln_matmul/bwd", dx, ds, db, dw)
    return dx, ds, db, dw


class _LnMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, b, w):
        ctx.save_for_backward(x, s, b, w)
        return _ops.ln_matmul(x, s, b, w)

    @staticmethod
    def backward(ctx, g):
        x, s, b, w = ctx.saved_tensors
        d = x.shape[-1]
        dx, ds, db, dw = ln_matmul_bwd(x.reshape(-1, d), s, b,
                                       w.to(x.dtype),
                                       g.reshape(-1, g.shape[-1]).contiguous())
        return (dx.reshape(x.shape), ds.to(s.dtype), db.to(b.dtype),
                dw.to(w.dtype))


def ln_matmul(x, s, b, w):
    """LayerNorm(x) @ w: x (..., N, D), w (D, K) -> (..., N, K) in x.dtype.
    CPU tensors take the plain version. Differentiable (backward #19)."""
    if _lib.needs_grad(x, s, b, w):
        return _LnMatmul.apply(x, s, b, w)
    return _ops.ln_matmul(x, s, b, w)


def _matmul_bias_residual_cuda(x, w, b, r):
    """#20 on the card (its op's CUDA implementation), counted with or
    without r."""
    lead, k = x.shape[:-1], w.shape[1]
    _lib.check_act(x, "x")
    if r is not None:
        _lib.check_act(r, "r")
        if r.dtype != x.dtype or r.shape != lead + (k,):
            raise ValueError(f"residual {tuple(r.shape)} {r.dtype} does not "
                             f"match x {tuple(x.shape)} {x.dtype}, K={k}")
    out = torch.empty(lead + (k,), dtype=x.dtype, device=x.device)
    gemm(x.reshape(-1, x.shape[-1]), w, out, bias32=_lib.f32(b.to(x.dtype)),
         res=r)
    _lib.LAUNCHES["matmul_bias_residual" if r is not None
                  else "matmul_bias_residual/no_r"] += 1
    return out


def _matmul_bias_residual_bwd(x, w, g):
    """(dx, dw) of x @ w for the flat x (R, D), w (D, K), g (R, K):
    jax.vjp of _matmul_bias_reference, a dot with f32 accumulation, so
    dx = g w^T rounded once to x's dtype and dw = x^T g in f32. No TPU
    kernel: on the card the same GEMM launches run it (counted nowhere)."""
    w = w.to(x.dtype)
    if not x.is_cuda:
        return ((g.float() @ w.float().t()).to(x.dtype),
                x.float().t() @ g.float())
    dx = torch.empty_like(x)
    gemm(g, w.contiguous(), dx, layout="nt")
    dw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
    gemm(x, g, dw, layout="tn")
    return dx, dw


class _MatmulBiasResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, r):
        ctx.save_for_backward(x, w, b)
        ctx.has_r = r is not None
        return _ops.matmul_bias_residual(x, w, b, r)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        gf = g.reshape(-1, g.shape[-1]).contiguous()
        dx, dw = _matmul_bias_residual_bwd(x.reshape(-1, x.shape[-1]), w, gf)
        db = gf.sum(0, dtype=torch.float32)
        return (dx.reshape(x.shape), dw.to(w.dtype), db.to(b.dtype),
                g if ctx.has_r else None)


def matmul_bias_residual(x, w, b, r=None):
    """x @ w + b (+ r): x (..., N, D), w (D, K), b (K,), r (..., N, K) or
    None -> (..., N, K) in x.dtype. CPU tensors take the plain version.
    Differentiable (backward in plain math, as JAX's _mbr_bwd)."""
    if _lib.needs_grad(x, w, b, r):
        return _MatmulBiasResidual.apply(x, w, b, r)
    return _ops.matmul_bias_residual(x, w, b, r)


# ---------------------------------------------------------------------------
# launch plumbing, shared with kernels/mlp.py (counts nothing)

_LAYOUT = {"nn": 0, "nt": 1, "tn": 2}


def ln_rows(x, s32, b32):
    """LayerNorm of the rows of a CUDA (R, D) x into x's dtype."""
    rows, d = x.shape
    y = torch.empty_like(x)
    _lib.check(_lib.load().istvt_ln_rows(
        x.data_ptr(), _lib.DTYPE_CODE[x.dtype], s32.data_ptr(),
        b32.data_ptr(), y.data_ptr(), rows, d, _lib.stream()), "ln_rows")
    return y


def gemm(a, b, out, *, layout: str = "nn", bias32=None, res=None,
         gelu: bool = False, out2=None, aux=None, part=None):
    """out (M, N) = epilogue(A @ B) on the card, f32 accumulation.

    layout 'nn': a (M, K), b (K, N) (b is cast to a's dtype: the weight);
    'nt': a (M, K), b (N, K), out = a @ b^T; 'tn': a (K, M), b (K, N),
    out = a^T @ b. out in a's dtype, or f32 (bf16 inputs: weight
    gradients, f32 intermediates). Epilogue: + bias32 (f32), the
    pre-activation into out2, tanh-GELU, + res; or, with aux (the pre-GELU
    hidden; layout 'nt', out in a's dtype), out = acc * gelu'(aux),
    gelu(aux) into out2 and the per-block column sums of the f32 result
    into part, (ceil(M / gemm_row_tile), N) f32. A 'tn' product into f32
    without epilogue (a weight gradient) is split along K as plan_splitk
    says, its partials in a scratch tensor made here. f32 inputs run as
    three TF32 products (split_tf32), B's two planes in a scratch tensor
    made here. The split holds for finite inputs: an input that is +-inf,
    or within 2^-12 of the largest f32 (its hi rounds to inf), has lo = inf
    - inf = NaN, so every output it reaches is NaN where the plain f32
    product gives +-inf (or, near the largest f32, a finite value); NaN
    inputs give NaN as the plain product does."""
    code = _LAYOUT[layout]
    b = b.to(a.dtype).contiguous()
    if layout == "tn":
        (k, m), n = a.shape, b.shape[1]
        ok = b.shape[0] == k and m % 8 == 0 and n % 8 == 0
    elif layout == "nt":
        (m, k), n = a.shape, b.shape[0]
        ok = b.shape[1] == k and k % 8 == 0
    else:
        (m, k), n = a.shape, b.shape[1]
        ok = b.shape[0] == k and k % 8 == 0 and n % 8 == 0
    if not ok:
        raise ValueError(f"GEMM {layout} takes operands whose contiguous "
                         f"extents are divisible by 8 (got {tuple(a.shape)}, "
                         f"{tuple(b.shape)})")
    if out.numel() != m * n or not out.is_contiguous():
        raise ValueError(f"GEMM output {tuple(out.shape)}, want ({m}, {n}) "
                         f"contiguous")
    for t in (a, b, bias32, res, out, out2, aux, part):
        if t is not None and (not t.is_cuda or t.data_ptr() % 16):
            raise ValueError("GEMM operands must be 16-byte aligned CUDA "
                             "tensors")
    out_f32 = out.dtype == torch.float32
    if not out_f32 and out.dtype != a.dtype:
        raise TypeError(f"GEMM output {out.dtype} for {a.dtype} inputs")
    splits, kslice, ws, planes = 1, 0, None, None
    if (layout == "tn" and out_f32 and bias32 is None and res is None
            and not gelu and out2 is None and aux is None):
        plan = plan_splitk(m, n, k, _sm_count(a.device.index), a.dtype)
        if plan.splits > 1:
            splits, kslice = plan.splits, plan.kslice
            ws = torch.empty(plan.part_shape, dtype=torch.float32,
                             device=a.device)
    if a.dtype == torch.float32:
        planes = torch.empty(tf32_planes_shape(n, k), dtype=torch.float32,
                             device=a.device)
    _lib.check(_lib.load().istvt_gemm(
        a.data_ptr(), b.data_ptr(), _lib.DTYPE_CODE[a.dtype], code,
        out.data_ptr(), int(out_f32), _lib.ptr(bias32), _lib.ptr(res),
        int(gelu), _lib.ptr(out2), _lib.ptr(aux), _lib.ptr(part),
        int(aux is not None), m, n, k, splits, kslice, _lib.ptr(ws),
        _lib.ptr(planes), _lib.stream()), "gemm")


def split_tf32(x):
    """(hi, lo) of f32 x as the f32 GEMM splits each input (csrc/wgmma.cuh
    tf32_rna, cvt.rna.tf32.f32): hi = x rounded to TF32, 10 mantissa bits,
    to nearest with ties away from zero (the low 13 bits zero), and lo =
    x - hi rounded the same way, so that hi + lo is x to 2^-22 of |x|. For
    finite x: adding half of the dropped unit to the magnitude's bits
    carries into the exponent where it should."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def tf32_planes_shape(n: int, k: int) -> Tuple[int, int, int]:
    """The f32 GEMM's B planes, (2, N, kp): hi then lo, K-major, each row
    padded to a multiple of 4 elements (16 bytes, TMA's row stride)."""
    return 2, n, _cdiv(k, 4) * 4


# The wgmma GEMMs' output tile (csrc/float_gemm.cu kBM, kBN) and the depth of
# one k-step by input dtype (kBK: 64 bf16; kFK: 32 f32, one 128-byte row).
GEMM_TILES = {torch.bfloat16: (128, 128, 64), torch.float32: (128, 128, 32)}
# The planner's model of the persistent GEMM (one block an SM, taking the
# tiles in turn): the time of one k-step of a tile by input dtype, a tile's
# fill and epilogue in k-steps, and the card's memory rate for the f32
# partials. The H100 measured 0.55 us a bf16 k-step where both operands are
# aligned (PERF.md); with that figure the model's dW shapes get the same
# splits, or (#23's at 2 clips) one more. An f32 k-step is half as deep but
# three TF32 products at half the bf16 rate: three bf16 k-steps' work.
_KSTEP_S = {torch.bfloat16: 0.43e-6, torch.float32: 3 * 0.43e-6}
_BLOCK_KSTEPS = 6
_HBM_BPS = 3.35e12
_MAX_SPLITS = 16


class SplitK(NamedTuple):
    """A split-K plan of one (M, N, K) GEMM: `splits` slices of `kslice`
    k-tiles (the last one shorter); `bounds` the K rows [begin, end) of each
    slice in order; `part_shape` the f32 partials, (splits, M, N)."""
    splits: int
    kslice: int
    bounds: Tuple[Tuple[int, int], ...]
    part_shape: Tuple[int, int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_splitk(m: int, n: int, k: int, sms: int,
                dtype=torch.bfloat16) -> SplitK:
    """How to split a weight-gradient GEMM (M, N) over K rows between `sms`
    SMs, for inputs of `dtype` (its k-step, GEMM_TILES): the number of
    slices whose modelled time is least, where a launch takes one tile
    time per wave (tiles / sms, rounded up; a tile's time its k-steps plus
    its fill and epilogue) and every slice beyond one also writes and reads
    an f32 (M, N) partial. So a grid under a wave (72 tiles of 128 x 128
    for the 728 x 1536 dW on 132 SMs), or a second wave of a few tiles (138
    for 728 x 2912), is split until the waves are nearly full, as long as
    the partials cost less than the time saved."""
    bm, bn, bk = GEMM_TILES[dtype]
    tiles, ksteps = _cdiv(m, bm) * _cdiv(n, bn), _cdiv(k, bk)
    part_ksteps = 8 * m * n / _HBM_BPS / _KSTEP_S[dtype]   # one partial
    best = None
    for want in range(1, min(_MAX_SPLITS, max(ksteps, 1)) + 1):
        kslice = _cdiv(ksteps, want)
        splits = _cdiv(ksteps, kslice) if ksteps else 1
        cost = (_cdiv(tiles * splits, sms) * (kslice + _BLOCK_KSTEPS)
                + (splits > 1) * splits * part_ksteps)
        if best is None or cost < best[0]:
            best = (cost, splits, kslice)
    _, splits, kslice = best
    bounds = tuple((z * kslice * bk, min(k, (z + 1) * kslice * bk))
                   for z in range(splits))
    return SplitK(splits, kslice, bounds, (splits, m, n))


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(
        torch.cuda.current_device() if index is None else index
    ).multi_processor_count


def gemm_row_tile(dtype) -> int:
    """Rows per block of the GEMM (GEMM_TILES[dtype][0], 128 for both input
    dtypes): the row count of a column-sum partial."""
    return GEMM_TILES[dtype][0]


def colsum(part):
    """(nout, P, N) or (P, N) f32 partials -> their sums over P, in order."""
    p3 = part.reshape((-1,) + part.shape[-2:])
    nout, p, n = p3.shape
    out = torch.empty((nout, n), dtype=torch.float32, device=part.device)
    _lib.check(_lib.load().istvt_colsum(p3.data_ptr(), nout, p, n,
                                        out.data_ptr(), _lib.stream()),
               "colsum")
    return out.reshape(part.shape[:-2] + (n,))


_LN_BWD_BLOCKS = 256


def ln_bwd(x, s32, dy, res=None):
    """LayerNorm backward rows on the card: x (R, D) in its dtype, dy (R, D)
    f32 -> dx (+ res) in x's dtype, and the column sums (dy * xhat, dy
    [, res]) in f32."""
    rows, d = x.shape
    if d > 1024:
        raise NotImplementedError(f"LayerNorm backward takes D <= 1024 "
                                  f"(got {d})")
    blocks = max(1, min((rows + 7) // 8, _LN_BWD_BLOCKS))
    nout = 2 if res is None else 3
    part = torch.empty((nout, blocks, d), dtype=torch.float32,
                       device=x.device)
    dx = torch.empty_like(x)
    _lib.check(_lib.load().istvt_ln_bwd_rows(
        x.data_ptr(), _lib.DTYPE_CODE[x.dtype], s32.data_ptr(),
        dy.data_ptr(), _lib.ptr(res), dx.data_ptr(), part.data_ptr(), rows,
        d, blocks, _lib.stream()), "ln_bwd_rows")
    return dx, colsum(part)
