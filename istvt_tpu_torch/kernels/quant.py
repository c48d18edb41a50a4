"""Int8 W8A8 serving kernels (counterpart of istvt_tpu/kernels/quant.py).

Scheme (identical to the JAX package, so the ports agree bit for bit on
the quantization points):
  * weights - per-OUTPUT-column symmetric int8, scale = max|w[:, j]| / 127
    (floored at 1e-12), quantized once at load time (quantize_weight);
  * activations - per-ROW symmetric int8, scale = max(amax, 1e-6) / 127,
    computed on the fly; values round half to even and clip to +-127;
  * GEMM - int8 x int8 -> int32, epilogue acc * row_scale * col_scale
    (+ bias, + residual) in f32.

Nine kernels, one wrapper each, serve the int8 modes that
istvt_tpu/models/istvt.py:258-356 chooses among (ISTVTConfig.q8_ff and
q8_attn); #n is the kernel's row in PERF.md's table of the TPU kernels
(#1-#3 are ingest's, in the order below):

  q8_ff='full', q8_attn='ingest' (the default; three a layer)
    ln_qkv_q8_temporal_attention        LN -> W8A8 QKV -> temporal core
    mm_q8_ln_qkv_q8_spatial_attention   W8A8 + b -> LN -> W8A8 QKV ->
                                        spatial core
    matmul_q8_res_ln_ff_q8_full         W8A8 + b + r -> LN -> int8 FF
  q8_ff='full', q8_attn='layer' (one a layer)
    st_layer_q8                         the whole ST layer in one
                                        persistent kernel     (TPU #9)
  q8_ff='full', any other q8_attn ('boundary'; the packed attention
  cores between)
    ln_matmul_q8                        LN -> W8A8            (TPU #4)
    matmul_q8_ln_matmul_q8              W8A8 + b -> LN -> W8A8 (TPU #8)
    matmul_q8_res_ln_ff_q8_full
  any other q8_ff (nn/attention.temporal_block_q8 and spatial_block_q8,
  then the FF)
    ln_matmul_q8
    matmul_q8_bias_residual             W8A8 + b [+ r]        (TPU #5)
    then by q8_ff:
    'mixed'  ln_ff_residual_q8          LN -> int8 fc1 -> GELU -> fc2 in
                                        x's dtype + b2 + x    (TPU #6)
    'bf16'   kernels/mlp's ln_ff_residual
    other    ln_ff_residual_q8_full     LN -> int8 fc1 -> GELU -> int8
                                        fc2 + b2 + x          (TPU #7)

Each wrapper calls its dispatcher op istvt::<wrapper name> (kernels/ops.py),
which chooses by the device of its tensors: for CUDA tensors the op's CUDA
implementation (`_<name>_cuda` here) checks its operands, launches the
hand-written CUDA kernels in csrc/ (built at first use, kernels/_lib.py)
and counts one launch in _lib.LAUNCHES under the wrapper's name however
many CUDA launches it makes; for CPU tensors the op runs the plain PyTorch
version beside the wrapper. There is no fallback from one to the other: a
CUDA tensor that the kernel cannot take raises. Since the kernels are
ops, a torch.export program of a model holds them, and a loaded program
launches (and counts) them as the live model does (serve_export.py).

Every wrapper runs its GEMMs on the int8 wgmma GEMM (csrc/q8_rows_gemm.cu,
gemm_q8 below; #9 the same device code inside its one launch), which reads
each weight as a K-major copy (kmajor(wq): the (K, N) codes transposed to
(N, Kp), Kp = K rounded up to 16, no code changed) and the activation
codes with rows Kp bytes apart. The model builds the copies once, when it is quantized or
loaded (models/istvt.py), and passes them as the wrappers' last argument
`wk` (one per int8 weight argument, in their order); a wrapper given none
builds them on the card in the call (counted in _lib.KMAJOR_BUILDS). The
plain versions read the (K, N) codes and ignore `wk`.

Each mode rounds in its own places, as JAX does: the QKV of #1 and #4 in
the activation dtype, the 728-wide intermediate of #2, #3 and #8 kept in
f32, the GELU hidden of #6 in the activation dtype (fc2 then runs in that
dtype with f32 sums), the hidden of #3 and #7 requantized to int8. #9
rounds where #1 -> #2 -> #3 do.

The plain versions do the int8 x int8 products in float64, which is exact
(float32 is not: a K=2912 dot of int8 codes can exceed 2**24).
"""
from __future__ import annotations

import ctypes

import torch

from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.kernels.attention import (check_spatial, check_temporal,
                                               spatial_core,
                                               spatial_packed_plain,
                                               temporal_core,
                                               temporal_packed_plain)
from istvt_tpu_torch.kernels.linear import _ln, gemm
from istvt_tpu_torch.kernels.mlp import _gelu_tanh

# the dispatcher ops of kernels/ops.py (resolved at call time; the package's
# __init__ registers them)
_ops = torch.ops.istvt


def _wk(wk):
    """A wrapper's `wk` (a sequence of K-major copies, or None) as its op's
    tensor-list argument: the copies, or an empty list where none is given."""
    return [] if wk is None else list(wk)


# ---------------------------------------------------------------------------
# plain helpers (kernels/quant.quantize_weight, _quant_rows, _q8_dot)


def _div127(t):
    """t / 127 rounded once, on every device. A CUDA tensor divided by a
    Python number is multiplied by the number's reciprocal instead, which
    can be an ulp off the quotient that JAX and the kernels take; a
    tensor divisor is divided by."""
    return t / torch.full_like(t, 127.0)


def quantize_weight(w):
    """(D, K) float -> (int8 (D, K), f32 scales (K,)) per output column."""
    w = w.to(torch.float32).contiguous()
    scale = _div127(w.abs().amax(dim=0))
    scale = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale


def _quant_rows(yf):
    """f32 (R, D) -> (int8 (R, D), f32 row scales (R, 1))."""
    amax = yf.abs().amax(dim=-1, keepdim=True)
    rs = _div127(amax.clamp_min(1e-6))
    q = torch.clamp(torch.round(yf / rs), -127, 127)
    return q.to(torch.int8), rs


def _q8_dot(q, wq):
    """int8 codes (R, D) x int8 (D, K) -> f32 (R, K) raw accumulator
    (exact in float64, then rounded to f32 as int32 -> f32 rounds)."""
    return (q.to(torch.float64) @ wq.to(torch.float64)).to(torch.float32)


def padded_k(k: int) -> int:
    """The row length in bytes of the int8 GEMM's activation codes and
    K-major weight copies: K rounded up to 16, TMA's unit of a row stride
    (728 -> 736; 512, 1536 and 2912 stay). The GEMM never reads the pad."""
    return -(-k // 16) * 16


def kmajor(wq):
    """The int8 GEMM's copy of an int8 weight wq (K, N): its transpose, (N,
    padded_k(K)) contiguous on wq's device, the pad columns zero. The same
    codes; the GEMM reads it K-major, the only major 8-bit wgmma takes."""
    k, n = wq.shape
    out = torch.zeros((n, padded_k(k)), dtype=torch.int8, device=wq.device)
    out[:, :k] = wq.t()
    return out


# ---------------------------------------------------------------------------
# kernel A: LN -> int8 QKV -> self-subtract temporal attention


def ln_qkv_q8_temporal_plain(x, s, b, wq, ws, heads: int):
    """Plain version of kernel A (quant._ln_qkv_q8_temporal_impl):
    x (B, T1, S, D) -> (B, T1, S, I) in x.dtype. The qkv is #4's, in the
    activation dtype before the self-subtract (quant.py:512-517)."""
    return temporal_packed_plain(ln_matmul_q8_plain(x, s, b, wq, ws), heads)


def _ln_qkv_q8_temporal_cuda(x, s, b, wq, ws, heads: int, wk):
    """Kernel A on the card (its op's CUDA implementation)."""
    out = temporal_core(_ln_matmul_q8_launch(x, s, b, wq, ws, wk), heads)
    _lib.LAUNCHES["ln_qkv_q8_temporal_attention"] += 1
    return out


def ln_qkv_q8_temporal_attention(x, s, b, wq, ws, heads: int, wk=None):
    """Fused LN -> int8 QKV -> self-subtract temporal attention:
    x (B, T1, S, D) -> (B, T1, S, I); wk: (kmajor(wq),) or None. CPU
    tensors take the plain version."""
    return _ops.ln_qkv_q8_temporal_attention(x, s, b, wq, ws, heads,
                                             _wk(wk))


# ---------------------------------------------------------------------------
# kernel B: t-out-proj (W8A8) + bias -> LN -> int8 QKV -> spatial attention


def mm_q8_ln_qkv_q8_spatial_plain(a, woq, wos, bo, s, b, wq, ws,
                                  heads: int, n_valid: int = -1):
    """Plain version of kernel B (quant._mm_q8_ln_qkv_q8_spatial_impl):
    a (G, S, I_in) -> (G, S, I) in a.dtype. The qkv is #8's."""
    qkv = matmul_q8_ln_matmul_q8_plain(a, woq, wos, bo, s, b, wq, ws)
    return spatial_packed_plain(qkv, heads, n_valid)


def mm_q8_ln_qkv_q8_spatial_attention(a, woq, wos, bo, s, b, wq, ws,
                                      heads: int, n_valid: int = -1,
                                      wk=None):
    """Fused t-out-proj (W8A8) -> LN -> int8 QKV -> spatial attention:
    a (G, S, I_in) -> (G, S, I); wk: (kmajor(woq), kmajor(wq)) or None.
    CPU tensors take the plain version."""
    return _ops.mm_q8_ln_qkv_q8_spatial_attention(
        a, woq, wos, bo, s, b, wq, ws, heads, n_valid, _wk(wk))


def _mm_q8_ln_qkv_q8_spatial_cuda(a, woq, wos, bo, s, b, wq, ws, heads: int,
                                  n_valid: int, wk):
    """Kernel B on the card (its op's CUDA implementation)."""
    qkv = _matmul_q8_ln_matmul_q8_launch(a, woq, wos, bo, s, b, wq, ws, wk)
    out = spatial_core(qkv, heads, a.shape[1] if n_valid < 0 else n_valid)
    _lib.LAUNCHES["mm_q8_ln_qkv_q8_spatial_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel C: s-out-proj (W8A8) + bias + residual -> PreNorm fully-int8 FF


def matmul_q8_res_ln_ff_q8_full_plain(a, r, wqo, wso, bo, s, b, w1q, w1s,
                                      b1, w2q, w2s, b2):
    """Plain version of kernel C (quant._mm_q8_res_ln_ff_q8_impl):
    y = a @ dq(wqo) + bo + r;  y + fc2_q8(gelu_tanh(fc1_q8(LN(y))))."""
    d = wqo.shape[1]
    q, rs = _quant_rows(a.reshape(-1, a.shape[-1]).float())
    y = _q8_dot(q, wqo) * rs * wso.float() + bo.float() \
        + r.reshape(-1, d).float()
    out = ln_ff_residual_q8_full_plain(y, s, b, w1q, w1s, b1, w2q, w2s, b2)
    return out.to(a.dtype).reshape(*a.shape[:-1], d)


def matmul_q8_res_ln_ff_q8_full(a, r, wqo, wso, bo, s, b, w1q, w1s, b1,
                                w2q, w2s, b2, wk=None):
    """y = a @ dq(wqo) + bo + r;  return y + FF_int8(LN(y)):
    a (..., N, I_in), r (..., N, D) -> (..., N, D); wk: (kmajor(wqo),
    kmajor(w1q), kmajor(w2q)) or None. CPU tensors take the plain
    version."""
    return _ops.matmul_q8_res_ln_ff_q8_full(a, r, wqo, wso, bo, s, b, w1q,
                                            w1s, b1, w2q, w2s, b2, _wk(wk))


def _matmul_q8_res_ln_ff_q8_full_cuda(a, r, wqo, wso, bo, s, b, w1q, w1s,
                                      b1, w2q, w2s, b2, wk):
    """Kernel C on the card (its op's CUDA implementation)."""
    d_in, d, hdim = a.shape[-1], wqo.shape[1], w1q.shape[1]
    _lib.check_act(a, "a")
    _check_res(r, a, d)
    _check_q8(wqo, wso, d_in, d)
    _check_q8(w1q, w1s, d, hdim)
    _check_q8(w2q, w2s, hdim, d)
    wko, wk1, wk2 = _kmajor_of(wk, wqo, w1q, w2q)
    lib, st = _lib.load(), _lib.stream()
    q, rs = _quant(lib, st, a.reshape(-1, d_in))
    y = torch.empty((q.shape[0], d), dtype=torch.float32, device=a.device)
    gemm_q8(q, wko, rs, wso, y, bias=bo, res=r)
    out = torch.empty(a.shape[:-1] + (d,), dtype=a.dtype, device=a.device)
    _ff_q8_full_cuda(lib, st, y, s, b, wk1, w1s, b1, wk2, w2s, b2, out)
    _lib.LAUNCHES["matmul_q8_res_ln_ff_q8_full"] += 1
    return out


# ---------------------------------------------------------------------------
# #4: LN -> W8A8 (the LN + QKV projection of the boundary chain and of the
# q8 blocks)


def ln_matmul_q8_plain(x, s, b, wq, ws):
    """Plain version of ln_matmul_q8 (quant._ln_matmul_q8_impl)."""
    lead, d = x.shape[:-1], x.shape[-1]
    q, rs = _quant_rows(_ln(x.reshape(-1, d).float(), s.float(), b.float()))
    o = _q8_dot(q, wq) * rs * ws.float()
    return o.to(x.dtype).reshape(*lead, wq.shape[1])


def _ln_matmul_q8_launch(x, s, b, wq, ws, wk):
    """#4's launches on the card, counted by the caller: LN + row quant,
    then the W8A8 GEMM whose epilogue scales and rounds to x's dtype."""
    d, k = x.shape[-1], wq.shape[1]
    _lib.check_act(x, "x")
    _check_q8(wq, ws, d, k)
    (wkq,) = _kmajor_of(wk, wq)
    lib, st = _lib.load(), _lib.stream()
    q, rs = _ln_quant(lib, st, x.reshape(-1, d), s, b)
    out = torch.empty(x.shape[:-1] + (k,), dtype=x.dtype, device=x.device)
    gemm_q8(q, wkq, rs, ws, out)
    return out


def ln_matmul_q8(x, s, b, wq, ws, wk=None):
    """LayerNorm(x) @ dequant(wq, ws): x (..., N, D), wq int8 (D, K), ws
    (K,) -> (..., N, K) in x.dtype; the rows quantize after the LN, no
    bias; wk: (kmajor(wq),) or None. CPU tensors take the plain version."""
    return _ops.ln_matmul_q8(x, s, b, wq, ws, _wk(wk))


def _ln_matmul_q8_cuda(x, s, b, wq, ws, wk):
    """#4 on the card (its op's CUDA implementation)."""
    out = _ln_matmul_q8_launch(x, s, b, wq, ws, wk)
    _lib.LAUNCHES["ln_matmul_q8"] += 1
    return out


# ---------------------------------------------------------------------------
# #5: W8A8 + b [+ r] (the out-projections of the q8 blocks)


def matmul_q8_bias_residual_plain(x, wq, ws, b, r=None):
    """Plain version of matmul_q8_bias_residual (quant._matmul_q8_impl):
    acc * rs * ws + b [+ r] in f32, one rounding to x's dtype."""
    k = wq.shape[1]
    q, rs = _quant_rows(x.reshape(-1, x.shape[-1]).float())
    o = _q8_dot(q, wq) * rs * ws.float() + b.float()
    if r is not None:
        o = o + r.reshape(-1, k).float()
    return o.to(x.dtype).reshape(*x.shape[:-1], k)


def matmul_q8_bias_residual(x, wq, ws, b, r=None, wk=None):
    """x @ dequant(wq, ws) + b [+ r]: x (..., N, D_in), r (..., N, K) or
    None -> (..., N, K) in x.dtype, the int8 form of
    kernels/linear.matmul_bias_residual; wk: (kmajor(wq),) or None. CPU
    tensors take the plain version."""
    return _ops.matmul_q8_bias_residual(x, wq, ws, b, r, _wk(wk))


def _matmul_q8_bias_residual_cuda(x, wq, ws, b, r, wk):
    """#5 on the card (its op's CUDA implementation), counted with or
    without r."""
    d_in, k = x.shape[-1], wq.shape[1]
    _lib.check_act(x, "x")
    if r is not None:
        _check_res(r, x, k)
    _check_q8(wq, ws, d_in, k)
    (wkq,) = _kmajor_of(wk, wq)
    q, rs = _quant(_lib.load(), _lib.stream(), x.reshape(-1, d_in))
    out = torch.empty(x.shape[:-1] + (k,), dtype=x.dtype, device=x.device)
    gemm_q8(q, wkq, rs, ws, out, bias=b, res=r)
    _lib.LAUNCHES["matmul_q8_bias_residual" if r is not None
                  else "matmul_q8_bias_residual/no_r"] += 1
    return out


# ---------------------------------------------------------------------------
# #8: W8A8 + b -> LN -> W8A8 (the boundary chain's t-out-proj -> spatial
# LN -> spatial QKV); the 728-wide intermediate stays f32 (quant.py:322-331)


def matmul_q8_ln_matmul_q8_plain(a, wq1, ws1, b1, s, b, wq2, ws2):
    """Plain version of matmul_q8_ln_matmul_q8 (quant._mm_q8_ln_mm_q8_impl)."""
    q, rs = _quant_rows(a.reshape(-1, a.shape[-1]).float())
    y = _q8_dot(q, wq1) * rs * ws1.float() + b1.float()     # stays f32
    q2, rs2 = _quant_rows(_ln(y, s.float(), b.float()))
    o = _q8_dot(q2, wq2) * rs2 * ws2.float()
    return o.to(a.dtype).reshape(*a.shape[:-1], wq2.shape[1])


def _matmul_q8_ln_matmul_q8_launch(a, wq1, ws1, b1, s, b, wq2, ws2, wk):
    """#8's launches on the card, counted by the caller: row quant, W8A8 +
    b1 into an f32 intermediate, LN + row quant of it, W8A8 rounded to a's
    dtype."""
    d_in, d_mid, k = a.shape[-1], wq1.shape[1], wq2.shape[1]
    _lib.check_act(a, "a")
    _check_q8(wq1, ws1, d_in, d_mid)
    _check_q8(wq2, ws2, d_mid, k)
    wk1, wk2 = _kmajor_of(wk, wq1, wq2)
    lib, st = _lib.load(), _lib.stream()
    q, rs = _quant(lib, st, a.reshape(-1, d_in))
    y = torch.empty((q.shape[0], d_mid), dtype=torch.float32,
                    device=a.device)
    gemm_q8(q, wk1, rs, ws1, y, bias=b1)
    q2, rs2 = _ln_quant(lib, st, y, s, b)
    out = torch.empty(a.shape[:-1] + (k,), dtype=a.dtype, device=a.device)
    gemm_q8(q2, wk2, rs2, ws2, out)
    return out


def matmul_q8_ln_matmul_q8(a, wq1, ws1, b1, s, b, wq2, ws2, wk=None):
    """LN(a @ dequant(wq1, ws1) + b1) @ dequant(wq2, ws2): a (..., N,
    D_in) -> (..., N, K) in a.dtype; wk: (kmajor(wq1), kmajor(wq2)) or
    None. CPU tensors take the plain version."""
    return _ops.matmul_q8_ln_matmul_q8(a, wq1, ws1, b1, s, b, wq2, ws2,
                                       _wk(wk))


def _matmul_q8_ln_matmul_q8_cuda(a, wq1, ws1, b1, s, b, wq2, ws2, wk):
    """#8 on the card (its op's CUDA implementation)."""
    out = _matmul_q8_ln_matmul_q8_launch(a, wq1, ws1, b1, s, b, wq2, ws2, wk)
    _lib.LAUNCHES["matmul_q8_ln_matmul_q8"] += 1
    return out


# ---------------------------------------------------------------------------
# #6: LN -> int8 fc1 + b1 -> tanh-GELU -> fc2 in x's dtype + b2 + x
# (q8_ff='mixed')


def ln_ff_residual_q8_plain(x, s, b, w1q, w1s, b1, w2, b2):
    """Plain version of ln_ff_residual_q8 (quant._ln_ff_q8_impl): the GELU
    hidden is rounded to x's dtype (quant.py:198) and fc2 takes w2 in x's
    dtype with f32 sums; + b2 + x in f32, one rounding."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d).float()
    q, rs = _quant_rows(_ln(xf, s.float(), b.float()))
    h = _gelu_tanh(_q8_dot(q, w1q) * rs * w1s.float() + b1.float())
    o = h.to(x.dtype).float() @ w2.to(x.dtype).float() + b2.float()
    return (o + xf).to(x.dtype).reshape(*lead, d)


def ln_ff_residual_q8(x, s, b, w1q, w1s, b1, w2, b2, wk=None):
    """x + fc2(gelu_tanh(fc1_q8(LN x))): x (..., N, D), w1q int8 (D, H),
    w2 (H, D) float in the (in, out) layout -> (..., N, D) in x.dtype; wk:
    (kmajor(w1q),) or None. CPU tensors take the plain version."""
    return _ops.ln_ff_residual_q8(x, s, b, w1q, w1s, b1, w2, b2, _wk(wk))


def _ln_ff_residual_q8_cuda(x, s, b, w1q, w1s, b1, w2, b2, wk):
    """#6 on the card (its op's CUDA implementation)."""
    d, hdim = x.shape[-1], w1q.shape[1]
    _lib.check_act(x, "x")
    _check_q8(w1q, w1s, d, hdim)
    if tuple(w2.shape) != (hdim, d):
        raise ValueError(f"fc2 weight {tuple(w2.shape)}, expected "
                         f"({hdim}, {d})")
    (wk1,) = _kmajor_of(wk, w1q)
    flat = x.reshape(-1, d)
    q, rs = _ln_quant(_lib.load(), _lib.stream(), flat, s, b)
    hid = torch.empty((q.shape[0], hdim), dtype=x.dtype, device=x.device)
    gemm_q8(q, wk1, rs, w1s, hid, bias=b1, gelu=True)
    out = torch.empty_like(x)
    gemm(hid, w2, out, bias32=_lib.f32(b2), res=flat)
    _lib.LAUNCHES["ln_ff_residual_q8"] += 1
    return out


# ---------------------------------------------------------------------------
# #7: LN -> int8 fc1 + b1 -> tanh-GELU -> int8 fc2 + b2 + x (any q8_ff but
# 'full', 'mixed' and 'bf16'; the FF half of #3)


def ln_ff_residual_q8_full_plain(x, s, b, w1q, w1s, b1, w2q, w2s, b2):
    """Plain version of ln_ff_residual_q8_full (quant._ln_ff_q8_full_impl):
    the f32 GELU hidden requantized per row, both GEMMs W8A8; + b2 + x in
    f32 (x read in its own dtype, quant.py:270), one rounding."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d).float()
    q, rs = _quant_rows(_ln(xf, s.float(), b.float()))
    hid = _gelu_tanh(_q8_dot(q, w1q) * rs * w1s.float() + b1.float())
    q2, rs2 = _quant_rows(hid)
    o = _q8_dot(q2, w2q) * rs2 * w2s.float() + b2.float()
    return (o + xf).to(x.dtype).reshape(*lead, d)


def _ff_q8_full_cuda(lib, st, x, s, b, wk1, w1s, b1, wk2, w2s, b2, out):
    """#7's launches on a CUDA (R, D) x into out (R's rows, x's or another
    float dtype), the weights as K-major copies: LN + row quant, fc1 + b1 +
    GELU into an f32 hidden, row quant of it, fc2 + b2 + x (read in x's
    dtype) rounded once to out's."""
    q, rs = _ln_quant(lib, st, x, s, b)
    hid = torch.empty((x.shape[0], wk1.shape[0]), dtype=torch.float32,
                      device=x.device)
    gemm_q8(q, wk1, rs, w1s, hid, bias=b1, gelu=True)
    q2, rs2 = _quant(lib, st, hid)
    gemm_q8(q2, wk2, rs2, w2s, out, bias=b2, res=x)


def ln_ff_residual_q8_full(x, s, b, w1q, w1s, b1, w2q, w2s, b2, wk=None):
    """x + fc2_q8(gelu_tanh(fc1_q8(LN x))): x (..., N, D), w1q int8 (D, H),
    w2q int8 (H, D) -> (..., N, D) in x.dtype; wk: (kmajor(w1q),
    kmajor(w2q)) or None. CPU tensors take the plain version."""
    return _ops.ln_ff_residual_q8_full(x, s, b, w1q, w1s, b1, w2q, w2s, b2,
                                       _wk(wk))


def _ln_ff_residual_q8_full_cuda(x, s, b, w1q, w1s, b1, w2q, w2s, b2, wk):
    """#7 on the card (its op's CUDA implementation)."""
    d, hdim = x.shape[-1], w1q.shape[1]
    _lib.check_act(x, "x")
    _check_q8(w1q, w1s, d, hdim)
    _check_q8(w2q, w2s, hdim, d)
    wk1, wk2 = _kmajor_of(wk, w1q, w2q)
    out = torch.empty_like(x)
    _ff_q8_full_cuda(_lib.load(), _lib.stream(), x.reshape(-1, d), s, b, wk1,
                     w1s, b1, wk2, w2s, b2, out)
    _lib.LAUNCHES["ln_ff_residual_q8_full"] += 1
    return out


# ---------------------------------------------------------------------------
# #9: one whole int8 ST layer (q8_attn='layer'): one persistent kernel
# (csrc/q8_layer.cu) with grid-wide barriers between its 14 phases


def st_layer_q8_plain(x, st, bt, wqt, wst, wot, sot, bot, ss, bs, wqs, wss,
                      wos, sos, bos, sf, bf, w1q, w1s, b1, w2q, w2s, b2,
                      heads: int, n_valid: int = -1):
    """Plain version of st_layer_q8 (quant._st_layer_q8_impl): the
    composition #1 -> #2 -> #3 of the plain versions above, since the TPU
    kernel rounds where they do: the temporal qkv in x's dtype before the
    self-subtract (quant.py:720-725, as #1 at :512-517), the t-out-proj
    output kept in f32 into the spatial LN and its qkv rounded to x's
    dtype (:763-772, as #8 and so #2), the s-out-proj output + b + x in
    f32 into the fully-int8 FF and + y at the end (:817-833, as #3)."""
    b, t1, s, d = x.shape
    a_t = ln_qkv_q8_temporal_plain(x, st, bt, wqt, wst, heads)
    a_s = mm_q8_ln_qkv_q8_spatial_plain(a_t.reshape(b * t1, s, -1), wot, sot,
                                        bot, ss, bs, wqs, wss, heads,
                                        n_valid)
    out = matmul_q8_res_ln_ff_q8_full_plain(
        a_s.reshape(b, t1 * s, -1), x.reshape(b, t1 * s, d), wos, sos, bos,
        sf, bf, w1q, w1s, b1, w2q, w2s, b2)
    return out.reshape(x.shape)


# csrc/q8_layer.cu's istvt_st_layer_q8: the pointers in the order it reads
# them (the weights in _st_layer_q8_impl's argument order, each int8 weight
# as its K-major copy)
_LAYER_PTRS = ("x", "out", "st", "bt", "wqt", "wst", "wot", "sot", "bot",
               "ss", "bs", "wqs", "wss", "wos", "sos", "bos", "sf", "bf",
               "w1q", "w1s", "b1", "w2q", "w2s", "b2", "q", "rs", "qkv", "a",
               "y", "hid")
# the kernel's phase stamps: its start and the end of each of its 14 phases
LAYER_STAMPS = 15


def layer_code_strides(d: int, inner: int, hdim: int) -> tuple:
    """The row strides in bytes of #9's int8 codes, by the width of the row
    pass that writes them (D: phases 1, 6, 11; inner: 4, 9; hdim: 13):
    padded_k of each, since its GEMM phase reads them by TMA."""
    return padded_k(d), padded_k(inner), padded_k(hdim)


def layer_workspace(rows: int, d: int, inner: int, hdim: int, dtype,
                    device) -> dict:
    """#9's workspace for `rows` rows: the int8 codes q (rows of the widest
    of layer_code_strides, each pass writing its own stride), their row
    scales rs, the packed qkv and the attention output a in the activation
    dtype, the f32 stream y and the f32 FF hidden hid; flat, uninitialised."""
    def empty(n, dt):
        return torch.empty(n, dtype=dt, device=device)
    return {"q": empty(rows * max(layer_code_strides(d, inner, hdim)),
                       torch.int8),
            "rs": empty(rows, torch.float32),
            "qkv": empty(rows * 3 * inner, dtype),
            "a": empty(rows * inner, dtype),
            "y": empty(rows * d, torch.float32),
            "hid": empty(rows * hdim, torch.float32)}


def st_layer_q8(x, st, bt, wqt, wst, wot, sot, bot, ss, bs, wqs, wss, wos,
                sos, bos, sf, bf, w1q, w1s, b1, w2q, w2s, b2, heads: int,
                n_valid: int = -1, wk=None, stamps=None):
    """One full int8 ST layer, x = FF(attn_s(attn_t(x)) + x) with every
    PreNorm and residual: x (B, T1, S, D) -> (B, T1, S, D) in x.dtype. The
    arguments are _st_layer_q8_impl's: per branch its LayerNorm, int8
    weights with their column scales and the out-projection's (fc1's,
    fc2's) bias; wk: the six int8 weights' K-major copies (kmajor(wqt),
    kmajor(wot), kmajor(wqs), kmajor(wos), kmajor(w1q), kmajor(w2q)) or None,
    checked on any device. On the card one launch: a persistent kernel that
    walks the layer's phases with its intermediates in a workspace
    allocated in the call (layer_workspace: 889 MB at B=16 in bf16);
    `stamps`, an int64 CUDA tensor of LAYER_STAMPS elements (dim_head 64, T1 <= 8
    only), runs the kernel's stamped instantiation instead, outside the
    dispatcher op, which writes there the %globaltimer ns at its start and
    at the end of each phase (tools/kernel_ms.py --layer-phases). CPU
    tensors take the plain version."""
    args = (x, st, bt, wqt, wst, wot, sot, bot, ss, bs, wqs, wss, wos, sos,
            bos, sf, bf, w1q, w1s, b1, w2q, w2s, b2, heads, n_valid, _wk(wk))
    if stamps is None:
        return _ops.st_layer_q8(*args)
    if not x.is_cuda:
        raise ValueError("phase stamps are the card kernel's")
    return _st_layer_q8_cuda(*args, stamps=stamps)


def _st_layer_q8_cuda(x, st, bt, wqt, wst, wot, sot, bot, ss, bs, wqs, wss,
                      wos, sos, bos, sf, bf, w1q, w1s, b1, w2q, w2s, b2,
                      heads: int, n_valid: int, wk, stamps=None):
    """#9 on the card (its op's CUDA implementation; with `stamps`, the
    stamped instantiation)."""
    if x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)}: expected (B, T1, S, D)")
    bsz, t1, s_len, d = x.shape
    i3, hdim = wqt.shape[1], w1q.shape[1]
    inner = i3 // 3
    _lib.check_act(x, "x")
    check_temporal(t1, inner, heads)
    check_spatial(inner, heads, dims=(16, 64))
    for wq, ws, d_in, d_out in ((wqt, wst, d, i3), (wot, sot, inner, d),
                                (wqs, wss, d, i3), (wos, sos, inner, d),
                                (w1q, w1s, d, hdim), (w2q, w2s, hdim, d)):
        _check_q8(wq, ws, d_in, d_out)
    vecs = {"st": st, "bt": bt, "wst": wst, "sot": sot, "bot": bot, "ss": ss,
            "bs": bs, "wss": wss, "sos": sos, "bos": bos, "sf": sf, "bf": bf,
            "w1s": w1s, "b1": b1, "w2s": w2s, "b2": b2}
    for name, v in vecs.items():
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, x on {x.device}")
    if stamps is not None and (
            not stamps.is_cuda or stamps.dtype != torch.int64 or
            stamps.numel() < LAYER_STAMPS or inner // heads != 64 or t1 > 8):
        raise ValueError(f"stamps: an int64 CUDA tensor of {LAYER_STAMPS} "
                         f"elements, at dim_head 64 and T1 <= 8")
    wkqt, wkot, wkqs, wkos, wk1, wk2 = _kmajor_of(wk, wqt, wot, wqs, wos,
                                                  w1q, w2q)
    ptr = {"x": x, "out": torch.empty_like(x), "wqt": wkqt, "wot": wkot,
           "wqs": wkqs, "wos": wkos, "w1q": wk1, "w2q": wk2,
           **{n: _lib.f32(v) for n, v in vecs.items()},
           **layer_workspace(bsz * t1 * s_len, d, inner, hdim, x.dtype,
                             x.device)}
    arr = (ctypes.c_void_p * len(_LAYER_PTRS))(
        *(ptr[n].data_ptr() for n in _LAYER_PTRS))
    _lib.check(_lib.load().istvt_st_layer_q8(
        ctypes.addressof(arr), _lib.DTYPE_CODE[x.dtype], bsz, t1, s_len, d,
        heads, inner, hdim, s_len if n_valid < 0 else n_valid,
        (inner // heads) ** -0.5, _lib.ptr(stamps), _lib.stream()),
        "st_layer_q8")
    _lib.LAUNCHES["st_layer_q8"] += 1
    return ptr["out"]


# ---------------------------------------------------------------------------
# launch plumbing (counts nothing)


def _check_q8(wq, ws, d_in, d_out):
    if wq.dtype != torch.int8 or tuple(wq.shape) != (d_in, d_out):
        raise ValueError(f"int8 weight {tuple(wq.shape)} {wq.dtype}, "
                         f"expected ({d_in}, {d_out}) int8")
    if tuple(ws.shape) != (d_out,):
        raise ValueError(f"column scales {tuple(ws.shape)}, expected "
                         f"({d_out},)")
    if not wq.is_cuda or not wq.is_contiguous() or d_in % 4 or d_out % 4:
        raise ValueError("int8 weights must be contiguous CUDA tensors with "
                         "both dims divisible by 4")


def _check_res(r, x, k):
    """A residual r (..., N, k) in x's dtype beside x (..., N, D_in)."""
    _lib.check_act(r, "r")
    if r.dtype != x.dtype or r.shape != x.shape[:-1] + (k,):
        raise ValueError(f"residual {tuple(r.shape)} {r.dtype} does not "
                         f"match x {tuple(x.shape)} {x.dtype}, K={k}")


def _codes(x):
    """Empty int8 codes for the rows of a CUDA (R, D) x: an (R, D) view of
    an (R, padded_k(D)) buffer, as the int8 GEMM reads them."""
    rows, d = x.shape
    buf = torch.empty((rows, padded_k(d)), dtype=torch.int8, device=x.device)
    return buf[:, :d]


def _ln_quant(lib, st, x, s, b):
    """LayerNorm + per-row int8 quant of the rows of a CUDA (R, D) x:
    (int8 codes (R, D) with rows padded_k(D) apart, f32 row scales
    (R,))."""
    rows, d = x.shape
    q = _codes(x)
    rs = torch.empty((rows,), dtype=torch.float32, device=x.device)
    s32, b32 = _lib.f32(s), _lib.f32(b)
    _lib.check(lib.istvt_ln_quant_rows(x.data_ptr(), _lib.DTYPE_CODE[x.dtype],
                                       s32.data_ptr(), b32.data_ptr(),
                                       q.data_ptr(), q.stride(0),
                                       rs.data_ptr(), rows, d, st),
               "ln_quant_rows")
    return q, rs


def _quant(lib, st, x):
    """Per-row int8 quant of the rows of a CUDA (R, D) x, laid out as
    _ln_quant's."""
    rows, d = x.shape
    q = _codes(x)
    rs = torch.empty((rows,), dtype=torch.float32, device=x.device)
    _lib.check(lib.istvt_quant_rows(x.data_ptr(), _lib.DTYPE_CODE[x.dtype],
                                    q.data_ptr(), q.stride(0), rs.data_ptr(),
                                    rows, d, st),
               "quant_rows")
    return q, rs


def kmajor_given(*copies):
    """Prebuilt K-major copies as a wrapper's `wk`, or None where one is
    missing (the wrapper then builds them)."""
    return None if any(c is None for c in copies) else copies


def _kmajor_of(wk, *wqs):
    """The K-major copies of the int8 weights wqs (checked, on the card):
    wk's, in wqs' order, or, where wk is None or empty, built now on the
    card (each counted in _lib.KMAJOR_BUILDS)."""
    if not wk:
        _lib.KMAJOR_BUILDS["q8_kmajor"] += len(wqs)
        return tuple(kmajor(wq) for wq in wqs)
    wk = tuple(wk)
    if len(wk) != len(wqs):
        raise ValueError(f"{len(wk)} K-major copies for {len(wqs)} int8 "
                         f"weights")
    for c, wq in zip(wk, wqs):
        want = (wq.shape[1], padded_k(wq.shape[0]))
        if c.dtype != torch.int8 or tuple(c.shape) != want:
            raise ValueError(f"K-major copy {tuple(c.shape)} {c.dtype} of an "
                             f"int8 weight {tuple(wq.shape)}: expected "
                             f"{want} int8, kmajor(wq)")
        if c.device != wq.device:
            raise ValueError(f"K-major copy on {c.device}, its weight on "
                             f"{wq.device}")
        if not c.is_contiguous() or (c.is_cuda and c.data_ptr() % 16):
            raise ValueError("K-major copy: not contiguous and 16-byte "
                             "aligned, as kmajor(wq) is")
    return wk


def check_gemm_q8(q, wk, out):
    """Raise ValueError unless the int8 GEMM takes these operands: codes q
    (M, K) int8 with rows padded_k(K) bytes apart, the K-major weight wk
    (N, padded_k(K)) int8 contiguous, out (M, N) contiguous, K and N
    divisible by 4, all 16-byte aligned CUDA tensors."""
    (m, k), n = q.shape, wk.shape[0]
    kp = padded_k(k)
    if k % 4 or n % 4:
        raise ValueError(f"int8 GEMM: K = {k} and N = {n} must be divisible "
                         f"by 4")
    if q.dtype != torch.int8 or q.stride() != (kp, 1):
        raise ValueError(f"int8 codes {tuple(q.shape)} {q.dtype}, stride "
                         f"{q.stride()}: the GEMM reads int8 rows {kp} bytes "
                         f"apart (padded_k({k}))")
    if wk.dtype != torch.int8 or tuple(wk.shape) != (n, kp) or \
            wk.stride() != (kp, 1):
        raise ValueError(f"K-major weight {tuple(wk.shape)} {wk.dtype}, "
                         f"stride {wk.stride()}: expected contiguous "
                         f"({n}, {kp}) int8, kmajor(wq)")
    if out.numel() != m * n or not out.is_contiguous():
        raise ValueError(f"int8 GEMM output {tuple(out.shape)}, want ({m}, "
                         f"{n}) contiguous")
    for name, t in (("int8 codes", q), ("K-major weight", wk),
                    ("output", out)):
        if not t.is_cuda:
            raise ValueError(f"{name} on {t.device}: the int8 GEMM takes "
                             f"CUDA tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer not 16-byte aligned")


def gemm_q8(q, wk, rs, ws, out, *, bias=None, res=None, gelu: bool = False):
    """out (M, N) = epilogue(q @ wk^T) on the card, the int8 wgmma GEMM:
    acc * rs * ws (+ bias) (+ res, read in its dtype) (-> tanh-GELU), in
    f32, rounded once to out's dtype (f32 or bf16). q: (M, K) int8 codes
    laid out as _ln_quant's; wk: kmajor(wq) of the (K, N) weight; rs (M,),
    ws and bias (N,); res (M, N) or None. Counts no launch: the wrappers
    above do."""
    check_gemm_q8(q, wk, out)
    (m, k), n = q.shape, wk.shape[0]
    if out.dtype not in _lib.DTYPE_CODE:
        raise TypeError(f"int8 GEMM output {out.dtype}")
    if res is not None and (res.dtype not in _lib.DTYPE_CODE or
                            res.numel() != m * n or not res.is_contiguous()):
        raise ValueError(f"residual {tuple(res.shape)} {res.dtype}: want "
                         f"({m}, {n}) contiguous f32 or bf16")
    ws32 = _lib.f32(ws)
    b32 = None if bias is None else _lib.f32(bias)
    res_dt = _lib.DTYPE_CODE[res.dtype] if res is not None else 0
    _lib.check(_lib.load().istvt_gemm_q8(
        q.data_ptr(), q.stride(0), wk.data_ptr(), wk.stride(0), rs.data_ptr(),
        ws32.data_ptr(), _lib.ptr(b32), _lib.ptr(res), res_dt,
        out.data_ptr(), _lib.DTYPE_CODE[out.dtype], int(gelu), m, n, k,
        _lib.stream()), "gemm_q8")
