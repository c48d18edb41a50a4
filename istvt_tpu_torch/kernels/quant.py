"""Int8 W8A8 serving kernels (counterpart of istvt_tpu/kernels/quant.py).

Scheme (identical to the JAX package, so the ports agree bit for bit on
the quantization points):
  * weights - per-OUTPUT-column symmetric int8, scale = max|w[:, j]| / 127
    (floored at 1e-12), quantized once at load time (quantize_weight);
  * activations - per-ROW symmetric int8, scale = max(amax, 1e-6) / 127,
    computed on the fly; values round half to even and clip to +-127;
  * GEMM - int8 x int8 -> int32, epilogue acc * row_scale * col_scale
    (+ bias, + residual) in f32.

Three kernels run per ST layer on the serving path
(istvt_tpu/models/istvt.py:284-318); each has a wrapper here that, for a
CUDA tensor, launches the hand-written CUDA kernels in csrc/ (built at
first use, kernels/_lib.py) and, for a CPU tensor, runs the plain PyTorch
version beside it. There is no fallback from one to the other: a CUDA
tensor that the kernel cannot take raises.

The plain versions do the int8 x int8 products in float64, which is exact
(float32 is not: a K=2912 dot of int8 codes can exceed 2**24).
"""
from __future__ import annotations

import torch

from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.kernels.attention import (check_spatial, check_temporal,
                                               spatial_core,
                                               spatial_packed_plain,
                                               temporal_core,
                                               temporal_packed_plain)
from istvt_tpu_torch.kernels.linear import _ln
from istvt_tpu_torch.kernels.mlp import _gelu_tanh


# ---------------------------------------------------------------------------
# plain helpers (kernels/quant.quantize_weight, _quant_rows, _q8_dot)


def quantize_weight(w):
    """(D, K) float -> (int8 (D, K), f32 scales (K,)) per output column."""
    w = w.to(torch.float32).contiguous()
    scale = w.abs().amax(dim=0) / 127.0
    scale = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale


def _quant_rows(yf):
    """f32 (R, D) -> (int8 (R, D), f32 row scales (R, 1))."""
    amax = yf.abs().amax(dim=-1, keepdim=True)
    rs = amax.clamp_min(1e-6) / 127.0
    q = torch.clamp(torch.round(yf / rs), -127, 127)
    return q.to(torch.int8), rs


def _q8_dot(q, wq):
    """int8 codes (R, D) x int8 (D, K) -> f32 (R, K) raw accumulator
    (exact in float64, then rounded to f32 as int32 -> f32 rounds)."""
    return (q.to(torch.float64) @ wq.to(torch.float64)).to(torch.float32)


# ---------------------------------------------------------------------------
# kernel A: LN -> int8 QKV -> self-subtract temporal attention


def ln_qkv_q8_temporal_plain(x, s, b, wq, ws, heads: int):
    """Plain version of kernel A (quant._ln_qkv_q8_temporal_impl):
    x (B, T1, S, D) -> (B, T1, S, I) in x.dtype."""
    bsz, t1, s_len, d = x.shape
    y = _ln(x.reshape(-1, d).float(), s.float(), b.float())
    q, rs = _quant_rows(y)
    acc = _q8_dot(q, wq) * rs * ws.float()
    # qkv in the activation dtype before the self-subtract (quant.py:512-517)
    qkv = acc.reshape(bsz, t1, s_len, wq.shape[1]).to(x.dtype)
    return temporal_packed_plain(qkv, heads)


def ln_qkv_q8_temporal_attention(x, s, b, wq, ws, heads: int):
    """Fused LN -> int8 QKV -> self-subtract temporal attention:
    x (B, T1, S, D) -> (B, T1, S, I). CPU tensors take the plain version."""
    if not x.is_cuda:
        return ln_qkv_q8_temporal_plain(x, s, b, wq, ws, heads)
    bsz, t1, s_len, d = x.shape
    i3 = wq.shape[1]
    inner = i3 // 3
    _lib.check_act(x, "x")
    _check_q8(wq, ws, d, i3)
    check_temporal(t1, inner, heads)
    lib, st, dt = _lib.load(), _lib.stream(), _lib.DTYPE_CODE[x.dtype]
    rows = bsz * t1 * s_len
    q = torch.empty((rows, d), dtype=torch.int8, device=x.device)
    rs = torch.empty((rows,), dtype=torch.float32, device=x.device)
    s32, b32, ws32 = _lib.f32(s), _lib.f32(b), _lib.f32(ws)
    _lib.check(lib.istvt_ln_quant_rows(x.data_ptr(), dt, s32.data_ptr(),
                                       b32.data_ptr(), q.data_ptr(),
                                       rs.data_ptr(), rows, d, st),
               "ln_quant_rows")
    qkv = torch.empty((bsz, t1, s_len, i3), dtype=x.dtype, device=x.device)
    _gemm(lib, st, q, wq, rs, ws32, None, None, qkv, gelu=False)
    out = temporal_core(qkv, heads)
    _lib.LAUNCHES["ln_qkv_q8_temporal_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel B: t-out-proj (W8A8) + bias -> LN -> int8 QKV -> spatial attention


def mm_q8_ln_qkv_q8_spatial_plain(a, woq, wos, bo, s, b, wq, ws,
                                  heads: int, n_valid: int = -1):
    """Plain version of kernel B (quant._mm_q8_ln_qkv_q8_spatial_impl):
    a (G, S, I_in) -> (G, S, I) in a.dtype."""
    g, s_len, d_in = a.shape
    if n_valid < 0:
        n_valid = s_len
    inner = wq.shape[1] // 3
    qa, rsa = _quant_rows(a.reshape(-1, d_in).float())
    y = _q8_dot(qa, woq) * rsa * wos.float() + bo.float()   # stays f32
    hn = _ln(y, s.float(), b.float())
    qh, rsh = _quant_rows(hn)
    x = (_q8_dot(qh, wq) * rsh * ws.float()).to(a.dtype)
    return spatial_packed_plain(x.reshape(g, s_len, 3 * inner), heads,
                                n_valid)


def mm_q8_ln_qkv_q8_spatial_attention(a, woq, wos, bo, s, b, wq, ws,
                                      heads: int, n_valid: int = -1):
    """Fused t-out-proj (W8A8) -> LN -> int8 QKV -> spatial attention:
    a (G, S, I_in) -> (G, S, I). CPU tensors take the plain version."""
    if not a.is_cuda:
        return mm_q8_ln_qkv_q8_spatial_plain(a, woq, wos, bo, s, b, wq, ws,
                                             heads, n_valid)
    g, s_len, d_in = a.shape
    if n_valid < 0:
        n_valid = s_len
    d_mid, i3 = woq.shape[1], wq.shape[1]
    inner = i3 // 3
    _lib.check_act(a, "a")
    _check_q8(woq, wos, d_in, d_mid)
    _check_q8(wq, ws, d_mid, i3)
    check_spatial(s_len, inner, heads)
    lib, st, dt = _lib.load(), _lib.stream(), _lib.DTYPE_CODE[a.dtype]
    rows = g * s_len
    dev = a.device
    qa = torch.empty((rows, d_in), dtype=torch.int8, device=dev)
    rsa = torch.empty((rows,), dtype=torch.float32, device=dev)
    _lib.check(lib.istvt_quant_rows(a.data_ptr(), dt, qa.data_ptr(),
                                    rsa.data_ptr(), rows, d_in, st),
               "quant_rows")
    y = torch.empty((rows, d_mid), dtype=torch.float32, device=dev)
    _gemm(lib, st, qa, woq, rsa, _lib.f32(wos), _lib.f32(bo), None, y,
          gelu=False)
    qh = torch.empty((rows, d_mid), dtype=torch.int8, device=dev)
    rsh = torch.empty((rows,), dtype=torch.float32, device=dev)
    s32, b32 = _lib.f32(s), _lib.f32(b)
    _lib.check(lib.istvt_ln_quant_rows(y.data_ptr(), 0, s32.data_ptr(),
                                       b32.data_ptr(), qh.data_ptr(),
                                       rsh.data_ptr(), rows, d_mid, st),
               "ln_quant_rows")
    qkv = torch.empty((g, s_len, i3), dtype=a.dtype, device=dev)
    _gemm(lib, st, qh, wq, rsh, _lib.f32(ws), None, None, qkv, gelu=False)
    out = spatial_core(qkv, heads, n_valid)
    _lib.LAUNCHES["mm_q8_ln_qkv_q8_spatial_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel C: s-out-proj (W8A8) + bias + residual -> PreNorm fully-int8 FF


def matmul_q8_res_ln_ff_q8_full_plain(a, r, wqo, wso, bo, s, b, w1q, w1s,
                                      b1, w2q, w2s, b2):
    """Plain version of kernel C (quant._mm_q8_res_ln_ff_q8_impl):
    y = a @ dq(wqo) + bo + r;  y + fc2_q8(gelu_tanh(fc1_q8(LN(y))))."""
    d = wqo.shape[1]
    lead = a.shape[:-1]
    q, rs = _quant_rows(a.reshape(-1, a.shape[-1]).float())
    y = _q8_dot(q, wqo) * rs * wso.float() + bo.float() \
        + r.reshape(-1, d).float()
    h = _ln(y, s.float(), b.float())
    q1, rs1 = _quant_rows(h)
    hid = _gelu_tanh(_q8_dot(q1, w1q) * rs1 * w1s.float() + b1.float())
    q2, rs2 = _quant_rows(hid)
    o = _q8_dot(q2, w2q) * rs2 * w2s.float() + b2.float()
    return (o + y).to(a.dtype).reshape(*lead, d)


def matmul_q8_res_ln_ff_q8_full(a, r, wqo, wso, bo, s, b, w1q, w1s, b1,
                                w2q, w2s, b2):
    """y = a @ dq(wqo) + bo + r;  return y + FF_int8(LN(y)):
    a (..., N, I_in), r (..., N, D) -> (..., N, D). CPU tensors take the
    plain version."""
    if not a.is_cuda:
        return matmul_q8_res_ln_ff_q8_full_plain(a, r, wqo, wso, bo, s, b,
                                                 w1q, w1s, b1, w2q, w2s, b2)
    d_in, d, hdim = a.shape[-1], wqo.shape[1], w1q.shape[1]
    _lib.check_act(a, "a")
    _lib.check_act(r, "r")
    if r.dtype != a.dtype or r.shape[:-1] != a.shape[:-1] or r.shape[-1] != d:
        raise ValueError(f"residual {tuple(r.shape)} {r.dtype} does not "
                         f"match a {tuple(a.shape)} {a.dtype}, D={d}")
    _check_q8(wqo, wso, d_in, d)
    _check_q8(w1q, w1s, d, hdim)
    _check_q8(w2q, w2s, hdim, d)
    lib, st, dt = _lib.load(), _lib.stream(), _lib.DTYPE_CODE[a.dtype]
    rows = a.numel() // d_in
    dev = a.device
    q = torch.empty((rows, d_in), dtype=torch.int8, device=dev)
    rs = torch.empty((rows,), dtype=torch.float32, device=dev)
    _lib.check(lib.istvt_quant_rows(a.data_ptr(), dt, q.data_ptr(),
                                    rs.data_ptr(), rows, d_in, st),
               "quant_rows")
    y = torch.empty((rows, d), dtype=torch.float32, device=dev)
    _gemm(lib, st, q, wqo, rs, _lib.f32(wso), _lib.f32(bo), r, y, gelu=False)
    q1 = torch.empty((rows, d), dtype=torch.int8, device=dev)
    rs1 = torch.empty((rows,), dtype=torch.float32, device=dev)
    s32, b32 = _lib.f32(s), _lib.f32(b)
    _lib.check(lib.istvt_ln_quant_rows(y.data_ptr(), 0, s32.data_ptr(),
                                       b32.data_ptr(), q1.data_ptr(),
                                       rs1.data_ptr(), rows, d, st),
               "ln_quant_rows")
    hid = torch.empty((rows, hdim), dtype=torch.float32, device=dev)
    _gemm(lib, st, q1, w1q, rs1, _lib.f32(w1s), _lib.f32(b1), None, hid,
          gelu=True)
    q2 = torch.empty((rows, hdim), dtype=torch.int8, device=dev)
    rs2 = torch.empty((rows,), dtype=torch.float32, device=dev)
    _lib.check(lib.istvt_quant_rows(hid.data_ptr(), 0, q2.data_ptr(),
                                    rs2.data_ptr(), rows, hdim, st),
               "quant_rows")
    out = torch.empty(a.shape[:-1] + (d,), dtype=a.dtype, device=dev)
    _gemm(lib, st, q2, w2q, rs2, _lib.f32(w2s), _lib.f32(b2), y, out,
          gelu=False)
    _lib.LAUNCHES["matmul_q8_res_ln_ff_q8_full"] += 1
    return out


# ---------------------------------------------------------------------------
# launch plumbing


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


def _gemm(lib, st, q, wq, rs, ws32, bias, res, out, gelu: bool):
    m, k = q.shape
    n = wq.shape[1]
    res_dt = _lib.DTYPE_CODE[res.dtype] if res is not None else 0
    _lib.check(lib.istvt_gemm_q8(q.data_ptr(), wq.data_ptr(), rs.data_ptr(),
                                 ws32.data_ptr(), _lib.ptr(bias),
                                 _lib.ptr(res), res_dt, out.data_ptr(),
                                 _lib.DTYPE_CODE[out.dtype], int(gelu),
                                 m, n, k, st),
               "gemm_q8")
