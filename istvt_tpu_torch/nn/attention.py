"""The decomposed attention of ISTVT (counterpart of
istvt_tpu/nn/attention.py): the XLA-math branches that return the attention
maps and take the `attn_bias` perturbation, and the fused PreNorm branches
of the float forward.

XLA-math branches (`spatial_only_attention`, `temporal_residual_attention`,
`self_subtract`; JAX :72-176) are plain torch, as JAX computes them outside
any Pallas kernel. They follow JAX's roundings: scores and softmax in f32
(the products of x's dtype accumulated in f32, as
`preferred_element_type=float32`), the bias added AFTER the softmax (its
gradient is d out / d map), the map cast to v's dtype before PV, the
result rounded once to v's dtype. Maps come back in the public orders:
spatial (B, H, T+1, S, S), temporal (B, H, S, T+1, T+1).

Fused branches: each runs three kernel wrappers: LN + QKV GEMM
(kernels/linear.py), the packed attention core (kernels/attention.py),
out-projection GEMM + bias (+ the layer residual). The kernels take JAX's (in, out) weights
from the module's `io_weights()`: in eval mode the `qkv_w` / `out_w`
copies that models/istvt.pack_params attaches at build time, in train
mode copies built from the parameters on every call (differentiable, as
JAX concatenates its weights inside the differentiated function). Every
wrapper is differentiable, so the branches train.

Int8 blocks (`temporal_block_q8`, `spatial_block_q8`; JAX :220-257): the
serving form of the fused branches for q8_ff='mixed' / 'bf16', with the
two projections W8A8 (kernels/quant.ln_matmul_q8, #4, and
matmul_q8_bias_residual, #5, from the modules' int8 copies) around the
same packed attention cores. Serving only: not differentiable.
"""
from __future__ import annotations

import torch

from istvt_tpu_torch.kernels.attention import (spatial_attention_packed,
                                               temporal_attention_packed)
from istvt_tpu_torch.kernels.linear import ln_matmul, matmul_bias_residual
from istvt_tpu_torch.kernels.quant import (kmajor_given, ln_matmul_q8,
                                           matmul_q8_bias_residual)
from istvt_tpu_torch.nn.layers import linear


def _out(fn, o):
    """The to_out projection (+ bias) of an attention module."""
    lin = fn.to_out[0]
    return linear(o, lin.weight, lin.bias)


def _scores(einsum: str, q, k, scale):
    """f32 scores of x's-dtype q, k (exact products, f32 sums), then the
    scale, as jnp.einsum(preferred_element_type=float32) * scale."""
    return torch.einsum(einsum, q.float(), k.float()) * scale


def _pv(einsum: str, attn, v):
    """PV with the map cast to v's dtype, f32 sums, one rounding to v's
    dtype (JAX :106-108, :169-171)."""
    return torch.einsum(einsum, attn.to(v.dtype).float(), v.float()).to(
        v.dtype)


def spatial_only_attention(fn, x, heads: int, tokens_per_frame: int,
                           return_attn: bool = False, attn_bias=None):
    """Per-frame attention over the hw axis (JAX :72-113, its XLA branch).
    fn: SpatialAttention; x (B, (T+1)*S, D) normalised -> out (B, N, D),
    and with return_attn the map (B, H, T+1, S, S) (+ attn_bias, which
    arrives in the same order)."""
    b, n, _ = x.shape
    s = tokens_per_frame
    t1 = n // s
    qkv = linear(x, fn.to_qkv.weight)
    q, k, v = (u.reshape(b, t1, s, heads, -1) for u in qkv.chunk(3, dim=-1))
    dots = _scores("btihd,btjhd->bthij", q, k, q.shape[-1] ** -0.5)
    attn = dots.softmax(dim=-1)
    if attn_bias is not None:
        attn = attn + attn_bias.transpose(1, 2)
    out = _pv("bthij,btjhd->btihd", attn, v).reshape(b, n, -1)
    out = _out(fn, out)
    return (out, attn.transpose(1, 2)) if return_attn else out


def self_subtract(x_bt, first_passthrough: int = 2):
    """cat(x[:, :2], x[:, 2:] - x[:, 1:-1]) over the t axis (JAX
    :116-122): rows 0 (temporal CLS) and 1 pass through, later rows become
    frame differences."""
    k = first_passthrough
    return torch.cat([x_bt[:, :k], x_bt[:, k:] - x_bt[:, k - 1:-1]], dim=1)


def temporal_residual_attention(fn, x, heads: int, tokens_per_frame: int,
                                return_attn: bool = False, attn_bias=None):
    """Self-subtract temporal attention over the t axis per location (JAX
    :125-176, its XLA branch): one GEMM over [to_qk | to_v], the
    self-subtract on the PROJECTED q|k (in bf16 the two orders round
    differently). fn: TemporalAttention; x (B, (T+1)*S, D) normalised ->
    out (B, N, D), and with return_attn the map (B, H, S, T+1, T+1)."""
    b, n, _ = x.shape
    s = tokens_per_frame
    t1 = n // s
    w = torch.cat([fn.to_qk.weight, fn.to_v.weight], dim=0)
    qkv = linear(x, w)
    inner = fn.to_v.weight.shape[0]
    qk, v = qkv[..., :2 * inner], qkv[..., 2 * inner:]
    qk = self_subtract(qk.reshape(b, t1, s, 2 * inner)).reshape(b, n, -1)
    q, k = (u.reshape(b, t1, s, heads, -1) for u in qk.chunk(2, dim=-1))
    v = v.reshape(b, t1, s, heads, -1)
    dots = _scores("bishd,bjshd->bshij", q, k, q.shape[-1] ** -0.5)
    attn = dots.softmax(dim=-1)
    if attn_bias is not None:
        attn = attn + attn_bias.transpose(1, 2)
    out = _pv("bshij,bjshd->bishd", attn, v).reshape(b, n, -1)
    out = _out(fn, out)
    return (out, attn.transpose(1, 2)) if return_attn else out


def temporal_block_fused(pre, x, heads: int, tokens_per_frame: int):
    """Whole PreNorm temporal branch: LN + packed QKV GEMM -> self-subtract
    attention -> out-projection + bias. pre: PreNorm(TemporalAttention);
    x (B, N, D) -> (B, N, D)."""
    at = pre.fn
    w_qkv, w_out = at.io_weights()                   # (D, 3I), (I, D)
    b, n, _ = x.shape
    t1 = n // tokens_per_frame
    inner = w_out.shape[0]
    qkv = ln_matmul(x, pre.norm.weight, pre.norm.bias, w_qkv)
    out = temporal_attention_packed(
        qkv.reshape(b, t1, tokens_per_frame, 3 * inner), heads)
    return matmul_bias_residual(out.reshape(b, n, inner), w_out,
                                at.to_out[0].bias, None)


def spatial_block_fused(pre, x, heads: int, tokens_per_frame: int, residual,
                        n_valid: int = -1):
    """Whole PreNorm spatial branch with the layer residual fused into the
    out-projection epilogue; keys >= n_valid are masked. pre:
    PreNorm(SpatialAttention); x, residual (B, N, D) -> (B, N, D)."""
    asp = pre.fn
    w_qkv, w_out = asp.io_weights()
    b, n, _ = x.shape
    t1 = n // tokens_per_frame
    inner = w_out.shape[0]
    qkv = ln_matmul(x, pre.norm.weight, pre.norm.bias, w_qkv)
    out = spatial_attention_packed(
        qkv.reshape(b * t1, tokens_per_frame, 3 * inner), heads, n_valid)
    return matmul_bias_residual(out.reshape(b, n, inner), w_out,
                                asp.to_out[0].bias, residual)


def temporal_block_q8(pre, x, heads: int, tokens_per_frame: int):
    """Int8 PreNorm temporal branch: LN + W8A8 QKV (#4) -> self-subtract
    attention -> W8A8 out-projection + bias (#5, no residual). pre:
    PreNorm(TemporalAttention) carrying quantize_params' copies; x (B, N,
    D) -> (B, N, D)."""
    at = pre.fn
    b, n, _ = x.shape
    inner = at.out_wq.shape[0]
    qkv = ln_matmul_q8(x, pre.norm.weight, pre.norm.bias, at.qkv_wq,
                       at.qkv_ws, wk=kmajor_given(at.qkv_wk))
    out = temporal_attention_packed(
        qkv.reshape(b, n // tokens_per_frame, tokens_per_frame, 3 * inner),
        heads)
    return matmul_q8_bias_residual(out.reshape(b, n, inner), at.out_wq,
                                   at.out_ws, at.to_out[0].bias, None,
                                   wk=kmajor_given(at.out_wk))


def spatial_block_q8(pre, x, heads: int, tokens_per_frame: int, residual,
                     n_valid: int = -1):
    """Int8 PreNorm spatial branch: LN + W8A8 QKV (#4) -> spatial
    attention (keys >= n_valid masked) -> W8A8 out-projection + bias + the
    layer residual (#5). x, residual (B, N, D) -> (B, N, D)."""
    asp = pre.fn
    b, n, _ = x.shape
    inner = asp.out_wq.shape[0]
    qkv = ln_matmul_q8(x, pre.norm.weight, pre.norm.bias, asp.qkv_wq,
                       asp.qkv_ws, wk=kmajor_given(asp.qkv_wk))
    out = spatial_attention_packed(
        qkv.reshape(b * (n // tokens_per_frame), tokens_per_frame,
                    3 * inner), heads, n_valid)
    return matmul_q8_bias_residual(out.reshape(b, n, inner), asp.out_wq,
                                   asp.out_ws, asp.to_out[0].bias, residual,
                                   wk=kmajor_given(asp.out_wk))
