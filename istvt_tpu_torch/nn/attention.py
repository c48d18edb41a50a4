"""The fused PreNorm attention branches of the float forward
(counterpart of istvt_tpu/nn/attention.py:179-217).

Each branch runs three kernel wrappers: LN + QKV GEMM (kernels/linear.py),
the packed attention core (kernels/attention.py), out-projection GEMM +
bias (+ the layer residual). The kernels take JAX's (in, out) weights:
the modules' `qkv_w` and `out_w` copies, which models/istvt.pack_params
attaches at build time.
"""
from __future__ import annotations

from istvt_tpu_torch.kernels.attention import (spatial_attention_packed,
                                               temporal_attention_packed)
from istvt_tpu_torch.kernels.linear import ln_matmul, matmul_bias_residual


def temporal_block_fused(pre, x, heads: int, tokens_per_frame: int):
    """Whole PreNorm temporal branch: LN + packed QKV GEMM -> self-subtract
    attention -> out-projection + bias. pre: PreNorm(TemporalAttention);
    x (B, N, D) -> (B, N, D)."""
    at = pre.fn
    b, n, _ = x.shape
    t1 = n // tokens_per_frame
    inner = at.out_w.shape[0]
    qkv = ln_matmul(x, pre.norm.weight, pre.norm.bias, at.qkv_w)  # (D, 3I)
    out = temporal_attention_packed(
        qkv.reshape(b, t1, tokens_per_frame, 3 * inner), heads)
    return matmul_bias_residual(out.reshape(b, n, inner), at.out_w,
                                at.to_out[0].bias, None)


def spatial_block_fused(pre, x, heads: int, tokens_per_frame: int, residual,
                        n_valid: int = -1):
    """Whole PreNorm spatial branch with the layer residual fused into the
    out-projection epilogue; keys >= n_valid are masked. pre:
    PreNorm(SpatialAttention); x, residual (B, N, D) -> (B, N, D)."""
    asp = pre.fn
    b, n, _ = x.shape
    t1 = n // tokens_per_frame
    inner = asp.out_w.shape[0]
    qkv = ln_matmul(x, pre.norm.weight, pre.norm.bias, asp.qkv_w)
    out = spatial_attention_packed(
        qkv.reshape(b * t1, tokens_per_frame, 3 * inner), heads, n_valid)
    return matmul_bias_residual(out.reshape(b, n, inner), asp.out_w,
                                asp.to_out[0].bias, residual)
