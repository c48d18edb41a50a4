"""The fused PreNorm attention branches of the float forward
(counterpart of istvt_tpu/nn/attention.py:179-217).

Each branch runs three kernel wrappers: LN + QKV GEMM (kernels/linear.py),
the packed attention core (kernels/attention.py), out-projection GEMM +
bias (+ the layer residual). The kernels take JAX's (in, out) weights
from the module's `io_weights()`: in eval mode the `qkv_w` / `out_w`
copies that models/istvt.pack_params attaches at build time, in train
mode copies built from the parameters on every call (differentiable, as
JAX concatenates its weights inside the differentiated function). Every
wrapper is differentiable, so the branches train.
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
