"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

quant.py (int8 serving path):
  ln_qkv_q8_temporal_attention       LN -> int8 QKV -> self-subtract
                                     temporal attention
  mm_q8_ln_qkv_q8_spatial_attention  int8 out-proj -> LN -> int8 QKV ->
                                     masked spatial attention
  matmul_q8_res_ln_ff_q8_full        int8 out-proj + residual -> PreNorm
                                     fully-int8 FF
attention.py, linear.py, mlp.py (float fused path):
  temporal_attention_packed          self-subtract temporal attention
  spatial_attention_packed           masked per-frame attention
  ln_matmul                          LN -> GEMM
  matmul_bias_residual               GEMM + bias (+ residual)
  ln_ff_residual                     x + fc2(gelu(fc1(LN x)))
  and for training (autograd.Functions' backward and the FF's stash):
  temporal_attention_packed_bwd, spatial_attention_packed_bwd,
  ln_matmul_bwd, ln_ff_residual_h1, ln_ff_residual_bwd
  fused_ff                           fc2(gelu_tanh(fc1 x)), the attention-map
                                     path's feed-forward
Sources in csrc/, built at first use by _lib.py, which also holds the
launch counts of every wrapper (_lib.LAUNCHES). The forwards of the serving
paths are dispatcher ops (ops.py, istvt::<wrapper name>), registered when
this package is imported.

The kernel API, exported here under the names of istvt_tpu.kernels:
  fused_frame_attention        (G, S, dh) per-frame attention (#14)
  fused_frame_attention_mh     (G, S, H*dh), every head, no mask (#15)
  fused_frame_attention_bwd    its backward, separate q, k, v, do (#13)
  fused_temporal_attention     self-subtract temporal attention on
                               separate (B, T1, S, H*dh) q, k, v (#16)
  fused_temporal_attention_bwd its backward (#17)
  spatial_attention_pallas, temporal_attention_pallas: differentiable
  entry points (torch.autograd.Function, as JAX's custom_vjp)
  fused_ff (above)
and conv.sepconv_bn, the fused [ReLU ->] sepconv -> folded BN (#24).
#14-#17 and #24 are on no model path, in either package: the models run
the packed cores and the stem's cuDNN convolutions (the JAX package's
docstring says its nn/attention.py uses these entry points; it uses the
packed kernels). They are reached through this API and the tests only.
Limits: dh in 16/32/64/128 (#13: 16/32/64) at any S for the spatial
entries, dh <= 128 at any T1 >= 2 for the temporal ones; outside them a
CUDA tensor raises NotImplementedError.
"""
from istvt_tpu_torch.kernels.attention import (  # noqa: F401
    fused_frame_attention,
    fused_frame_attention_bwd,
    fused_frame_attention_mh,
    fused_temporal_attention,
    fused_temporal_attention_bwd,
    spatial_attention_pallas,
    temporal_attention_pallas,
)
from istvt_tpu_torch.kernels.mlp import fused_ff  # noqa: F401
from istvt_tpu_torch.kernels import ops  # noqa: F401,E402  (registers)
