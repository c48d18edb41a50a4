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
Sources in csrc/, built at first use by _lib.py, which also holds the
launch counts of every wrapper (_lib.LAUNCHES).
"""
