"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

quant.py:
  ln_qkv_q8_temporal_attention       LN -> int8 QKV -> self-subtract
                                     temporal attention
  mm_q8_ln_qkv_q8_spatial_attention  int8 out-proj -> LN -> int8 QKV ->
                                     masked spatial attention
  matmul_q8_res_ln_ff_q8_full        int8 out-proj + residual -> PreNorm
                                     fully-int8 FF
Sources in csrc/, built at first use by _lib.py.
"""
