"""istvt_tpu_torch — the PyTorch / CUDA port of istvt_tpu for NVIDIA Hopper.

The JAX package `istvt_tpu` is the reference; this package mirrors its
layout (the counterpart of `istvt_tpu/x/y.py` is `istvt_tpu_torch/x/y.py`)
and is held against it by the tests. It imports `torch` and never `jax`.

Ported so far: the int8 W8A8 serving forward of ISTVT
(`ISTVTConfig(use_pallas=True, quantize='int8')`, q8_ff='full',
q8_attn='ingest', stem_store='f8'), the float fused serving forward
(`quantize='none'`), training on the float fused path and on the
XLA-math path (`use_pallas=False`), with dropout and remat, checkpoints,
resume and BN recalibration, and the interpretability path (attention
maps, attn_bias gradients, LRP relevance; the XLA-math eval forward):

  core/      config copies, device selection, TF32 control, dtype cast,
             checkpoints (torch files)
  nn/        the layers the Xception stem and the ST layers use
  kernels/   the per-layer kernels, forward and backward, hand-written CUDA
             for sm_90a (csrc/), each with a plain PyTorch version beside it
  models/    Xception stem, ISTVT, the `istvt` registry key
  compat/    JAX params and TrainState <-> port state_dict and optimizer
  serve.py   bucketed Predictor; serve_daemon.py the HTTP batch server;
             serve_export.py the serving artifact (torch.export program
             with the kernels as istvt:: ops, kernels/ops.py)
  train/     loss, metrics, schedules, the train / eval steps, Trainer,
             recalibrate_bn, the metrics logger
  data/      synthetic clips and a synchronous ClipLoader
  interpret/ LRP rollout, full epsilon-rule LRP, saliency PNGs
  cli/       `python -m istvt_tpu_torch.cli.serve --int8`,
             `python -m istvt_tpu_torch.cli.export --int8 --out DIR`,
             `python -m istvt_tpu_torch.cli.train --dataset synthetic`,
             `python -m istvt_tpu_torch.cli.visualize --dataset synthetic`
"""

__version__ = "0.1.0"
