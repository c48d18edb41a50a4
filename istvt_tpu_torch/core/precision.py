"""Matmul/conv precision control (counterpart of istvt_tpu/core/precision.py).

A float32 matmul on the card runs in full float32 by default, but a
float32 cuDNN convolution runs in TF32 (about three decimal digits).
Parity runs against the JAX reference need both off, as the JAX side
needs `jax.default_matmul_precision("highest")`.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def highest():
    """Full-float32 matmuls and convolutions inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
