"""Layers of the ported slices (counterpart of istvt_tpu/nn/layers.py).

Plain functions on tensors with the JAX package's numerics: exact-erf
GELU, LayerNorm eps 1e-5 with the two-pass variance in f32, eval and
train BatchNorm eps 1e-5,
MaxPool padding with -inf like torch MaxPool2d(3, s, 1). Convolutions take
NCHW activations (kept in channels_last memory by the stem) and OIHW
weights, and run through cuDNN on the card, as XLA computes them outside
any Pallas kernel in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-5


def relu(x):
    return torch.clamp_min(x, 0)


def gelu(x):
    """Exact GELU (erf), torch nn.GELU()'s default (nn/layers.gelu)."""
    return F.gelu(x, approximate="none")


def conv2d(x, w, b=None, stride: int = 1, padding: int = 0, groups: int = 1):
    """torch Conv2d semantics; the weight is cast to the activation dtype
    and the bias added after the convolution, as nn/layers.conv2d does."""
    y = F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding,
                 groups=groups)
    if b is not None:
        y = y + b.to(y.dtype)[None, :, None, None]
    return y


def separable_conv2d(x, dw, pw, padding: int = 1):
    """Depthwise 3x3 (stride 1) then pointwise 1x1."""
    x = conv2d(x, dw, padding=padding, groups=x.shape[1])
    return conv2d(x, pw)


def bn_affine(weight, bias, mean, var, eps: float = _EPS):
    """Eval BN as f32 (A, B) with y = x * A + B (models/xception._bn_affine)."""
    inv = torch.rsqrt(var.float() + eps)
    a = weight.float() * inv
    return a, bias.float() - mean.float() * a


def batchnorm_eval(x, weight, bias, mean, var, eps: float = _EPS):
    """Eval BatchNorm over the channel axis 1 (nn/layers.batchnorm,
    train=False): the scale and shift are formed in f32 and cast to the
    activation dtype before they are applied."""
    inv = torch.rsqrt(var.float() + eps)
    scale = (weight.float() * inv).to(x.dtype)
    shift = (bias.float() - mean.float() * weight.float() * inv).to(x.dtype)
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def batchnorm_train(x, weight, bias, running_mean, running_var,
                    momentum: float = 0.1, eps: float = _EPS):
    """Train BatchNorm over the channel axis 1 (nn/layers.batchnorm,
    train=True), differentiable through the batch statistics.

    As jnp.mean / jnp.var of an array in the activation dtype do, the batch
    mean and (biased) variance are summed in f32 and rounded to x's dtype
    (bf16 under --bf16, where torch's own BN keeps f32 statistics). The
    scale and shift are formed in f32 from those rounded statistics and
    cast to x's dtype. The f32 running statistics are updated in place:
    (1 - momentum) * old + momentum * new, with the unbiased variance
    var * n / (n - 1) taken in x's dtype (the factor rounded to it too)."""
    dims = [0] + list(range(2, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims).to(x.dtype)
    var = xf.var(dim=dims, unbiased=False).to(x.dtype)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        unbiased = var * torch.tensor(n / max(n - 1, 1), dtype=var.dtype)
        running_mean.copy_((1 - momentum) * running_mean
                           + momentum * mean.to(running_mean.dtype))
        running_var.copy_((1 - momentum) * running_var
                          + momentum * unbiased.to(running_var.dtype))
    inv = torch.rsqrt(var.float() + eps)
    scale = (weight.float() * inv).to(x.dtype)
    shift = (bias.float() - mean.float() * weight.float() * inv).to(x.dtype)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.reshape(shape) + shift.reshape(shape)


def max_pool2d(x, window: int = 3, stride: int = 2, padding: int = 1):
    """torch MaxPool2d(window, stride, padding): pads with -inf."""
    return F.max_pool2d(x, window, stride, padding)


def layernorm(x, weight, bias, eps: float = _EPS):
    """f32 statistics, result in x.dtype (nn/layers.layernorm)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def linear(x, w, b=None):
    """x @ w.T (+ b) for a torch-layout (out, in) weight, rounded to
    x.dtype before the bias is added (nn/layers.linear)."""
    y = x @ w.to(x.dtype).t()
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def dropout_mask(shape, rate: float, rng, device):
    """The keep mask of one dropout call (bool, True = kept with
    probability 1 - rate), drawn from `rng`: a torch.Generator on `device`,
    or a callable (shape, device) -> bool mask that hands out given masks
    in call order (the tests give both packages the same masks)."""
    if callable(rng):
        return rng(tuple(shape), device)
    return torch.rand(shape, generator=rng, device=device) < 1.0 - rate


def dropout(x, rate: float, train: bool, mask=None):
    """nn/layers.dropout: the identity unless training with rate > 0 and a
    mask; else the kept values scaled by 1 / (1 - rate), the rest 0."""
    if not train or rate == 0.0 or mask is None:
        return x
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
