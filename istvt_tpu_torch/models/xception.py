"""Xception backbone (counterpart of istvt_tpu/models/xception.py).

The module tree and its state_dict keys are the reference's
(network/xception.py): conv1/bn1, conv2/bn2, block{1..12}.rep.N with the
ReLU modules counted in N, skip/skipbn, conv3/bn3, conv4/bn4, fc — so
`istvt_tpu.compat.torch_import.xception_from_torch` reads a port
state_dict unchanged. Only `low_level_features` (conv1 through block3, the
ISTVT stem) runs, in eval mode or, for training, with train-mode
BatchNorm (batch statistics; the running statistics updated in place);
the later blocks hold weights only.

Activations enter and leave as NHWC; inside, they are NCHW tensors in
channels_last memory (a free permute of NHWC), the layout cuDNN prefers.

Serving stores the inter-conv activations as float8_e4m3fn (the JAX
package's stem_store='f8'): eval BN folds into the conv weights in f32
before the cast to the compute dtype, the following ReLU moves into the
producing epilogue, and every tensor between two convolutions is rounded
to e4m3 (models/xception.block_apply :124-181, _entry :228-242), past the
+-464 tie to NaN as jnp.astype(float8_e4m3fn) rounds (see `to_store`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from istvt_tpu_torch.nn.layers import (batchnorm_eval, batchnorm_train,
                                       bn_affine, conv2d, max_pool2d, relu,
                                       separable_conv2d)

# (in, out, reps, stride, start_with_relu, grow_first) per block
# (reference network/xception.py:126-140)
BLOCK_SPECS = (
    (64, 128, 2, 2, False, True),
    (128, 256, 2, 2, True, True),
    (256, 728, 2, 2, True, True),
    *((728, 728, 3, 1, True, True),) * 8,
    (728, 1024, 2, 2, True, False),
)


@dataclasses.dataclass(frozen=True)
class XceptionConfig:
    num_classes: int = 1000
    in_channels: int = 3
    low_level_through: int = 3


_E4M3_NAN_PAST = 464.0   # the tie between e4m3's largest finite 448 and 480
_E4M3_NAN_BITS = 0x7F


def to_store(x, store, nonneg: bool = False):
    """x cast to the storage dtype as jnp.astype casts it. For e4m3fn that
    is torch's rounding (identical up to the +-464 tie, ties to even
    included) except past the tie, where torch saturates to +-448 and JAX
    gives NaN: one masked_fill on the f8 bytes puts the NaN back.
    nonneg: x is a ReLU output, so x > 464 finds the overflow without the
    pass that |x| takes."""
    y = x.to(store)
    if store == torch.float8_e4m3fn:
        over = (x if nonneg else x.abs()) > _E4M3_NAN_PAST
        y.view(torch.uint8).masked_fill_(over, _E4M3_NAN_BITS)
    return y


def _block_filters(spec):
    in_f, out_f, reps, _, _, grow_first = spec
    if grow_first:
        return [(in_f, out_f)] + [(out_f, out_f)] * (reps - 1)
    return [(in_f, in_f)] * (reps - 1) + [(in_f, out_f)]


class SeparableConv2d(nn.Module):
    """Depthwise 3x3 `conv1` + 1x1 `pointwise` (reference xception.py:39-49)."""

    def __init__(self, cin, cout, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cin, 3, 1, 1, groups=cin, bias=False,
                               device=device)
        self.pointwise = nn.Conv2d(cin, cout, 1, bias=False, device=device)


class Block(nn.Module):
    """Residual sepconv block (reference xception.py:52-101)."""

    def __init__(self, spec, device=None):
        super().__init__()
        in_f, out_f, _, stride, start_with_relu, _ = spec
        self.stride, self.start_with_relu = stride, start_with_relu
        if out_f != in_f or stride != 1:
            self.skip = nn.Conv2d(in_f, out_f, 1, stride=stride, bias=False,
                                  device=device)
            self.skipbn = nn.BatchNorm2d(out_f, device=device)
        else:
            self.skip = None
        rep = []
        for ci, co in _block_filters(spec):
            rep += [nn.ReLU(), SeparableConv2d(ci, co, device=device),
                    nn.BatchNorm2d(co, device=device)]
        if not start_with_relu:
            rep = rep[1:]
        if stride != 1:
            rep.append(nn.MaxPool2d(3, stride, 1))
        self.rep = nn.Sequential(*rep)

    def units(self):
        seps = [m for m in self.rep if isinstance(m, SeparableConv2d)]
        bns = [m for m in self.rep if isinstance(m, nn.BatchNorm2d)]
        return list(zip(seps, bns))

    def forward(self, x, store_dtype=None, compute_dtype=None):
        if store_dtype is not None:
            return self._forward_stored(x, store_dtype, compute_dtype)
        y = x
        for i, (sep, bn) in enumerate(self.units()):
            if i > 0 or self.start_with_relu:
                y = relu(y)
            y = separable_conv2d(y, sep.conv1.weight, sep.pointwise.weight)
            y = _batchnorm(bn, y)
        if self.stride != 1:
            y = max_pool2d(y, 3, self.stride, 1)
        if self.skip is not None:
            skip = conv2d(x, self.skip.weight, stride=self.stride)
            skip = _batchnorm(self.skipbn, skip)
        else:
            skip = x
        return y + skip

    def _forward_stored(self, x, store, cd):
        up = lambda v: v if v.dtype == cd else v.to(cd)  # noqa: E731
        units = self.units()
        y = x
        for i, (sep, bn) in enumerate(units):
            if i == 0 and self.start_with_relu:
                y = relu(up(y))
            y = to_store(conv2d(up(y), sep.conv1.weight, padding=1,
                                groups=y.shape[1]), store)
            w, b = _fold(sep.pointwise.weight, bn, cd)
            z = conv2d(up(y), w, b)
            inner = i + 1 < len(units)
            if inner:
                z = relu(z)   # the next unit's pre-relu, in this epilogue
            y = to_store(z, store, nonneg=inner)
        y = up(y)
        if self.stride != 1:
            y = max_pool2d(y, 3, self.stride, 1)
        if self.skip is not None:
            w, b = _fold(self.skip.weight, self.skipbn, cd)
            skip = conv2d(up(x), w, b, stride=self.stride)
        else:
            skip = up(x)
        return to_store(y + skip, store)


def _bn(bn):
    return bn.weight, bn.bias, bn.running_mean, bn.running_var


def _batchnorm(bn, x):
    """BatchNorm as the module's mode says: train (batch statistics, the
    running ones updated in place) or eval."""
    if bn.training:
        return batchnorm_train(x, *_bn(bn))
    return batchnorm_eval(x, *_bn(bn))


def _fold(w, bn, cd):
    """Eval BN folded into the preceding conv: (w * A in f32 -> cd, B -> cd)."""
    a, b = bn_affine(*_bn(bn))
    return (w.float() * a[:, None, None, None]).to(cd), b.to(cd)


class Xception(nn.Module):
    def __init__(self, cfg: XceptionConfig = XceptionConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv2d(cfg.in_channels, 32, 3, 2, 0, bias=False,
                               device=device)
        self.bn1 = nn.BatchNorm2d(32, device=device)
        self.conv2 = nn.Conv2d(32, 64, 3, bias=False, device=device)
        self.bn2 = nn.BatchNorm2d(64, device=device)
        for i, spec in enumerate(BLOCK_SPECS):
            setattr(self, f"block{i + 1}", Block(spec, device=device))
        self.conv3 = SeparableConv2d(1024, 1536, device=device)
        self.bn3 = nn.BatchNorm2d(1536, device=device)
        self.conv4 = SeparableConv2d(1536, 2048, device=device)
        self.bn4 = nn.BatchNorm2d(2048, device=device)
        self.fc = nn.Linear(2048, cfg.num_classes, device=device)

    def _entry(self, x, store):
        if store is not None:
            cd = x.dtype
            w, b = _fold(self.conv1.weight, self.bn1, cd)
            x = to_store(relu(conv2d(x, w, b, stride=2)), store, nonneg=True)
            w, b = _fold(self.conv2.weight, self.bn2, cd)
            return to_store(relu(conv2d(x.to(cd), w, b)), store, nonneg=True)
        x = conv2d(x, self.conv1.weight, stride=2)
        x = relu(_batchnorm(self.bn1, x))
        x = conv2d(x, self.conv2.weight)
        return relu(_batchnorm(self.bn2, x))

    def low_level_features(self, x, store_dtype: Optional[torch.dtype] = None):
        """(N, H, W, C) NHWC -> (N, h, w, 728) NHWC in x.dtype, in the
        modules' mode (train mode updates the BN running statistics).

        store_dtype (eval-mode serving): storage dtype of the inter-conv
        tensors (torch.float8_e4m3fn); compute stays in x.dtype."""
        if store_dtype is not None and self.training:
            raise ValueError("the f8 stem store is for eval-mode serving")
        cd = x.dtype
        x = self._entry(x.permute(0, 3, 1, 2), store_dtype)
        for i in range(1, self.cfg.low_level_through + 1):
            x = getattr(self, f"block{i}")(x, store_dtype, cd)
        return x.to(cd).permute(0, 2, 3, 1)


class TransferModel(nn.Module):
    """`xcep.model.*` wrapper of the reference (models_copy.py:40-47)."""

    def __init__(self, cfg: XceptionConfig = XceptionConfig(num_classes=2),
                 device=None):
        super().__init__()
        self.model = Xception(cfg, device=device)


@torch.no_grad()
def init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise Xception weights in place with the JAX package's
    distributions (nn/layers.py inits): conv and linear weights/biases
    U(+-1/sqrt(fan_in)), BN scale 1, bias 0, running mean 0, var 1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = fan_in ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    return module
