"""The fused [ReLU ->] separable conv -> folded eval BN (counterpart of
istvt_tpu/kernels/conv.py).

  sepconv_bn(x, dw, pw, a, b, relu_in=False)
      x (N, H, W, Cin) NHWC -> (N, H, W, Cout) in x's dtype:
      [relu ->] depthwise 3x3 (pad 1, stride 1) -> pointwise -> o * a + b

TPU kernel _sepconv_bn_impl, one launch of csrc/sepconv_bn.cu on a CUDA
tensor (the design and its bound are in that file); a CPU tensor runs the
plain version, sepconv_bn_plain, in the kernel's rounding order.
Differentiable: the backward is autograd through _sepconv_bn_reference (a
grouped conv, an einsum and the affine), as JAX's _sepconv_bwd is jax.vjp of
its XLA formulation: the JAX package has no backward kernel for it.

As in the JAX package, the kernel is on no model path: models/xception.py
runs the stem's units as cuDNN convolutions with the BN folded into the
pointwise weights (JAX measured the TPU kernel slower than XLA's convs and
left it unwired, istvt_tpu/kernels/conv.py:20-28). It is reached only
through this module.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from istvt_tpu_torch.kernels import _lib


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Inference BN -> (A, B) with y = x * A + B."""
    a = scale * torch.rsqrt(var + eps)
    return a, bias - mean * a


def _affine(a, b, cout):
    """a, b as (Cout,) f32: they may come as (Cout,), (1, Cout) or
    (1, 1, Cout), each broadcastable to the output's channel axis."""
    return tuple(t.to(torch.float32).reshape(-1).expand(cout).contiguous()
                 for t in (a, b))


def _sepconv_bn_reference(x, dw, pw, a, b, relu_in: bool):
    """JAX _sepconv_bn_reference (the XLA formulation, identical math): a
    grouped 3x3 conv and the pointwise einsum in x's dtype with f32 sums,
    then the affine; differentiable, the backward of sepconv_bn."""
    if relu_in:
        x = torch.clamp_min(x, 0)
    cin = x.shape[-1]
    w = dw.reshape(3, 3, cin).permute(2, 0, 1).unsqueeze(1).to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1, groups=cin)
    o = torch.einsum("nchw,ck->nhwk", y.float(), pw.to(x.dtype).float())
    return (o * a + b).to(x.dtype)


def sepconv_bn_plain(x, dw, pw, a, b, relu_in: bool = False):
    """Plain version of sepconv_bn in _sepconv_kernel's order: x in f32
    (ReLU'd if relu_in), the 9 taps (di, dj) in f32 times dw in f32, the sum
    rounded to x's dtype, the pointwise product with pw in x's dtype and f32
    sums, o * a + b in f32, rounded to x's dtype."""
    n, h, w, _ = x.shape
    xf = x.float()
    if relu_in:
        xf = torch.clamp_min(xf, 0)
    xp = F.pad(xf, (0, 0, 1, 1, 1, 1))
    dwf = dw.float().reshape(9, -1)
    acc = None
    for di in range(3):
        for dj in range(3):
            tap = xp[:, di:di + h, dj:dj + w] * dwf[di * 3 + dj]
            acc = tap if acc is None else acc + tap
    o = acc.to(x.dtype).float() @ pw.to(x.dtype).float()
    a32, b32 = _affine(a, b, pw.shape[1])
    return (o * a32 + b32).to(x.dtype)


def _sepconv_fwd(x, dw, pw, a, b, relu_in):
    if not x.is_cuda:
        return sepconv_bn_plain(x, dw, pw, a, b, relu_in)
    n, h, w, cin = x.shape
    cout = pw.shape[1]
    _lib.check_act(x, "x")
    if dw.numel() != 9 * cin or pw.shape[0] != cin:
        raise ValueError(f"sepconv_bn: dw {tuple(dw.shape)}, pw "
                         f"{tuple(pw.shape)} for Cin {cin}")
    dw32 = dw.to(torch.float32).reshape(9, cin).contiguous()
    pwx = pw.to(x.dtype).contiguous()
    a32, b32 = _affine(a, b, cout)
    for t in (dw32, pwx, a32, b32):
        if t.device != x.device:
            raise ValueError(f"sepconv_bn: a weight on {t.device}, x on "
                             f"{x.device}")
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    _lib.check(_lib.load().istvt_sepconv_bn(
        x.data_ptr(), dw32.data_ptr(), pwx.data_ptr(), a32.data_ptr(),
        b32.data_ptr(), out.data_ptr(), _lib.DTYPE_CODE[x.dtype], n, h, w,
        cin, cout, int(relu_in), _lib.stream()), "sepconv_bn")
    _lib.LAUNCHES["sepconv_bn"] += 1
    return out


class _SepconvBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dw, pw, a, b, relu_in):
        ctx.save_for_backward(x, dw, pw, a, b)
        ctx.relu_in = relu_in
        return _sepconv_fwd(x, dw, pw, a, b, relu_in)

    @staticmethod
    def backward(ctx, g):
        ins = ctx.saved_tensors
        need = [i for i, n in enumerate(ctx.needs_input_grad[:5]) if n]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in need)
                      for i, t in enumerate(ins)]
            out = _sepconv_bn_reference(*leaves, relu_in=ctx.relu_in)
            grads = torch.autograd.grad(out, [leaves[i] for i in need], g)
        full = [None] * 6
        for i, gi in zip(need, grads):
            full[i] = gi
        return tuple(full)


def sepconv_bn(x, dw, pw, a, b, relu_in: bool = False):
    """[relu ->] depthwise 3x3 -> pointwise -> affine, one kernel.

    x (N, H, W, Cin); dw (9, Cin) flattened 3x3 taps; pw (Cin, Cout), cast
    to x's dtype as JAX's wrapper casts it; a, b: the folded-BN affine
    (fold_bn), (Cout,)-, (1, Cout)- or (1, 1, Cout)-shaped. CPU tensors take
    the plain version. Differentiable (autograd through
    _sepconv_bn_reference)."""
    pw = pw.to(x.dtype)
    if _lib.needs_grad(x, dw, pw, a, b):
        return _SepconvBN.apply(x, dw, pw, a, b, relu_in)
    return _sepconv_fwd(x, dw, pw, a, b, relu_in)
