"""The PreNorm feed-forward residual branch
(counterpart of istvt_tpu/kernels/mlp.py).

  ln_ff_residual(x, s, bn, w1, b1, w2, b2) = x + fc2(gelu_tanh(fc1(LN x)))

TPU kernel _ln_ff_res_impl. A CUDA tensor runs three launches of
csrc/float_gemm.cu: LN rows -> GEMM (+ b1, tanh-GELU) -> GEMM (+ b2, + x).
The TPU kernel keeps the (N, 4D) hidden in VMEM; here it makes a round
trip through device memory in x's dtype (240 MB at B=16 in bf16). The
numbers are the same, because JAX casts the hidden to x's dtype before fc2
(mlp.py:95); removing that round trip (fc1 and fc2 in one kernel) is later
work. A CPU tensor runs the plain version.
"""
from __future__ import annotations

import torch

from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.kernels.linear import _ln, gemm, ln_rows


def _gelu_tanh(x):
    """jax.nn.gelu(x, approximate=True), term for term."""
    c = 0.7978845608028654
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def ln_ff_residual_plain(x, s, bn, w1, b1, w2, b2):
    """Plain version of ln_ff_residual (_ln_ff_res_reference; the JAX
    wrapper casts every parameter to x's dtype first)."""
    dt = x.dtype
    xf = x.float()
    y = _ln(xf, s.to(dt).float(), bn.to(dt).float()).to(dt)
    h = y.float() @ w1.to(dt).float() + b1.to(dt).float()
    h = _gelu_tanh(h).to(dt)
    o = h.float() @ w2.to(dt).float() + b2.to(dt).float() + xf
    return o.to(dt)


def ln_ff_residual(x, s, bn, w1, b1, w2, b2):
    """x + fc2(gelu_tanh(fc1(LN(x)))): x (..., N, D), w1 (D, 4D),
    w2 (4D, D) -> (..., N, D) in x.dtype. CPU tensors take the plain
    version."""
    if not x.is_cuda:
        return ln_ff_residual_plain(x, s, bn, w1, b1, w2, b2)
    dt, d = x.dtype, x.shape[-1]
    _lib.check_act(x, "x")
    flat = x.reshape(-1, d)
    as32 = lambda t: _lib.f32(t.to(dt))  # noqa: E731
    y = ln_rows(flat, as32(s), as32(bn))
    hid = torch.empty((flat.shape[0], w1.shape[1]), dtype=dt, device=x.device)
    gemm(y, w1, as32(b1), None, hid, gelu=True)
    out = torch.empty_like(x)
    gemm(hid, w2, as32(b2), flat, out, gelu=False)
    _lib.LAUNCHES["ln_ff_residual"] += 1
    return out
