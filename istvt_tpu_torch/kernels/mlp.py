"""The transformer MLP kernels, forward and backward (counterpart of
istvt_tpu/kernels/mlp.py).

  ln_ff_residual(x, s, bn, w1, b1, w2, b2) = x + fc2(gelu_tanh(fc1(LN x)))
  fused_ff(x, w1, b1, w2, b2)              = fc2(gelu_tanh(fc1(x)))

ln_ff_residual is TPU kernel _ln_ff_res_impl, the PreNorm FF branch of the
float fused path. A CUDA tensor runs three launches of csrc/float_gemm.cu:
LN rows -> GEMM (+ b1, tanh-GELU) -> GEMM (+ b2, + x).
The TPU kernel keeps the (N, 4D) hidden in VMEM; here it makes a round
trip through device memory in x's dtype (240 MB at B=16 in bf16). The
numbers are the same, because JAX casts the hidden to x's dtype before fc2
(mlp.py:95); removing that round trip (fc1 and fc2 in one kernel) is later
work. A CPU tensor runs the plain version. The forward is the dispatcher
op istvt::ln_ff_residual (kernels/ops.py), which chooses so by the device
of its tensors.

Where autograd records the call, ln_ff_residual is a torch.autograd.Function
as JAX's custom_vjp is: its forward is the h1-stash variant
(ln_ff_residual_h1, TPU _ln_ff_res_impl(stash_h1=True)), whose fc1
epilogue also writes the pre-GELU hidden h1 in x's dtype, and its backward
is ln_ff_residual_bwd (TPU _ln_ff_bwd_impl), which recomputes LN and the
GELU from the stash instead of the fc1 GEMM.

fused_ff is TPU kernel _fused_ff_impl, the feed-forward of the
attention-map path (models/istvt._feed_forward with use_pallas: no LN, no
residual; the rows are B*(T+1)*362, unpadded). A CUDA tensor runs two
launches of the same GEMM: fc1 with the + b1, tanh-GELU epilogue, then fc2
with the + b2 epilogue (the GEMM masks the row tail, so any row count
goes). Its hidden also round-trips device memory in x's dtype; one kernel
that keeps the hidden tile in shared memory, as the TPU kernel keeps it in
VMEM, is later work, as for ln_ff_residual. Its backward is autograd
through fused_ff_plain, a recompute in plain PyTorch, as JAX's
_fused_ff_bwd is jax.vjp of _ff_reference: the JAX package has no backward
kernel for it.
"""
from __future__ import annotations

import torch

from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.kernels.linear import (_ln, _ln_bwd_rows, _ln_stats,
                                            colsum, gemm, gemm_row_tile,
                                            ln_bwd, ln_rows)
from istvt_tpu_torch.utils.debug import check_outputs

# the dispatcher ops of kernels/ops.py (resolved at call time; the package's
# __init__ registers them)
_ops = torch.ops.istvt

_GC = 0.7978845608028654   # sqrt(2/pi)
_GA = 0.044715


def _gelu_tanh(x):
    """jax.nn.gelu(x, approximate=True), term for term."""
    return x * (0.5 * (1.0 + torch.tanh(_GC * (x + _GA * (x * x * x)))))


def _gelu_tanh_and_grad(h):
    """tanh-approx GELU value and derivative, f32 (_gelu_tanh_and_grad)."""
    t = torch.tanh(_GC * (h + _GA * h * h * h))
    val = 0.5 * h * (1.0 + t)
    dval = 0.5 * (1.0 + t) \
        + 0.5 * h * (1.0 - t * t) * _GC * (1.0 + 3.0 * _GA * h * h)
    return val, dval


def _ff_plain(x, s, bn, w1, b1, w2, b2):
    """(out, h1): the plain forward and its pre-GELU hidden in f32."""
    dt = x.dtype
    xf = x.float()
    y = _ln(xf, s.to(dt).float(), bn.to(dt).float()).to(dt)
    h1 = y.float() @ w1.to(dt).float() + b1.to(dt).float()
    h = _gelu_tanh(h1).to(dt)
    o = h.float() @ w2.to(dt).float() + b2.to(dt).float() + xf
    return o.to(dt), h1


def ln_ff_residual_plain(x, s, bn, w1, b1, w2, b2):
    """Plain version of ln_ff_residual (_ln_ff_res_reference; the JAX
    wrapper casts every parameter to x's dtype first)."""
    return _ff_plain(x, s, bn, w1, b1, w2, b2)[0]


def ln_ff_residual_h1_plain(x, s, bn, w1, b1, w2, b2):
    """Plain version of ln_ff_residual_h1: (out, h1 in x's dtype)."""
    out, h1 = _ff_plain(x, s, bn, w1, b1, w2, b2)
    return out, h1.to(x.dtype)


def ln_ff_residual_bwd_plain(x, s, bn, w1, h1, w2, g):
    """Plain version of ln_ff_residual_bwd (the math of _ln_ff_bwd_kernel):
    x, g (R, D), h1 (R, FF) in x's dtype -> dx (R, D) in x's dtype; ds,
    dbn (D,), dw1 (D, FF), db1 (FF,), dw2 (FF, D), db2 (D,) in f32."""
    dt = x.dtype
    xhat, rstd = _ln_stats(x.float())
    sf = s.to(dt).float()
    y = (xhat * sf + bn.to(dt).float()).to(dt).float()
    hg, dgelu = _gelu_tanh_and_grad(h1.float())
    gf = g.float()
    dw2 = hg.to(dt).float().t() @ gf
    dh1 = (gf @ w2.to(dt).float().t()) * dgelu
    dh1b = dh1.to(dt).float()
    dw1 = y.t() @ dh1b
    dy = dh1b @ w1.to(dt).float().t()
    dx = (_ln_bwd_rows(dy, xhat, sf, rstd) + gf).to(dt)
    return (dx, (dy * xhat).sum(0), dy.sum(0), dw1, dh1.sum(0), dw2,
            gf.sum(0))


# ---------------------------------------------------------------------------
# kernel wrappers (count their launches)


def _ff_cuda(x, s, bn, w1, b1, w2, b2, stash: bool):
    dt, d = x.dtype, x.shape[-1]
    _lib.check_act(x, "x")
    flat = x.reshape(-1, d)
    as32 = lambda t: _lib.f32(t.to(dt))  # noqa: E731
    y = ln_rows(flat, as32(s), as32(bn))
    hid = torch.empty((flat.shape[0], w1.shape[1]), dtype=dt, device=x.device)
    h1 = torch.empty_like(hid) if stash else None
    gemm(y, w1, hid, bias32=as32(b1), gelu=True, out2=h1)
    out = torch.empty_like(x)
    gemm(hid, w2, out, bias32=as32(b2), res=flat)
    return out, h1


def ln_ff_residual_h1(x, s, bn, w1, b1, w2, b2):
    """The training forward of ln_ff_residual (#21, stash_h1): (out, h1)
    with h1 (..., N, FF) the pre-GELU hidden fc1(LN x) + b1 in x.dtype.
    CPU tensors take the plain version."""
    if not x.is_cuda:
        return ln_ff_residual_h1_plain(x, s, bn, w1, b1, w2, b2)
    out, h1 = _ff_cuda(x, s, bn, w1, b1, w2, b2, stash=True)
    _lib.LAUNCHES["ln_ff_residual/h1"] += 1
    check_outputs("ln_ff_residual/h1", out, h1)
    return out, h1.reshape(x.shape[:-1] + (w1.shape[1],))


def ln_ff_residual_bwd(x, s, bn, w1, h1, w2, g):
    """The backward of ln_ff_residual from the h1 stash (#23): x, g (R, D),
    h1 (R, FF) -> (dx, ds, dbn, dw1, db1, dw2, db2), dx in x.dtype, the
    rest f32. CPU tensors take the plain version."""
    if not x.is_cuda:
        return ln_ff_residual_bwd_plain(x, s, bn, w1, h1, w2, g)
    dt, dev = x.dtype, x.device
    rows, ff = h1.shape
    for t, name in ((x, "x"), (h1, "h1"), (g, "g")):
        _lib.check_act(t, name)
    if h1.dtype != dt or g.dtype != dt:
        raise TypeError(f"h1 {h1.dtype} / g {g.dtype} for x {dt}")
    w1 = w1.to(dt).contiguous()
    w2 = w2.to(dt).contiguous()
    s32 = _lib.f32(s.to(dt))
    y = ln_rows(x, s32, _lib.f32(bn.to(dt)))
    # dh1 = (g w2^T) * gelu'(h1) in x's dtype, gelu(h1) beside it, db1 sums
    dh1 = torch.empty_like(h1)
    hg = torch.empty_like(h1)
    tile = gemm_row_tile(dt)
    part = torch.empty(((rows + tile - 1) // tile, ff), dtype=torch.float32,
                       device=dev)
    gemm(g, w2, dh1, layout="nt", aux=h1, out2=hg, part=part)
    db1 = colsum(part)
    dw2 = torch.empty(w2.shape, dtype=torch.float32, device=dev)
    gemm(hg, g, dw2, layout="tn")
    dw1 = torch.empty(w1.shape, dtype=torch.float32, device=dev)
    gemm(y, dh1, dw1, layout="tn")
    dy = torch.empty(x.shape, dtype=torch.float32, device=dev)
    gemm(dh1, w1, dy, layout="nt")
    dx, (ds, dbn, db2) = ln_bwd(x, s32, dy, res=g)
    _lib.LAUNCHES["ln_ff_residual/bwd"] += 1
    check_outputs("ln_ff_residual/bwd", dx, ds, dbn, dw1, db1, dw2, db2)
    return dx, ds, dbn, dw1, db1, dw2, db2


def _ln_ff_residual_cuda(x, s, bn, w1, b1, w2, b2):
    """#21 on the card (its op's CUDA implementation)."""
    out, _ = _ff_cuda(x, s, bn, w1, b1, w2, b2, stash=False)
    _lib.LAUNCHES["ln_ff_residual"] += 1
    return out


class _LnFFResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, bn, w1, b1, w2, b2):
        out, h1 = ln_ff_residual_h1(x, s, bn, w1, b1, w2, b2)
        ctx.save_for_backward(x, s, bn, w1, b1, w2, b2, h1)
        return out

    @staticmethod
    def backward(ctx, g):
        x, s, bn, w1, b1, w2, b2, h1 = ctx.saved_tensors
        d, ff = x.shape[-1], h1.shape[-1]
        dx, ds, dbn, dw1, db1, dw2, db2 = ln_ff_residual_bwd(
            x.reshape(-1, d), s, bn, w1, h1.reshape(-1, ff), w2,
            g.reshape(-1, d).contiguous())
        return (dx.reshape(x.shape), ds.to(s.dtype), dbn.to(bn.dtype),
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype))


def ln_ff_residual(x, s, bn, w1, b1, w2, b2):
    """x + fc2(gelu_tanh(fc1(LN(x)))): x (..., N, D), w1 (D, 4D),
    w2 (4D, D) -> (..., N, D) in x.dtype. CPU tensors take the plain
    version. Differentiable (h1-stash forward, backward #23)."""
    if _lib.needs_grad(x, s, bn, w1, b1, w2, b2):
        return _LnFFResidual.apply(x, s, bn, w1, b1, w2, b2)
    return _ops.ln_ff_residual(x, s, bn, w1, b1, w2, b2)


# ---------------------------------------------------------------------------
# fused_ff (#22): fc2(gelu_tanh(fc1(x))), no LN, no residual


def fused_ff_plain(x, w1, b1, w2, b2):
    """Plain version of fused_ff (_ff_reference after the wrapper's casts of
    every parameter to x's dtype): fc1 and fc2 accumulate in f32, the bias
    is added in f32, tanh-GELU, the hidden cast to x's dtype before fc2."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.to(dt).float()
    h = _gelu_tanh(h).to(dt)
    o = h.float() @ w2.to(dt).float() + b2.to(dt).float()
    return o.to(dt)


def _fused_ff_fwd(x, w1, b1, w2, b2):
    if not x.is_cuda:
        return fused_ff_plain(x, w1, b1, w2, b2)
    dt, d = x.dtype, x.shape[-1]
    _lib.check_act(x, "x")
    flat = x.reshape(-1, d)
    hid = torch.empty((flat.shape[0], w1.shape[1]), dtype=dt, device=x.device)
    gemm(flat, w1, hid, bias32=_lib.f32(b1.to(dt)), gelu=True)
    out = torch.empty(x.shape[:-1] + (w2.shape[1],), dtype=dt,
                      device=x.device)
    gemm(hid, w2, out, bias32=_lib.f32(b2.to(dt)))
    _lib.LAUNCHES["fused_ff"] += 1
    check_outputs("fused_ff", out)
    return out


class _FusedFF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _fused_ff_fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        ins = ctx.saved_tensors
        need = [i for i, n in enumerate(ctx.needs_input_grad) if n]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in need)
                      for i, t in enumerate(ins)]
            out = fused_ff_plain(*leaves)
            grads = torch.autograd.grad(out, [leaves[i] for i in need], g)
        full = [None] * len(ins)
        for i, gi in zip(need, grads):
            full[i] = gi
        return tuple(full)


def fused_ff(x, w1, b1, w2, b2):
    """fc2(gelu_tanh(fc1(x))): x (..., N, D), w1 (D, 4D), b1 (4D,),
    w2 (4D, D), b2 (D,) -> (..., N, D) in x.dtype; every parameter is cast
    to x's dtype first, as JAX's wrapper does. CPU tensors take the plain
    version. Differentiable: the backward recomputes fused_ff_plain."""
    dt = x.dtype
    w1, b1, w2, b2 = (t.to(dt) for t in (w1, b1, w2, b2))
    if _lib.needs_grad(x, w1, b1, w2, b2):
        return _FusedFF.apply(x, w1, b1, w2, b2)
    return _fused_ff_fwd(x, w1, b1, w2, b2)
