"""Packed-qkv attention cores (counterpart of istvt_tpu/kernels/attention.py).

Two wrappers of the float fused path, each over a hand-written CUDA core
in csrc/q8_attention.cu (forward) and csrc/attention_bwd.cu (backward),
each with its plain PyTorch version beside it:

  temporal_attention_packed(qkv, heads)         (B, T1, S, 3I) -> (B, T1, S, I)
      self-subtract softmax attention over the T1 frames per (clip,
      location, head): TPU kernel fused_temporal_attention_packed;
  spatial_attention_packed(qkv, heads, n_valid) (G, S, 3I) -> (G, S, I)
      per-frame multi-head attention, keys >= n_valid masked: TPU kernel
      fused_frame_attention_packed.

Both are differentiable: where autograd records the call, the wrapper is
a torch.autograd.Function whose backward is temporal_attention_packed_bwd
(TPU kernel fused_temporal_attention_packed_bwd) or
spatial_attention_packed_bwd (TPU kernel fused_frame_attention_bwd).
Each forward is a dispatcher op (kernels/ops.py, istvt::<wrapper name>):
for CUDA tensors its CUDA implementation (`_temporal_cuda`,
`_spatial_cuda`) launches the core (or raises on a shape the core does not
take) and counts the launch; for CPU tensors it runs the plain version. The spatial core and its
backward run on the tensor cores in both dtypes: bf16 products for bf16
activations, three TF32 products each for f32 ones (chosen by dtype when
the kernels are compiled); the
temporal core and its backward lay each head on a few lanes of a warp, in
the layout temporal_plan picks (csrc/temporal.cuh), a clip of up to
TEMPORAL_TMAX frames in registers and a longer one on the general lanes
(its key frames in shared memory, or in a device scratch that the wrapper
allocates when one warp's rows do not fit a block); the spatial cores
stream the keys, at any S. The int8 ingest kernels
(kernels/quant.py) run the same cores and plain helpers on their own
packed qkv, through `temporal_core` / `spatial_core`, which count nothing:
each wrapper counts its own launches only.

The kernel API of istvt_tpu/kernels/__init__.py follows, under JAX's names
and signatures (without `interpret`), on no model path in either package:
fused_frame_attention (#14) and fused_frame_attention_mh (#15) launch the
spatial core on separate q, k, v without a mask; fused_frame_attention_bwd
is #13 on separate tensors; fused_temporal_attention (#16) and
fused_temporal_attention_bwd (#17) are kernels of their own
(csrc/temporal_unpacked.cu), since JAX's unpacked temporal kernels round in
another order than the packed ones; spatial_attention_pallas and
temporal_attention_pallas are their differentiable entry points, whose
backward is #13 / #17 on the card and autograd through JAX's XLA
references (_spatial_reference, _temporal_reference) on the CPU, as JAX's
custom_vjp branches on the TPU and elsewhere.
"""
from __future__ import annotations

import ctypes

import torch

from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.utils.debug import check_outputs

# the dispatcher ops of kernels/ops.py (resolved at call time; the package's
# __init__ registers them)
_ops = torch.ops.istvt


# ---------------------------------------------------------------------------
# plain versions


def _mh_attention(q, k, v, heads: int, scale: float, n_valid: int):
    """Masked multi-head softmax attention per frame.

    q, k, v: (G, S, H*dh) in the activation dtype -> (G, S, H*dh) in it.
    f32 scores, additive -1e30 for keys >= n_valid, exact softmax, the
    probabilities cast to the activation dtype before the PV product
    (kernels/attention._mh_attention_vmem, _spatial_packed_reference)."""
    g, s_len, hd = q.shape
    dh = hd // heads

    def split(t):
        return t.reshape(g, s_len, heads, dh).permute(0, 2, 1, 3).float()

    sc = split(q) @ split(k).transpose(-1, -2) * scale      # (G, H, S, S)
    if n_valid < s_len:
        cols = torch.arange(s_len, device=q.device)
        sc = sc + torch.where(cols < n_valid, 0.0, -1e30).to(sc.dtype)
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    pr = e / e.sum(dim=-1, keepdim=True)
    o = pr.to(q.dtype).float() @ split(v)
    return o.to(q.dtype).permute(0, 2, 1, 3).reshape(g, s_len, hd)


def _self_subtract(u):
    """cat(u[:, :2], u[:, 2:] - u[:, 1:-1]) over axis 1, in u's dtype."""
    return torch.cat([u[:, :2], u[:, 2:] - u[:, 1:-1]], dim=1)


def _unsubtract(d):
    """The transposed self-subtract: d[0], d[t] - d[t + 1] (1 <= t <= T1-2),
    d[T1 - 1], in d's dtype."""
    return torch.cat([d[:, :1], d[:, 1:-1] - d[:, 2:], d[:, -1:]], dim=1)


def spatial_packed_plain(qkv, heads: int, n_valid: int = -1):
    """Plain version of the spatial core (_spatial_packed_reference)."""
    s_len, inner = qkv.shape[1], qkv.shape[2] // 3
    if n_valid < 0:
        n_valid = s_len
    return _mh_attention(qkv[..., :inner], qkv[..., inner:2 * inner],
                         qkv[..., 2 * inner:], heads,
                         (inner // heads) ** -0.5, n_valid)


def temporal_packed_plain(qkv, heads: int):
    """Plain version of the temporal core (_temporal_packed_reference):
    the self-subtract cat(x[:2], x[2:] - x[1:-1]) on q and k, taken in the
    activation dtype, f32 logits, softmax over T1. As the Pallas kernel
    (_temporal_packed_kernel) and the CUDA core do, the weights stay
    unnormalised through PV and the sum is divided once at the end."""
    bsz, t1, s_len, i3 = qkv.shape
    inner = i3 // 3
    dh = inner // heads
    qq, kk, vv = qkv.split(inner, dim=-1)
    qs, ks = _self_subtract(qq), _self_subtract(kk)

    def heads_of(t):
        return t.float().reshape(bsz, t1, s_len, heads, dh)

    lg = torch.einsum("bisnd,bjsnd->bsnij", heads_of(qs),
                      heads_of(ks)) * dh ** -0.5
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1)                                      # (B, S, H, T1)
    acc = torch.einsum("bsnij,bjsnd->bisnd", e, heads_of(vv))
    out = acc / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(bsz, t1, s_len, inner).to(qkv.dtype)


def fused_frame_attention_bwd_plain(q, k, v, do, heads: int,
                                    n_valid: int = -1):
    """Plain version of fused_frame_attention_bwd (the math of
    _attn_bwd_kernel per head): q, k, v, do (G, S, H*dh) -> (dq, dk, dv).
    P in f32 from the masked scores; dV = round(P)^T dO; dS =
    round((P o (dP - rowsum(P o dP))) * scale); dQ = dS K, dK = dS^T Q,
    f32 sums rounded once to the activation dtype."""
    gsz, s_len, inner = q.shape
    dh = inner // heads
    scale = dh ** -0.5
    dt = q.dtype
    if n_valid < 0:
        n_valid = s_len

    def split(t):
        return t.reshape(gsz, s_len, heads, dh).permute(0, 2, 1, 3).float()

    q, k, v, do = split(q), split(k), split(v), split(do)
    sc = q @ k.transpose(-1, -2) * scale                     # (G, H, S, S)
    if n_valid < s_len:
        cols = torch.arange(s_len, device=q.device)
        sc = sc + torch.where(cols < n_valid, 0.0, -1e30).to(sc.dtype)
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = p.to(dt).float().transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    ds = (ds * scale).to(dt).float()
    dq, dk = ds @ k, ds.transpose(-1, -2) @ q

    def merge(t):
        return t.to(dt).permute(0, 2, 1, 3).reshape(gsz, s_len, inner)

    return merge(dq), merge(dk), merge(dv)


def spatial_packed_bwd_plain(qkv, g, heads: int, n_valid: int = -1):
    """Plain version of spatial_attention_packed_bwd: qkv (G, S, 3I),
    g (G, S, I) -> (G, S, 3I), fused_frame_attention_bwd_plain on the
    three column blocks."""
    inner = qkv.shape[-1] // 3
    return torch.cat(fused_frame_attention_bwd_plain(
        *qkv.split(inner, dim=-1), g, heads, n_valid), dim=-1)


def temporal_packed_bwd_plain(qkv, g, heads: int):
    """Plain version of temporal_attention_packed_bwd (the math of
    _temporal_packed_bwd_kernel): qkv (B, T1, S, 3I), g (B, T1, S, I) ->
    (B, T1, S, 3I). The subtracted q, k in the activation dtype; dq summed
    in f32 over the key frames and rounded once; dk and dv summed over the
    query frames in the activation dtype, each term rounded first (the TPU
    kernel's += into its refs); then the transposed self-subtract."""
    bsz, t1, s_len, i3 = qkv.shape
    inner = i3 // 3
    dh = inner // heads
    scale = dh ** -0.5
    dt = qkv.dtype
    qq, kk, vv = qkv.split(inner, dim=-1)
    qs, ks = _self_subtract(qq), _self_subtract(kk)

    def heads_of(t):
        return t.float().reshape(bsz, t1, s_len, heads, dh)

    q, k, v, do = heads_of(qs), heads_of(ks), heads_of(vv), heads_of(g)
    lg = torch.einsum("bisnd,bjsnd->bsnij", q, k) * scale
    dp = torch.einsum("bisnd,bjsnd->bsnij", do, v)
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1, keepdim=True)
    pdp = (e * dp).sum(dim=-1, keepdim=True) / den
    p = e / den
    ds = p * (dp - pdp) * scale                               # (B, S, H, i, j)
    dqs = torch.einsum("bsnij,bjsnd->bisnd", ds, k).to(dt)
    dks = torch.zeros((bsz, t1, s_len, heads, dh), dtype=dt,
                      device=qkv.device)
    dv = torch.zeros_like(dks)
    for i in range(t1):
        # (B, S, H, j) -> (B, j, S, H, 1) times query frame i's rows
        dsi = ds[:, :, :, i].permute(0, 3, 1, 2)[..., None]
        pi = p[:, :, :, i].permute(0, 3, 1, 2)[..., None]
        dks = dks + (dsi * q[:, i:i + 1]).to(dt)
        dv = dv + (pi * do[:, i:i + 1]).to(dt)

    parts = [_unsubtract(dqs), _unsubtract(dks), dv]
    return torch.cat([t.reshape(bsz, t1, s_len, inner) for t in parts],
                     dim=-1)


# ---------------------------------------------------------------------------
# CUDA cores (csrc/q8_attention.cu): limits, launches


def check_temporal(t1: int, inner: int, heads: int):
    if t1 < 2 or inner % heads or inner // heads > 128:
        raise NotImplementedError(
            f"temporal attention core takes T1 >= 2 and dim_head <= 128 "
            f"(got T1={t1}, inner={inner}, heads={heads})")


# The temporal cores' head layouts (csrc/temporal.cuh with_temporal_plan): the
# wide form, one vector a lane, of 16 bytes in the forward (#11, #1, #9's phase
# 3) and of TEMPORAL_BWD_VEC elements in the backward (#12), on a power of two
# of lanes up to 32 (and 128 elements a head); the narrow form, single
# elements on 32 lanes, 1, 2 or 4 a lane.
TEMPORAL_VEC_BYTES = 16
TEMPORAL_BWD_VEC = 4


def temporal_plan(dtype, dh: int, backward: bool = False):
    """(vec, lanes, chunks): how the temporal core (or, with backward, #12)
    lays one head of dh elements on a warp's lanes: lane l holds elements
    (c * lanes + l) * vec + [0, vec) for c < chunks. The wide form where dh
    is a multiple of the vector (16 bytes of `dtype` in the forward,
    TEMPORAL_BWD_VEC elements in the backward): chunks 1, lanes dh / vec up
    to a power of two; else the narrow form: vec 1, lanes 32, chunks
    ceil(dh / 32) up to a power of two."""
    vw = TEMPORAL_BWD_VEC if backward else TEMPORAL_VEC_BYTES // dtype.itemsize
    if dh % vw == 0:
        return vw, 1 << (dh // vw - 1).bit_length(), 1
    return 1, 32, 1 << (-(-dh // 32) - 1).bit_length()


def check_spatial(inner: int, heads: int, dims=(16, 32, 64, 128)):
    """The spatial cores stream the keys past the query rows: any S; the
    dim_heads they are instantiated at."""
    if inner % heads or inner // heads not in dims:
        raise NotImplementedError(
            f"spatial attention core takes dim_head in "
            f"{'/'.join(map(str, dims))} (got inner={inner}, heads={heads})")


# the register lanes' T1 (csrc/temporal.cuh kTMax); past it the general
# lanes run, whose slots may need a device scratch
TEMPORAL_TMAX = 8


def _temporal_scratch(qkv, backward: bool, heads: int, plan):
    """The device scratch the general lanes need for this qkv (None unless
    T1 > TEMPORAL_TMAX and not one warp's slots fit a block's shared
    memory: csrc istvt_temporal_scratch)."""
    bsz, t1, s_len, i3 = qkv.shape
    if t1 <= TEMPORAL_TMAX:
        return None
    n = ctypes.c_longlong(0)
    _lib.check(_lib.load().istvt_temporal_scratch(
        _lib.DTYPE_CODE[qkv.dtype], int(backward), bsz, t1, s_len, heads,
        *plan, ctypes.byref(n)), "temporal_scratch")
    if n.value == 0:
        return None
    return torch.empty(n.value, dtype=torch.uint8, device=qkv.device)


def temporal_core(qkv, heads: int):
    """Launch the temporal core on a CUDA (B, T1, S, 3I) qkv; counts
    nothing."""
    bsz, t1, s_len, i3 = qkv.shape
    inner = i3 // 3
    _lib.check_act(qkv, "qkv")
    check_temporal(t1, inner, heads)
    out = torch.empty((bsz, t1, s_len, inner), dtype=qkv.dtype,
                      device=qkv.device)
    plan = temporal_plan(qkv.dtype, inner // heads)
    scratch = _temporal_scratch(qkv, False, heads, plan)
    _lib.check(_lib.load().istvt_temporal_attn(
        qkv.data_ptr(), out.data_ptr(), _lib.DTYPE_CODE[qkv.dtype], bsz, t1,
        s_len, heads, inner, (inner // heads) ** -0.5, *plan,
        _lib.ptr(scratch), _lib.stream()), "temporal_attn")
    return out


def spatial_core(qkv, heads: int, n_valid: int):
    """Launch the spatial core on a CUDA (G, S, 3I) qkv; counts nothing."""
    g, s_len, i3 = qkv.shape
    inner = i3 // 3
    _lib.check_act(qkv, "qkv")
    check_spatial(inner, heads)
    out = torch.empty((g, s_len, inner), dtype=qkv.dtype, device=qkv.device)
    _lib.check(_lib.load().istvt_spatial_attn(
        qkv.data_ptr(), out.data_ptr(), _lib.DTYPE_CODE[qkv.dtype], g, s_len,
        heads, inner, n_valid, (inner // heads) ** -0.5, _lib.stream()),
        "spatial_attn")
    return out


def _check_grad(g, shape, dtype):
    _lib.check_act(g, "g")
    if g.shape != shape or g.dtype != dtype:
        raise ValueError(f"output grad {tuple(g.shape)} {g.dtype}, want "
                         f"{tuple(shape)} {dtype}")


def temporal_attention_packed_bwd(qkv, g, heads: int):
    """The backward of temporal_attention_packed (#12): qkv (B, T1, S, 3I),
    g (B, T1, S, I) -> dqkv (B, T1, S, 3I). CPU tensors take the plain
    version."""
    if not qkv.is_cuda:
        return temporal_packed_bwd_plain(qkv, g, heads)
    bsz, t1, s_len, i3 = qkv.shape
    inner = i3 // 3
    _lib.check_act(qkv, "qkv")
    _check_grad(g, (bsz, t1, s_len, inner), qkv.dtype)
    check_temporal(t1, inner, heads)
    dqkv = torch.empty_like(qkv)
    plan = temporal_plan(qkv.dtype, inner // heads, backward=True)
    scratch = _temporal_scratch(qkv, True, heads, plan)
    _lib.check(_lib.load().istvt_temporal_attn_bwd(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        _lib.DTYPE_CODE[qkv.dtype], bsz, t1, s_len, heads, inner,
        (inner // heads) ** -0.5, *plan, _lib.ptr(scratch), _lib.stream()),
        "temporal_attn_bwd")
    _lib.LAUNCHES["temporal_attention_packed/bwd"] += 1
    check_outputs("temporal_attention_packed/bwd", dqkv)
    return dqkv


def spatial_attention_packed_bwd(qkv, g, heads: int, n_valid: int = -1):
    """The backward of spatial_attention_packed (#13): qkv (G, S, 3I),
    g (G, S, I) -> dqkv (G, S, 3I), keys >= n_valid masked. CPU tensors
    take the plain version."""
    if not qkv.is_cuda:
        return spatial_packed_bwd_plain(qkv, g, heads, n_valid)
    gsz, s_len, i3 = qkv.shape
    inner = i3 // 3
    _lib.check_act(qkv, "qkv")
    _check_grad(g, (gsz, s_len, inner), qkv.dtype)
    check_spatial(inner, heads, dims=(16, 32, 64))
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((gsz, heads, s_len, 3), dtype=torch.float32,
                        device=qkv.device)
    _lib.check(_lib.load().istvt_spatial_attn_bwd(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        _lib.DTYPE_CODE[qkv.dtype], gsz, s_len, heads, inner,
        s_len if n_valid < 0 else n_valid, (inner // heads) ** -0.5,
        _lib.stream()), "spatial_attn_bwd")
    _lib.LAUNCHES["spatial_attention_packed/bwd"] += 1
    check_outputs("spatial_attention_packed/bwd", dqkv)
    return dqkv


# ---------------------------------------------------------------------------
# wrappers


def _temporal_cuda(qkv, heads: int):
    """#11 on the card (its op's CUDA implementation)."""
    out = temporal_core(qkv, heads)
    _lib.LAUNCHES["temporal_attention_packed"] += 1
    return out


def _spatial_cuda(qkv, heads: int, n_valid: int):
    """#10 on the card (its op's CUDA implementation)."""
    out = spatial_core(qkv, heads, qkv.shape[1] if n_valid < 0 else n_valid)
    _lib.LAUNCHES["spatial_attention_packed"] += 1
    return out


class _TemporalPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads):
        ctx.save_for_backward(qkv)
        ctx.heads = heads
        return _ops.temporal_attention_packed(qkv, heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return temporal_attention_packed_bwd(qkv, g.contiguous(),
                                             ctx.heads), None


class _SpatialPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, n_valid):
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.n_valid = heads, n_valid
        return _ops.spatial_attention_packed(qkv, heads, n_valid)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return spatial_attention_packed_bwd(qkv, g.contiguous(), ctx.heads,
                                            ctx.n_valid), None, None


def temporal_attention_packed(qkv, heads: int):
    """Packed-qkv self-subtract temporal attention:
    (B, T1, S, 3I) -> (B, T1, S, I). CPU tensors take the plain version.
    Differentiable (backward #12)."""
    if _lib.needs_grad(qkv):
        return _TemporalPacked.apply(qkv, heads)
    return _ops.temporal_attention_packed(qkv, heads)


def spatial_attention_packed(qkv, heads: int, n_valid: int = -1):
    """Packed-qkv per-frame attention, keys >= n_valid masked:
    (G, S, 3I) -> (G, S, I). CPU tensors take the plain version.
    Differentiable (backward #13)."""
    if _lib.needs_grad(qkv):
        return _SpatialPacked.apply(qkv, heads, n_valid)
    return _ops.spatial_attention_packed(qkv, heads, n_valid)


# ---------------------------------------------------------------------------
# The kernel API's unpacked entries (istvt_tpu/kernels/__init__.py): on no
# model path in either package. Plain versions first.


def fused_frame_attention_mh_plain(q, k, v, heads: int):
    """Plain version of fused_frame_attention_mh (_attn_kernel_mh, no
    mask): q, k, v (G, S, H*dh) -> (G, S, H*dh)."""
    return _mh_attention(q, k, v, heads, (q.shape[-1] // heads) ** -0.5,
                         q.shape[1])


def fused_frame_attention_plain(q, k, v):
    """Plain version of fused_frame_attention (_attn_kernel): q, k, v
    (G, S, dh) -> (G, S, dh), the multi-head version with one head."""
    return fused_frame_attention_mh_plain(q, k, v, 1)


def _rounded_dots(a, b):
    """(B, i, S, H, dh) x (B, j, S, H, dh) -> (B, S, H, i, j): the sums over
    dh in f32 of the products rounded to the inputs' dtype ((a * b)
    .astype(f32).sum(-1) of _temporal_kernel / _temporal_bwd_kernel)."""
    prod = a.unsqueeze(2) * b.unsqueeze(1)               # (B, i, j, S, H, dh)
    return prod.float().sum(dim=-1).permute(0, 3, 4, 1, 2)


def _softmax_f32(lg):
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _rows(w, j):
    """(B, S, H, i, j) -> the (B, i, S, H, 1) column j, to scale rows."""
    return w[..., j].permute(0, 3, 1, 2).unsqueeze(-1)


def fused_temporal_attention_plain(q, k, v, heads: int):
    """Plain version of fused_temporal_attention (_temporal_kernel, in its
    rounding order): q, k, v (B, T1, S, H*dh) pre-subtract -> (B, T1, S,
    H*dh). The self-subtract in the inputs' dtype; logits from products
    rounded to it, summed in f32; p normalised in f32, then rounded to v's
    dtype; out = sum_j p_j v_j in v's dtype, each product and partial sum
    rounded (torch rounds each bf16 operation, as JAX does on the CPU)."""
    b, t1, s, hd = q.shape
    dh = hd // heads

    def split(u):
        return u.reshape(b, t1, s, heads, dh)

    qs, ks, vh = split(_self_subtract(q)), split(_self_subtract(k)), split(v)
    p = _softmax_f32(_rounded_dots(qs, ks) * dh ** -0.5).to(v.dtype)
    out = _rows(p, 0) * vh[:, 0:1]
    for j in range(1, t1):
        out = out + _rows(p, j) * vh[:, j:j + 1]
    return out.reshape(b, t1, s, hd)


def fused_temporal_attention_bwd_plain(q, k, v, do, heads: int):
    """Plain version of fused_temporal_attention_bwd (_temporal_bwd_kernel,
    in its rounding order): q, k, v, do (B, T1, S, H*dh) -> (dq, dk, dv)
    with respect to the pre-subtract streams. P from the subtracted
    streams; dp from products of do and v rounded to the inputs' dtype,
    summed in f32; ds = (p (dp - sum p dp)) scale rounded to it; dqs, dks
    and dv summed in it, each product rounded first (JAX's scratch refs are
    q.dtype); then the transposed self-subtract."""
    b, t1, s, hd = q.shape
    dh = hd // heads
    scale = dh ** -0.5
    dt = q.dtype

    def split(u):
        return u.reshape(b, t1, s, heads, dh)

    qs, ks = split(_self_subtract(q)), split(_self_subtract(k))
    vh, doh = split(v), split(do)
    p = _softmax_f32(_rounded_dots(qs, ks) * scale)          # (B, S, H, i, j)
    dp = _rounded_dots(doh, vh)
    ds = (p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * scale).to(dt)
    pb = p.to(dt)
    dqs = _rows(ds, 0) * ks[:, 0:1]
    for j in range(1, t1):
        dqs = dqs + _rows(ds, j) * ks[:, j:j + 1]
    # dks[j] = sum_i ds[i, j] qs[i], dv[j] = sum_i pb[i, j] do[i], in order i
    dsT, pbT = ds.transpose(-1, -2), pb.transpose(-1, -2)
    dks = _rows(dsT, 0) * qs[:, 0:1]
    dv = _rows(pbT, 0) * doh[:, 0:1]
    for i in range(1, t1):
        dks = dks + _rows(dsT, i) * qs[:, i:i + 1]
        dv = dv + _rows(pbT, i) * doh[:, i:i + 1]
    return tuple(u.reshape(b, t1, s, hd)
                 for u in (_unsubtract(dqs), _unsubtract(dks), dv))


def _spatial_reference(q, k, v):
    """JAX _spatial_reference (the XLA formulation its backward
    differentiates off the TPU): q, k, v (B, T1, S, H, dh); f32 scores,
    softmax, the map cast to v's dtype, PV with f32 sums."""
    dots = torch.einsum("btihd,btjhd->bthij", q.float(),
                        k.float()) * q.shape[-1] ** -0.5
    attn = torch.softmax(dots, dim=-1)
    return torch.einsum("bthij,btjhd->btihd", attn.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def _temporal_reference(q, k, v, heads: int):
    """JAX _temporal_reference: q, k, v (B, T1, S, H*dh) pre-subtract; the
    self-subtract, f32 scores, softmax, the map cast to v's dtype, PV with
    f32 sums."""
    b, t1, s, hd = q.shape
    dh = hd // heads

    def split(u):
        return u.reshape(b, t1, s, heads, dh).float()

    dots = torch.einsum("bishd,bjshd->bshij", split(_self_subtract(q)),
                        split(_self_subtract(k))) * dh ** -0.5
    attn = torch.softmax(dots, dim=-1)
    out = torch.einsum("bshij,bjshd->bishd", attn.to(v.dtype).float(),
                       split(v)).to(v.dtype)
    return out.reshape(b, t1, s, hd)


def _check_like(ref, **ts):
    """Raise unless every tensor is an activation the kernels take, on
    ref's device, with ref's shape and dtype."""
    for name, t in ts.items():
        _lib.check_act(t, name)
        if (t.device != ref.device or t.shape != ref.shape
                or t.dtype != ref.dtype):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {tuple(ref.shape)} "
                             f"{ref.dtype} on {ref.device}")


def _frame_cuda(q, k, v, heads: int):
    """Launch the spatial core on separate CUDA q, k, v (G, S, H*dh), no
    mask; counts nothing."""
    g, s_len, inner = q.shape
    _check_like(q, q=q, k=k, v=v)
    check_spatial(inner, heads)
    out = torch.empty_like(q)
    _lib.check(_lib.load().istvt_frame_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _lib.DTYPE_CODE[q.dtype], g, s_len, heads, inner,
        (inner // heads) ** -0.5, _lib.stream()), "frame_attn")
    return out


def fused_frame_attention(q, k, v):
    """#14: softmax(q k^T / sqrt(dh)) v for each leading index: q, k, v
    (G, S, dh) -> (G, S, dh); any S, dh in 16/32/64/128. CPU tensors
    take the plain version."""
    if not q.is_cuda:
        return fused_frame_attention_plain(q, k, v)
    out = _frame_cuda(q, k, v, 1)
    _lib.LAUNCHES["fused_frame_attention"] += 1
    return out


def fused_frame_attention_mh(q, k, v, heads: int):
    """#15: every head of per-frame attention on the contiguous projection
    layout, no mask: q, k, v (G, S, H*dh) -> (G, S, H*dh); any S, dh in
    16/32/64/128. CPU tensors take the plain version."""
    if not q.is_cuda:
        return fused_frame_attention_mh_plain(q, k, v, heads)
    out = _frame_cuda(q, k, v, heads)
    _lib.LAUNCHES["fused_frame_attention_mh"] += 1
    return out


def fused_frame_attention_bwd(q, k, v, do, heads: int, n_valid: int = -1):
    """#13 under its JAX signature: q, k, v, do (G, S, H*dh) -> (dq, dk, dv),
    keys >= n_valid masked (-1: none); any S, dh in 16/32/64. CPU
    tensors take the plain version."""
    if not q.is_cuda:
        return fused_frame_attention_bwd_plain(q, k, v, do, heads, n_valid)
    g, s_len, inner = q.shape
    _check_like(q, q=q, k=k, v=v, do=do)
    check_spatial(inner, heads, dims=(16, 32, 64))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((g, heads, s_len, 3), dtype=torch.float32,
                        device=q.device)
    _lib.check(_lib.load().istvt_frame_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        _lib.DTYPE_CODE[q.dtype], g, s_len, heads, inner,
        s_len if n_valid < 0 else n_valid, (inner // heads) ** -0.5,
        _lib.stream()), "frame_attn_bwd")
    _lib.LAUNCHES["fused_frame_attention_bwd"] += 1
    return dq, dk, dv


def fused_temporal_attention(q, k, v, heads: int):
    """#16: self-subtract temporal attention on separate pre-subtract q, k,
    v (B, T1, S, H*dh) -> (B, T1, S, H*dh), in _temporal_kernel's rounding
    order; T1 >= 2, dh <= 128. CPU tensors take the plain version."""
    if not q.is_cuda:
        return fused_temporal_attention_plain(q, k, v, heads)
    b, t1, s_len, inner = q.shape
    _check_like(q, q=q, k=k, v=v)
    check_temporal(t1, inner, heads)
    out = torch.empty_like(q)
    _lib.check(_lib.load().istvt_temporal_unpacked(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _lib.DTYPE_CODE[q.dtype], b, t1, s_len, heads, inner // heads,
        (inner // heads) ** -0.5, _lib.stream()), "temporal_unpacked")
    _lib.LAUNCHES["fused_temporal_attention"] += 1
    return out


def fused_temporal_attention_bwd(q, k, v, do, heads: int):
    """#17: (dq, dk, dv) of fused_temporal_attention with respect to the
    pre-subtract q, k, v (B, T1, S, H*dh), in _temporal_bwd_kernel's
    rounding order; T1 >= 2, dh <= 128. CPU tensors take the plain
    version."""
    if not q.is_cuda:
        return fused_temporal_attention_bwd_plain(q, k, v, do, heads)
    b, t1, s_len, inner = q.shape
    _check_like(q, q=q, k=k, v=v, do=do)
    check_temporal(t1, inner, heads)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _lib.check(_lib.load().istvt_temporal_unpacked_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _lib.DTYPE_CODE[q.dtype],
        b, t1, s_len, heads, inner // heads, (inner // heads) ** -0.5,
        _lib.stream()), "temporal_unpacked_bwd")
    _lib.LAUNCHES["fused_temporal_attention_bwd"] += 1
    return dq, dk, dv


def _reference_grads(ref, ins, g):
    """The gradients of ref(*ins) against g by autograd (JAX's non-TPU
    backward: jax.vjp of its XLA reference)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in ins]
        return torch.autograd.grad(ref(*leaves), leaves, g)


def _fold(u):
    """(B, T1, S, H, dh) -> (B*T1, S, H*dh), a view of a contiguous u."""
    b, t1, s, h, dh = u.shape
    return u.reshape(b * t1, s, h * dh)


def _spatial_pallas_fwd(q, k, v):
    return fused_frame_attention_mh(_fold(q), _fold(k), _fold(v),
                                    q.shape[3]).reshape(q.shape)


class _SpatialPallas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _spatial_pallas_fwd(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if not q.is_cuda:
            return _reference_grads(_spatial_reference, (q, k, v), g)
        grads = fused_frame_attention_bwd(
            _fold(q), _fold(k), _fold(v), _fold(g.contiguous()), q.shape[3])
        return tuple(t.reshape(q.shape) for t in grads)


class _TemporalPallas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads):
        ctx.save_for_backward(q, k, v)
        ctx.heads = heads
        return fused_temporal_attention(q, k, v, heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if not q.is_cuda:
            grads = _reference_grads(
                lambda *t: _temporal_reference(*t, ctx.heads), (q, k, v), g)
        else:
            grads = fused_temporal_attention_bwd(q, k, v, g.contiguous(),
                                                 ctx.heads)
        return (*grads, None)


def spatial_attention_pallas(q, k, v):
    """Differentiable per-frame attention, JAX's custom_vjp of the same
    name: q, k, v (B, T1, S, H, dh) -> (B, T1, S, H, dh). Forward #15 on
    the (B*T1, S, H*dh) fold; backward #13 (fused_frame_attention_bwd) on
    the card and autograd through _spatial_reference on the CPU, as JAX's
    _spatial_bwd branches on the TPU and elsewhere."""
    if _lib.needs_grad(q, k, v):
        return _SpatialPallas.apply(q, k, v)
    return _spatial_pallas_fwd(q, k, v)


def temporal_attention_pallas(q, k, v, heads: int):
    """Differentiable self-subtract temporal attention, JAX's custom_vjp of
    the same name: q, k, v (B, T1, S, H*dh) pre-subtract -> (B, T1, S,
    H*dh). Forward #16; backward #17 on the card and autograd through
    _temporal_reference on the CPU, as JAX's _temporal_bwd branches."""
    if _lib.needs_grad(q, k, v):
        return _TemporalPallas.apply(q, k, v, heads)
    return fused_temporal_attention(q, k, v, heads)
