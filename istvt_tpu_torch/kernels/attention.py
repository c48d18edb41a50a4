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
A CUDA tensor launches the core (or raises on a shape the core does not
take); a CPU tensor runs the plain version. The int8 ingest kernels
(kernels/quant.py) run the same cores and plain helpers on their own
packed qkv, through `temporal_core` / `spatial_core`, which count nothing:
each wrapper counts its own launches only.
"""
from __future__ import annotations

import torch

from istvt_tpu_torch.kernels import _lib


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
    qs = torch.cat([qq[:, :2], qq[:, 2:] - qq[:, 1:-1]], dim=1)
    ks = torch.cat([kk[:, :2], kk[:, 2:] - kk[:, 1:-1]], dim=1)

    def heads_of(t):
        return t.float().reshape(bsz, t1, s_len, heads, dh)

    lg = torch.einsum("bisnd,bjsnd->bsnij", heads_of(qs),
                      heads_of(ks)) * dh ** -0.5
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1)                                      # (B, S, H, T1)
    acc = torch.einsum("bsnij,bjsnd->bisnd", e, heads_of(vv))
    out = acc / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(bsz, t1, s_len, inner).to(qkv.dtype)


def spatial_packed_bwd_plain(qkv, g, heads: int, n_valid: int = -1):
    """Plain version of spatial_attention_packed_bwd (the math of
    _attn_bwd_kernel per head): qkv (G, S, 3I), g (G, S, I) -> (G, S, 3I).
    P in f32 from the masked scores; dV = round(P)^T dO; dS =
    round((P o (dP - rowsum(P o dP))) * scale); dQ = dS K, dK = dS^T Q,
    f32 sums rounded once to the activation dtype."""
    gsz, s_len, i3 = qkv.shape
    inner = i3 // 3
    dh = inner // heads
    scale = dh ** -0.5
    dt = qkv.dtype
    if n_valid < 0:
        n_valid = s_len

    def split(t):
        return t.reshape(gsz, s_len, heads, dh).permute(0, 2, 1, 3).float()

    q, k, v = (split(t) for t in qkv.split(inner, dim=-1))
    do = split(g)
    sc = q @ k.transpose(-1, -2) * scale                     # (G, H, S, S)
    if n_valid < s_len:
        cols = torch.arange(s_len, device=qkv.device)
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

    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)


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
    qs = torch.cat([qq[:, :2], qq[:, 2:] - qq[:, 1:-1]], dim=1)
    ks = torch.cat([kk[:, :2], kk[:, 2:] - kk[:, 1:-1]], dim=1)

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

    def unsubtract(d):
        return torch.cat([d[:, :1], d[:, 1:-1] - d[:, 2:], d[:, -1:]], dim=1)

    parts = [unsubtract(dqs), unsubtract(dks), dv]
    return torch.cat([t.reshape(bsz, t1, s_len, inner) for t in parts],
                     dim=-1)


# ---------------------------------------------------------------------------
# CUDA cores (csrc/q8_attention.cu): limits, launches


def check_temporal(t1: int, inner: int, heads: int):
    if t1 > 8 or inner % heads or inner // heads > 128:
        raise NotImplementedError(
            f"temporal attention core takes T1 <= 8 and dim_head <= 128 "
            f"(got T1={t1}, inner={inner}, heads={heads})")


def check_spatial(s_len: int, inner: int, heads: int,
                  dims=(16, 32, 64, 128)):
    if s_len > 384 or inner % heads or inner // heads not in dims:
        raise NotImplementedError(
            f"spatial attention core takes S <= 384 and dim_head in "
            f"{'/'.join(map(str, dims))} (got S={s_len}, inner={inner}, "
            f"heads={heads})")


def temporal_core(qkv, heads: int):
    """Launch the temporal core on a CUDA (B, T1, S, 3I) qkv; counts
    nothing."""
    bsz, t1, s_len, i3 = qkv.shape
    inner = i3 // 3
    _lib.check_act(qkv, "qkv")
    check_temporal(t1, inner, heads)
    out = torch.empty((bsz, t1, s_len, inner), dtype=qkv.dtype,
                      device=qkv.device)
    _lib.check(_lib.load().istvt_temporal_attn(
        qkv.data_ptr(), out.data_ptr(), _lib.DTYPE_CODE[qkv.dtype], bsz, t1,
        s_len, heads, inner, (inner // heads) ** -0.5, _lib.stream()),
        "temporal_attn")
    return out


def spatial_core(qkv, heads: int, n_valid: int):
    """Launch the spatial core on a CUDA (G, S, 3I) qkv; counts nothing."""
    g, s_len, i3 = qkv.shape
    inner = i3 // 3
    _lib.check_act(qkv, "qkv")
    check_spatial(s_len, inner, heads)
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
    _lib.check(_lib.load().istvt_temporal_attn_bwd(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        _lib.DTYPE_CODE[qkv.dtype], bsz, t1, s_len, heads, inner,
        (inner // heads) ** -0.5, _lib.stream()), "temporal_attn_bwd")
    _lib.LAUNCHES["temporal_attention_packed/bwd"] += 1
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
    check_spatial(s_len, inner, heads, dims=(16, 32, 64))
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((gsz, heads, s_len, 3), dtype=torch.float32,
                        device=qkv.device)
    _lib.check(_lib.load().istvt_spatial_attn_bwd(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        _lib.DTYPE_CODE[qkv.dtype], gsz, s_len, heads, inner,
        s_len if n_valid < 0 else n_valid, (inner // heads) ** -0.5,
        _lib.stream()), "spatial_attn_bwd")
    _lib.LAUNCHES["spatial_attention_packed/bwd"] += 1
    return dqkv


# ---------------------------------------------------------------------------
# wrappers


def _temporal_fwd(qkv, heads):
    if not qkv.is_cuda:
        return temporal_packed_plain(qkv, heads)
    out = temporal_core(qkv, heads)
    _lib.LAUNCHES["temporal_attention_packed"] += 1
    return out


def _spatial_fwd(qkv, heads, n_valid):
    if not qkv.is_cuda:
        return spatial_packed_plain(qkv, heads, n_valid)
    out = spatial_core(qkv, heads, qkv.shape[1] if n_valid < 0 else n_valid)
    _lib.LAUNCHES["spatial_attention_packed"] += 1
    return out


class _TemporalPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads):
        ctx.save_for_backward(qkv)
        ctx.heads = heads
        return _temporal_fwd(qkv, heads)

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
        return _spatial_fwd(qkv, heads, n_valid)

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
    return _temporal_fwd(qkv, heads)


def spatial_attention_packed(qkv, heads: int, n_valid: int = -1):
    """Packed-qkv per-frame attention, keys >= n_valid masked:
    (G, S, 3I) -> (G, S, I). CPU tensors take the plain version.
    Differentiable (backward #13)."""
    if _lib.needs_grad(qkv):
        return _SpatialPacked.apply(qkv, heads, n_valid)
    return _spatial_fwd(qkv, heads, n_valid)
