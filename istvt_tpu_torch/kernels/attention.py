"""Packed-qkv attention cores (counterpart of istvt_tpu/kernels/attention.py).

Two wrappers of the float fused forward, each over a hand-written CUDA
core in csrc/q8_attention.cu, with its plain PyTorch version beside it:

  temporal_attention_packed(qkv, heads)         (B, T1, S, 3I) -> (B, T1, S, I)
      self-subtract softmax attention over the T1 frames per (clip,
      location, head): TPU kernel fused_temporal_attention_packed;
  spatial_attention_packed(qkv, heads, n_valid) (G, S, 3I) -> (G, S, I)
      per-frame multi-head attention, keys >= n_valid masked: TPU kernel
      fused_frame_attention_packed.

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


# ---------------------------------------------------------------------------
# CUDA cores (csrc/q8_attention.cu): limits, launches


def check_temporal(t1: int, inner: int, heads: int):
    if t1 > 8 or inner % heads or inner // heads > 128:
        raise NotImplementedError(
            f"temporal attention core takes T1 <= 8 and dim_head <= 128 "
            f"(got T1={t1}, inner={inner}, heads={heads})")


def check_spatial(s_len: int, inner: int, heads: int):
    if s_len > 384 or inner % heads or inner // heads not in (16, 32, 64,
                                                              128):
        raise NotImplementedError(
            f"spatial attention core takes S <= 384 and dim_head in "
            f"16/32/64/128 (got S={s_len}, inner={inner}, heads={heads})")


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


# ---------------------------------------------------------------------------
# wrappers


def temporal_attention_packed(qkv, heads: int):
    """Packed-qkv self-subtract temporal attention:
    (B, T1, S, 3I) -> (B, T1, S, I). CPU tensors take the plain version."""
    if not qkv.is_cuda:
        return temporal_packed_plain(qkv, heads)
    out = temporal_core(qkv, heads)
    _lib.LAUNCHES["temporal_attention_packed"] += 1
    return out


def spatial_attention_packed(qkv, heads: int, n_valid: int = -1):
    """Packed-qkv per-frame attention, keys >= n_valid masked:
    (G, S, 3I) -> (G, S, I). CPU tensors take the plain version."""
    if not qkv.is_cuda:
        return spatial_packed_plain(qkv, heads, n_valid)
    out = spatial_core(qkv, heads, qkv.shape[1] if n_valid < 0 else n_valid)
    _lib.LAUNCHES["spatial_attention_packed"] += 1
    return out
