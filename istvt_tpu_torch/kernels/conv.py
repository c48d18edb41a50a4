"""The fused [ReLU ->] separable conv -> folded eval BN (counterpart of
istvt_tpu/kernels/conv.py).

  sepconv_bn(x, dw, pw, a, b, relu_in=False)
      x (N, H, W, Cin) NHWC -> (N, H, W, Cout) in x's dtype:
      [relu ->] depthwise 3x3 (pad 1, stride 1) -> pointwise -> o * a + b

TPU kernel _sepconv_bn_impl, one launch of csrc/sepconv_bn.cu on a CUDA
tensor; a CPU tensor runs the plain version, sepconv_bn_plain, in the
kernel's rounding order. The kernel: a block owns 128 output pixels of one
frame (8 x 16 or 16 x 8) and computes their depthwise once, for all of Cin,
into a resident A tile in shared memory (the halo staged by 16-byte
cp.async), then the pointwise over its N-tiles of 64 channels on the tensor
cores (bf16 mma.sync; f32 as three TF32 products, a fresh sum each 32-deep
k-step) with pw streamed through a cp.async ring, and the affine in the
epilogue. Its bound is the bytes of x and of the output (0.010-0.040 ms at
the stem's units, 12 frames, bf16). _sepconv_plan picks the tiles, the
channels a block (a Cout split where the pixel tiles would leave the card's
block slots empty), the A chunk (all of Cin where it fits) and the shared
memory; csrc/sepconv_bn.cu's header has the rest.
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

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from istvt_tpu_torch.kernels import _lib

# csrc/sepconv_bn.cu's tiles: pixels a block, channels an N-tile, pw rows a
# ring stage, ring stages, bytes of channels a halo chunk, the pixel tiles
# (rows, columns) it takes, the blocks an SM its __launch_bounds__ allow,
# and an H100's shared memory a block (opt-in) and an SM (1 KB of it
# reserved a block)
SEP_M, SEP_N, SEP_K, SEP_STAGES, SEP_HALO_C = 128, 64, 32, 4, 128
SEP_TILES = ((8, 16), (16, 8))
SEP_BLOCKS_PER_SM = {torch.bfloat16: 2, torch.float32: 1}
SMEM_BLOCK, SMEM_SM, SMEM_RESERVED = 232_448, 233_472, 1024
H100_SMS = 132


def _cdiv(a, b):
    return -(-a // b)


@dataclass(frozen=True)
class SepconvPlan:
    """A launch of csrc/sepconv_bn.cu: th x tw pixel tiles (tiles_y x
    tiles_x a frame; grid.x = frames x tiles), per_split N-tiles of SEP_N
    channels a blockIdx.y (grid.y = splits), the Cin padded to kp, A chunks
    of kc columns (kc = kp: one chunk, the depthwise once a tile), and the
    shared memory of a block."""
    th: int
    tw: int
    tiles_y: int
    tiles_x: int
    n_tiles: int
    per_split: int
    splits: int
    kp: int
    kc: int
    smem: int

    def block(self, bx: int, by: int, n_frames: int, cout: int):
        """(frame, rows, columns, channels) of block (bx, by) as the kernel
        decodes them, the channels clipped to Cout."""
        tx, rest = bx % self.tiles_x, bx // self.tiles_x
        ty, frame = rest % self.tiles_y, rest // self.tiles_y
        assert frame < n_frames
        nt0 = by * self.per_split
        c1 = min(cout, (nt0 + self.per_split) * SEP_N)
        return (frame, (ty * self.th, (ty + 1) * self.th),
                (tx * self.tw, (tx + 1) * self.tw), (nt0 * SEP_N, c1))


def _sepconv_plan(n, h, w, cin, cout, dtype, sms: int = H100_SMS):
    """The tile plan of one sepconv_bn launch (SepconvPlan): the pixel tile
    of SEP_TILES with the fewest tiles a frame (ties: 8 x 16); A's columns,
    all of Cin (rounded up to SEP_K) where the A tile, the halo chunk and
    the ring fit a block's shared memory, else the fewest chunks of a
    multiple of 64 columns; and Cout split over blockIdx.y until the grid
    holds the blocks the card keeps resident at once (sms x the blocks an
    SM takes), where the pixel tiles alone do not (at most one N-tile a
    split)."""
    esize = torch.finfo(dtype).bits // 8
    pad = 16 // esize
    th, tw = min(SEP_TILES, key=lambda t: _cdiv(h, t[0]) * _cdiv(w, t[1]))
    tiles_y, tiles_x = _cdiv(h, th), _cdiv(w, tw)
    fixed = ((th + 2) * (tw + 2) * SEP_HALO_C
             + SEP_STAGES * SEP_K * (SEP_N + 8) * esize)
    kp = _cdiv(cin, SEP_K) * SEP_K
    fits = (SMEM_BLOCK - fixed) // (SEP_M * esize) - pad
    if kp <= fits:
        kc = kp
    else:
        most = fits // 64 * 64
        kc = _cdiv(_cdiv(kp, _cdiv(kp, most)), 64) * 64
    smem = SEP_M * (min(kc, kp) + pad) * esize + fixed
    per_sm = min(SEP_BLOCKS_PER_SM[dtype],
                 SMEM_SM // (smem + SMEM_RESERVED))
    tiles, n_tiles = n * tiles_y * tiles_x, _cdiv(cout, SEP_N)
    want = min(n_tiles, max(1, _cdiv(sms * per_sm, tiles)))
    per_split = _cdiv(n_tiles, want)
    return SepconvPlan(th, tw, tiles_y, tiles_x, n_tiles, per_split,
                       _cdiv(n_tiles, per_split), kp, kc, smem)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    plan = _sepconv_plan(n, h, w, cin, cout, x.dtype, _sms(x.device.index))
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    _lib.check(_lib.load().istvt_sepconv_bn(
        x.data_ptr(), dw32.data_ptr(), pwx.data_ptr(), a32.data_ptr(),
        b32.data_ptr(), out.data_ptr(), _lib.DTYPE_CODE[x.dtype], n, h, w,
        cin, cout, int(relu_in), plan.th, plan.tw, plan.per_split, plan.kc,
        plan.smem, _lib.stream()), "sepconv_bn")
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
