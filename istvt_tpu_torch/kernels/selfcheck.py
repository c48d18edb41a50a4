"""Kernel-vs-plain check cases at the serving slice's shapes (and, for the
training slice's backward kernels and h1-stash forward, the same shapes;
fused_ff, the attention-map path's feed-forward, at that path's unpadded
rows: 2 clips x 7 frames x 362 tokens = 5,068).

Used by chip_smoke.py (phase 3) and tests/test_torch_kernels_gpu.py: the
same seeded inputs go through each kernel's wrapper (CUDA) and its plain
PyTorch version on the card.

SLICE: 2 clips, T+1 = 7 frames, S = 368 tokens (362 valid, pad rows all
zero), D = 728, I = 512 (8 heads x 64), FF hidden 2912. The weights and
biases are drawn like the model's own init, U(+-1/sqrt(fan_in)); the int8
cases quantize them.

Int8 kernels and their plain versions take the same int8 decisions
(identical LayerNorm statistics, quantization and epilogue order), so in
f32 they differ only by the attention's (or #6's float fc2's) summation
order, far inside atol = rtol = 2e-3. That margin matters: one flipped activation code would
move its row's outputs by up to amax * max|w| / 127, about 1e-3 at these
scales. The float kernels differ from theirs only by summation order, and
are held in f32 at atol = rtol = 1e-5: a GEMM that rounded its f32 inputs
to TF32 or bf16 would be off by about 1e-3 here. The backward kernels
return several outputs, among them weight gradients summed over every
row; each output is held at max|diff| <= 1e-5 * max|plain| (summation
order only; TF32 or bf16 rounding of the f32 inputs is ~1e-3 of the
scale and fails).

st_layer_q8 (#9) is the one int8 case that quantizes attention outputs it
computed itself (a_t, then a_s): the temporal core's summation order
moves a_t by up to 4.8e-7 against the plain version's, which flips 7 or 8
of its 2.6 million int8 codes at SLICE, and the spatial attention spreads
each flip over its frame (f32 max|diff| 9.8e-3 and 1.1e-2, rel-L2 8.6e-4
and 7.3e-4 at seeds 0 and 1 on an NVIDIA H100 80GB HBM3, 700 W,
tools/q8_layer_diag.py). So #9 is held in f32 as a free-running chain is
(tests/test_torch_istvt.py holds the stream after every layer at rel-L2
<= 1e-2), by the bf16 criterion below; that it computes exactly what
#1 -> #2 -> #3 compute is held bit for bit by
tests/test_torch_kernels_gpu.py.

Case names are the wrappers' launch-count names (kernels/_lib.LAUNCHES).
"""
from __future__ import annotations

import torch

from istvt_tpu_torch.kernels import attention, linear, mlp, quant

# the serving slice at the paper geometry, and the small geometry of the
# JAX package's kernel tests (tests/test_quant.py:207; dim_head 16)
SLICE = dict(b=2, t1=7, s=368, n_valid=362, d=728, inner=512, heads=8,
             hid=2912)
SMALL = dict(b=2, t1=4, s=32, n_valid=26, d=128, inner=64, heads=4, hid=256)
INT8_CASES = ("ln_qkv_q8_temporal_attention",
              "mm_q8_ln_qkv_q8_spatial_attention",
              "matmul_q8_res_ln_ff_q8_full", "ln_matmul_q8",
              "matmul_q8_ln_matmul_q8", "matmul_q8_bias_residual",
              "matmul_q8_bias_residual/no_r", "ln_ff_residual_q8",
              "st_layer_q8", "ln_ff_residual_q8_full")
BWD_CASES = ("temporal_attention_packed/bwd", "spatial_attention_packed/bwd",
             "ln_matmul/bwd", "ln_ff_residual/bwd")
FREE_RUNNING_CASES = ("st_layer_q8",)
F32_TOL_INT8, F32_TOL_FLOAT, F32_TOL_FREE_RUNNING = 2e-3, 1e-5, 1e-2


def slice_cases(device, geometry=SLICE, seed: int = 0):
    """{kernel name: (wrapper, plain, make_args(dtype))}."""
    g = torch.Generator().manual_seed(seed)
    b, t1, s, n_valid = (geometry[k] for k in ("b", "t1", "s", "n_valid"))
    d, inner, heads, hid = (geometry[k] for k in ("d", "inner", "heads",
                                                   "hid"))

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    def init(d_in, *shape):
        """U(+-1/sqrt(d_in)), the init of a layer with fan-in d_in."""
        return (torch.rand(*shape, generator=g) * 2 - 1) * d_in ** -0.5

    def q8(d_in, d_out):
        wq, ws = quant.quantize_weight(init(d_in, d_in, d_out))
        return wq.to(device), ws.to(device)

    ln_s, ln_b = rn(d, scale=0.1) + 1.0, rn(d, scale=0.02)
    bo, b1, b2 = rn(d, scale=0.02), rn(hid, scale=0.02), rn(d, scale=0.02)
    wqt, wst = q8(d, 3 * inner)
    woq, wos = q8(inner, d)
    wqs, wss = q8(d, 3 * inner)
    w1q, w1s = q8(d, hid)
    w2q, w2s = q8(hid, d)
    x = rn(b, t1, s, d)
    x[:, :, n_valid:] = 0.0                  # pad tokens are all-zero rows
    a_t = rn(b * t1, s, inner, scale=0.5)
    a_s = rn(b, t1 * s, inner, scale=0.5)
    # float cases: packed qkv activations, (in, out) weights, biases
    qkv_t = rn(b, t1, s, 3 * inner)
    qkv_s = rn(b * t1, s, 3 * inner)
    w_qkv, w_out = init(d, d, 3 * inner), init(inner, inner, d)
    b_out = init(inner, d)
    w1, b1f, w2, b2f = init(d, d, hid), init(d, hid), init(hid, hid, d), \
        init(hid, d)
    stream = x.reshape(b, t1 * s, d)
    # backward cases: output grads, the stream's rows
    g_t, g_s = rn(b, t1, s, inner), rn(b * t1, s, inner)
    rows = stream.reshape(-1, d)
    g_qkv, g_rows = rn(rows.shape[0], 3 * inner), rn(*rows.shape)
    # the attention-map path runs at S = n_valid, unpadded
    ff_rows = x[:, :, :n_valid].reshape(b, t1 * n_valid, d)
    # st_layer_q8's spatial QKV and out-projection (drawn last, so that
    # the draws above stay those of the other cases)
    wqs2, wss2 = q8(d, 3 * inner)
    wos2, sos2 = q8(inner, d)

    def on(dt, *ts):
        return [t.to(device, dt) for t in ts]

    def ff_bwd_args(dt):
        xr, s_, b_, w1_, b1_, w2_, b2_ = on(dt, rows, ln_s, ln_b, w1, b1f, w2,
                                             b2f)
        h1 = mlp.ln_ff_residual_h1_plain(xr, s_, b_, w1_, b1_, w2_, b2_)[1]
        return [xr, s_, b_, w1_, h1, w2_, *on(dt, g_rows)]

    return {
        "ln_qkv_q8_temporal_attention": (
            quant.ln_qkv_q8_temporal_attention, quant.ln_qkv_q8_temporal_plain,
            lambda dt: [*on(dt, x, ln_s, ln_b), wqt, wst, heads]),
        "mm_q8_ln_qkv_q8_spatial_attention": (
            quant.mm_q8_ln_qkv_q8_spatial_attention,
            quant.mm_q8_ln_qkv_q8_spatial_plain,
            lambda dt: [*on(dt, a_t), woq, wos, *on(dt, bo, ln_s, ln_b),
                        wqs, wss, heads, n_valid]),
        "matmul_q8_res_ln_ff_q8_full": (
            quant.matmul_q8_res_ln_ff_q8_full,
            quant.matmul_q8_res_ln_ff_q8_full_plain,
            lambda dt: [*on(dt, a_s, x.reshape(b, t1 * s, d)), woq, wos,
                        *on(dt, bo, ln_s, ln_b), w1q, w1s, *on(dt, b1),
                        w2q, w2s, *on(dt, b2)]),
        "ln_matmul_q8": (
            quant.ln_matmul_q8, quant.ln_matmul_q8_plain,
            lambda dt: [*on(dt, stream, ln_s, ln_b), wqt, wst]),
        "matmul_q8_ln_matmul_q8": (
            quant.matmul_q8_ln_matmul_q8, quant.matmul_q8_ln_matmul_q8_plain,
            lambda dt: [*on(dt, a_s), woq, wos, *on(dt, bo, ln_s, ln_b),
                        wqs, wss]),
        "matmul_q8_bias_residual": (
            quant.matmul_q8_bias_residual,
            quant.matmul_q8_bias_residual_plain,
            lambda dt: [*on(dt, a_s), woq, wos, *on(dt, bo, stream)]),
        "matmul_q8_bias_residual/no_r": (
            quant.matmul_q8_bias_residual,
            quant.matmul_q8_bias_residual_plain,
            lambda dt: [*on(dt, a_s), woq, wos, *on(dt, bo)]),
        "ln_ff_residual_q8": (
            quant.ln_ff_residual_q8, quant.ln_ff_residual_q8_plain,
            lambda dt: [*on(dt, stream, ln_s, ln_b), w1q, w1s,
                        *on(dt, b1, w2, b2f)]),
        "st_layer_q8": (
            quant.st_layer_q8, quant.st_layer_q8_plain,
            lambda dt: [*on(dt, x, ln_s, ln_b), wqt, wst, woq, wos,
                        *on(dt, bo, ln_s, ln_b), wqs2, wss2, wos2, sos2,
                        *on(dt, bo, ln_s, ln_b), w1q, w1s, *on(dt, b1), w2q,
                        w2s, *on(dt, b2), heads, n_valid]),
        "ln_ff_residual_q8_full": (
            quant.ln_ff_residual_q8_full, quant.ln_ff_residual_q8_full_plain,
            lambda dt: [*on(dt, stream, ln_s, ln_b), w1q, w1s, *on(dt, b1),
                        w2q, w2s, *on(dt, b2)]),
        "temporal_attention_packed": (
            attention.temporal_attention_packed,
            attention.temporal_packed_plain,
            lambda dt: [*on(dt, qkv_t), heads]),
        "spatial_attention_packed": (
            attention.spatial_attention_packed,
            attention.spatial_packed_plain,
            lambda dt: [*on(dt, qkv_s), heads, n_valid]),
        "ln_matmul": (
            linear.ln_matmul, linear.ln_matmul_plain,
            lambda dt: on(dt, stream, ln_s, ln_b, w_qkv)),
        "matmul_bias_residual": (
            linear.matmul_bias_residual, linear.matmul_bias_residual_plain,
            lambda dt: on(dt, a_s, w_out, b_out, stream)),
        "matmul_bias_residual/no_r": (
            linear.matmul_bias_residual, linear.matmul_bias_residual_plain,
            lambda dt: on(dt, a_s, w_out, b_out)),
        "ln_ff_residual": (
            mlp.ln_ff_residual, mlp.ln_ff_residual_plain,
            lambda dt: on(dt, stream, ln_s, ln_b, w1, b1f, w2, b2f)),
        "temporal_attention_packed/bwd": (
            attention.temporal_attention_packed_bwd,
            attention.temporal_packed_bwd_plain,
            lambda dt: [*on(dt, qkv_t, g_t), heads]),
        "spatial_attention_packed/bwd": (
            attention.spatial_attention_packed_bwd,
            attention.spatial_packed_bwd_plain,
            lambda dt: [*on(dt, qkv_s, g_s), heads, n_valid]),
        "ln_matmul/bwd": (
            linear.ln_matmul_bwd, linear.ln_matmul_bwd_plain,
            lambda dt: on(dt, rows, ln_s, ln_b, w_qkv, g_qkv)),
        "ln_ff_residual/h1": (
            mlp.ln_ff_residual_h1, mlp.ln_ff_residual_h1_plain,
            lambda dt: on(dt, stream, ln_s, ln_b, w1, b1f, w2, b2f)),
        "ln_ff_residual/bwd": (
            mlp.ln_ff_residual_bwd, mlp.ln_ff_residual_bwd_plain,
            ff_bwd_args),
        "fused_ff": (
            mlp.fused_ff, mlp.fused_ff_plain,
            lambda dt: on(dt, ff_rows, w1, b1f, w2, b2f)),
    }


def outputs(out) -> tuple:
    """A kernel's result as a tuple of tensors."""
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def f32_tol(case: str) -> float:
    """The f32 criterion of a case: atol = rtol, for a backward case the
    bound on max|diff| / max|plain| of every output, for a free-running
    case the bound on rel-L2 (with max|diff| < 0.02 max|plain|)."""
    if case in FREE_RUNNING_CASES:
        return F32_TOL_FREE_RUNNING
    return F32_TOL_INT8 if case in INT8_CASES else F32_TOL_FLOAT


def f32_close(case: str, got, want) -> tuple:
    """(ok, err): err is max|diff| (for a backward case max|diff| /
    max|plain|, the worst output), ok its criterion (f32_tol)."""
    if case in FREE_RUNNING_CASES:
        ok, _, mx, _ = bf16_close(got, want, rel_l2=F32_TOL_FREE_RUNNING)
        return ok, mx
    tol, ok, err = f32_tol(case), True, 0.0
    for g, w in zip(outputs(got), outputs(want)):
        diff = (g.float() - w.float()).abs().max().item()
        if case in BWD_CASES:
            e = diff / max(w.float().abs().max().item(), 1e-30)
            ok = ok and e <= tol
        else:
            e = diff
            ok = ok and torch.allclose(g, w, atol=tol, rtol=tol)
        err = max(err, e)
    return ok, err


def bf16_close(got, want, rel_l2: float = 1e-2, max_frac: float = 0.02):
    """(ok, rel-L2, max|diff|, max|want|) of the worst output: the
    criterion of tests/test_tpu_smoke._assert_close_bf16 — small relative
    L2 error AND a max deviation bounded by a fraction of the tensor's
    scale, since two valid bf16 accumulation orders round a few entries
    differently."""
    ok, worst = True, (0.0, 0.0, 0.0)
    for g, w in zip(outputs(got), outputs(want)):
        g, w = g.float(), w.float()
        rel = ((g - w).norm() / w.norm().clamp_min(1e-9)).item()
        mx, scale = (g - w).abs().max().item(), w.abs().max().item()
        ok = ok and rel < rel_l2 and mx < max_frac * scale
        worst = max(worst, (rel, mx, scale))
    return (ok,) + worst
