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
are held in f32 at atol = rtol = 1e-5, a test of f32-level accuracy: a
GEMM that rounded its f32 inputs to TF32 once, or to bf16, would be off by
about 1e-3 here, where the three TF32 products (a_lo b_hi + a_hi b_lo +
a_hi b_hi, kernels/linear.split_tf32) of the f32 GEMM and of the f32
spatial attention cores meet it, as f32 in another summation order does
(the GEMM on the card: max|diff| 3e-6 to 1.2e-5 at the callers' shapes,
the largest on outputs of magnitude ~1; PERF.md,
tests/test_torch_gemm_f32.py and tests/test_torch_spatial_f32.py). The backward kernels return several
outputs, among them weight gradients summed over every row; each output
is held at max|diff| <= 1e-5 * max|plain| (summation order only; TF32 or
bf16 rounding of the f32 inputs is ~1e-3 of the scale and fails).

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

The kernel API's entries (#13's unpacked entry, #14-#17, #24 sepconv_bn)
are on no model path; their cases take the slice's attention shapes (#14
folds the heads into G = 2 x 7 x 8 = 112), the temporal ones also at
S = n_valid (362, the shape tests/test_tpu_smoke.py:109 holds JAX to), and
sepconv_bn the Xception stem's four stride-1 units over 12 frames (2 clips
x 6): block1's 147^2 x 64 -> 128 (no pre-ReLU) and 128 -> 128, block2's
74^2 x 128 -> 256, block3's 37^2 x 256 -> 728 (SMALL: 13 x 11 up to 4 x 4,
channels off the kernel's 32 / 64 tiles). They are held by the float
criteria; #16 and #17 follow JAX's bf16 roundings, so in bf16 they agree
with their plain versions almost bit for bit.

Case names are the wrappers' launch-count names (kernels/_lib.LAUNCHES),
one case each; a few kernels have more cases at other shapes,
"name@shape", which count under `counter(case)`: among them the temporal
core #11 and its backward #12 at the B=16 forward's and train step's 16
clips ("@b16", the main path's shape, drawn when made). The int8 wrappers
that run the int8 GEMM are given the K-major weight copies (quant.kmajor)
made here, once, as a model holds them.

The GEMMs alone are tabled below the cases: the float GEMM (gemm_shapes,
with bf16 or f32 inputs) and the int8 GEMM (gemm_q8_shapes), each at
every caller's shape, with their operands, plain versions, criteria and
counts of work.
"""
from __future__ import annotations

import functools
import re

import torch
import torch.nn.functional as F

from istvt_tpu_torch.kernels import _lib, attention, conv, linear, mlp, quant

# the serving slice at the paper geometry, and the small geometry of the
# JAX package's kernel tests (tests/test_quant.py:207; dim_head 16);
# units: sepconv_bn's cases, (H, W, Cin, Cout, relu_in) over `frames`
SLICE = dict(b=2, t1=7, s=368, n_valid=362, d=728, inner=512, heads=8,
             hid=2912, frames=12,
             units={"block1.0": (147, 147, 64, 128, False),
                    "block1.1": (147, 147, 128, 128, True),
                    "block2.0": (74, 74, 128, 256, True),
                    "block3.0": (37, 37, 256, 728, True)})
SMALL = dict(b=2, t1=4, s=32, n_valid=26, d=128, inner=64, heads=4, hid=256,
             frames=2,
             units={"block1.0": (13, 11, 16, 24, False),
                    "block1.1": (13, 11, 24, 24, True),
                    "block2.0": (7, 6, 24, 40, True),
                    "block3.0": (4, 4, 40, 72, True)})
# the kernel API's sepconv_bn case (the unit chip_smoke.py's kernel API
# phase runs) and the cases at other shapes
SEPCONV_UNIT = "block2.0"
VARIANTS = ("fused_temporal_attention@n_valid",
            "fused_temporal_attention_bwd@n_valid",
            "temporal_attention_packed@b16",
            "temporal_attention_packed/bwd@b16",
            *(f"sepconv_bn@{u}" for u in SLICE["units"] if u != SEPCONV_UNIT))
# the geometries past the paper's that the JAX package runs: longer clips
# (--seq_len 8, 16, 32: T1 = 9, 17, 33; the temporal cores' general lanes)
# and larger frames (-is 320: a 20 x 20 grid, S = 408 with 401 valid keys;
# -is 448: 28 x 28, S = 792 with 785): "@tN" at T1 = N, "@sN" at S = N, "b16"
# at the B=16 forward's 16 clips, each drawn from a generator of its own
GEOMETRY_VARIANTS = (
    "temporal_attention_packed@b16t9", "temporal_attention_packed@b16t17",
    "temporal_attention_packed@b16t33",
    "temporal_attention_packed/bwd@b16t9",
    "temporal_attention_packed/bwd@b16t17",
    "spatial_attention_packed@b16s408", "spatial_attention_packed@b16s792",
    "spatial_attention_packed/bwd@b16s408",
    "spatial_attention_packed/bwd@b16s792",
    "ln_qkv_q8_temporal_attention@t9",
    "mm_q8_ln_qkv_q8_spatial_attention@s408", "st_layer_q8@t9s408",
    "fused_temporal_attention@t9", "fused_temporal_attention_bwd@t9",
    "fused_frame_attention_mh@s408", "fused_frame_attention_bwd@s408")
# valid keys of the padded S of a larger frame (h w + 1 tokens)
GEOMETRY_N_VALID = {408: 401, 792: 785}
CASES = tuple(_lib.LAUNCHES) + VARIANTS + GEOMETRY_VARIANTS
INT8_CASES = ("ln_qkv_q8_temporal_attention",
              "mm_q8_ln_qkv_q8_spatial_attention",
              "matmul_q8_res_ln_ff_q8_full", "ln_matmul_q8",
              "matmul_q8_ln_matmul_q8", "matmul_q8_bias_residual",
              "matmul_q8_bias_residual/no_r", "ln_ff_residual_q8",
              "st_layer_q8", "ln_ff_residual_q8_full")
BWD_CASES = ("temporal_attention_packed/bwd", "spatial_attention_packed/bwd",
             "ln_matmul/bwd", "ln_ff_residual/bwd",
             "fused_frame_attention_bwd", "fused_temporal_attention_bwd")
# kernels that follow JAX's bf16 roundings op for op: the share of their
# bf16 outputs equal to the plain version's bit for bit is reported
BITWISE_CASES = ("fused_temporal_attention", "fused_temporal_attention_bwd")
FREE_RUNNING_CASES = ("st_layer_q8",)
# the clips of the "@b16" cases: the B=16 forward's and train step's batch
B16 = 16
F32_TOL_INT8, F32_TOL_FLOAT, F32_TOL_FREE_RUNNING = 2e-3, 1e-5, 1e-2


def counter(case: str) -> str:
    """The launch counter of a case: its name up to any '@shape'."""
    return case.split("@")[0]


def slice_cases(device, geometry=SLICE, seed: int = 0):
    """{case name (CASES): (wrapper, plain, make_args(dtype))}."""
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

    def with_wk(wrapper, *wqs):
        """The int8 wrapper given the K-major copies of wqs, made once."""
        return functools.partial(wrapper,
                                 wk=tuple(quant.kmajor(w) for w in wqs))

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
    # the kernel API: unpacked q, k, v (and out-grads), drawn after the rest
    dh = inner // heads
    fq, fk, fv = (rn(b * t1 * heads, s, dh) for _ in range(3))
    mq, mk, mv, mg = (rn(b * t1, s, inner) for _ in range(4))
    tq, tk, tv, tg = (rn(b, t1, s, inner) for _ in range(4))
    units = {}
    for name, (uh, uw, cin, cout, relu_in) in geometry["units"].items():
        bn = (torch.rand(cout, generator=g) + 0.5, rn(cout, scale=0.1),
              rn(cout, scale=0.05), torch.rand(cout, generator=g) + 0.5)
        units[name] = (rn(geometry["frames"], uh, uw, cin, scale=0.5),
                       init(9, 9, cin), init(cin, cin, cout),
                       *conv.fold_bn(*bn), relu_in)

    def unit_case(name):
        x, dw, pw, a, b_, relu_in = units[name]
        return (conv.sepconv_bn, conv.sepconv_bn_plain,
                lambda dt: [*on(dt, x), *on(torch.float32, dw, pw, a, b_),
                            relu_in])

    def on(dt, *ts):
        return [t.to(device, dt) for t in ts]

    def b16(dt, grad=False):
        """The temporal qkv (and its output grad) at the B=16 forward's and
        train step's shape, from a generator of its own when a case is
        made (so that no other case's draws move)."""
        g16 = torch.Generator().manual_seed(seed + B16)
        qkv = torch.randn(B16, t1, s, 3 * inner, generator=g16)
        grads = [torch.randn(B16, t1, s, inner, generator=g16)] if grad else []
        return on(dt, qkv, *grads)

    def drawn(tag, *shapes):
        """Tensors of these shapes from a generator of the case's own."""
        gv = torch.Generator().manual_seed(seed + sum(map(ord, tag)))
        return [torch.randn(*sh, generator=gv) for sh in shapes]

    def padded(x, n):
        x[:, :, n:] = 0.0
        return x

    def temporal_at(nb, nt, grad=False):
        shapes = [(nb, nt, s, 3 * inner)] + ([(nb, nt, s, inner)] if grad
                                              else [])
        return lambda dt: [*on(dt, *drawn(f"t{nb}.{nt}.{grad}", *shapes)),
                           heads]

    def spatial_at(nb, ns, grad=False):
        shapes = [(nb * t1, ns, 3 * inner)] + ([(nb * t1, ns, inner)] if grad
                                               else [])
        return lambda dt: [*on(dt, *drawn(f"s{nb}.{ns}.{grad}", *shapes)),
                           heads, GEOMETRY_N_VALID[ns]]

    def ff_bwd_args(dt):
        xr, s_, b_, w1_, b1_, w2_, b2_ = on(dt, rows, ln_s, ln_b, w1, b1f, w2,
                                             b2f)
        h1 = mlp.ln_ff_residual_h1_plain(xr, s_, b_, w1_, b1_, w2_, b2_)[1]
        return [xr, s_, b_, w1_, h1, w2_, *on(dt, g_rows)]

    cases = {
        "ln_qkv_q8_temporal_attention": (
            with_wk(quant.ln_qkv_q8_temporal_attention, wqt),
            quant.ln_qkv_q8_temporal_plain,
            lambda dt: [*on(dt, x, ln_s, ln_b), wqt, wst, heads]),
        "mm_q8_ln_qkv_q8_spatial_attention": (
            with_wk(quant.mm_q8_ln_qkv_q8_spatial_attention, woq, wqs),
            quant.mm_q8_ln_qkv_q8_spatial_plain,
            lambda dt: [*on(dt, a_t), woq, wos, *on(dt, bo, ln_s, ln_b),
                        wqs, wss, heads, n_valid]),
        "matmul_q8_res_ln_ff_q8_full": (
            with_wk(quant.matmul_q8_res_ln_ff_q8_full, woq, w1q, w2q),
            quant.matmul_q8_res_ln_ff_q8_full_plain,
            lambda dt: [*on(dt, a_s, x.reshape(b, t1 * s, d)), woq, wos,
                        *on(dt, bo, ln_s, ln_b), w1q, w1s, *on(dt, b1),
                        w2q, w2s, *on(dt, b2)]),
        "ln_matmul_q8": (
            with_wk(quant.ln_matmul_q8, wqt), quant.ln_matmul_q8_plain,
            lambda dt: [*on(dt, stream, ln_s, ln_b), wqt, wst]),
        "matmul_q8_ln_matmul_q8": (
            with_wk(quant.matmul_q8_ln_matmul_q8, woq, wqs),
            quant.matmul_q8_ln_matmul_q8_plain,
            lambda dt: [*on(dt, a_s), woq, wos, *on(dt, bo, ln_s, ln_b),
                        wqs, wss]),
        "matmul_q8_bias_residual": (
            with_wk(quant.matmul_q8_bias_residual, woq),
            quant.matmul_q8_bias_residual_plain,
            lambda dt: [*on(dt, a_s), woq, wos, *on(dt, bo, stream)]),
        "matmul_q8_bias_residual/no_r": (
            with_wk(quant.matmul_q8_bias_residual, woq),
            quant.matmul_q8_bias_residual_plain,
            lambda dt: [*on(dt, a_s), woq, wos, *on(dt, bo)]),
        "ln_ff_residual_q8": (
            with_wk(quant.ln_ff_residual_q8, w1q),
            quant.ln_ff_residual_q8_plain,
            lambda dt: [*on(dt, stream, ln_s, ln_b), w1q, w1s,
                        *on(dt, b1, w2, b2f)]),
        "st_layer_q8": (
            with_wk(quant.st_layer_q8, wqt, woq, wqs2, wos2, w1q, w2q),
            quant.st_layer_q8_plain,
            lambda dt: [*on(dt, x, ln_s, ln_b), wqt, wst, woq, wos,
                        *on(dt, bo, ln_s, ln_b), wqs2, wss2, wos2, sos2,
                        *on(dt, bo, ln_s, ln_b), w1q, w1s, *on(dt, b1), w2q,
                        w2s, *on(dt, b2), heads, n_valid]),
        "ln_ff_residual_q8_full": (
            with_wk(quant.ln_ff_residual_q8_full, w1q, w2q),
            quant.ln_ff_residual_q8_full_plain,
            lambda dt: [*on(dt, stream, ln_s, ln_b), w1q, w1s, *on(dt, b1),
                        w2q, w2s, *on(dt, b2)]),
        "temporal_attention_packed": (
            attention.temporal_attention_packed,
            attention.temporal_packed_plain,
            lambda dt: [*on(dt, qkv_t), heads]),
        "temporal_attention_packed@b16": (
            attention.temporal_attention_packed,
            attention.temporal_packed_plain,
            lambda dt: [*b16(dt), heads]),
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
        "temporal_attention_packed/bwd@b16": (
            attention.temporal_attention_packed_bwd,
            attention.temporal_packed_bwd_plain,
            lambda dt: [*b16(dt, grad=True), heads]),
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
        "fused_frame_attention": (
            attention.fused_frame_attention,
            attention.fused_frame_attention_plain,
            lambda dt: on(dt, fq, fk, fv)),
        "fused_frame_attention_mh": (
            attention.fused_frame_attention_mh,
            attention.fused_frame_attention_mh_plain,
            lambda dt: [*on(dt, mq, mk, mv), heads]),
        "fused_frame_attention_bwd": (
            attention.fused_frame_attention_bwd,
            attention.fused_frame_attention_bwd_plain,
            lambda dt: [*on(dt, mq, mk, mv, mg), heads]),
        "fused_temporal_attention": (
            attention.fused_temporal_attention,
            attention.fused_temporal_attention_plain,
            lambda dt: [*on(dt, tq, tk, tv), heads]),
        "fused_temporal_attention@n_valid": (
            attention.fused_temporal_attention,
            attention.fused_temporal_attention_plain,
            lambda dt: [*(t[:, :, :n_valid].contiguous()
                          for t in on(dt, tq, tk, tv)), heads]),
        "fused_temporal_attention_bwd": (
            attention.fused_temporal_attention_bwd,
            attention.fused_temporal_attention_bwd_plain,
            lambda dt: [*on(dt, tq, tk, tv, tg), heads]),
        "fused_temporal_attention_bwd@n_valid": (
            attention.fused_temporal_attention_bwd,
            attention.fused_temporal_attention_bwd_plain,
            lambda dt: [*(t[:, :, :n_valid].contiguous()
                          for t in on(dt, tq, tk, tv, tg)), heads]),
        "sepconv_bn": unit_case(SEPCONV_UNIT),
        **{f"sepconv_bn@{u}": unit_case(u) for u in units
           if u != SEPCONV_UNIT},
    }
    for nt in (9, 17, 33):
        cases[f"temporal_attention_packed@b16t{nt}"] = (
            attention.temporal_attention_packed,
            attention.temporal_packed_plain, temporal_at(B16, nt))
        cases[f"temporal_attention_packed/bwd@b16t{nt}"] = (
            attention.temporal_attention_packed_bwd,
            attention.temporal_packed_bwd_plain,
            temporal_at(B16, nt, grad=True))
    for ns in GEOMETRY_N_VALID:
        cases[f"spatial_attention_packed@b16s{ns}"] = (
            attention.spatial_attention_packed,
            attention.spatial_packed_plain, spatial_at(B16, ns))
        cases[f"spatial_attention_packed/bwd@b16s{ns}"] = (
            attention.spatial_attention_packed_bwd,
            attention.spatial_packed_bwd_plain,
            spatial_at(B16, ns, grad=True))
    x9, = drawn("x9", (b, 9, s, d))
    a408, = drawn("a408", (b * t1, 408, inner))
    x9s, = drawn("x9s", (b, 9, 408, d))
    t9 = drawn("t9", *[(b, 9, s, inner)] * 4)
    m408 = drawn("m408", *[(b * t1, 408, inner)] * 4)
    cases.update({
        "ln_qkv_q8_temporal_attention@t9": (
            *cases["ln_qkv_q8_temporal_attention"][:2],
            lambda dt: [*on(dt, padded(x9, n_valid), ln_s, ln_b), wqt, wst,
                        heads]),
        "mm_q8_ln_qkv_q8_spatial_attention@s408": (
            *cases["mm_q8_ln_qkv_q8_spatial_attention"][:2],
            lambda dt: [*on(dt, a408 * 0.5), woq, wos,
                        *on(dt, bo, ln_s, ln_b), wqs, wss, heads, 401]),
        "st_layer_q8@t9s408": (
            *cases["st_layer_q8"][:2],
            lambda dt: [*on(dt, padded(x9s, 401), ln_s, ln_b), wqt, wst, woq,
                        wos, *on(dt, bo, ln_s, ln_b), wqs2, wss2, wos2, sos2,
                        *on(dt, bo, ln_s, ln_b), w1q, w1s, *on(dt, b1), w2q,
                        w2s, *on(dt, b2), heads, 401]),
        "fused_temporal_attention@t9": (
            *cases["fused_temporal_attention"][:2],
            lambda dt: [*on(dt, *t9[:3]), heads]),
        "fused_temporal_attention_bwd@t9": (
            *cases["fused_temporal_attention_bwd"][:2],
            lambda dt: [*on(dt, *t9), heads]),
        "fused_frame_attention_mh@s408": (
            *cases["fused_frame_attention_mh"][:2],
            lambda dt: [*on(dt, *m408[:3]), heads]),
        "fused_frame_attention_bwd@s408": (
            *cases["fused_frame_attention_bwd"][:2],
            lambda dt: [*on(dt, *m408), heads]),
    })
    return {c: cases[c] for c in CASES}


def outputs(out) -> tuple:
    """A kernel's result as a tuple of tensors."""
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def f32_tol(case: str) -> float:
    """The f32 criterion of a case: atol = rtol, for a backward case the
    bound on max|diff| / max|plain| of every output, for a free-running
    case the bound on rel-L2 (with max|diff| < 0.02 max|plain|)."""
    case = counter(case)
    if case in FREE_RUNNING_CASES:
        return F32_TOL_FREE_RUNNING
    return F32_TOL_INT8 if case in INT8_CASES else F32_TOL_FLOAT


def f32_close(case: str, got, want) -> tuple:
    """(ok, err): err is max|diff| (for a backward case max|diff| /
    max|plain|, the worst output), ok its criterion (f32_tol)."""
    if counter(case) in FREE_RUNNING_CASES:
        ok, _, mx, _ = bf16_close(got, want, rel_l2=F32_TOL_FREE_RUNNING)
        return ok, mx
    tol, ok, err = f32_tol(case), True, 0.0
    for g, w in zip(outputs(got), outputs(want)):
        diff = (g.float() - w.float()).abs().max().item()
        if counter(case) in BWD_CASES:
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


def bit_equal_share(got, want) -> float:
    """The share of elements, over every output, equal bit for bit."""
    same = total = 0
    for g, w in zip(outputs(got), outputs(want)):
        same += int((g == w).sum().item())
        total += w.numel()
    return same / max(total, 1)


# ---------------------------------------------------------------------------
# The float GEMM (kernels/linear.gemm) alone, at the shapes of its callers and
# at edges: bf16 operands in their stored layout, one of its epilogues.

# epilogues of a GEMM case: + bias, tanh-GELU, + res in the std epilogue;
# "stash" is bias + GELU with the pre-activation stored (layout nn, bf16
# out); "gelu_bwd" acc * gelu'(aux) with gelu(aux) and the column-sum
# partials (layout nt, bf16 out)
GEMM_EPILOGUES = ("plain", "bias", "bias_gelu", "bias_res", "bias_gelu_res",
                  "stash", "gelu_bwd")


def gemm_shapes(geometry=SLICE, dtype=torch.bfloat16) -> dict:
    """{name: (layout, M, N, K, epilogue, out dtype)}: every GEMM launch of
    the float path at `geometry`'s rows R = b * t1 * s (#22's fused_ff at
    its unpadded b * t1 * n_valid rows), with the epilogue and output
    dtype its caller gives it for inputs of `dtype` (f32 inputs give f32
    outputs)."""
    b, t1, s, n_valid = (geometry[k] for k in ("b", "t1", "s", "n_valid"))
    d, inner, hid = geometry["d"], geometry["inner"], geometry["hid"]
    r, fr, f32, dt = b * t1 * s, b * t1 * n_valid, torch.float32, dtype
    return {
        "#18 QKV": ("nn", r, 3 * inner, d, "plain", dt),
        "#20 out-projection + r": ("nn", r, d, inner, "bias_res", dt),
        "#20 out-projection": ("nn", r, d, inner, "bias", dt),
        "#21 fc1": ("nn", r, hid, d, "bias_gelu", dt),
        "#21_h1 fc1 (stash)": ("nn", r, hid, d, "stash", dt),
        "#21 / #6 fc2": ("nn", r, d, hid, "bias_res", dt),
        "#22 fc1": ("nn", fr, hid, d, "bias_gelu", dt),
        "#22 fc2": ("nn", fr, d, hid, "bias", dt),
        "#19 dy": ("nt", r, d, 3 * inner, "plain", f32),
        "#19 dW": ("tn", d, 3 * inner, r, "plain", f32),
        "#20 backward dx": ("nt", r, inner, d, "plain", dt),
        "#20 backward dW": ("tn", inner, d, r, "plain", f32),
        "#23 dh1 (gelu_bwd)": ("nt", r, hid, d, "gelu_bwd", dt),
        "#23 dw2": ("tn", hid, d, r, "plain", f32),
        "#23 dw1": ("tn", d, hid, r, "plain", f32),
        "#23 dy": ("nt", r, d, hid, "plain", f32),
    }


def gemm_operands(layout, m, n, k, epilogue, out_dtype, device, seed=0,
                  dtype=torch.bfloat16):
    """The arguments of one linear.gemm call with inputs of `dtype`: {"a",
    "b", "out", "layout", and the epilogue's keywords}; a drawn N(0, 1)
    like activations, b like a layer's init U(+-1/sqrt(k)) (for tn, where
    both are activations or gradients, N(0, 1) too), bias N(0, 0.02), res
    and aux N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(*((k, m) if layout == "tn" else (m, k)), generator=g)
    b_shape = (n, k) if layout == "nt" else (k, n)
    b = (torch.randn(*b_shape, generator=g) if layout == "tn"
         else (torch.rand(*b_shape, generator=g) * 2 - 1) * k ** -0.5)
    ops = {"a": a.to(device, dtype), "b": b.to(device, dtype),
           "layout": layout,
           "out": torch.empty(m, n, dtype=out_dtype, device=device)}
    if epilogue != "plain" and epilogue != "gelu_bwd":
        ops["bias32"] = (torch.randn(n, generator=g) * 0.02).to(device)
    if "res" in epilogue:
        ops["res"] = torch.randn(m, n, generator=g).to(device, dtype)
    if "gelu" in epilogue or epilogue == "stash":
        ops["gelu"] = True
    if epilogue == "stash":
        ops["out2"] = torch.empty(m, n, dtype=dtype, device=device)
    if epilogue == "gelu_bwd":
        del ops["gelu"]
        ops["aux"] = torch.randn(m, n, generator=g).to(device, dtype)
        ops["out2"] = torch.empty(m, n, dtype=dtype, device=device)
        ops["part"] = torch.empty(-(-m // linear.gemm_row_tile(dtype)), n,
                                  dtype=torch.float32, device=device)
    return ops


def run_gemm(ops):
    """linear.gemm on the operands of gemm_operands."""
    linear.gemm(**ops)


def gemm_results(ops) -> tuple:
    """The outputs of a run_gemm call: out (, out2) (, part)."""
    return tuple(ops[k] for k in ("out", "out2", "part") if k in ops)


def gemm_plain(ops) -> tuple:
    """The plain f32 version of run_gemm on the same operands, with the
    outputs of gemm_results: the product of the bf16 values in f32, the
    epilogue in the JAX order (kernels/linear._matmul_bias_reference,
    kernels/mlp._ff_reference and _ln_ff_bwd_kernel), each output rounded
    once to its dtype."""
    a, b, layout, out = ops["a"].float(), ops["b"].float(), ops["layout"], \
        ops["out"]
    acc = a.t() @ b if layout == "tn" else a @ b.t() if layout == "nt" \
        else a @ b
    if "aux" in ops:
        val, dval = mlp._gelu_tanh_and_grad(ops["aux"].float())
        o = acc * dval
        m, n = o.shape
        tile = linear.gemm_row_tile(ops["a"].dtype)
        pad = torch.zeros(-(-m // tile) * tile - m, n, device=o.device)
        part = torch.cat([o, pad]).reshape(-1, tile, n).sum(1)
        return o.to(out.dtype), val.to(ops["out2"].dtype), part
    v = acc
    if ops.get("bias32") is not None:
        v = v + ops["bias32"]
    pre = v
    if ops.get("gelu"):
        v = mlp._gelu_tanh(v)
    if ops.get("res") is not None:
        v = v + ops["res"].float()
    if "out2" in ops:
        return v.to(out.dtype), pre.to(ops["out2"].dtype)
    return (v.to(out.dtype),)


def gemm_flops_bytes(ops) -> tuple:
    """(operations, bytes) of a GEMM case: 2 M N K, and each input read and
    each output written once (the f32 GEMM's B planes are its own scratch
    traffic, not the function's: their pass counts in its time only)."""
    (m, n), layout = ops["out"].shape, ops["layout"]
    k = ops["a"].shape[0 if layout == "tn" else 1]
    tensors = [t for t in ops.values() if torch.is_tensor(t)]
    return 2 * m * n * k, sum(t.numel() * t.element_size() for t in tensors)


# published H100 SXM peaks (NVIDIA's data sheet): bytes/s, and dense
# operations/s by the type of the operation (int8, bf16 and tf32: the tensor
# cores; f32: the FMA pipes, outside them)
HBM_BPS = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def float_gemm_ops(flops, dtype) -> dict:
    """{type: operations} of `flops` (2 M N K) on the float GEMM, or on the
    spatial attention cores, with inputs of `dtype`: bf16 products on the
    bf16 tensor cores, f32 as three TF32 products (split_tf32)."""
    return {"tf32": 3 * flops} if dtype == torch.float32 else {"bf16": flops}


def bound_ms(ops: dict, nbytes) -> tuple:
    """(ms, what sets it) of the least time the card could take for work of
    `ops` ({type: operations}) that must move `nbytes`: the larger of the
    bytes over the memory rate and the operations over their peaks."""
    t_ops = sum(n / PEAK_OPS[k] for k, n in ops.items())
    t_bytes = nbytes / HBM_BPS
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# The yardsticks of a case (chip_smoke.py's kernels line, tools/kernel_ms.py
# --library): its operations by type, its bound, and one PyTorch call
# computing the same function.

# the kernels whose float products run on the tensor cores in f32 as three
# TF32 products a multiply-add: those on the float GEMM, the spatial
# attention cores (#10, #13, #14, #15, #2's core) and #24's pointwise (its
# depthwise stays f32 on the FMA pipes); the other f32 products (the
# temporal cores) run on the FMA pipes (#9 runs both kinds)
TF32_CASES = ("ln_matmul", "matmul_bias_residual",
              "matmul_bias_residual/no_r", "ln_ff_residual",
              "ln_ff_residual/h1", "ln_ff_residual/bwd", "ln_matmul/bwd",
              "fused_ff", "ln_ff_residual_q8", "spatial_attention_packed",
              "spatial_attention_packed/bwd", "fused_frame_attention",
              "fused_frame_attention_mh", "fused_frame_attention_bwd",
              "mm_q8_ln_qkv_q8_spatial_attention", "sepconv_bn")


def case_ops(name, args):
    """{input type: operations} the kernel's products need on these inputs
    (multiply-adds count 2; elementwise work is left out). Masked keys
    (>= n_valid) are not counted: the data does not need them."""
    if name == "ln_qkv_q8_temporal_attention":
        x, wq, heads = args[0], args[3], args[5]
        b, t1, s, d = x.shape
        inner = wq.shape[1] // 3
        return {"int8": 2 * x.numel() // d * d * 3 * inner,
                "bf16": 4 * b * s * t1 * t1 * inner}
    if name == "mm_q8_ln_qkv_q8_spatial_attention":
        a, woq, wq, n_valid = args[0], args[1], args[6], args[9]
        g, s, d_in = a.shape
        d, inner = woq.shape[1], wq.shape[1] // 3
        return {"int8": 2 * g * s * (d_in * d + d * 3 * inner),
                "bf16": 4 * g * s * n_valid * inner}
    if name == "matmul_q8_res_ln_ff_q8_full":
        a, wqo, w1q = args[0], args[2], args[7]
        rows = a.numel() // a.shape[-1]
        d, hid = wqo.shape[1], w1q.shape[1]
        return {"int8": 2 * rows * (a.shape[-1] * d + 2 * d * hid)}
    if name == "st_layer_q8":                     # 6 GEMMs, both cores
        x, n_valid = args[0], args[24]
        b, t1, s, d = x.shape
        inner = args[3].shape[1] // 3
        return {"int8": 2 * x.numel() // d * sum(
                    args[i].numel() for i in (3, 5, 10, 12, 17, 20)),
                "bf16": 4 * b * s * t1 * t1 * inner
                + 4 * b * t1 * s * n_valid * inner}
    if name == "temporal_attention_packed":
        b, t1, s, i3 = args[0].shape
        return {"bf16": 4 * b * s * t1 * t1 * (i3 // 3)}
    if name == "spatial_attention_packed":
        g, s, i3 = args[0].shape
        return {"bf16": 4 * g * s * args[2] * (i3 // 3)}
    if name == "temporal_attention_packed/bwd":   # 5 products of (T1, T1)
        b, t1, s, i3 = args[0].shape
        return {"bf16": 10 * b * s * t1 * t1 * (i3 // 3)}
    if name == "spatial_attention_packed/bwd":    # 5 products, valid keys
        g, s, i3 = args[0].shape
        return {"bf16": 10 * g * s * args[3] * (i3 // 3)}
    if name in ("fused_frame_attention", "fused_frame_attention_mh"):
        g, s, inner = args[0].shape               # no mask
        return {"bf16": 4 * g * s * s * inner}
    if name == "fused_frame_attention_bwd":       # 5 products, no mask
        g, s, inner = args[0].shape
        return {"bf16": 10 * g * s * s * inner}
    if name == "fused_temporal_attention":
        b, t1, s, inner = args[0].shape
        return {"bf16": 4 * b * s * t1 * t1 * inner}
    if name == "fused_temporal_attention_bwd":    # 5 products of (T1, T1)
        b, t1, s, inner = args[0].shape
        return {"bf16": 10 * b * s * t1 * t1 * inner}
    if name == "sepconv_bn":                      # pointwise; f32 depthwise
        pixels, cin = args[0].numel() // args[0].shape[-1], args[0].shape[-1]
        return {"bf16": 2 * pixels * cin * args[2].shape[1],
                "f32": 18 * pixels * cin}
    rows = args[0].numel() // args[0].shape[-1]
    if name == "ln_matmul_q8":                    # (rows, D) @ (D, K)
        return {"int8": 2 * rows * args[3].numel()}
    if name in ("matmul_q8_bias_residual", "matmul_q8_bias_residual/no_r"):
        return {"int8": 2 * rows * args[1].numel()}
    if name == "matmul_q8_ln_matmul_q8":          # out-proj, then QKV
        return {"int8": 2 * rows * (args[1].numel() + args[6].numel())}
    if name == "ln_ff_residual_q8":               # int8 fc1, float fc2
        return {"int8": 2 * rows * args[3].numel(),
                "bf16": 2 * rows * args[6].numel()}
    if name == "ln_ff_residual_q8_full":          # int8 fc1 and fc2
        return {"int8": 2 * rows * (args[3].numel() + args[6].numel())}
    if name in ("ln_ff_residual", "ln_ff_residual/h1"):
        return {"bf16": 4 * rows * args[3].shape[0] * args[3].shape[1]}
    if name == "fused_ff":                        # fc1, fc2
        return {"bf16": 4 * rows * args[1].shape[0] * args[1].shape[1]}
    if name == "ln_ff_residual/bwd":              # dW2, dH, dW1, dY
        return {"bf16": 8 * rows * args[3].shape[0] * args[3].shape[1]}
    if name == "ln_matmul/bwd":                   # dY, dW
        return {"bf16": 4 * rows * args[3].numel()}
    # ln_matmul, matmul_bias_residual(/no_r): one (rows, K) @ (K, N) product
    return {"bf16": 2 * rows * args[-1 if name == "ln_matmul" else 1].numel()}


def case_ops_as_run(name, args, dtype):
    """case_ops by the type of operation that runs them for activations of
    `dtype`: in f32 the products of TF32_CASES as three TF32 products
    (float_gemm_ops), the others f32 on the FMA pipes."""
    ops = case_ops(name, args)
    if dtype != torch.float32:
        return ops
    out = {}
    for k, n in ops.items():
        parts = {k: n}
        if k == "bf16":
            parts = (float_gemm_ops(n, dtype)
                     if name in TF32_CASES else {"f32": n})
        for kk, nn in parts.items():
            out[kk] = out.get(kk, 0) + nn
    return out


def case_bound_ms(name, args, out, dtype=torch.bfloat16):
    """The least time the card could take (bound_ms): the bytes the
    function must move (each input read once, the output written once) and
    its operations by type (case_ops_as_run for activations of `dtype`)."""
    tensors = [t for t in args if torch.is_tensor(t)] + list(outputs(out))
    return bound_ms(case_ops_as_run(name, args, dtype),
                    sum(t.numel() * t.element_size() for t in tensors))


def library_call(name, args):
    """One PyTorch call computing the same function, timed as a yardstick
    only (the port never calls it), or None where there is none."""
    if name == "spatial_attention_packed":
        qkv, heads, n_valid = args
        g, s, i3 = qkv.shape
        q, k, v = (t.view(g, s, heads, -1).transpose(1, 2)
                   for t in qkv.split(i3 // 3, dim=-1))
        mask = torch.zeros(1, 1, 1, s, dtype=qkv.dtype, device=qkv.device)
        mask[..., n_valid:] = -1e30
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask)
    if name == "matmul_bias_residual/no_r":
        x, w, b = args
        return lambda: F.linear(x, w.t(), b)
    if name in ("fused_frame_attention", "fused_frame_attention_mh"):
        q, k, v = args[:3]
        heads = args[3] if len(args) > 3 else 1
        g, s, _ = q.shape
        q, k, v = (t.view(g, s, heads, -1).transpose(1, 2) for t in (q, k, v))
        return lambda: F.scaled_dot_product_attention(q, k, v)
    if name == "fused_frame_attention_bwd":
        # the backward of one SDPA call without a mask
        q, k, v, go, heads = args
        g, s, _ = q.shape
        q, k, v = (t.reshape(g, s, heads, -1).transpose(1, 2).detach()
                   .requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v)
        gout = go.reshape(g, s, heads, -1).transpose(1, 2)
        return lambda: torch.autograd.grad(out, (q, k, v), gout,
                                           retain_graph=True)
    if name == "spatial_attention_packed/bwd":
        # the backward of one SDPA call with the same additive mask
        qkv, go, heads, n_valid = args
        g, s, i3 = qkv.shape
        q, k, v = (t.reshape(g, s, heads, -1).transpose(1, 2).detach()
                   .requires_grad_() for t in qkv.split(i3 // 3, dim=-1))
        mask = torch.zeros(1, 1, 1, s, dtype=qkv.dtype, device=qkv.device)
        mask[..., n_valid:] = -1e30
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        gout = go.reshape(g, s, heads, -1).transpose(1, 2)
        return lambda: torch.autograd.grad(out, (q, k, v), gout,
                                           retain_graph=True)
    return None


def sepconv_cudnn(args):
    """#24's composition yardstick: the stem's own route for a sepconv_bn
    case (models/xception.py), cuDNN's grouped 3x3 conv and 1x1 conv on
    channels_last tensors in the case's dtype, then the affine. Several
    PyTorch calls, so not a library_call; timed beside the kernel only
    (the port never calls it), in f32 under highest() (TF32 off)."""
    x, dw, pw, a, b, relu_in = args
    cin, cout = pw.shape
    xc = x.permute(0, 3, 1, 2)                   # NHWC memory: channels_last
    w_dw = dw.t().reshape(cin, 1, 3, 3).to(x.dtype)
    w_pw = pw.t().reshape(cout, cin, 1, 1).to(x.dtype).contiguous(
        memory_format=torch.channels_last)
    a4, b4 = (t.to(x.dtype).reshape(1, cout, 1, 1) for t in (a, b))

    def run():
        y = F.conv2d(xc.clamp_min(0) if relu_in else xc, w_dw, padding=1,
                     groups=cin)
        return F.conv2d(y, w_pw) * a4 + b4

    return run


def gemm_bound_ms(ops) -> tuple:
    """(bound ms, what sets it, FMA ms or None) of a GEMM case: bound_ms of
    its operations (float_gemm_ops) and bytes (gemm_flops_bytes); f32 inputs
    also get 2 M N K on the FMA pipes beside it."""
    flops, nbytes = gemm_flops_bytes(ops)
    f32 = ops["a"].dtype == torch.float32
    return (*bound_ms(float_gemm_ops(flops, ops["a"].dtype), nbytes),
            1e3 * flops / PEAK_OPS["f32"] if f32 else None)


def gemm_f32_close(ops, got, want) -> tuple:
    """(ok, err) of an f32 GEMM case against its plain version: nn and nt at
    atol = rtol = F32_TOL_FLOAT (err max|diff|); tn, a weight gradient
    summed over the rows, at max|diff| <= F32_TOL_FLOAT * max|plain| per
    output (err the worst ratio): there f32 in another summation order
    already misses the allclose criterion by 4-6x
    (tests/test_torch_gemm_f32.py)."""
    ok, err = True, 0.0
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs().max().item()
        if ops["layout"] == "tn":
            e = diff / max(w.float().abs().max().item(), 1e-30)
            ok = ok and e <= F32_TOL_FLOAT
        else:
            e = diff
            ok = ok and torch.allclose(g, w, atol=F32_TOL_FLOAT,
                                       rtol=F32_TOL_FLOAT)
        err = max(err, e)
    return ok, err


# ---------------------------------------------------------------------------
# The int8 GEMM (quant.gemm_q8) alone, at the shapes of its callers: the
# activation codes with rows padded_k(K) apart, the weight as its K-major
# copy, one epilogue of acc * rs * ws (+ bias) (+ res) (-> GELU).


def gemm_q8_shapes(geometry=SLICE, dtype=torch.bfloat16) -> dict:
    """{name: (M, N, K, out dtype, residual dtype or None, bias, gelu)}:
    every int8 GEMM launch of the int8 wrappers at `geometry`'s rows R =
    b * t1 * s, for activations in `dtype`, with the epilogue its caller
    gives it (kernels/quant.py): the QKV of #1 / #4 and the spatial QKV of
    #2 / #8 in the activation dtype; their t-out-projection + b into an
    f32 intermediate; #3's s-out-projection + b + r (r in the activation
    dtype) into an f32 y; the fc1 + b1 + GELU of #3 / #7 (f32 hidden) and
    of #6 (hidden in the activation dtype); the fc2 + b2 + residual of #3
    (over its f32 y) and of #7 (over x); #5's out-projection + b with and
    without r."""
    b, t1, s = (geometry[k] for k in ("b", "t1", "s"))
    d, inner, hid = geometry["d"], geometry["inner"], geometry["hid"]
    r, f32, t = b * t1 * s, torch.float32, dtype
    return {
        "#1 / #4 QKV": (r, 3 * inner, d, t, None, False, False),
        "#2 / #8 t-out-projection": (r, d, inner, f32, None, True, False),
        "#2 / #8 spatial QKV": (r, 3 * inner, d, t, None, False, False),
        "#3 s-out-projection + r": (r, d, inner, f32, t, True, False),
        "#3 / #7 fc1 (GELU)": (r, hid, d, f32, None, True, True),
        "#3 fc2 + y": (r, d, hid, t, f32, True, False),
        "#7 fc2 + x": (r, d, hid, t, t, True, False),
        "#5 out-projection + r": (r, d, inner, t, t, True, False),
        "#5 out-projection": (r, d, inner, t, None, True, False),
        "#6 fc1 (GELU)": (r, hid, d, t, None, True, True),
    }


def gemm_q8_operands(m, n, k, out_dtype, res_dtype, bias, gelu, device,
                     seed=0, pad=0):
    """The arguments of one quant.gemm_q8 call, with the (K, N) weight
    beside its copy: {"q", "wq", "wk", "rs", "ws", "out", and "bias",
    "res", "gelu" where the epilogue has them}. Activations N(0, 1)
    quantized per row, the weight like a layer's init U(+-1/sqrt(k))
    quantized per column, bias N(0, 0.02), res N(0, 1). The codes' and the
    copy's pad bytes (past K in each row) are set to `pad`; the GEMM must
    not read them."""
    g = torch.Generator().manual_seed(seed)
    q, rs = quant._quant_rows(torch.randn(m, k, generator=g))
    wq, ws = quant.quantize_weight((torch.rand(k, n, generator=g) * 2 - 1)
                                   * k ** -0.5)
    kp = quant.padded_k(k)
    buf = torch.full((m, kp), pad, dtype=torch.int8)
    buf[:, :k] = q
    wk = quant.kmajor(wq)
    wk[:, k:] = pad
    ops = {"q": buf.to(device)[:, :k], "wq": wq.to(device),
           "wk": wk.to(device), "rs": rs.reshape(m).to(device),
           "ws": ws.to(device),
           "out": torch.empty(m, n, dtype=out_dtype, device=device)}
    if bias:
        ops["bias"] = (torch.randn(n, generator=g) * 0.02).to(device)
    if res_dtype is not None:
        ops["res"] = torch.randn(m, n, generator=g).to(device, res_dtype)
    if gelu:
        ops["gelu"] = True
    return ops


def run_gemm_q8(ops):
    """quant.gemm_q8 on the operands of gemm_q8_operands."""
    quant.gemm_q8(ops["q"], ops["wk"], ops["rs"], ops["ws"], ops["out"],
                  bias=ops.get("bias"), res=ops.get("res"),
                  gelu=ops.get("gelu", False))


def gemm_q8_plain(ops):
    """The plain version of run_gemm_q8 from the (K, N) weight: the exact
    int8 dot (quant._q8_dot), then the kernels' f32 epilogue in their
    order, * rs * ws (+ bias) (+ res) (-> tanh-GELU), one rounding to the
    output's dtype."""
    v = quant._q8_dot(ops["q"], ops["wq"]) * ops["rs"][:, None] * ops["ws"]
    if "bias" in ops:
        v = v + ops["bias"]
    if "res" in ops:
        v = v + ops["res"].float()
    if ops.get("gelu"):
        v = mlp._gelu_tanh(v)
    return v.to(ops["out"].dtype)


def gemm_q8_ops_bytes(ops) -> tuple:
    """(operations, bytes) of an int8 GEMM case: 2 M N K int8 operations;
    the codes (M K), the weight (K N), the scales, bias and residual read
    and the output written once each."""
    (m, k), n = ops["q"].shape, ops["wq"].shape[1]
    tensors = [ops[key] for key in ("rs", "ws", "bias", "res", "out")
               if key in ops]
    return 2 * m * n * k, m * k + k * n + sum(
        t.numel() * t.element_size() for t in tensors)


# The kernels that run the spatial attention core or its backward, and the
# float GEMMs: every bf16 instantiation of the attention kernels must use the
# tensor cores, and every f32 one TF32 mma.sync (HMMA.1688.F32.TF32: the f32
# tile's three TF32 products a product, which meet the 1e-5 check where one TF32
# product would miss it by ~1e-3; #9's f32 spatial phase runs that tile too);
# every instantiation of the bf16 GEMM must run wgmma (HGMMA), not mma.sync
# alone, and every instantiation of the f32 GEMM TF32 wgmma
# (HGMMA.64x128x8.F32.TF32, the same three products). Patterns are the
# Itanium-mangled template heads of csrc's kernels: the attention kernels'
# first template parameter is the activation type; the GEMMs' names say it
# (their parameters start with the layout), so every instantiation of the
# name counts.
TENSOR_CORE_KERNELS = ("spatial_attn_kernel", "frame_attn_kernel",
                       "st_layer_q8_kernel", "spatial_attn_bwd_dq_kernel",
                       "spatial_attn_bwd_dkv_kernel", "gemm_bf16_wgmma_kernel")
TF32_MMA_KERNELS = ("spatial_attn_kernel", "frame_attn_kernel",
                    "spatial_attn_bwd_dq_kernel",
                    "spatial_attn_bwd_dkv_kernel", "st_layer_q8_kernel")
TF32_MMA_OP = re.compile(r"HMMA\.\S*\.TF32")
# the spatial attention kernels (forward and #13's two passes): no
# instantiation may spill (#9's budget is held with the wgmma kernels')
SPATIAL_KERNELS = TF32_MMA_KERNELS[:4]
WGMMA_KERNELS = ("gemm_bf16_wgmma_kernel",)
TF32_WGMMA_KERNELS = ("gemm_f32_wgmma_kernel",)
TF32_WGMMA_OP = re.compile(r"HGMMA\.\S*\.TF32")
# the int8 GEMM and the one-launch layer #9, whose GEMM phases run its body:
# every instantiation (whatever its output and residual types, dtype or
# dim_head) must run int8 wgmma, IGMMA in the SASS, and, where the int8
# mma.sync counts (IMMA) are given, none of those
INT8_WGMMA_KERNELS = ("gemm_q8_wgmma_kernel", "st_layer_q8_kernel")
INT8_WGMMA_OP = "IGMMA."
INT8_MMA_SYNC_OP = "IMMA."
_NAMED_DTYPE = ("gemm_bf16_wgmma_kernel", "gemm_f32_wgmma_kernel")
# the warp-specialised wgmma kernels: launched with 168 registers a thread
# (setmaxnreg's budget; fewer would stall the consumers' setmaxnreg.inc)
# and none spilled
WGMMA_REGISTERS = 168


def tensor_core_check(counts, wgmma=None, igmma=None, imma=None,
                      tf32=None, tf32_mma=None) -> list:
    """Rows (kernel, dtype, {mangled name: tensor-core instructions}, ok)
    for each entry of TENSOR_CORE_KERNELS in bf16 (ok: every instantiation
    has some; for WGMMA_KERNELS, every instantiation has HGMMA, counted in
    `wgmma`), TF32_MMA_KERNELS in f32 (ok: every instantiation has TF32
    HMMA, counted in `tf32_mma`), TF32_WGMMA_KERNELS in f32 (ok: every
    instantiation has TF32 HGMMA, counted in `tf32`) and INT8_WGMMA_KERNELS
    in int8 (ok: every instantiation has IGMMA, counted in `igmma`, and,
    with `imma`, none has IMMA); `counts` is _lib.tensor_ops_of_sass(sass),
    `wgmma` tensor_ops_of_sass(sass, ("HGMMA.",)), `tf32_mma`
    tensor_ops_of_sass(sass, (TF32_MMA_OP,)), `tf32` tensor_ops_of_sass(sass,
    (TF32_WGMMA_OP,)), `igmma` tensor_ops_of_sass(sass, (INT8_WGMMA_OP,))
    and `imma` tensor_ops_of_sass(sass, (INT8_MMA_SYNC_OP,)) of the built
    library's sass (_lib.sass_text; without `wgmma`, `tf32_mma`, `tf32` or
    `igmma` their rows fail)."""
    rows = []
    for kernels, dtype, tag, source in (
            (TENSOR_CORE_KERNELS, "bf16", "I13__nv_bfloat16", counts),
            (TF32_MMA_KERNELS, "f32", "If", tf32_mma or {}),
            (TF32_WGMMA_KERNELS, "f32", "I", tf32 or {}),
            (INT8_WGMMA_KERNELS, "int8", "I", igmma or {})):
        for k in kernels:
            head = f"{len(k)}{k}" + ("I" if k in _NAMED_DTYPE else tag)
            src = (wgmma or {}) if k in WGMMA_KERNELS else source
            found = {n: c for n, c in src.items() if head in n}
            ok = bool(found) and all(found.values())
            if dtype == "int8" and imma is not None:
                ok = ok and not any(imma.get(n, 0) for n in found)
            rows.append((k, dtype, found, ok))
    return rows


def wgmma_register_rows(report) -> list:
    """Rows (kernel, {mangled name: registers}, [names off budget]) of every
    instantiation of the wgmma kernels (TF32_WGMMA_KERNELS,
    INT8_WGMMA_KERNELS) in `report` (_lib.ptxas_report of build/build.log):
    off budget if it spilled or holds more than WGMMA_REGISTERS, or, for
    the f32 GEMM (warp-specialised by setmaxnreg), fewer."""
    rows = []
    for k, regs, spilled in spill_rows(report, TF32_WGMMA_KERNELS
                                       + INT8_WGMMA_KERNELS):
        off = set(spilled) | {n for n, r in regs.items()
                              if r is None or r > WGMMA_REGISTERS
                              or (k in TF32_WGMMA_KERNELS
                                  and r != WGMMA_REGISTERS)}
        rows.append((k, regs, sorted(off)))
    return rows


# the temporal core #11 and its backward #12: every head layout that
# attention.temporal_plan can pick is an instantiation (csrc/temporal.cuh
# with_temporal_plan: the forward's 16-byte wide form on 1-16 lanes in bf16
# and 1-32 in f32, the backward's 4-element one on 1-32 lanes in both, and
# the narrow form at 1, 2 and 4 elements a lane), each built with no spill;
# their general lanes' kernels (T1 > 8) at the same plans
TEMPORAL_KERNELS = {"temporal_attn_kernel": 17,
                    "temporal_attn_bwd_kernel": 18,
                    "temporal_attn_any_kernel": 17,
                    "temporal_attn_bwd_any_kernel": 18}


def spill_rows(report, kernels) -> list:
    """Rows (kernel, {mangled name: registers}, [spilled names]) of every
    instantiation of each kernel in `kernels` in `report`
    (_lib.ptxas_report of build/build.log)."""
    rows = []
    for k in kernels:
        got = {n: r for n, r in report.items() if f"{len(k)}{k}I" in n}
        rows.append((k, {n: r.get("registers") for n, r in got.items()},
                     [n for n, r in got.items()
                      if r.get("spill_stores") or r.get("spill_loads")]))
    return rows
