"""Port int8 kernels (istvt_tpu_torch/kernels/quant.py, plain versions on
the CPU) held against the JAX package's kernels (interpret mode on the CPU,
through their public wrappers) on the same numpy inputs. The whole-layer
kernel #9 (st_layer_q8) is held stage by stage (its test's docstring says
why).

Tolerance for kernels A/B/C and for the A/B modes' #4, #5 (with and
without the residual), #6 and #8, atol = rtol = 2e-3: the two sides compute
the LayerNorm statistics in different summation orders, so a last-ulp LN
difference can flip one int8 activation code, which moves one output by at
most about amax * max|w| / 127 (a few 1e-4 at these scales).

#4, #5, #6, #7 and #8 return a GEMM's output without an attention after it,
where one flipped code moves its row by up to about 1e-2 at these scales.
JAX's own Pallas kernel and JAX's own unfused math
(_quant_rows(_ln(...)) outside the kernel) already disagree on such a
near-tie: in matmul_q8_ln_matmul_q8 at the small size, row 190's LN output
sits 7.6e-6 of a code from a tie, and the kernel moves that row by 7.6e-3
against JAX's own composition, which the port's plain version matches to
2.4e-7. So these cases hold every row at atol = rtol = 2e-3 except at most
one row in 64, and the whole output at rel-L2 <= 1e-3."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from istvt_tpu.core import precision as jprecision
from istvt_tpu.kernels import quant as jq
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.kernels import quant as tq

# (rows of the stream, widths) at the JAX test sizes: the small size of
# tests/test_quant.py:207 and the paper widths with few rows (:159)
SIZES = {
    "small": dict(b=2, t1=4, s=32, d=128, heads=4, inner=64, hid=256,
                  n_valid=26),
    "full_width": dict(b=1, t1=3, s=16, d=728, heads=8, inner=512,
                       hid=2912, n_valid=13),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _q8(rng, d_in, d_out):
    wq, ws = jq.quantize_weight(
        jnp.asarray(rng.randn(d_in, d_out) * 0.05, jnp.float32))
    return np.asarray(wq), np.asarray(ws)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_quantize_weight_bitwise():
    rng = np.random.RandomState(0)
    w = (rng.randn(96, 40) * 0.3).astype(np.float32)
    w[:, 3] = 0.0                                   # scale floor 1e-12
    w[5, 7] = 2.5 * np.abs(w[:, 7]).max()           # dominant column entry
    jw, js = jq.quantize_weight(jnp.asarray(w))
    tw, ts = tq.quantize_weight(torch.from_numpy(w))
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quant_rows_bitwise_with_ties():
    rng = np.random.RandomState(1)
    y = (rng.randn(6, 64) * 2.0).astype(np.float32)
    # rows whose amax is 127 quantize with rs == 1.0 exactly, so x.5
    # values are exact ties: round half to even on both sides
    y[0] = np.linspace(-127, 127, 64).astype(np.float32)
    y[0, :8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    y[1] = 0.0                                      # row-scale floor 1e-6
    y[2, :4] = [1e-8, -3e-8, 0.0, 2e-7]
    jqv, jrs = jq._quant_rows(jnp.asarray(y))
    tqv, trs = tq._quant_rows(torch.from_numpy(y))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(trs.numpy(), np.asarray(jrs))
    assert list(tqv[0, :6]) == [0, 2, 2, 0, -2, -2]


def _temporal_inputs(rng, c):
    x = (rng.randn(c["b"], c["t1"], c["s"], c["d"]) * 0.8).astype(np.float32)
    x[:, :, c["n_valid"]:] = 0.0                     # all-zero pad tokens
    s = (rng.rand(c["d"]) + 0.5).astype(np.float32)
    b = (rng.randn(c["d"]) * 0.01).astype(np.float32)
    wq, ws = _q8(rng, c["d"], 3 * c["inner"])
    return x, s, b, wq, ws


def _spatial_inputs(rng, c):
    a = (rng.randn(c["b"] * c["t1"], c["s"], c["inner"]) * 0.3
         ).astype(np.float32)
    woq, wos = _q8(rng, c["inner"], c["d"])
    bo = (rng.randn(c["d"]) * 0.01).astype(np.float32)
    s = (rng.rand(c["d"]) + 0.5).astype(np.float32)
    b = (rng.randn(c["d"]) * 0.01).astype(np.float32)
    wq, ws = _q8(rng, c["d"], 3 * c["inner"])
    return a, woq, wos, bo, s, b, wq, ws


def _ff_inputs(rng, c):
    n = c["b"] * c["t1"] * c["s"]
    a = (rng.randn(c["b"], n // c["b"], c["inner"]) * 0.3).astype(np.float32)
    r = (rng.randn(c["b"], n // c["b"], c["d"]) * 0.3).astype(np.float32)
    woq, wos = _q8(rng, c["inner"], c["d"])
    bo = (rng.randn(c["d"]) * 0.01).astype(np.float32)
    s = (rng.rand(c["d"]) + 0.5).astype(np.float32)
    b = (rng.randn(c["d"]) * 0.01).astype(np.float32)
    w1q, w1s = _q8(rng, c["d"], c["hid"])
    b1 = (rng.randn(c["hid"]) * 0.01).astype(np.float32)
    w2q, w2s = _q8(rng, c["hid"], c["d"])
    b2 = (rng.randn(c["d"]) * 0.01).astype(np.float32)
    return a, r, woq, wos, bo, s, b, w1q, w1s, b1, w2q, w2s, b2


def _ln_matmul_q8_inputs(rng, c):
    x, s, b, wq, ws = _temporal_inputs(rng, c)
    return x.reshape(c["b"], -1, c["d"]), s, b, wq, ws


def _mm_q8_inputs(rng, c, res: bool):
    a = (rng.randn(c["b"], c["t1"] * c["s"], c["inner"]) * 0.3
         ).astype(np.float32)
    wq, ws = _q8(rng, c["inner"], c["d"])
    bo = (rng.randn(c["d"]) * 0.01).astype(np.float32)
    if not res:
        return a, wq, ws, bo
    r = (rng.randn(c["b"], c["t1"] * c["s"], c["d"]) * 0.3
         ).astype(np.float32)
    return a, wq, ws, bo, r


def _mm_ln_mm_inputs(rng, c):
    a, woq, wos, bo, s, b, wq, ws = _spatial_inputs(rng, c)
    return a.reshape(c["b"], -1, c["inner"]), woq, wos, bo, s, b, wq, ws


def _ff_q8_inputs(rng, c):
    x = (rng.randn(c["b"], c["t1"] * c["s"], c["d"]) * 0.8
         ).astype(np.float32)
    s = (rng.rand(c["d"]) + 0.5).astype(np.float32)
    b = (rng.randn(c["d"]) * 0.01).astype(np.float32)
    w1q, w1s = _q8(rng, c["d"], c["hid"])
    b1 = (rng.randn(c["hid"]) * 0.01).astype(np.float32)
    w2 = (rng.randn(c["hid"], c["d"]) * 0.02).astype(np.float32)
    b2 = (rng.randn(c["d"]) * 0.01).astype(np.float32)
    return x, s, b, w1q, w1s, b1, w2, b2


# the kernels of the A/B modes: (inputs, JAX wrapper, port wrapper)
AB_KERNELS = {
    "ln_matmul_q8": (_ln_matmul_q8_inputs, jq.ln_matmul_q8,
                     tq.ln_matmul_q8),
    "matmul_q8_bias_residual": (
        lambda rng, c: _mm_q8_inputs(rng, c, True),
        jq.matmul_q8_bias_residual, tq.matmul_q8_bias_residual),
    "matmul_q8_bias_residual/no_r": (
        lambda rng, c: _mm_q8_inputs(rng, c, False),
        jq.matmul_q8_bias_residual, tq.matmul_q8_bias_residual),
    "matmul_q8_ln_matmul_q8": (_mm_ln_mm_inputs, jq.matmul_q8_ln_matmul_q8,
                               tq.matmul_q8_ln_matmul_q8),
    "ln_ff_residual_q8": (_ff_q8_inputs, jq.ln_ff_residual_q8,
                          tq.ln_ff_residual_q8),
}


def _ff_q8_full_inputs(rng, c):
    x, s, b, w1q, w1s, b1, _, b2 = _ff_q8_inputs(rng, c)
    w2q, w2s = _q8(rng, c["hid"], c["d"])
    return x, s, b, w1q, w1s, b1, w2q, w2s, b2


def _layer_inputs(rng, c):
    """x and the 22 arguments of one int8 ST layer in _st_layer_q8_impl's
    order: per branch LN scale and bias, int8 weights and column scales,
    the out-projection's (fc1's, fc2's) bias."""
    d, inner, hid = c["d"], c["inner"], c["hid"]

    def ln():
        return ((rng.rand(d) + 0.5).astype(np.float32),
                (rng.randn(d) * 0.01).astype(np.float32))

    def bias(n):
        return (rng.randn(n) * 0.01).astype(np.float32)

    x = (rng.randn(c["b"], c["t1"], c["s"], d) * 0.8).astype(np.float32)
    x[:, :, c["n_valid"]:] = 0.0                     # all-zero pad tokens
    return (x, *ln(), *_q8(rng, d, 3 * inner), *_q8(rng, inner, d), bias(d),
            *ln(), *_q8(rng, d, 3 * inner), *_q8(rng, inner, d), bias(d),
            *ln(), *_q8(rng, d, hid), bias(hid), *_q8(rng, hid, d), bias(d))


def _jax_layer(st, bt, wqt, wst, wot, sot, bot, ss, bs, wqs, wss, wos, sos,
               bos, sf, bf, w1q, w1s, b1, w2q, w2s, b2):
    """The quantized layer subtree jq.st_layer_q8 reads."""
    def attn(s_, b_, wq, ws, woq, wos_, bo):
        return {"norm": {"scale": s_, "bias": b_}, "to_out": {"b": bo},
                "q8": {"qkv_wq": wq, "qkv_ws": ws, "out_wq": woq,
                       "out_ws": wos_}}

    return {"attn_t": attn(st, bt, wqt, wst, wot, sot, bot),
            "attn_s": attn(ss, bs, wqs, wss, wos, sos, bos),
            "ff": {"norm": {"scale": sf, "bias": bf}, "fc1": {"b": b1},
                   "fc2": {"b": b2},
                   "q8": {"w1q": w1q, "w1s": w1s, "w2q": w2q, "w2s": w2s}}}


# #7, the FF of any q8_ff but 'full' / 'mixed' / 'bf16' (q8_ff='int8' in
# these tests): (inputs, JAX wrapper, port wrapper)
FULL_INT8_KERNELS = {
    "ln_ff_residual_q8_full": (_ff_q8_full_inputs, jq.ln_ff_residual_q8_full,
                               tq.ln_ff_residual_q8_full),
}
KERNELS = ["temporal", "spatial", "ff", *AB_KERNELS, *FULL_INT8_KERNELS]


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_plain_matches_jax(kernel, size):
    c = SIZES[size]
    i = list(SIZES).index(size)
    if kernel in AB_KERNELS:
        rng = np.random.RandomState(10 + len(AB_KERNELS) * i
                                    + list(AB_KERNELS).index(kernel))
        make, jfn, tfn = AB_KERNELS[kernel]
        arrs = make(rng, c)
    elif kernel in FULL_INT8_KERNELS:
        rng = np.random.RandomState(30 + 2 * i
                                    + list(FULL_INT8_KERNELS).index(kernel))
        make, jfn, tfn = FULL_INT8_KERNELS[kernel]
        arrs = make(rng, c)
    else:
        rng = np.random.RandomState(3 * i + KERNELS.index(kernel))
    if kernel == "temporal":
        arrs = _temporal_inputs(rng, c)
        jfn = lambda *a: jq.ln_qkv_q8_temporal_attention(*a, c["heads"])
        tfn = lambda *a: tq.ln_qkv_q8_temporal_attention(*a, c["heads"])
    elif kernel == "spatial":
        arrs = _spatial_inputs(rng, c)
        jfn = lambda *a: jq.mm_q8_ln_qkv_q8_spatial_attention(
            *a, c["heads"], c["n_valid"])
        tfn = lambda *a: tq.mm_q8_ln_qkv_q8_spatial_attention(
            *a, c["heads"], c["n_valid"])
    elif kernel == "ff":
        arrs = _ff_inputs(rng, c)
        jfn = jq.matmul_q8_res_ln_ff_q8_full
        tfn = tq.matmul_q8_res_ln_ff_q8_full
    with jprecision.highest():
        want = np.asarray(jfn(*_j(*arrs)))
    _lib.reset_launches()
    with tprecision.highest():
        got = tfn(*_t(*arrs))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.isfinite(got.numpy()).all()
    if kernel in AB_KERNELS or kernel in FULL_INT8_KERNELS:
        _assert_close_but_near_ties(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    assert all(v == 0 for v in _lib.LAUNCHES.values())


def _layer_stages(q, a, heads, n_valid):
    """One int8 ST layer as #1 -> #2 -> #3 of the quant module q on the
    layer's arguments a (_layer_inputs): three functions, each of the
    previous stage's output."""
    x = a[0]
    b, t1, s, d = x.shape
    return [
        lambda _: q.ln_qkv_q8_temporal_attention(x, *a[1:5], heads),
        lambda a_t: q.mm_q8_ln_qkv_q8_spatial_attention(
            a_t.reshape(b * t1, s, -1), *a[5:12], heads, n_valid),
        lambda a_s: q.matmul_q8_res_ln_ff_q8_full(
            a_s.reshape(b, t1 * s, -1), x.reshape(b, t1 * s, d),
            *a[12:]).reshape(x.shape)]


@pytest.mark.parametrize("size", list(SIZES))
def test_st_layer_q8_matches_jax_stage_by_stage(size):
    """#9 (st_layer_q8) against JAX's (_st_layer_q8_impl, interpret mode).
    Both round where #1 -> #2 -> #3 do: JAX's layer equals JAX's chain bit
    for bit, the port's plain version equals the port's chain bit for bit,
    and each stage of the port's chain, fed the port's previous stage,
    agrees with JAX's stage fed the same tensor within rel-L2 1e-3
    (measured <= 3.5e-7). The two layers are not held to 1e-3 as wholes:
    summation order (the LN statistics, the temporal softmax) moves a_t by
    1e-7 to 1e-6, which flips one or a few of its int8 codes, and the
    spatial attention spreads a flip over its frame (rel-L2 2.2e-3 at the
    small size, 9.4e-3 at full width; each stage of JAX fed the port's
    a_t or a_s agrees with the port's to <= 3.5e-7)."""
    c = SIZES[size]
    heads, n_valid = c["heads"], c["n_valid"]
    arrs = _layer_inputs(np.random.RandomState(40 + list(SIZES).index(size)),
                         c)
    ja, ta = _j(*arrs), _t(*arrs)
    with jprecision.highest():
        want = np.asarray(jq.st_layer_q8(ja[0], _jax_layer(*ja[1:]), heads,
                                         n_valid))
        v = None
        for stage in _layer_stages(jq, ja, heads, n_valid):
            v = stage(v)
        np.testing.assert_array_equal(np.asarray(v), want)
    _lib.reset_launches()
    v = None
    with tprecision.highest():
        got = tq.st_layer_q8(*ta, heads, n_valid)
        for i, (tstage, jstage) in enumerate(zip(
                _layer_stages(tq, ta, heads, n_valid),
                _layer_stages(jq, ja, heads, n_valid))):
            with jprecision.highest():
                ref = np.asarray(jstage(None if v is None
                                        else jnp.asarray(v.numpy())))
            v = tstage(v)
            rel = np.linalg.norm(v.numpy() - ref) / np.linalg.norm(ref)
            assert rel <= 1e-3, (i, rel)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    torch.testing.assert_close(got, v, atol=0, rtol=0)
    assert all(n == 0 for n in _lib.LAUNCHES.values())


def test_fused_boundaries_equal_the_kernels_they_fuse():
    """The port's form of tests/test_quant.py:144-190: #8 equals #5
    without r then #4, and #3 equals #5 with r then #7; in f32 on the CPU
    bit for bit (the same quantization points, and #5's f32 output is the
    fused kernels' f32 intermediate)."""
    c = SIZES["full_width"]
    rng = np.random.RandomState(0)
    a, woq, wos, bo, s, b, wq, ws = _t(*_mm_ln_mm_inputs(rng, c))
    r = torch.from_numpy((rng.randn(*a.shape[:-1], c["d"]) * 0.3
                          ).astype(np.float32))
    w1q, w1s = _t(*_q8(rng, c["d"], c["hid"]))
    w2q, w2s = _t(*_q8(rng, c["hid"], c["d"]))
    b1, b2 = (torch.from_numpy((rng.randn(n) * 0.01).astype(np.float32))
              for n in (c["hid"], c["d"]))
    with tprecision.highest():
        y = tq.matmul_q8_bias_residual(a, woq, wos, bo)
        torch.testing.assert_close(
            tq.matmul_q8_ln_matmul_q8(a, woq, wos, bo, s, b, wq, ws),
            tq.ln_matmul_q8(y, s, b, wq, ws), atol=0, rtol=0)
        y = tq.matmul_q8_bias_residual(a, woq, wos, bo, r)
        torch.testing.assert_close(
            tq.matmul_q8_res_ln_ff_q8_full(a, r, woq, wos, bo, s, b, w1q,
                                           w1s, b1, w2q, w2s, b2),
            tq.ln_ff_residual_q8_full(y, s, b, w1q, w1s, b1, w2q, w2s, b2),
            atol=0, rtol=0)


def _assert_close_but_near_ties(got, want):
    """atol = rtol = 2e-3 on every row but at most one in 64 (a near-tie
    that flips an int8 code), rel-L2 <= 1e-3 over the whole output."""
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    bad = ~np.isclose(g, w, atol=2e-3, rtol=2e-3).all(axis=1)
    assert bad.sum() <= max(1, len(bad) // 64), np.flatnonzero(bad)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-3, rel
