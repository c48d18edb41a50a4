"""Port int8 kernels (istvt_tpu_torch/kernels/quant.py, plain versions on
the CPU) held against the JAX package's kernels (interpret mode on the CPU,
through their public wrappers) on the same numpy inputs.

Tolerance for kernels A/B/C and for the A/B modes' #4, #5 (with and
without the residual), #6 and #8, atol = rtol = 2e-3: the two sides compute
the LayerNorm statistics in different summation orders, so a last-ulp LN
difference can flip one int8 activation code, which moves one output by at
most about amax * max|w| / 127 (a few 1e-4 at these scales).

#4, #5, #6 and #8 return a GEMM's output without an attention after it,
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
KERNELS = ["temporal", "spatial", "ff", *AB_KERNELS]


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
    if kernel in AB_KERNELS:
        _assert_close_but_near_ties(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    assert all(v == 0 for v in _lib.LAUNCHES.values())


def _assert_close_but_near_ties(got, want):
    """atol = rtol = 2e-3 on every row but at most one in 64 (a near-tie
    that flips an int8 code), rel-L2 <= 1e-3 over the whole output."""
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    bad = ~np.isclose(g, w, atol=2e-3, rtol=2e-3).all(axis=1)
    assert bad.sum() <= max(1, len(bad) // 64), np.flatnonzero(bad)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-3, rel
