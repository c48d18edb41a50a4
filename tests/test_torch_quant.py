"""Port int8 kernels (istvt_tpu_torch/kernels/quant.py, plain versions on
the CPU) held against the JAX package's kernels (interpret mode on the CPU,
through their public wrappers) on the same numpy inputs.

Tolerance for kernels A/B/C, atol = rtol = 2e-3: the two sides compute the
LayerNorm statistics in different summation orders, so a last-ulp LN
difference can flip one int8 activation code, which moves one output by at
most about amax * max|w| / 127 (a few 1e-4 at these scales)."""
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


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("kernel", ["temporal", "spatial", "ff"])
def test_kernel_plain_matches_jax(kernel, size):
    c = SIZES[size]
    rng = np.random.RandomState(
        3 * list(SIZES).index(size) + ["temporal", "spatial", "ff"].index(kernel))
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
    else:
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
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    assert all(v == 0 for v in _lib.LAUNCHES.values())
