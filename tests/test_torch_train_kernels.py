"""The training slice's kernels: the port's plain versions of the backward
kernels #12, #13, #19, #23 and of the h1-stash forward of #21
(istvt_tpu_torch/kernels/{attention,linear,mlp}.py) against the JAX
package's Pallas kernels run in interpret mode on the CPU, on the same
numpy inputs; then each wrapper's torch.autograd.Function against jax.grad
of the JAX wrapper (which on the CPU differentiates its XLA reference).

f32: max|diff| <= 1e-5 * max|ref| (no rounding to a narrower type on
either side; the two differ by summation order only). bf16: rel-L2 < 1e-2
(both sides round at the same places; a value next to a bf16 rounding
boundary can round the other way after a different summation order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from istvt_tpu.core import precision as jprecision
from istvt_tpu.kernels import attention as ja
from istvt_tpu.kernels import linear as jl
from istvt_tpu.kernels import mlp as jm
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.kernels import attention as ta
from istvt_tpu_torch.kernels import linear as tl
from istvt_tpu_torch.kernels import mlp as tm

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# rows x widths: the paper's D = 728 / FF = 2912 (neither a tile multiple)
# with few rows, and a small width with a row count off every tile
GEOM = dict(rows=40, d=728, k=1536, ff=2912)
SMALL = dict(rows=52, d=64, k=96, ff=256)


def _close(got, want, dtype_name, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype_name == "f32":
        err = np.abs(got - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (what, err,
                                                  np.abs(want).max())
    else:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel < 1e-2, (what, rel)


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _pair(a, dts):
    """numpy f32 -> (torch, jax) in the case's dtype (bf16 rounded once,
    identically on both sides)."""
    tdt, jdt = dts
    t = torch.from_numpy(a).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _init(rng, fan_in, *shape):
    return rng.uniform(-1, 1, shape).astype(np.float32) * fan_in ** -0.5


@pytest.mark.parametrize("dt", DTYPES)
def test_temporal_packed_bwd_matches_pallas(dt):
    """#12 at T+1 = 7 frames, 8 heads x 64 (dk, dv accumulate in the
    activation dtype on both sides)."""
    rng = np.random.RandomState(0)
    b, t1, s, heads, dh = 2, 7, 8, 8, 64
    inner = heads * dh
    qkv, jqkv = _pair(rng.randn(b, t1, s, 3 * inner).astype(np.float32),
                      DTYPES[dt])
    g, jg = _pair(rng.randn(b, t1, s, inner).astype(np.float32), DTYPES[dt])
    with jprecision.highest():
        want = ja.fused_temporal_attention_packed_bwd(jqkv, jg, heads=heads,
                                                      interpret=True)
    got = ta.temporal_attention_packed_bwd(qkv, g, heads)
    assert got.dtype == qkv.dtype
    _close(_np(got), _np(want), dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_spatial_packed_bwd_matches_pallas(dt):
    """#13 with pad keys masked (n_valid < S), head pairs of 64 lanes."""
    rng = np.random.RandomState(1)
    g_, s, n_valid, heads, dh = 3, 40, 34, 4, 64
    inner = heads * dh
    qkv, jqkv = _pair(rng.randn(g_, s, 3 * inner).astype(np.float32),
                      DTYPES[dt])
    g, jg = _pair(rng.randn(g_, s, inner).astype(np.float32), DTYPES[dt])
    q, k, v = (jqkv[..., i * inner:(i + 1) * inner] for i in range(3))
    with jprecision.highest():
        want = ja.fused_frame_attention_bwd(q, k, v, jg, heads=heads,
                                            n_valid=n_valid, interpret=True)
    got = ta.spatial_attention_packed_bwd(qkv, g, heads, n_valid)
    for i, name in enumerate(("dq", "dk", "dv")):
        _close(_np(got[..., i * inner:(i + 1) * inner]), _np(want[i]), dt,
               name)


def _ln_inputs(rng, c, dts):
    x = (rng.randn(c["rows"], c["d"]) * 0.8).astype(np.float32)
    s = (rng.rand(c["d"]) + 0.5).astype(np.float32)
    b = (rng.randn(c["d"]) * 0.1).astype(np.float32)
    return [_pair(a, dts) for a in (x, s, b)]


@pytest.mark.parametrize("geom", ["paper_width", "small"])
@pytest.mark.parametrize("dt", DTYPES)
def test_ln_matmul_bwd_matches_pallas(dt, geom):
    """#19: dx in the activation dtype, ds, db, dw in f32."""
    c = GEOM if geom == "paper_width" else SMALL
    rng = np.random.RandomState(2)
    (x, jx), (s, js), (b, jb) = _ln_inputs(rng, c, DTYPES[dt])
    w, jw = _pair(_init(rng, c["d"], c["d"], c["k"]), DTYPES[dt])
    g, jg = _pair(rng.randn(c["rows"], c["k"]).astype(np.float32),
                  DTYPES[dt])
    with jprecision.highest():
        want = jl._ln_matmul_bwd_impl(jx, js, jb, jw, jg, interpret=True)
    got = tl.ln_matmul_bwd(x, s, b, w, g)
    assert got[0].dtype == x.dtype
    assert all(t.dtype == torch.float32 for t in got[1:])
    for name, gt, wt in zip(("dx", "ds", "db", "dw"), got, want):
        _close(_np(gt), _np(wt), dt, name)


def _ff_inputs(rng, c, dts):
    d, ff = c["d"], c["ff"]
    (x, jx), (s, js), (bn, jbn) = _ln_inputs(rng, c, dts)
    rest = [_pair(a, dts) for a in (
        _init(rng, d, d, ff), _init(rng, d, ff), _init(rng, ff, ff, d),
        _init(rng, ff, d))]
    return [(x, jx), (s, js), (bn, jbn)] + rest


@pytest.mark.parametrize("geom", ["paper_width", "small"])
@pytest.mark.parametrize("dt", DTYPES)
def test_ln_ff_residual_h1_matches_pallas(dt, geom):
    """#21's h1-stash forward: the output and the pre-GELU hidden."""
    c = GEOM if geom == "paper_width" else SMALL
    pairs = _ff_inputs(np.random.RandomState(3), c, DTYPES[dt])
    with jprecision.highest():
        want = jm._ln_ff_res_h1_impl(*[p[1] for p in pairs], interpret=True)
    got = tm.ln_ff_residual_h1(*[p[0] for p in pairs])
    assert got[1].dtype == got[0].dtype == pairs[0][0].dtype
    for name, gt, wt in zip(("out", "h1"), got, want):
        _close(_np(gt), _np(wt), dt, name)


@pytest.mark.parametrize("geom", ["paper_width", "small"])
@pytest.mark.parametrize("dt", DTYPES)
def test_ln_ff_residual_bwd_matches_pallas(dt, geom):
    """#23 from the h1 stash: dx in the activation dtype, the six
    parameter grads in f32."""
    c = GEOM if geom == "paper_width" else SMALL
    rng = np.random.RandomState(4)
    (x, jx), (s, js), (bn, jbn), (w1, jw1), (b1, jb1), (w2, jw2), \
        (b2, jb2) = _ff_inputs(rng, c, DTYPES[dt])
    g, jg = _pair(rng.randn(c["rows"], c["d"]).astype(np.float32),
                  DTYPES[dt])
    _, h1 = tm.ln_ff_residual_h1(x, s, bn, w1, b1, w2, b2)
    jh1 = jnp.asarray(h1.float().numpy()).astype(DTYPES[dt][1])
    with jprecision.highest():
        want = jm._ln_ff_bwd_impl(jx, js, jbn, jw1, jh1, jw2, jg,
                                  interpret=True)
    got = tm.ln_ff_residual_bwd(x, s, bn, w1, h1, w2, g)
    names = ("dx", "ds", "dbn", "dw1", "db1", "dw2", "db2")
    for name, gt, wt in zip(names, got, want):
        _close(_np(gt), _np(wt), dt, name)


# ---------------------------------------------------------------------------
# the autograd.Functions vs jax.grad of the JAX wrappers (f32)


def _grads_match(t_fn, j_fn, arrays, out_shape, seed):
    """d/d(inputs) of sum(fn(*inputs) * c) for a fixed random c, both
    sides, compared at 1e-5 of each grad's scale."""
    c = np.random.RandomState(seed).randn(*out_shape).astype(np.float32)
    with jprecision.highest():
        jg = jax.jit(jax.grad(lambda *a: jnp.sum(j_fn(*a) * c),
                              argnums=tuple(range(len(arrays)))))(
            *[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    _lib.reset_launches()
    with tprecision.highest():
        (t_fn(*ts) * torch.from_numpy(c)).sum().backward()
    assert all(v == 0 for v in _lib.LAUNCHES.values())   # CPU: plain only
    for i, (t, j) in enumerate(zip(ts, jg)):
        _close(t.grad.numpy(), np.asarray(j), "f32", f"input {i}")


def test_autograd_functions_match_jax_grad():
    rng = np.random.RandomState(5)
    heads, inner = 4, 64
    qkv_t = rng.randn(2, 4, 8, 3 * inner).astype(np.float32)
    _grads_match(lambda u: ta.temporal_attention_packed(u, heads),
                 lambda u: ja.temporal_attention_packed(u, heads),
                 [qkv_t], (2, 4, 8, inner), 0)
    qkv_s = rng.randn(3, 16, 3 * inner).astype(np.float32)
    _grads_match(lambda u: ta.spatial_attention_packed(u, heads, 13),
                 lambda u: ja.spatial_attention_packed(u, heads, 13),
                 [qkv_s], (3, 16, inner), 1)
    c = SMALL
    x = (rng.randn(2, 26, c["d"]) * 0.8).astype(np.float32)
    s, b = (rng.rand(c["d"]) + 0.5).astype(np.float32), \
        (rng.randn(c["d"]) * 0.1).astype(np.float32)
    w = _init(rng, c["d"], c["d"], c["k"])
    _grads_match(tl.ln_matmul, jl.ln_matmul, [x, s, b, w],
                 (2, 26, c["k"]), 2)
    a = rng.randn(2, 26, c["k"]).astype(np.float32)
    wo, bo = _init(rng, c["k"], c["k"], c["d"]), _init(rng, c["k"], c["d"])
    _grads_match(tl.matmul_bias_residual, jl.matmul_bias_residual,
                 [a, wo, bo, x], (2, 26, c["d"]), 3)
    _grads_match(lambda *u: tl.matmul_bias_residual(*u, None),
                 lambda *u: jl.matmul_bias_residual(*u, None),
                 [a, wo, bo], (2, 26, c["d"]), 4)
    ff = [_init(rng, c["d"], c["d"], c["ff"]), _init(rng, c["d"], c["ff"]),
          _init(rng, c["ff"], c["ff"], c["d"]), _init(rng, c["ff"], c["d"])]
    _grads_match(tm.ln_ff_residual, jm.ln_ff_residual, [x, s, b] + ff,
                 (2, 26, c["d"]), 5)
