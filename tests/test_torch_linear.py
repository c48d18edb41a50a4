"""Port LN -> GEMM, GEMM + bias (+ residual) and PreNorm-FF wrappers
(istvt_tpu_torch/kernels/linear.py, mlp.py; plain versions on the CPU)
against the JAX package's Pallas kernels (interpret mode on the CPU,
through their public wrappers) on the same numpy inputs.

f32: atol = rtol = 1e-5 (no int8 rounding on this path; the two sides
differ only by summation order, measured max|diff| <= 2.0e-6 at these
sizes). bf16: the criterion of the card check (selfcheck.bf16_close):
both sides round at the same places (LN output, FF hidden, result), and a
value next to a bf16 rounding boundary can round the other way after a
different summation order."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from istvt_tpu.core import precision as jprecision
from istvt_tpu.kernels import linear as jl
from istvt_tpu.kernels import mlp as jm
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.kernels import _lib, selfcheck
from istvt_tpu_torch.kernels import linear as tl
from istvt_tpu_torch.kernels import mlp as tm

# the small geometry of the JAX kernel tests, and the paper widths
# (D 728, I 512, FF 2912: K and N not multiples of 16) with few rows
SIZES = {"small": selfcheck.SMALL,
         "full_width": dict(b=1, t1=3, s=16, d=728, inner=512, hid=2912)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
KERNELS = ["ln_matmul", "matmul_bias_residual", "matmul_bias", "ln_ff"]


def _inputs(kernel, c, rng):
    n = c["b"] * c["t1"] * c["s"]
    d, inner, hid = c["d"], c["inner"], c["hid"]

    def init(fan_in, *shape):
        return rng.uniform(-1, 1, shape).astype(np.float32) * fan_in ** -0.5

    x = (rng.randn(c["b"], n // c["b"], d) * 0.8).astype(np.float32)
    s = (rng.rand(d) + 0.5).astype(np.float32)
    b = (rng.randn(d) * 0.02).astype(np.float32)
    if kernel == "ln_matmul":
        return [x, s, b, init(d, d, 3 * inner)]
    if kernel.startswith("matmul_bias"):
        a = (rng.randn(c["b"], n // c["b"], inner) * 0.5).astype(np.float32)
        r = [x] if kernel == "matmul_bias_residual" else [None]
        return [a, init(inner, inner, d), init(inner, d)] + r
    return [x, s, b, init(d, d, hid), init(d, hid), init(hid, hid, d),
            init(hid, d)]


def _fns(kernel):
    if kernel == "ln_matmul":
        return jl.ln_matmul, tl.ln_matmul
    if kernel == "ln_ff":
        return jm.ln_ff_residual, tm.ln_ff_residual
    return jl.matmul_bias_residual, tl.matmul_bias_residual


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_jax(kernel, size, dtype):
    c = SIZES[size]
    rng = np.random.RandomState(
        len(KERNELS) * list(SIZES).index(size) + KERNELS.index(kernel))
    arrs = _inputs(kernel, c, rng)
    jfn, tfn = _fns(kernel)
    tdt, jdt = DTYPES[dtype]
    # activations in the working dtype; parameters stay f32, as the model
    # passes them before a cast (each wrapper casts what JAX casts)
    with jprecision.highest():
        jargs = [None if a is None else jnp.asarray(a) for a in arrs]
        jargs[0] = jargs[0].astype(jdt)
        if kernel == "matmul_bias_residual":
            jargs[3] = jargs[3].astype(jdt)
        want = np.asarray(jfn(*jargs).astype(jnp.float32))
    targs = [None if a is None else torch.from_numpy(a) for a in arrs]
    targs[0] = targs[0].to(tdt)
    if kernel == "matmul_bias_residual":
        targs[3] = targs[3].to(tdt)
    _lib.reset_launches()
    with tprecision.highest():
        got = tfn(*targs)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert all(v == 0 for v in _lib.LAUNCHES.values())
    got = got.float()
    assert torch.isfinite(got).all()
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        ok, rel, mx, scale = selfcheck.bf16_close(got, torch.tensor(want))
        assert ok, (rel, mx, scale)
