"""Port packed attention wrappers (istvt_tpu_torch/kernels/attention.py,
plain versions on the CPU) against the JAX package's Pallas kernels
(interpret mode on the CPU, through their public wrappers) on the same
numpy inputs.

f32: atol = rtol = 1e-5 (no int8 rounding on this path; the two sides
differ only by summation order, measured max|diff| <= 1.9e-6 at these
sizes). bf16: the criterion of the card check (selfcheck.bf16_close),
since the two sides round the f32 result to bf16 after different
summation orders."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from istvt_tpu.core import precision as jprecision
from istvt_tpu.kernels import attention as ja
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.kernels import _lib, selfcheck
from istvt_tpu_torch.kernels import attention as ta

# the small geometry of the JAX kernel tests (dim_head 16) and the paper's
# heads x dim_head (8 x 64, the head-pair path of the Pallas kernel) with a
# few tokens
SIZES = {"small": selfcheck.SMALL,
         "paper_heads": dict(b=1, t1=7, s=40, n_valid=35, inner=512,
                             heads=8)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _run(jfn, tfn, arr, dtype):
    tdt, jdt = DTYPES[dtype]
    with jprecision.highest():
        want = jfn(jnp.asarray(arr).astype(jdt))
        want = np.asarray(want.astype(jnp.float32))
    _lib.reset_launches()
    with tprecision.highest():
        got = tfn(torch.from_numpy(arr).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert all(v == 0 for v in _lib.LAUNCHES.values())
    got = got.float()
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        ok, rel, mx, scale = selfcheck.bf16_close(got, torch.tensor(want))
        assert ok, (rel, mx, scale)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("size", list(SIZES))
def test_temporal_attention_packed_matches_jax(size, dtype):
    c = SIZES[size]
    rng = np.random.RandomState(list(SIZES).index(size))
    qkv = rng.randn(c["b"], c["t1"], c["s"], 3 * c["inner"]).astype(
        np.float32)
    _run(lambda q: ja.temporal_attention_packed(q, c["heads"]),
         lambda q: ta.temporal_attention_packed(q, c["heads"]), qkv, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("size", list(SIZES))
def test_spatial_attention_packed_matches_jax(size, dtype):
    c = SIZES[size]
    assert c["n_valid"] < c["s"]
    rng = np.random.RandomState(10 + list(SIZES).index(size))
    qkv = rng.randn(c["b"] * c["t1"], c["s"], 3 * c["inner"]).astype(
        np.float32)
    _run(lambda q: ja.spatial_attention_packed(q, c["heads"], c["n_valid"]),
         lambda q: ta.spatial_attention_packed(q, c["heads"], c["n_valid"]),
         qkv, dtype)


def test_core_limits_raise_with_a_message():
    """What the CUDA cores cannot take raises before any launch."""
    ta.check_spatial(384, 512, 8)
    ta.check_temporal(8, 1024, 8)
    for s_len, inner, heads in ((392, 512, 8), (368, 384, 8), (368, 512, 3)):
        with pytest.raises(NotImplementedError, match="spatial attention"):
            ta.check_spatial(s_len, inner, heads)
    for t1, inner, heads in ((9, 512, 8), (7, 2048, 8)):
        with pytest.raises(NotImplementedError, match="temporal attention"):
            ta.check_temporal(t1, inner, heads)
