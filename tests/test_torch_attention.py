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
    """What the CUDA cores cannot take raises before any launch: a dim_head
    they are not built for, heads that do not divide inner, T1 < 2. Longer
    clips are taken (T1 = 9, 33), and the spatial check has no S to refuse:
    the cores stream the keys."""
    ta.check_spatial(512, 8)
    ta.check_temporal(8, 1024, 8)
    for t1 in (9, 33):
        ta.check_temporal(t1, 512, 8)
    for inner, heads in ((384, 8), (512, 3)):
        with pytest.raises(NotImplementedError, match="spatial attention"):
            ta.check_spatial(inner, heads)
    with pytest.raises(NotImplementedError, match="spatial attention"):
        ta.check_spatial(1024, 8, dims=(16, 32, 64))
    for t1, inner, heads in ((7, 2048, 8), (7, 512, 3), (1, 512, 8)):
        with pytest.raises(NotImplementedError, match="temporal attention"):
            ta.check_temporal(t1, inner, heads)


# a cuobjdump -sass excerpt in its layout: the spatial kernels' bf16 and f32
# instantiations (the f32 one on TF32 mma.sync), #9's with int8 IMMA and, in
# f32, TF32 mma.sync
_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN5istvt19spatial_attn_kernelI13__nv_bfloat16Li64EEEvPKT_PS2_iiif
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0a30*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;
        /*0a40*/                   HMMA.16816.F32.BF16 R28, R4, R22, R28 ;
\t\tFunction : _ZN5istvt19spatial_attn_kernelIfLi64EEEvPKT_PS1_iiif
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
\t\tFunction : _ZN5istvt18st_layer_q8_kernelIfLi64EEEvNS_7LayerQ8E
        /*0200*/                   IMMA.16832.S8.S8 R8, R12, R16, R8 ;
        /*0210*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
\t\tFunction : _ZN5istvt18st_layer_q8_kernelI13__nv_bfloat16Li64EEEvNS_7LayerQ8E
        /*0200*/                   IMMA.16832.S8.S8 R8, R12, R16, R8 ;
        /*0300*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
"""


def _rows(sass):
    """{(kernel, dtype): ok} of the tensor-core check on `sass`, its TF32
    mma.sync counts given."""
    return {(k, d): ok for k, d, _, ok in selfcheck.tensor_core_check(
        _lib.tensor_ops_of_sass(sass),
        tf32_mma=_lib.tensor_ops_of_sass(sass, (selfcheck.TF32_MMA_OP,)))}


def test_tensor_core_check_reads_the_sass():
    """The tensor-core check of chip_smoke.py's build phase and the card
    test, on a canned cuobjdump listing: HMMA / HGMMA count, IMMA does
    not, and an f32 instantiation counts TF32 mma.sync (HMMA.1688.F32.TF32)
    alone; a bf16 kernel with none, an f32 one on the FMA pipes or on bf16
    products, or a kernel not in the library at all fails."""
    counts = _lib.tensor_ops_of_sass(_SASS)
    assert sorted(counts.values()) == [1, 1, 1, 2]
    tf32 = _lib.tensor_ops_of_sass(_SASS, (selfcheck.TF32_MMA_OP,))
    assert sorted(tf32.values()) == [0, 0, 1, 1]
    rows = _rows(_SASS)
    assert rows[("spatial_attn_kernel", "bf16")]
    assert rows[("spatial_attn_kernel", "f32")]
    assert rows[("st_layer_q8_kernel", "bf16")]
    assert rows[("st_layer_q8_kernel", "f32")]
    assert not rows[("frame_attn_kernel", "bf16")]          # not built
    assert not rows[("frame_attn_kernel", "f32")]
    assert not any(ok for k, d, _, ok in selfcheck.tensor_core_check(counts)
                   if d == "f32" and k in selfcheck.TF32_MMA_KERNELS)
    for other in ("FFMA R4, R2, R3, R4", "HMMA.16816.F32.BF16 R4, R8, R12, R4"):
        rows = _rows(_SASS.replace("HMMA.1688.F32.TF32 R4, R8, R12, R4",
                                   other))
        assert not rows[("spatial_attn_kernel", "f32")], other
        assert not rows[("st_layer_q8_kernel", "f32")], other
        assert rows[("spatial_attn_kernel", "bf16")], other
    fma = _SASS.replace("HMMA.16816.F32.BF16", "FFMA")
    assert not _rows(fma)[("spatial_attn_kernel", "bf16")]
