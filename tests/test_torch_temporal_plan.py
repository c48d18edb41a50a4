"""The temporal cores' launch planning, which needs no card
(istvt_tpu_torch/kernels/attention.temporal_plan, csrc/temporal.cuh): for
every dim_head the cores take (1 to 128) and both activation dtypes, the
head's layout on the lanes of a warp, in the forward (#11, #1, #9's phase
3) and in the backward (#12), covers the head once with vectors that
divide it, is one the CUDA source instantiates, and wastes no more lanes
or chunks than a power of two needs; #9's compile-time plan is the
forward's. Pure Python: a few seconds."""
import re
from pathlib import Path

import pytest
import torch

from istvt_tpu_torch.kernels import _lib, attention, selfcheck

CSRC = Path(attention.__file__).resolve().parent / "csrc"
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _instantiated():
    """(wide lanes, narrow chunks, the wide lanes that need vec <= 4) of
    with_temporal_plan in csrc/temporal.cuh."""
    src = (CSRC / "temporal.cuh").read_text()
    body = src[src.index("int with_temporal_plan("):]
    body = body[:body.index("return static_cast<int>(cudaErrorInvalidValue)")]
    wide = {int(n) for n in re.findall(r"TPlan<VW, (\d+), 1>", body)}
    narrow = {int(c) for c in re.findall(r"TPlan<1, 32, (\d+)>", body)}
    guarded = {int(n) for n in re.findall(
        r"if constexpr \(VW <= 4\) \{\s*f\(TPlan<VW, (\d+), 1>", body)}
    return wide, narrow, guarded


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_plan_covers_every_dim_head_once(dtype, backward):
    """Lane l holds elements (c * lanes + l) * vec + [0, vec), c < chunks:
    over a head's lanes these cover [0, lanes * vec * chunks) exactly once,
    which holds all of dh; vec divides dh (a vector is inside the head or
    past it, never across its end), and one vector is at most 16 bytes; the
    wide form wherever dh is a multiple of the wide vector, with lanes the
    least power of two that covers dh, and the narrow form on 32 lanes with
    the least power of two of chunks that covers dh."""
    size = dtype.itemsize
    wide = (attention.TEMPORAL_BWD_VEC if backward
            else attention.TEMPORAL_VEC_BYTES // size)
    for dh in range(1, 129):
        vec, lanes, chunks = attention.temporal_plan(dtype, dh, backward)
        cols = sorted((c * lanes + lane) * vec + v for lane in range(lanes)
                      for c in range(chunks) for v in range(vec))
        assert cols == list(range(lanes * vec * chunks)), dh
        assert lanes * vec * chunks >= dh and dh % vec == 0, dh
        assert vec * size <= 16 and lanes in (1, 2, 4, 8, 16, 32), dh
        if dh % wide == 0:
            assert (vec, chunks) == (wide, 1), dh
            assert lanes // 2 * vec < dh <= lanes * vec, dh
        else:
            assert (vec, lanes) == (1, 32), dh
            assert chunks // 2 * 32 < dh <= chunks * 32, dh


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_plan_is_instantiated(dtype, backward):
    """Every plan of dim_head 1 to 128 is one of with_temporal_plan's
    instantiations (the wrapper would raise on any other): the wide form's
    lanes among its cases (32 only for vectors of at most 4 elements), the
    narrow form's chunks among its."""
    wide, narrow, guarded = _instantiated()
    assert narrow == {1, 2, 4}
    assert wide == {1, 2, 4, 8, 16, 32} and guarded == {32}
    for dh in range(1, 129):
        vec, lanes, chunks = attention.temporal_plan(dtype, dh, backward)
        if vec == 1:
            assert lanes == 32 and chunks in narrow, dh
        else:
            assert chunks == 1 and lanes in wide, dh
            assert lanes not in guarded or vec <= 4, dh


def test_backward_vector_is_the_sources():
    """The backward's wide vector (TEMPORAL_BWD_VEC elements) is
    kTemporalBwdVec of csrc/temporal.cuh, and the forward's 16 bytes its
    instantiation in csrc/q8_attention.cu."""
    src = (CSRC / "temporal.cuh").read_text()
    assert re.search(r"constexpr int kTemporalBwdVec = (\d+);",
                     src).group(1) == str(attention.TEMPORAL_BWD_VEC)
    fwd = (CSRC / "q8_attention.cu").read_text()
    assert f"with_temporal_plan<{attention.TEMPORAL_VEC_BYTES} / sizeof(T)>" \
        in fwd


@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_layer_plan_is_the_forwards(dtype, dh):
    """#9's phase 3 takes TemporalWide<T, DH>: 16-byte vectors on the least
    power of two of lanes that covers DH (csrc/temporal.cuh), which is what
    temporal_plan gives the standalone core at #9's dim_heads (16, 64); so
    both sum each score in the same order, and #9 equals #1 bit for bit."""
    src = (CSRC / "temporal.cuh").read_text()
    assert "static constexpr int V = 16 / sizeof(T);" in src
    assert "using Plan = TPlan<V, pow2_ceil(DH / V), 1>;" in src
    v = 16 // dtype.itemsize
    lanes = 1
    while lanes * v < dh:
        lanes *= 2
    assert attention.temporal_plan(dtype, dh) == (v, lanes, 1)


def test_instantiation_counts_are_the_dispatchers():
    """selfcheck.TEMPORAL_KERNELS, the instantiations chip_smoke.py's build
    phase wants of #11 and #12 and of their general lanes' kernels (T1 >
    8, launched through the same with_temporal_plan), are those
    with_temporal_plan makes: the wide form's lanes (32 only for vectors of
    at most 4 elements) and the narrow form's chunks, per dtype."""
    wide, narrow, guarded = _instantiated()

    def count(vec):
        return len([n for n in wide if n not in guarded or vec <= 4]) + \
            len(narrow)

    fwd = sum(count(attention.TEMPORAL_VEC_BYTES // size) for size in (4, 2))
    bwd = 2 * count(attention.TEMPORAL_BWD_VEC)
    assert selfcheck.TEMPORAL_KERNELS == {"temporal_attn_kernel": fwd,
                                          "temporal_attn_bwd_kernel": bwd,
                                          "temporal_attn_any_kernel": fwd,
                                          "temporal_attn_bwd_any_kernel": bwd}


def test_spill_rows_of_a_canned_report():
    """selfcheck.spill_rows reads each instantiation's registers and
    spills from nvcc's -Xptxas -v report, by the kernel's mangled name
    (temporal_attn_kernel does not match temporal_attn_bwd_kernel, nor
    either of them the general lanes' kernels, which this report lacks)."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN5istvt20temporal_attn_kernelIfLi4ELi16ELi1EEEvPKT_PS1_iiiiifl'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN5istvt20temporal_attn_kernelIfLi4ELi16ELi1EEEvPKT_PS1_iiiiifl",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 123 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN5istvt24temporal_attn_bwd_kernelIfLi4ELi4ELi1EEEvPKT_S3_PS1_"
        "iiiiifl' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN5istvt24temporal_attn_bwd_kernelIfLi4ELi4ELi1EEEvPKT_S3_PS1_"
        "iiiiifl",
        "    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill "
        "loads",
        "ptxas info    : Used 128 registers"])
    rows = selfcheck.spill_rows(_lib.ptxas_report(log),
                                selfcheck.TEMPORAL_KERNELS)
    (fk, fregs, fspill), (bk, bregs, bspill), *general = rows
    assert [(k, regs, sp) for k, regs, sp in general] == [
        ("temporal_attn_any_kernel", {}, []),
        ("temporal_attn_bwd_any_kernel", {}, [])]
    assert (fk, list(fregs.values()), fspill) == \
        ("temporal_attn_kernel", [123], [])
    assert (bk, list(bregs.values()), len(bspill)) == \
        ("temporal_attn_bwd_kernel", [128], 1)
