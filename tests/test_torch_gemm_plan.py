"""The float GEMM's launch planning and checks that need no card
(istvt_tpu_torch/kernels/linear.py, selfcheck.py, _lib.py): the split-K
plan of the weight-gradient (TN) products, the column-sum partials' row
tile, the plain version that the card tests hold the GEMM to, and the
wgmma (HGMMA) count of chip_smoke.py's build phase on a canned cuobjdump
listing. Pure Python and small tensors: a few seconds."""
import pytest
import torch

from istvt_tpu_torch.kernels import _lib, linear, selfcheck

SMS = 132                                 # an H100 SXM
# the weight-gradient products (M, N) of a train step: #19's dW, #23's dw2
# and dw1, #20's backward dW; their K is the step's rows
DW_SHAPES = [(728, 1536), (2912, 728), (728, 2912), (512, 728)]
ROWS = {"slice": 2 * 7 * 368, "B=16": 16 * 7 * 368}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(m, n, splits):
    """The share of the launch's waves that its blocks fill."""
    bm, bn, _ = linear.GEMM_TILES[torch.bfloat16]
    blocks = -(-m // bm) * -(-n // bn) * splits
    return blocks / (-(-blocks // SMS) * SMS)


@pytest.mark.parametrize("k", [1, 8, 64, 65, 728, 5152, 41216, 123457])
@pytest.mark.parametrize("m, n", DW_SHAPES + [(8, 8), (4096, 4096)])
def test_splitk_slices_cover_k_in_order(m, n, k):
    """The slices cover [0, K) exactly, in order, each non-empty and
    starting and ending on a k-tile boundary (but the last, at K); the
    partials are (splits, M, N); kslice k-tiles a slice, as the kernel
    reads them."""
    bk = linear.GEMM_TILES[torch.bfloat16][2]
    plan = linear.plan_splitk(m, n, k, SMS)
    assert plan.splits == len(plan.bounds) >= 1
    assert plan.part_shape == (plan.splits, m, n)
    assert plan.bounds[0][0] == 0 and plan.bounds[-1][1] == k
    for (b0, e0), (b1, _) in zip(plan.bounds, plan.bounds[1:]):
        assert e0 == b1
    for z, (b, e) in enumerate(plan.bounds):
        assert b < e and b % bk == 0 and (e % bk == 0 or e == k)
        assert b == z * plan.kslice * bk
        assert e == min(k, (z + 1) * plan.kslice * bk)


@pytest.mark.parametrize("rows", ROWS.values(), ids=ROWS.keys())
@pytest.mark.parametrize("m, n", DW_SHAPES)
def test_splitk_fills_the_waves_of_the_dw_products(m, n, rows):
    """Each dW product of a train step leaves no more of its last wave
    empty than without a split; at B=16 (644 k-tiles) it is split and its
    waves are at least 90% full (#19's 72 tiles of 132 SMs alone fill
    55%, #23's 138 tiles 52%)."""
    plan = linear.plan_splitk(m, n, rows, SMS)
    assert _fill(m, n, plan.splits) >= _fill(m, n, 1)
    if rows == ROWS["B=16"]:
        assert plan.splits > 1
        assert _fill(m, n, plan.splits) >= 0.9


def test_splitk_leaves_full_grids_whole():
    """A grid of many waves, or K of one k-tile, is not split."""
    assert linear.plan_splitk(41216, 1536, 728, SMS).splits == 1
    assert linear.plan_splitk(728, 1536, 64, SMS).splits == 1
    assert linear.plan_splitk(8192, 8192, 8192, SMS).splits == 1


def test_row_tile_is_the_planned_m_tile():
    """The column-sum partials of the GELU-backward epilogue have a row per
    block row of the GEMM: gemm_row_tile and the planner's M tile are one
    number, 128 for bf16 and for f32 inputs (both on the wgmma tile)."""
    bf16 = linear.GEMM_TILES[torch.bfloat16]
    f32 = linear.GEMM_TILES[torch.float32]
    assert linear.gemm_row_tile(torch.bfloat16) == bf16[0] == 128
    assert linear.gemm_row_tile(torch.float32) == f32[0] == 128


@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
def test_gemm_plain_reads_the_stored_layouts(layout):
    """The plain version the card tests hold the GEMM to computes A @ B
    from the operands as each layout stores them: nn a (M, K), b (K, N);
    nt b (N, K); tn a (K, M)."""
    ops = selfcheck.gemm_operands(layout, 24, 16, 40, "plain", torch.float32,
                                  "cpu", seed=3)
    a, b = ops["a"].float(), ops["b"].float()
    a = a.t() if layout == "tn" else a
    b = b.t() if layout == "nt" else b
    (got,) = selfcheck.gemm_plain(ops)
    assert got.shape == (24, 16)
    torch.testing.assert_close(got, a @ b, rtol=1e-6, atol=1e-5)


def test_gemm_plain_epilogues():
    """The epilogues of the plain version in the JAX order: + bias, the
    pre-activation (stash), tanh-GELU, + res, one rounding; the GELU
    backward's product, gelu(aux) and per-128-row column sums of the f32
    product."""
    from istvt_tpu_torch.kernels import mlp
    ops = selfcheck.gemm_operands("nn", 200, 24, 16, "stash", torch.bfloat16,
                                  "cpu", seed=4)
    acc = ops["a"].float() @ ops["b"].float()
    out, pre = selfcheck.gemm_plain(ops)
    h = acc + ops["bias32"]
    assert torch.equal(pre, h.to(torch.bfloat16))
    assert torch.equal(out, mlp._gelu_tanh(h).to(torch.bfloat16))
    ops = selfcheck.gemm_operands("nn", 20, 24, 16, "bias_gelu_res",
                                  torch.float32, "cpu", seed=5)
    (out,) = selfcheck.gemm_plain(ops)
    want = mlp._gelu_tanh(ops["a"].float() @ ops["b"].float()
                          + ops["bias32"]) + ops["res"].float()
    assert torch.equal(out, want)
    ops = selfcheck.gemm_operands("nt", 200, 24, 16, "gelu_bwd",
                                  torch.bfloat16, "cpu", seed=6)
    out, hg, part = selfcheck.gemm_plain(ops)
    val, dval = mlp._gelu_tanh_and_grad(ops["aux"].float())
    prod = (ops["a"].float() @ ops["b"].float().t()) * dval
    assert torch.equal(out, prod.to(torch.bfloat16))
    assert torch.equal(hg, val.to(torch.bfloat16))
    assert part.shape == (2, 24) == ops["part"].shape
    torch.testing.assert_close(part[0], prod[:128].sum(0))
    torch.testing.assert_close(part[1], prod[128:].sum(0))


def test_gemm_shapes_are_the_callers():
    """The GEMM table of chip_smoke.py's phase 3 at the slice: every float
    caller's launch, with the operand shapes the wrappers give the GEMM."""
    shapes = selfcheck.gemm_shapes()
    r = ROWS["slice"]
    assert shapes["#18 QKV"] == ("nn", r, 1536, 728, "plain", torch.bfloat16)
    assert shapes["#19 dW"] == ("tn", 728, 1536, r, "plain", torch.float32)
    assert shapes["#22 fc1"][1] == 2 * 7 * 362
    assert shapes["#23 dh1 (gelu_bwd)"] == ("nt", r, 2912, 728, "gelu_bwd",
                                            torch.bfloat16)
    assert {s[0] for s in shapes.values()} == {"nn", "nt", "tn"}
    for layout, m, n, k, epilogue, dt in shapes.values():
        ops = selfcheck.gemm_operands(layout, m // 64 + 8, n // 8, k // 64 + 8,
                                      epilogue, dt, "cpu")
        assert all(t.shape == w.shape and t.dtype == w.dtype for t, w in zip(
            selfcheck.gemm_results(ops), selfcheck.gemm_plain(ops)))


# a cuobjdump -sass excerpt in its layout: two instantiations of the bf16
# GEMM (template parameters layout, output type, epilogue, BN), one of the
# f32 GEMM (layout, epilogue) on TF32 wgmma, an f32 spatial attention kernel
# on TF32 mma.sync and a bf16 one
_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN5istvt22gemm_bf16_wgmma_kernelILi0E13__nv_bfloat16Li0ELi128EEEv14CUtensorMap_stS2_PT0_NS_3EpiEiiii
        /*0a30*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;
        /*0a40*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
\t\tFunction : _ZN5istvt22gemm_bf16_wgmma_kernelILi2EfLi0ELi128EEEv14CUtensorMap_stS1_PT0_NS_3EpiEiiii
        /*0a30*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;
\t\tFunction : _ZN5istvt21gemm_f32_wgmma_kernelILi0ELi0EEEv14CUtensorMap_stS1_S1_PfNS_3EpiEiiNS_8TileGridE
        /*0b10*/                   HGMMA.64x128x8.F32.TF32 R24, R152, gdesc[UR4], R24, gsb0 ;
        /*0b20*/                   HGMMA.64x128x8.F32.TF32 R24, R156, gdesc[UR8], R24, gsb0 ;
\t\tFunction : _ZN5istvt19spatial_attn_kernelIfLi64EEEvPKT_PS2_iiif
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
\t\tFunction : _ZN5istvt19spatial_attn_kernelI13__nv_bfloat16Li64EEEvPKT_PS2_iiif
        /*0a30*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;
"""


def _gemm_rows(sass, **given):
    """{(kernel, dtype): ok} of tensor_core_check on `sass` for its GEMMs
    and the spatial kernel, the wgmma, TF32 wgmma and TF32 mma.sync counts
    given unless set in `given` (None leaves them out)."""
    counts = {"wgmma": _lib.tensor_ops_of_sass(sass, ("HGMMA.",)),
              "tf32": _lib.tensor_ops_of_sass(sass,
                                              (selfcheck.TF32_WGMMA_OP,)),
              "tf32_mma": _lib.tensor_ops_of_sass(sass,
                                                  (selfcheck.TF32_MMA_OP,))}
    counts.update(given)
    return {(k, d): ok for k, d, _, ok in selfcheck.tensor_core_check(
        _lib.tensor_ops_of_sass(sass), **counts)}


def test_wgmma_check_reads_the_sass():
    """The GEMM rows of the tensor-core check: HGMMA is counted apart from
    HMMA, and its TF32 form apart from bf16; every instantiation of the
    bf16 GEMM must have HGMMA and every one of the f32 GEMM TF32 HGMMA,
    whatever their template parameters, and the f32 attention kernels TF32
    mma.sync (HMMA.1688.F32.TF32), which is not TF32 wgmma; a bf16 GEMM on
    mma.sync alone, an f32 GEMM on bf16 wgmma, TF32 mma.sync or the FMA
    pipes, an f32 attention kernel on bf16 products or the FMA pipes, or a
    kernel whose counts are not given, fails."""
    counts = _lib.tensor_ops_of_sass(_SASS)
    wgmma = _lib.tensor_ops_of_sass(_SASS, ("HGMMA.",))
    tf32 = _lib.tensor_ops_of_sass(_SASS, (selfcheck.TF32_WGMMA_OP,))
    assert sorted(counts.values()) == [1, 1, 1, 2, 2]
    assert sorted(wgmma.values()) == [0, 0, 1, 2, 2]
    assert sorted(tf32.values()) == [0, 0, 0, 0, 2]
    tf32_mma = _lib.tensor_ops_of_sass(_SASS, (selfcheck.TF32_MMA_OP,))
    assert sorted(tf32_mma.values()) == [0, 0, 0, 0, 1]
    rows = {(k, d): (f, ok) for k, d, f, ok
            in selfcheck.tensor_core_check(counts, wgmma, tf32=tf32,
                                           tf32_mma=tf32_mma)}
    found, ok = rows[("gemm_bf16_wgmma_kernel", "bf16")]
    assert ok and sorted(found.values()) == [1, 2]
    found, ok = rows[("gemm_f32_wgmma_kernel", "f32")]
    assert ok and list(found.values()) == [2]
    found, ok = rows[("spatial_attn_kernel", "f32")]
    assert ok and list(found.values()) == [1]
    assert rows[("spatial_attn_kernel", "bf16")][1]
    assert ("gemm_f32_kernel", "f32") not in rows      # the FMA GEMM is gone
    hmma_only = _SASS.replace("HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24, "
                              "gsb0 ;\n\t\tFunction : _ZN5istvt21",
                              "HMMA.16816.F32.BF16 R24, R4, R20, R24 ;\n"
                              "\t\tFunction : _ZN5istvt21")
    rows = _gemm_rows(hmma_only)
    assert not rows[("gemm_bf16_wgmma_kernel", "bf16")]
    assert rows[("gemm_f32_wgmma_kernel", "f32")]
    for other in ("HGMMA.64x128x16.F32.BF16", "HMMA.1688.F32.TF32", "FFMA"):
        rows = _gemm_rows(_SASS.replace("HGMMA.64x128x8.F32.TF32", other))
        assert not rows[("gemm_f32_wgmma_kernel", "f32")], other
        assert rows[("gemm_bf16_wgmma_kernel", "bf16")]
    for other in ("HMMA.16816.F32.BF16", "FFMA"):
        rows = _gemm_rows(_SASS.replace("HMMA.1688.F32.TF32", other))
        assert not rows[("spatial_attn_kernel", "f32")], other
    rows = _gemm_rows(_SASS, wgmma=None, tf32=None,
                      tf32_mma=None)                # no counts given
    assert not rows[("gemm_bf16_wgmma_kernel", "bf16")]
    assert not rows[("gemm_f32_wgmma_kernel", "f32")]
    assert not rows[("spatial_attn_kernel", "f32")]
