"""The port's CUDA kernels vs their plain PyTorch versions on the card, at
the serving slice's shapes (the checks of chip_smoke.py phase 3) and at
the small geometry of the JAX kernel tests (dim_head 16, S = 32): every
launch counter of kernels/_lib.LAUNCHES, the training slice's backward
kernels and h1-stash forward and the int8 A/B modes' kernels included;
the one-kernel layer #9 at more shapes and against the #1 -> #2 -> #3
chain; the kernel API's entries (#13's unpacked entry, #14-#17, #24)
against their plain versions, the packed cores they share device code
with, and the differentiable wrappers' backward on the card; the spatial
attention core and its backward #13 at more shapes (S off the 16-row mma
tile, masked keys, every dim_head, 112 frames), bf16 on bf16 products
and f32 as three TF32 products, both on the tensor cores, and from the
built library's SASS and ptxas report that each runs on the pipes it
should, without a spill (and, from tools/mma_tf32_probe.cu, that
mma.sync truncates the sums those tiles start afresh each k-step); the
float GEMM (wgmma) alone at every caller's shape and at edges of each
layout, every epilogue, both output dtypes and split-K; the int8 GEMM
(s8 wgmma) alone at every caller's shape at the slice and at the B=16
forward's rows, at M off its tile and in every (output, residual, GELU)
combination its callers use, bit for bit against its plain version
without GELU, with its padding never read and its weight copies built in
a call where none is given; then small models on the card against the
CPU, and small serving artifacts exported on the card against the live
model.

Needs an NVIDIA GPU with nvcc: marked `gpu`, and skipped (inside the
fixture, not at import) where torch sees no CUDA device. Run on the card:
    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu
"""
import subprocess
from pathlib import Path

import pytest
import torch

from istvt_tpu_torch.core.precision import highest
from istvt_tpu_torch.kernels import (_lib, attention, conv, linear, quant,
                                     selfcheck)
from istvt_tpu_torch.models.xception import to_store

pytestmark = pytest.mark.gpu

KERNELS = list(selfcheck.CASES)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["SLICE", "SMALL"])
def cases(cuda, request):
    return selfcheck.slice_cases(cuda, getattr(selfcheck, request.param))


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_f32_matches_plain(cases, name):
    kern, plain, make = cases[name]
    args = make(torch.float32)
    before = dict(_lib.LAUNCHES)
    with highest():
        got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    n = selfcheck.counter(name)
    assert _lib.LAUNCHES == {**before, n: before[n] + 1}
    ok, err = selfcheck.f32_close(name, got, want)
    assert ok, f"max|diff| {err}"


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_bf16_matches_plain(cases, name):
    kern, plain, make = cases[name]
    args = make(torch.bfloat16)
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    assert selfcheck.outputs(got)[0].dtype == torch.bfloat16
    ok, rel, mx, scale = selfcheck.bf16_close(got, want)
    assert ok, (rel, mx, scale)


# (S, n_valid, dim_head, frames) of the spatial core's extra cases: the
# model's S = 368 with 362 valid keys, S = 384, S off the 16-row mma tile
# with masked keys, every dim_head, and the B=16 forward's 112 frames; the
# larger frames the JAX package runs (-is 320, 352, 380, 448: S = 408, 488,
# 584, 792 with h w + 1 valid keys); #13 at the dim_heads it takes (16, 32,
# 64)
SPATIAL_SHAPES = [(368, 362, 64, 14), (384, 384, 64, 6), (97, 90, 64, 6),
                  (361, 300, 64, 6), (368, 362, 16, 6), (368, 362, 32, 6),
                  (368, 362, 128, 6), (97, 61, 128, 6), (361, 355, 16, 6),
                  (368, 362, 64, 112), (408, 401, 64, 14), (488, 485, 32, 6),
                  (584, 577, 128, 6), (792, 785, 64, 6), (792, 785, 16, 6)]
SPATIAL_BWD_SHAPES = [c for c in SPATIAL_SHAPES if c[2] <= 64]


def _spatial_qkv(cuda, s, dh, frames, heads=4, grad=False):
    g = torch.Generator().manual_seed(1000 * s + dh + frames)
    qkv = torch.randn(frames, s, 3 * heads * dh, generator=g)
    go = torch.randn(frames, s, heads * dh, generator=g) if grad else None
    return heads, qkv.to(cuda), None if go is None else go.to(cuda)


@pytest.mark.parametrize("s, n_valid, dh, frames", SPATIAL_SHAPES)
def test_spatial_core_matches_plain_at_more_shapes(cuda, record_property, s,
                                                   n_valid, dh, frames):
    """The spatial core (#10's, and so #2's, #9's, #14's and #15's) against
    its plain version: bf16 (bf16 products) by the bf16 criterion, the
    share of elements equal bit for bit recorded; f32 (three TF32 products)
    at atol = rtol = 1e-5, and a second call equal to the first bit for
    bit."""
    heads, qkv, _ = _spatial_qkv(cuda, s, dh, frames)
    with highest():
        got = attention.spatial_attention_packed(qkv, heads, n_valid)
        want = attention.spatial_packed_plain(qkv, heads, n_valid)
    again = attention.spatial_attention_packed(qkv, heads, n_valid)
    torch.cuda.synchronize()
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5), \
        (got - want).abs().max()
    assert torch.equal(again, got)
    x = qkv.bfloat16()
    got = attention.spatial_attention_packed(x, heads, n_valid)
    want = attention.spatial_packed_plain(x, heads, n_valid)
    torch.cuda.synchronize()
    ok, rel, mx, scale = selfcheck.bf16_close(got, want)
    share = selfcheck.bit_equal_share(got, want)
    record_property("bf16_bit_equal", share)
    record_property("bf16_rel_l2", rel)
    assert ok, (rel, mx, scale, share)


@pytest.mark.parametrize("s, n_valid, dh, frames", SPATIAL_BWD_SHAPES)
def test_spatial_bwd_matches_plain_at_more_shapes(cuda, record_property, s,
                                                  n_valid, dh, frames):
    """#13 (packed) against its plain version at the same shapes: bf16 by
    the bf16 criterion per output, the share equal bit for bit recorded;
    f32 (three TF32 products) at max|diff| <= 1e-5 max|plain| per output,
    and a second call equal to the first bit for bit."""
    heads, qkv, go = _spatial_qkv(cuda, s, dh, frames, grad=True)
    with highest():
        got = attention.spatial_attention_packed_bwd(qkv, go, heads, n_valid)
        want = attention.spatial_packed_bwd_plain(qkv, go, heads, n_valid)
    again = attention.spatial_attention_packed_bwd(qkv, go, heads, n_valid)
    torch.cuda.synchronize()
    inner = heads * dh
    for a, b in zip(got.split(inner, dim=-1), want.split(inner, dim=-1)):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert torch.equal(again, got)
    x, gb = qkv.bfloat16(), go.bfloat16()
    got = attention.spatial_attention_packed_bwd(x, gb, heads, n_valid)
    want = attention.spatial_packed_bwd_plain(x, gb, heads, n_valid)
    torch.cuda.synchronize()
    got3, want3 = got.split(inner, dim=-1), want.split(inner, dim=-1)
    ok, rel, mx, scale = selfcheck.bf16_close(got3, want3)
    share = selfcheck.bit_equal_share(got3, want3)
    record_property("bf16_bit_equal", share)
    record_property("bf16_rel_l2", rel)
    assert ok, (rel, mx, scale, share)


# (B, T1, S, heads, dim_head) of the temporal core's and #12's extra cases:
# every dim_head the model geometries use (16, 32, 64, 128), T1 = 2, 3, 7
# and 8, B S H not a multiple of a block's heads, and dim_heads off the
# 16-byte vector: 20 and 100 (the narrow form in bf16, the wide in f32, 100
# on 32 lanes), 7 and 33 (the narrow form in both, 1 and 2 elements a lane);
# then the general lanes (T1 > 8: --seq_len 8, 16, 32) at the same kinds of
# layout, and at T1 = 240, where not one warp's slots fit a block's shared
# memory and they go to a device scratch
TEMPORAL_SHAPES = [(2, 7, 368, 8, 64), (1, 2, 37, 3, 16), (2, 3, 45, 4, 32),
                   (1, 8, 29, 2, 128), (2, 7, 61, 5, 20), (1, 7, 33, 3, 100),
                   (1, 3, 19, 4, 7), (1, 8, 24, 2, 33),
                   (2, 9, 368, 8, 64), (1, 17, 37, 3, 16), (1, 33, 45, 4, 32),
                   (1, 9, 29, 2, 128), (1, 17, 61, 5, 20), (1, 9, 33, 3, 100),
                   (1, 33, 19, 4, 7), (1, 17, 24, 2, 33), (1, 240, 5, 2, 64)]


def _temporal_qkv(cuda, b, t1, s, heads, dh, seed=0):
    g = torch.Generator().manual_seed(seed + 1000 * dh + 10 * t1 + s)
    qkv = torch.randn(b, t1, s, 3 * heads * dh, generator=g)
    go = torch.randn(b, t1, s, heads * dh, generator=g)
    return qkv.to(cuda), go.to(cuda)


def _ids(shapes):
    return ["x".join(map(str, c)) for c in shapes]


@pytest.mark.parametrize("b, t1, s, heads, dh", TEMPORAL_SHAPES,
                         ids=_ids(TEMPORAL_SHAPES))
def test_temporal_core_matches_plain_at_more_shapes(cuda, b, t1, s, heads,
                                                    dh):
    """The temporal core (#11's, and so #1's and #9's phase 3) against its
    plain version in the layout attention.temporal_plan picks: f32 at
    atol = rtol = 1e-5, bf16 by the bf16 criterion; one launch each."""
    qkv, _ = _temporal_qkv(cuda, b, t1, s, heads, dh)
    before = _lib.LAUNCHES["temporal_attention_packed"]
    with highest():
        got = attention.temporal_attention_packed(qkv, heads)
        want = attention.temporal_packed_plain(qkv, heads)
    torch.cuda.synchronize()
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5), \
        (got - want).abs().max()
    x = qkv.bfloat16()
    got = attention.temporal_attention_packed(x, heads)
    want = attention.temporal_packed_plain(x, heads)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["temporal_attention_packed"] == before + 2
    ok, rel, mx, scale = selfcheck.bf16_close(got, want)
    assert ok, (rel, mx, scale)


@pytest.mark.parametrize("b, t1, s, heads, dh", TEMPORAL_SHAPES,
                         ids=_ids(TEMPORAL_SHAPES))
def test_temporal_bwd_matches_plain_at_more_shapes(cuda, b, t1, s, heads,
                                                   dh):
    """#12 against its plain version at the same shapes: f32 at max|diff|
    <= 1e-5 max|plain| for each of dq, dk, dv; bf16 by the bf16 criterion
    per output."""
    qkv, go = _temporal_qkv(cuda, b, t1, s, heads, dh)
    inner = heads * dh
    with highest():
        got = attention.temporal_attention_packed_bwd(qkv, go, heads)
        want = attention.temporal_packed_bwd_plain(qkv, go, heads)
    torch.cuda.synchronize()
    for a, w in zip(got.split(inner, dim=-1), want.split(inner, dim=-1)):
        assert (a - w).abs().max() <= 1e-5 * w.abs().max()
    x, gb = qkv.bfloat16(), go.bfloat16()
    got = attention.temporal_attention_packed_bwd(x, gb, heads)
    want = attention.temporal_packed_bwd_plain(x, gb, heads)
    torch.cuda.synchronize()
    ok, rel, mx, scale = selfcheck.bf16_close(got.split(inner, dim=-1),
                                              want.split(inner, dim=-1))
    assert ok, (rel, mx, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_temporal_cores_back_to_back_on_reused_outputs(cuda, dtype):
    """#11 and #12 twice each, back to back, the second call on other
    inputs and on the memory the first's output just gave back: each result
    is its plain version's (by the dtype's criterion), and a repeat of the
    first call gives its result bit for bit (nothing read from a stale
    output, no order between threads)."""
    b, t1, s, heads, dh = TEMPORAL_SHAPES[0]
    (qa, ga), (qb, gb) = (
        (t.to(dtype) for t in _temporal_qkv(cuda, b, t1, s, heads, dh,
                                            seed=seed)) for seed in (0, 1))
    inner = heads * dh
    for kern, plain, args_a, args_b, parts in (
            (attention.temporal_attention_packed,
             attention.temporal_packed_plain, (qa, heads), (qb, heads), 1),
            (attention.temporal_attention_packed_bwd,
             attention.temporal_packed_bwd_plain, (qa, ga, heads),
             (qb, gb, heads), 3)):
        first = kern(*args_a).clone()
        torch.cuda.synchronize()
        got = kern(*args_b)
        with highest():
            want = plain(*args_b)
        torch.cuda.synchronize()
        got3, want3 = got.split(inner, dim=-1), want.split(inner, dim=-1)
        assert len(got3) == parts
        if dtype == torch.float32 and parts == 1:
            assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
        elif dtype == torch.float32:
            for a, w in zip(got3, want3):
                assert (a - w).abs().max() <= 1e-5 * w.abs().max()
        else:
            ok, rel, mx, scale = selfcheck.bf16_close(got3, want3)
            assert ok, (rel, mx, scale)
        del got, got3
        again = kern(*args_a)
        torch.cuda.synchronize()
        assert torch.equal(again, first)


def test_temporal_kernels_build_without_spills(cuda):
    """Every instantiation of #11 and #12 that attention.temporal_plan can
    pick is in the built library (selfcheck.TEMPORAL_KERNELS), and ptxas
    reports no spill for any (build/build.log)."""
    _lib.load()
    report = _lib.ptxas_report((_lib.BUILD_DIR / "build.log").read_text())
    for kernel, regs, spilled in selfcheck.spill_rows(
            report, selfcheck.TEMPORAL_KERNELS):
        assert len(regs) == selfcheck.TEMPORAL_KERNELS[kernel], (kernel, regs)
        assert not spilled, (kernel, spilled)


@pytest.mark.parametrize("t1, dh", [(9, 64), (17, 16), (33, 32), (17, 128),
                                    (9, 20)])
def test_unpacked_temporal_matches_plain_at_long_clips(cuda, record_property,
                                                      t1, dh):
    """#16 and #17 past T1 = 8 (their general kernels: rows read again each
    sweep, dk / dv summed in the outputs) against their plain versions: f32
    at atol = rtol = 1e-5 (#17 per output at 1e-5 of its scale), bf16 by the
    bf16 criterion, the share equal bit for bit recorded."""
    g = torch.Generator().manual_seed(t1 * 1000 + dh)
    t = [torch.randn(2, t1, 29, 3 * dh, generator=g).to(cuda)
         for _ in range(4)]
    for dt in (torch.float32, torch.bfloat16):
        x = [u.to(dt) for u in t]
        with highest():
            got = (attention.fused_temporal_attention(*x[:3], 3),
                   *attention.fused_temporal_attention_bwd(*x, 3))
            want = (attention.fused_temporal_attention_plain(*x[:3], 3),
                    *attention.fused_temporal_attention_bwd_plain(*x, 3))
        torch.cuda.synchronize()
        if dt == torch.float32:
            assert torch.allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
            for a, w in zip(got[1:], want[1:]):
                assert (a - w).abs().max() <= 1e-5 * w.abs().max()
        else:
            ok, rel, mx, scale = selfcheck.bf16_close(got, want)
            record_property("bf16_bit_equal",
                            selfcheck.bit_equal_share(got, want))
            assert ok, (rel, mx, scale)


@pytest.mark.parametrize("kernel, dtype", [
    *((k, "bf16") for k in selfcheck.TENSOR_CORE_KERNELS),
    *((k, "f32") for k in selfcheck.TF32_MMA_KERNELS
      + selfcheck.TF32_WGMMA_KERNELS)])
def test_spatial_attention_on_the_tensor_cores(cuda, kernel, dtype):
    """From the built library (cuobjdump -sass): every bf16 instantiation
    of the kernels that run the spatial core (#10 and #2's
    spatial_attn_kernel, #14 / #15's frame_attn_kernel, #9's
    st_layer_q8_kernel) or #13 (both passes) has tensor-core instructions
    (HMMA / HGMMA; #9's int8 IMMA does not count), every f32 one TF32
    mma.sync (HMMA.1688.F32.TF32: the f32 tile's three TF32 products),
    every instantiation of the bf16 float GEMM has wgmma (HGMMA) and every
    one of the f32 float GEMM TF32 wgmma (HGMMA.64x128x8.F32.TF32)."""
    _lib.load()
    sass = _lib.sass_text()
    rows = selfcheck.tensor_core_check(
        _lib.tensor_ops_of_sass(sass),
        _lib.tensor_ops_of_sass(sass, ("HGMMA.",)),
        tf32=_lib.tensor_ops_of_sass(sass, (selfcheck.TF32_WGMMA_OP,)),
        tf32_mma=_lib.tensor_ops_of_sass(sass, (selfcheck.TF32_MMA_OP,)))
    (found, ok), = [(f, o) for k, d, f, o in rows
                    if k == kernel and d == dtype]
    assert ok, found


def test_spatial_attention_kernels_build_without_spills(cuda):
    """ptxas reports no spill for any f32 instantiation of the spatial
    core's kernels and #13's two passes (selfcheck.SPATIAL_KERNELS: every
    dim_head, packed and unpacked); #9, whose f32 spatial phase runs the
    same tile, is held to its 168 registers with the wgmma kernels
    (test_st_layer_q8_runs_int8_wgmma_without_spills). (The bf16 pass (a)
    of #13's unpacked entry at dim_head 16 spills 12 bytes, as it did
    before the f32 tiles came; its code is unchanged.)"""
    _lib.load()
    report = _lib.ptxas_report((_lib.BUILD_DIR / "build.log").read_text())
    for kernel, regs, spilled in selfcheck.spill_rows(
            report, selfcheck.SPATIAL_KERNELS):
        f32 = [n for n in regs if f"{len(kernel)}{kernel}If" in n]
        assert f32 and not set(f32) & set(spilled), (kernel, regs, spilled)



def test_mma_sync_tf32_sums_round_toward_zero(cuda, tmp_path):
    """Why the f32 spatial tiles start a fresh sum every 32-deep k-step
    (csrc/attention_tf32.cuh): mma.sync's TF32 products round their f32 sum
    toward zero, as wgmma's do. tools/mma_tf32_probe.cu adds one product of
    0.75 ulp to +1 and to -1 on one lane and reads back +1 and -1."""
    src = Path(__file__).resolve().parent.parent / "tools" / \
        "mma_tf32_probe.cu"
    exe = tmp_path / "mma_tf32_probe"
    subprocess.run([_lib._nvcc(), *_lib.ARCH_FLAGS, "-O3", "-o", str(exe),
                    str(src)], check=True, capture_output=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout
    assert "rounded toward zero" in out, out

def test_f32_gemm_builds_at_its_register_budget(cuda):
    """ptxas reports each of the f32 GEMM's five instantiations (three
    layouts without an epilogue kind of their own, the stash, the GELU
    backward) at exactly the 168 registers its setmaxnreg split needs, with
    no byte spilled, and no note that it serialized the kernel's wgmma."""
    _lib.load()
    log = (_lib.BUILD_DIR / "build.log").read_text()
    rows = {k: (regs, off) for k, regs, off in selfcheck.wgmma_register_rows(
        _lib.ptxas_report(log))}
    regs, off = rows["gemm_f32_wgmma_kernel"]
    assert len(regs) == 5 and not off, (regs, off)
    assert not [ln for ln in log.splitlines() if "serialized" in ln
                and "gemm_f32_wgmma_kernel" in ln]


# the float GEMM alone: every caller's launch at the slice, and edges of
# each layout (M of 1, 7, 129 rows; K of 8, 24 and the model's 728 / 2912,
# whose k-tail the TMA zero-fills; N of 8 and off the 128-wide tile) with
# every epilogue in both output dtypes; tn at K = 5152 and 41216, which
# plan_splitk splits (3 and 5 slices on 132 SMs)
_GEMM_EDGES = {"nn": [(1, 8, 8), (7, 728, 24), (129, 1536, 728),
                      (5068, 728, 2912)],
               "nt": [(1, 8, 8), (7, 1536, 24), (129, 728, 2912),
                      (5068, 8, 728)],
               "tn": [(8, 8, 8), (136, 728, 24), (728, 1536, 5152),
                      (512, 728, 41216)]}
GEMM_CASES = [*selfcheck.gemm_shapes().values(), *(
    (layout, m, n, k, epi, dt)
    for layout, shapes in _GEMM_EDGES.items() for m, n, k in shapes
    for epi, dt in [*((e, d) for e in selfcheck.GEMM_EPILOGUES[:5]
                      for d in (torch.bfloat16, torch.float32)),
                    *((("stash", torch.bfloat16),) if layout == "nn" else ()),
                    *((("gelu_bwd", torch.bfloat16),) if layout == "nt"
                      else ())])]


@pytest.mark.parametrize(
    "layout, m, n, k, epilogue, out_dtype", GEMM_CASES,
    ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-{c[4]}-{str(c[5])[6:]}"
         for c in GEMM_CASES])
def test_gemm_matches_plain_at_more_shapes(cuda, record_property, layout, m,
                                           n, k, epilogue, out_dtype):
    """The bf16 wgmma GEMM (kernels/linear.gemm) against its plain f32
    version (selfcheck.gemm_plain) by the bf16 criterion, every output
    (out, the stash or gelu(aux), the column-sum partials); the split-K
    plan of a tn product recorded."""
    ops = selfcheck.gemm_operands(layout, m, n, k, epilogue, out_dtype, cuda,
                                  seed=m + 3 * n + 7 * k)
    selfcheck.run_gemm(ops)
    with highest():
        want = selfcheck.gemm_plain(ops)
    torch.cuda.synchronize()
    got = selfcheck.gemm_results(ops)
    ok, rel, mx, scale = selfcheck.bf16_close(got, want)
    record_property("rel_l2", rel)
    if layout == "tn":
        record_property("splits", linear.plan_splitk(
            m, n, k, torch.cuda.get_device_properties(cuda).
            multi_processor_count).splits)
    assert ok, (rel, mx, scale)


def test_gemm_raises_what_it_cannot_take(cuda):
    """No other route: a bf16 GEMM that the wgmma kernel does not take
    raises (the wrapper's checks, or the C entry's refusal through
    _lib.check), it is never computed another way."""
    bf = torch.bfloat16
    a, b = (torch.zeros(64, 64, device=cuda, dtype=bf) for _ in range(2))
    out = torch.empty(64, 64, device=cuda, dtype=bf)
    with pytest.raises(RuntimeError, match="gemm"):       # stash on nt
        linear.gemm(a, b, out, layout="nt", out2=torch.empty_like(out))
    with pytest.raises(RuntimeError, match="gemm"):       # f32 dh1
        linear.gemm(a, b, out.float(), layout="nt", aux=out, out2=out,
                    part=torch.empty(1, 64, device=cuda))
    with pytest.raises(ValueError, match="divisible by 8"):
        linear.gemm(torch.zeros(64, 60, device=cuda, dtype=bf),
                    torch.zeros(60, 64, device=cuda, dtype=bf), out)
    with pytest.raises(ValueError, match="aligned"):
        linear.gemm(torch.zeros(64 * 64 + 1, device=cuda, dtype=bf)[1:]
                    .view(64, 64), b, out)


# the f32 GEMM alone (three TF32 products): every caller's launch at the
# slice and at the B=16 step's rows, in f32, and the edges of each layout
# with every epilogue (tn at K = 5152 and 41216 split along K)
GEMM_F32_CASES = [
    *selfcheck.gemm_shapes(dtype=torch.float32).values(),
    *selfcheck.gemm_shapes({**selfcheck.SLICE, "b": 16},
                           torch.float32).values(),
    *((layout, m, n, k, epi, torch.float32)
      for layout, shapes in _GEMM_EDGES.items() for m, n, k in shapes
      for epi in [*selfcheck.GEMM_EPILOGUES[:5],
                  *(("stash",) if layout == "nn" else ()),
                  *(("gelu_bwd",) if layout == "nt" else ())])]


@pytest.mark.parametrize(
    "layout, m, n, k, epilogue, out_dtype", GEMM_F32_CASES,
    ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-{c[4]}" for c in GEMM_F32_CASES])
def test_gemm_f32_matches_plain(cuda, record_property, layout, m, n, k,
                                epilogue, out_dtype):
    """The f32 GEMM (kernels/linear.gemm on f32 inputs: three TF32
    products on wgmma) against the plain f32 product (TF32 off) by the f32
    criterion, every output: nn and nt at atol = rtol = 1e-5, tn (weight
    gradients) at max|diff| <= 1e-5 max|plain| (selfcheck.gemm_f32_close);
    a second call gives the same bits."""
    ops = selfcheck.gemm_operands(layout, m, n, k, epilogue, out_dtype, cuda,
                                  seed=m + 3 * n + 7 * k,
                                  dtype=torch.float32)
    selfcheck.run_gemm(ops)
    with highest():
        want = selfcheck.gemm_plain(ops)
    torch.cuda.synchronize()
    got = [t.clone() for t in selfcheck.gemm_results(ops)]
    ok, err = selfcheck.gemm_f32_close(ops, got, want)
    record_property("err", err)
    assert ok, err
    selfcheck.run_gemm(ops)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(
        got, selfcheck.gemm_results(ops)))


@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
def test_gemm_f32_non_finite_inputs(cuda, layout):
    """An inf or NaN in either f32 input (linear.gemm's stated limit of the
    TF32 split): exactly the outputs that the plain f32 product makes
    non-finite are non-finite (NaN, where the plain product may give
    +-inf), and the others still meet the f32 criterion."""
    ops = selfcheck.gemm_operands(layout, 256, 256, 512, "bias", torch.float32,
                                  cuda, seed=11, dtype=torch.float32)
    a, b = ops["a"], ops["b"]
    # a's element of output row 3 and a NaN in row 7; b's element of column 9
    a[(5, 3) if layout == "tn" else (3, 5)] = float("inf")
    a[(2, 7) if layout == "tn" else (7, 2)] = float("nan")
    b[(9, 4) if layout == "nt" else (4, 9)] = float("-inf")
    selfcheck.run_gemm(ops)
    with highest():
        want = selfcheck.gemm_plain(ops)
    torch.cuda.synchronize()
    got = selfcheck.gemm_results(ops)
    for g, w in zip(got, want):
        assert torch.equal(torch.isfinite(g), torch.isfinite(w))
        assert not torch.isfinite(w[[3, 7]]).any()
        assert not torch.isfinite(w[:, 9]).any()
    finite = [torch.where(torch.isfinite(t), t, 0) for t in got]
    ok, err = selfcheck.gemm_f32_close(
        ops, finite, [torch.where(torch.isfinite(t), t, 0) for t in want])
    assert ok, err


def test_gemm_f32_raises_what_it_cannot_take(cuda):
    """No other route for f32 either: what the f32 GEMM does not take
    raises, it is never computed on the FMA pipes or by a plain version."""
    f32 = torch.float32
    a, b = (torch.zeros(64, 64, device=cuda) for _ in range(2))
    out = torch.empty(64, 64, device=cuda)
    with pytest.raises(RuntimeError, match="gemm"):       # stash on nt
        linear.gemm(a, b, out, layout="nt", out2=torch.empty_like(out))
    with pytest.raises(RuntimeError, match="gemm"):       # GELU bwd on nn
        linear.gemm(a, b, out, aux=out, out2=torch.empty_like(out),
                    part=torch.empty(1, 64, device=cuda))
    with pytest.raises(TypeError, match="output"):        # bf16 out
        linear.gemm(a, b, out.to(torch.bfloat16))
    with pytest.raises(ValueError, match="divisible by 8"):
        linear.gemm(torch.zeros(64, 60, device=cuda),
                    torch.zeros(60, 64, device=cuda), out)
    with pytest.raises(ValueError, match="aligned"):
        linear.gemm(torch.zeros(64 * 64 + 1, device=cuda, dtype=f32)[1:]
                    .view(64, 64), b, out)
    with pytest.raises(ValueError, match="CUDA"):
        linear.gemm(a.cpu(), b, out)


# the int8 GEMM alone: every caller's launch at the slice and at the B=16
# forward's rows (activations in bf16, and at the slice in f32 too: the f32
# instantiations), then each caller's (N, K, epilogue) at M of 1, 129 and
# 5,153 rows (off the 128-row tile)
_Q8_SHAPES = {**selfcheck.gemm_q8_shapes(),
              **{f"{n} f32": s for n, s in selfcheck.gemm_q8_shapes(
                  dtype=torch.float32).items()},
              **{f"{n} B=16": s for n, s in selfcheck.gemm_q8_shapes(
                  {**selfcheck.SLICE, "b": 16}).items()},
              **{f"{n} M={m}": (m, *s[1:]) for n, s in
                 selfcheck.gemm_q8_shapes().items() for m in (1, 129, 5153)}}


@pytest.mark.parametrize("shape", _Q8_SHAPES.values(), ids=_Q8_SHAPES.keys())
def test_gemm_q8_matches_plain(cuda, record_property, shape):
    """The int8 wgmma GEMM (quant.gemm_q8) against its plain version (the
    exact int8 dot in float64, the same f32 epilogue in the same order):
    equal bit for bit without GELU (exact int32 sums, the same IEEE f32
    operations), within atol = rtol = 2e-3 with it (tanhf against torch's
    tanh); the share of equal elements recorded."""
    m, n, k, out_dtype, res_dtype, bias, gelu = shape
    ops = selfcheck.gemm_q8_operands(*shape, cuda, seed=m + 3 * n + 7 * k)
    selfcheck.run_gemm_q8(ops)
    want = selfcheck.gemm_q8_plain(ops)
    torch.cuda.synchronize()
    got = ops["out"]
    share = selfcheck.bit_equal_share(got, want)
    record_property("bit_equal", share)
    if gelu:
        tol = selfcheck.F32_TOL_INT8
        assert torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    else:
        assert share == 1.0, (share, (got.float() - want.float()).abs().max())


@pytest.mark.parametrize("k", [728, 20, 512])
def test_gemm_q8_never_reads_the_pad_bytes(cuda, k):
    """Codes and K-major weight with their pad bytes (past K in each row;
    512 has none) set to 127 give the same bits as with zeros there, and
    as the plain version: the tensor maps end at K."""
    outs = []
    for pad in (0, 127):
        ops = selfcheck.gemm_q8_operands(300, 256, k, torch.float32,
                                         torch.bfloat16, True, False, cuda,
                                         seed=5, pad=pad)
        selfcheck.run_gemm_q8(ops)
        outs.append(ops["out"])
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[1], selfcheck.gemm_q8_plain(ops))


def test_int8_wrappers_build_missing_copies_in_the_call(cuda):
    """An int8 wrapper given no K-major copies builds them on the card in
    the call (counted in _lib.KMAJOR_BUILDS, one per int8 weight) and
    returns the same bits as with the prebuilt ones; given them, it builds
    none."""
    cases = selfcheck.slice_cases(cuda, selfcheck.SMALL)
    for name in selfcheck.INT8_CASES:
        kern, _, make = cases[name]
        args = make(torch.bfloat16)
        _lib.reset_launches()
        given = kern(*args)
        assert _lib.KMAJOR_BUILDS["q8_kmajor"] == 0, name
        built = kern.func(*args)
        torch.cuda.synchronize()
        assert _lib.KMAJOR_BUILDS["q8_kmajor"] == len(kern.keywords["wk"])
        assert torch.equal(given, built), name


def test_gemm_q8_refuses_what_it_cannot_take(cuda):
    """No other route: codes at another row stride, a weight that is not
    its K-major copy, a host tensor, N not divisible by 4, or a wrapper
    given a wrong copy: ValueError."""
    ops = selfcheck.gemm_q8_operands(64, 64, 728, torch.float32, None, False,
                                     False, cuda)
    q, wk, rs, ws, out = (ops[n] for n in ("q", "wk", "rs", "ws", "out"))
    with pytest.raises(ValueError, match="bytes apart"):
        quant.gemm_q8(q.contiguous(), wk, rs, ws, out)
    with pytest.raises(ValueError, match="K-major"):
        quant.gemm_q8(q, ops["wq"].t().contiguous(), rs, ws, out)
    with pytest.raises(ValueError, match="CUDA"):
        quant.gemm_q8(q, wk.cpu(), rs, ws, out)
    with pytest.raises(ValueError, match="divisible by 4"):
        quant.gemm_q8(q, wk[:62].contiguous(), rs, ws[:62],
                      out[:, :62].contiguous())
    kern, _, make = selfcheck.slice_cases(cuda, selfcheck.SMALL)[
        "ln_matmul_q8"]
    x, s, b, wq, ws = make(torch.float32)
    with pytest.raises(ValueError, match="K-major copy"):   # not (N, Kp)
        quant.ln_matmul_q8(x, s, b, wq, ws, wk=(wq.contiguous(),))


def test_f8_cast_same_on_card_and_cpu(cuda):
    """The f8 stem store rounds the same on the card as on the CPU, NaN
    past the +-464 tie included."""
    x = torch.cat([torch.linspace(-500, 500, 20001),
                   torch.tensor([464.0, -464.0, 0.5 ** 10, 1e-12])])
    for dt in (torch.float32, torch.bfloat16):
        cpu = to_store(x.to(dt), torch.float8_e4m3fn).float()
        card = to_store(x.to(dt).cuda(), torch.float8_e4m3fn).float().cpu()
        assert cpu.isnan().sum() > 0
        assert torch.equal(cpu.nan_to_num(1e9), card.nan_to_num(1e9))


def test_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    cases = selfcheck.slice_cases(cuda, selfcheck.SMALL)
    kern, _, make = cases["ln_qkv_q8_temporal_attention"]
    x, *rest = make(torch.float32)
    with pytest.raises(TypeError):
        kern(x.half(), *rest)
    with pytest.raises(ValueError):
        kern(x.transpose(1, 2), *rest)
    # S = 392, past the 384 the cores once took: run, and held to the plain
    # version
    qkv = torch.randn(2, 392, 3 * 512, generator=torch.Generator()
                      .manual_seed(392)).to(cuda)
    with highest():
        got = attention.spatial_attention_packed(qkv, 8, 362)
        want = attention.spatial_packed_plain(qkv, 8, 362)
    torch.cuda.synchronize()
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="dim_head"):
        attention.spatial_attention_packed(qkv[:, :368].contiguous(), 12,
                                           362)
    a = torch.zeros(16, 724, device=cuda)                # K % 8 != 0
    with pytest.raises(ValueError, match="divisible by 8"):
        linear.matmul_bias_residual(a, torch.zeros(724, 728, device=cuda),
                                    torch.zeros(728, device=cuda))


def test_train_step_on_card_matches_cpu(cuda):
    """One bf16 train step of a small float fused ISTVT on the card
    (kernels, their backward kernels) against the same step in f32 on the
    CPU (plain versions): loss within 5e-2, gradient cosine >= 0.99, and
    every backward kernel launched its count per layer."""
    import copy

    from istvt_tpu_torch.core.config import ISTVTConfig, TrainConfig
    from istvt_tpu_torch.models import istvt
    from istvt_tpu_torch.train import schedule, step

    cfg = ISTVTConfig(num_frames=2, image_size=72, feat_hw=5, depth=2,
                      use_pallas=True, dropout=0.0)
    cpu = istvt.init(cfg, torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda)
    g = torch.Generator().manual_seed(1)
    batch = {"clips": torch.randn(2, 2, 72, 72, 3, generator=g),
             "labels": torch.tensor([0, 1])}
    opt = step.make_optimizer(TrainConfig(checkpoint_dir=""),
                              schedule.constant_schedule(1e-4))
    grads, losses = [], []
    _lib.reset_launches()
    for model, dt in ((card, torch.bfloat16), (cpu, None)):
        ts = step.create_train_state(model, opt)
        with highest():
            m = step.make_train_step(compute_dtype=dt)(ts, batch)
        losses.append(float(m["loss"]))
        grads.append(torch.cat([p.grad.double().cpu().ravel()
                                for p in model.parameters()]))
    torch.cuda.synchronize()
    per_layer = {"temporal_attention_packed/bwd": 1,
                 "spatial_attention_packed/bwd": 1, "ln_matmul/bwd": 2,
                 "ln_ff_residual/h1": 1, "ln_ff_residual/bwd": 1,
                 "ln_ff_residual": 0}
    for name, n in per_layer.items():
        assert _lib.LAUNCHES[name] == n * cfg.depth, (name, _lib.LAUNCHES)
    assert abs(losses[0] - losses[1]) <= 5e-2, losses
    cos = torch.nn.functional.cosine_similarity(grads[0], grads[1], dim=0)
    assert cos >= 0.99, cos


def test_attention_map_path_on_card_matches_cpu(cuda):
    """The attention-map path of a small ISTVT (use_pallas: its
    feed-forward is fused_ff, #22) on the card against the CPU's plain
    versions, f32: generate_lrp's cams at rel-L2 <= 1e-3 and fused_ff
    launched once per layer; its backward (plain recompute) launches
    nothing."""
    from istvt_tpu_torch.core.config import ISTVTConfig
    from istvt_tpu_torch.interpret import generate_lrp
    from istvt_tpu_torch.models import istvt

    cfg = ISTVTConfig(num_frames=2, image_size=72, feat_hw=5, depth=2,
                      use_pallas=True)
    cpu = istvt.init(cfg, torch.Generator().manual_seed(0))
    card = istvt.init(cfg, torch.Generator().manual_seed(0), cuda)
    clips = torch.randn(1, 2, 72, 72, 3, generator=torch.Generator()
                        .manual_seed(1))
    with highest():
        want = generate_lrp(cpu, clips)
        _lib.reset_launches()
        got = generate_lrp(card, clips.to(cuda))
        torch.cuda.synchronize()
    assert _lib.LAUNCHES == {**dict.fromkeys(_lib.LAUNCHES, 0),
                             "fused_ff": cfg.depth}
    for g, w in zip(got, want):
        rel = (g.cpu() - w).norm() / w.norm().clamp_min(1e-30)
        assert rel <= 1e-3, rel


@pytest.mark.parametrize("q8_ff, q8_attn", [("full", "boundary"),
                                            ("mixed", "ingest"),
                                            ("bf16", "ingest"),
                                            ("full", "layer"),
                                            ("int8", "ingest")])
def test_int8_mode_on_card_matches_cpu(cuda, q8_ff, q8_attn):
    """A small int8 ISTVT in each A/B mode, as cli/serve.py --int8 builds
    it (bf16 parameters, quantize_params, then pack_params for the FF's
    float copies): the card's logits (kernels, bf16) against the CPU's
    (plain versions, f32) within 5e-2, each mode's kernels launched once
    per layer (ln_matmul_q8 twice in the q8 blocks; st_layer_q8 alone for
    q8_attn='layer'), every other counter 0, and no K-major weight copy
    built in a call."""
    import copy

    from istvt_tpu_torch.core import tree
    from istvt_tpu_torch.core.config import ISTVTConfig
    from istvt_tpu_torch.models import istvt

    cfg = ISTVTConfig(num_frames=2, image_size=72, feat_hw=5, depth=2,
                      use_pallas=True, quantize="int8", q8_ff=q8_ff,
                      q8_attn=q8_attn)
    card = tree.cast(istvt.init(cfg, torch.Generator().manual_seed(0), cuda),
                     torch.bfloat16)
    istvt.pack_params(istvt.quantize_params(card))
    cpu = istvt.pack_params(tree.cast(copy.deepcopy(card).cpu(),
                                      torch.float32))
    clips = torch.randn(2, 2, 72, 72, 3, generator=torch.Generator()
                        .manual_seed(1))
    _lib.reset_launches()
    with torch.inference_mode():
        got = card(clips.to(cuda, torch.bfloat16)).float().cpu()
        torch.cuda.synchronize()
        counts = dict(_lib.LAUNCHES)
        with highest():
            want = cpu(clips)
    ff_kernel = {"mixed": "ln_ff_residual_q8",
                 "bf16": "ln_ff_residual"}.get(q8_ff, "ln_ff_residual_q8_full")
    if q8_attn == "layer":
        per_layer = {"st_layer_q8": 1}
    elif q8_ff == "full":
        per_layer = {"ln_matmul_q8": 1, "matmul_q8_ln_matmul_q8": 1,
                     "matmul_q8_res_ln_ff_q8_full": 1}
    else:
        per_layer = {"ln_matmul_q8": 2, "matmul_q8_bias_residual": 1,
                     "matmul_q8_bias_residual/no_r": 1, ff_kernel: 1}
    if q8_attn != "layer":
        per_layer.update(temporal_attention_packed=1,
                         spatial_attention_packed=1)
    assert counts == {**dict.fromkeys(counts, 0),
                      **{n: k * cfg.depth for n, k in per_layer.items()}}
    assert _lib.KMAJOR_BUILDS["q8_kmajor"] == 0     # the model's copies
    assert (got - want).abs().max() <= 5e-2, (got, want)


@pytest.mark.parametrize("flags, per_layer", [
    (["--int8"], {"ln_qkv_q8_temporal_attention": 1,
                  "mm_q8_ln_qkv_q8_spatial_attention": 1,
                  "matmul_q8_res_ln_ff_q8_full": 1}),
    (["--bf16"], {"ln_matmul": 2, "temporal_attention_packed": 1,
                  "spatial_attention_packed": 1, "matmul_bias_residual": 1,
                  "matmul_bias_residual/no_r": 1, "ln_ff_residual": 1})],
    ids=["int8", "bf16"])
def test_artifact_on_card_matches_the_live_model(cuda, tmp_path, flags,
                                                 per_layer):
    """A small model exported on the card (serve_export, its kernels as
    istvt:: ops), reloaded: over 3 clips in buckets (2, 4) its logits equal
    the live Predictor's within 1e-3 (bit for bit expected: the same
    kernels on the same weights), and its forwards launch exactly the
    live forwards' kernels, the model's K-major copies built 0 times."""
    import numpy as np

    from istvt_tpu_torch import serve_export
    from istvt_tpu_torch.cli.serve import build_parser, build_predictor

    args = build_parser().parse_args(flags + [
        "-sl", "2", "-is", "72", "--depth", "2", "--buckets", "2", "4"])
    live = build_predictor(args, cuda)
    out = str(tmp_path / "artifact")
    manifest = serve_export.save_artifact(
        out, live.model, input_shape=(2, 72, 72, 3), batch_sizes=(2, 4),
        input_dtype=torch.bfloat16)
    assert manifest["platforms"] == ["cuda"]
    scorer = serve_export.load_artifact(out)
    clips = np.random.RandomState(3).randn(3, 2, 72, 72, 3).astype(
        np.float32)
    counts = []
    for pred in (scorer, live):
        torch.cuda.synchronize()
        _lib.reset_launches()
        pred.n_forwards = 0
        logits = pred.predict(clips)["logits"]
        torch.cuda.synchronize()
        counts.append(dict(_lib.LAUNCHES))
        assert pred.n_forwards == 1
        assert counts[-1] == {**dict.fromkeys(_lib.LAUNCHES, 0),
                              **{n: k * 2 for n, k in per_layer.items()}}
        assert _lib.KMAJOR_BUILDS["q8_kmajor"] == 0
        if pred is scorer:
            got = logits
    assert np.abs(got - logits).max() <= 1e-3, (got, logits)


def _layer_case(cuda, **geometry):
    """st_layer_q8's selfcheck case at SLICE with `geometry` changed."""
    return selfcheck.slice_cases(cuda, {**selfcheck.SLICE, **geometry})[
        "st_layer_q8"]


@pytest.mark.parametrize("b, n_valid", [(1, 362), (3, 362), (2, 368)])
def test_st_layer_q8_rows_off_the_tile_and_masks(cuda, b, n_valid):
    """#9 at B=1 and B=3 (2,576 and 7,728 rows: neither fills the 128-row
    GEMM tile) and without masked keys, in f32 and bf16, against its plain
    version by selfcheck's criteria; one launch per call."""
    kern, plain, make = _layer_case(cuda, b=b, n_valid=n_valid)
    args = make(torch.float32)
    _lib.reset_launches()
    with highest():
        got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["st_layer_q8"] == 1
    ok, err = selfcheck.f32_close("st_layer_q8", got, want)
    assert ok, f"max|diff| {err}"
    args = make(torch.bfloat16)
    ok, rel, mx, scale = selfcheck.bf16_close(kern(*args), plain(*args))
    assert ok, (rel, mx, scale)


def test_st_layer_q8_equals_the_ingest_chain(cuda):
    """One launch of #9 equals #1 -> #2 -> #3 on the card bit for bit, in
    f32 and bf16: the same device code in the same order."""
    from istvt_tpu_torch.kernels import quant

    _, _, make = _layer_case(cuda)
    for dt in (torch.float32, torch.bfloat16):
        (x, st, bt, wqt, wst, wot, sot, bot, ss, bs, wqs, wss, wos, sos, bos,
         sf, bf, w1q, w1s, b1, w2q, w2s, b2, heads, n_valid) = make(dt)
        b, t1, s, d = x.shape
        a_t = quant.ln_qkv_q8_temporal_attention(x, st, bt, wqt, wst, heads)
        a_s = quant.mm_q8_ln_qkv_q8_spatial_attention(
            a_t.reshape(b * t1, s, -1), wot, sot, bot, ss, bs, wqs, wss, heads,
            n_valid)
        want = quant.matmul_q8_res_ln_ff_q8_full(
            a_s.reshape(b, t1 * s, -1), x.reshape(b, t1 * s, d), wos, sos, bos,
            sf, bf, w1q, w1s, b1, w2q, w2s, b2).reshape(x.shape)
        got = quant.st_layer_q8(*make(dt))
        torch.cuda.synchronize()
        assert torch.equal(got, want), (dt, (got - want).abs().max())


def _ingest_chain(args, wk):
    """#1 -> #2 -> #3 on st_layer_q8's arguments and K-major copies: the
    chain #9 equals bit for bit."""
    (x, st, bt, wqt, wst, wot, sot, bot, ss, bs, wqs, wss, wos, sos, bos, sf,
     bf, w1q, w1s, b1, w2q, w2s, b2, heads, n_valid) = args
    kqt, kot, kqs, kos, k1, k2 = wk
    b, t1, s, d = x.shape
    a_t = quant.ln_qkv_q8_temporal_attention(x, st, bt, wqt, wst, heads,
                                             wk=(kqt,))
    a_s = quant.mm_q8_ln_qkv_q8_spatial_attention(
        a_t.reshape(b * t1, s, -1), wot, sot, bot, ss, bs, wqs, wss, heads,
        n_valid, wk=(kot, kqs))
    return quant.matmul_q8_res_ln_ff_q8_full(
        a_s.reshape(b, t1 * s, -1), x.reshape(b, t1 * s, d), wos, sos, bos,
        sf, bf, w1q, w1s, b1, w2q, w2s, b2, wk=(kos, k1, k2)).reshape(x.shape)


# #9's geometries against the chain: the slice (5,152 rows, 362 of 368 keys
# valid), the B=16 forward's 41,216 rows, B=1 (2,576 rows: 20 tiles and a
# ragged one), every key valid, and the small dim_head-16 geometry
_LAYER_GEOMETRIES = {"slice": selfcheck.SLICE,
                     "B=16": {**selfcheck.SLICE, "b": 16},
                     "B=1": {**selfcheck.SLICE, "b": 1},
                     "n_valid=S": {**selfcheck.SLICE, "n_valid": 368},
                     "small": selfcheck.SMALL,
                     # --seq_len 8 at -is 320 (phase 3's general lane, the
                     # spatial phase past 384 keys), and a longer clip
                     "T1=9,S=408": {**selfcheck.SLICE, "t1": 9, "s": 408,
                                    "n_valid": 401},
                     "T1=17,small": {**selfcheck.SMALL, "t1": 17}}


@pytest.mark.parametrize("geometry", _LAYER_GEOMETRIES.values(),
                         ids=_LAYER_GEOMETRIES.keys())
def test_st_layer_q8_equals_the_chain_at_more_shapes(cuda, geometry):
    """#9, its GEMM phases on s8 wgmma inside the cooperative kernel, equals
    #1 -> #2 -> #3 (the standalone wgmma GEMM) bit for bit in f32 and bf16,
    both given the same K-major copies; one launch of #9, no copy built."""
    kern, _, make = selfcheck.slice_cases(cuda, geometry)["st_layer_q8"]
    for dt in (torch.float32, torch.bfloat16):
        args = make(dt)
        _lib.reset_launches()
        got = kern(*args)
        assert _lib.LAUNCHES["st_layer_q8"] == 1
        want = _ingest_chain(args, kern.keywords["wk"])
        torch.cuda.synchronize()
        assert _lib.KMAJOR_BUILDS["q8_kmajor"] == 0
        assert torch.equal(got, want), (dt, (got - want).abs().max())


def test_st_layer_q8_back_to_back_calls_read_their_own_codes(cuda):
    """Two calls queued back to back on different inputs (the second's
    workspace is the first's memory again, from the caching allocator) each
    equal the chain on their own input: no GEMM phase reads codes by TMA
    from before the row pass that wrote them."""
    kern, _, make = _layer_case(cuda)
    for dt in (torch.float32, torch.bfloat16):
        args = make(dt)
        x2 = torch.randn(args[0].shape, generator=torch.Generator()
                         .manual_seed(9)).to(cuda, dt)
        x2[:, :, args[-1]:] = 0
        args2 = [x2, *args[1:]]
        got = [kern(*args), kern(*args2)]
        want = [_ingest_chain(a, kern.keywords["wk"]) for a in (args, args2)]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (dt, (g - w).abs().max())
        assert not torch.equal(got[0], got[1])


def test_st_layer_q8_never_reads_the_pad_bytes(cuda):
    """The K-major copies with their pad bytes (past K = 728 in each row of
    the QKV and fc1 copies) set to 127 give the same bits: the tensor maps
    end at K."""
    kern, _, make = _layer_case(cuda, b=1)
    args = make(torch.bfloat16)
    padded = []
    for c, w in zip(kern.keywords["wk"], (args[i] for i in (3, 5, 10, 12,
                                                             17, 20))):
        c = c.clone()
        c[:, w.shape[0]:] = 127
        padded.append(c)
    assert sum(int((c == 127).sum()) for c in padded) > 0
    got = kern.func(*args, wk=tuple(padded))
    want = kern(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_st_layer_q8_phase_stamps(cuda):
    """The stamped instantiation (tools/kernel_ms.py --layer-phases) returns
    the same bits and 15 increasing %globaltimer stamps; dim_head 16 and
    CPU tensors refuse stamps."""
    kern, _, make = _layer_case(cuda, b=1)
    args = make(torch.bfloat16)
    stamps = torch.zeros(quant.LAYER_STAMPS, dtype=torch.int64, device=cuda)
    got = kern(*args, stamps=stamps)
    want = kern(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    t = stamps.cpu()
    assert (t[1:] > t[:-1]).all(), t
    small = selfcheck.slice_cases(cuda, selfcheck.SMALL)["st_layer_q8"]
    with pytest.raises(ValueError, match="dim_head 64"):
        small[0](*small[2](torch.bfloat16), stamps=stamps)


def test_st_layer_q8_runs_int8_wgmma_without_spills(cuda):
    """From the built library: every instantiation of #9 (f32 and bf16 at
    dim_head 16, 64 and 64 stamped) has int8 wgmma (IGMMA) and no int8
    mma.sync (IMMA), as the standalone int8 GEMM; ptxas reports each, and
    each instantiation of the standalone GEMM, at the launch budget of 168
    registers with no byte spilled."""
    _lib.load()
    sass = _lib.sass_text()
    rows = selfcheck.tensor_core_check(
        _lib.tensor_ops_of_sass(sass), None,
        _lib.tensor_ops_of_sass(sass, (selfcheck.INT8_WGMMA_OP,)),
        _lib.tensor_ops_of_sass(sass, (selfcheck.INT8_MMA_SYNC_OP,)))
    found = {}
    for kernel in selfcheck.INT8_WGMMA_KERNELS:
        (found[kernel], ok), = [(f, o) for k, d, f, o in rows
                                if k == kernel and d == "int8"]
        assert ok, (kernel, found[kernel])
    assert len(found["st_layer_q8_kernel"]) == 6
    report = _lib.ptxas_report((_lib.BUILD_DIR / "build.log").read_text())
    for kernel, n in (("gemm_q8_wgmma_kernel", 8), ("st_layer_q8_kernel", 6)):
        got = {f: r for f, r in report.items() if kernel in f}
        assert len(got) == n, sorted(got)
        for name, r in got.items():
            # the GEMM's setmaxnreg needs the whole 168 at launch
            assert (r["registers"] == 168 if n == 8
                    else r["registers"] <= 168), (name, r)
            assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (name,
                                                                       r)


def test_st_layer_q8_rejects_what_the_kernel_cannot_take(cuda):
    from istvt_tpu_torch.kernels import quant

    x, *rest = _layer_case(cuda, b=1)[2](torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        quant.st_layer_q8(x.transpose(1, 2), *rest)
    with pytest.raises(TypeError, match="dtype"):
        quant.st_layer_q8(x.half(), *rest)
    cpu_w = list(rest)
    cpu_w[2] = cpu_w[2].cpu()                  # wqt, the temporal QKV
    with pytest.raises(ValueError, match="CUDA"):
        quant.st_layer_q8(x, *cpu_w)
    cpu_v = list(rest)
    cpu_v[0] = cpu_v[0].cpu()                  # st, the temporal LN scale
    with pytest.raises(ValueError, match="cpu"):
        quant.st_layer_q8(x, *cpu_v)
    with pytest.raises(ValueError, match="B, T1, S, D"):
        quant.st_layer_q8(x[0], *rest)


def test_unpacked_spatial_entries_equal_the_packed_core(cuda):
    """#15 and #13's unpacked entry run the packed cores' device code on
    separate tensors: on the same numbers they equal spatial_attention_packed
    (n_valid = S) and spatial_attention_packed_bwd bit for bit, f32 and
    bf16."""
    g = torch.Generator().manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.randn(14, 368, 3 * 512, generator=g).to(cuda, dt)
        go = torch.randn(14, 368, 512, generator=g).to(cuda, dt)
        q, k, v = (t.contiguous() for t in qkv.split(512, dim=-1))
        assert torch.equal(attention.fused_frame_attention_mh(q, k, v, 8),
                           attention.spatial_attention_packed(qkv, 8))
        for n_valid in (-1, 362):
            got = attention.fused_frame_attention_bwd(q, k, v, go, 8, n_valid)
            want = attention.spatial_attention_packed_bwd(qkv, go, 8, n_valid)
            assert torch.equal(torch.cat(got, dim=-1), want), (dt, n_valid)
        torch.cuda.synchronize()


def test_kernel_api_wrappers_backward_on_card(cuda):
    """spatial_attention_pallas and temporal_attention_pallas on the card:
    forward #15 / #16, backward #13 / #17 (one launch each), the gradients
    against autograd through JAX's XLA references in f32 at max|diff| <=
    2e-4 max|ref| (the kernels' math, summed in another order); sepconv_bn's
    backward is autograd through its reference and launches nothing."""
    g = torch.Generator().manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    cases = (
        (attention.spatial_attention_pallas, attention._spatial_reference,
         [rnd(2, 3, 40, 2, 32) for _ in range(4)],
         {"fused_frame_attention_mh": 1, "fused_frame_attention_bwd": 1}),
        (lambda a, b, c: attention.temporal_attention_pallas(a, b, c, 2),
         lambda a, b, c: attention._temporal_reference(a, b, c, 2),
         [rnd(2, 7, 40, 64) for _ in range(4)],
         {"fused_temporal_attention": 1, "fused_temporal_attention_bwd": 1}))
    with highest():
        for fn, ref, (q, k, v, go), launches in cases:
            _lib.reset_launches()
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves)
            got = torch.autograd.grad(out, leaves, go)
            torch.cuda.synchronize()
            assert _lib.LAUNCHES == {**dict.fromkeys(_lib.LAUNCHES, 0),
                                     **launches}
            want = attention._reference_grads(ref, (q, k, v), go)
            assert (out - ref(q, k, v)).abs().max() <= 1e-5
            for a, b in zip(got, want):
                assert (a - b).abs().max() <= 2e-4 * b.abs().max()
        x = rnd(2, 20, 30, 48).requires_grad_()
        dw, pw, a, b = rnd(9, 48), rnd(48, 80), rnd(80), rnd(80)
        _lib.reset_launches()
        out = conv.sepconv_bn(x, dw, pw, a, b, True)
        (gx,) = torch.autograd.grad(out.square().sum(), x)
        torch.cuda.synchronize()
        assert _lib.LAUNCHES["sepconv_bn"] == 1
        ref = conv._sepconv_bn_reference(x, dw, pw, a, b, True)
        (gr,) = torch.autograd.grad(ref.square().sum(), x)
        assert (out - ref).abs().max() <= 1e-5 * (1 + ref.abs().max())
        assert (gx - gr).abs().max() <= 1e-5 * gr.abs().max()


# #24 where each edge of its design is hit: (frames, H, W, Cin, Cout,
# relu_in). H and W off the 8 x 16 / 16 x 8 pixel tile (147, 37, 11, 4;
# 30 x 8 takes the 16 x 8 tile),
# Cout off the 64-channel N-tile (728, 72, 40, 36, 7), Cin off the 32-deep
# k-step and the 64-channel halo chunk (24, 40) and off the 16-byte vector
# (3, 5; 12 and 20 in bf16: the halo staged element by element; Cout 36 in
# bf16 and 7: pw and the output likewise), Cin past what A holds whole
# (728 in f32, 1024 in bf16: A in chunks, recomputed each N-tile), and
# relu_in both ways
SEPCONV_EDGES = [(2, 147, 147, 64, 128, False), (3, 37, 37, 256, 728, True),
                 (2, 11, 11, 24, 72, True), (2, 4, 4, 40, 40, False),
                 (2, 13, 11, 3, 24, True), (2, 9, 7, 20, 36, False),
                 (3, 6, 21, 12, 64, True), (1, 7, 5, 5, 7, True),
                 (2, 30, 8, 32, 64, False), (2, 19, 19, 728, 728, True),
                 (1, 10, 10, 1024, 160, False)]


def _sepconv_args(cuda, frames, h, w, cin, cout, relu_in, dtype, seed=0,
                  pw_offset=0):
    """sepconv_bn's arguments drawn as selfcheck draws a unit's (pw, in
    x's dtype, `pw_offset` elements into its storage on the card)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(frames, h, w, cin, generator=g) * 0.5
    dw = (torch.rand(9, cin, generator=g) * 2 - 1) / 3
    pw = (torch.rand(cin, cout, generator=g) * 2 - 1) * cin ** -0.5
    bn = (torch.rand(cout, generator=g) + 0.5,
          torch.randn(cout, generator=g) * 0.1,
          torch.randn(cout, generator=g) * 0.05,
          torch.rand(cout, generator=g) + 0.5)
    a, b = conv.fold_bn(*bn)
    buf = torch.empty(cin * cout + pw_offset, dtype=dtype, device=cuda)
    buf[pw_offset:] = pw.reshape(-1).to(cuda, dtype)
    pw = buf[pw_offset:].view(cin, cout)
    return [x.to(cuda, dtype), dw.to(cuda), pw,
            *(t.to(cuda) for t in (a, b)), relu_in]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SEPCONV_EDGES,
                         ids=["x".join(map(str, s[:5])) + ("-relu" if s[5]
                                                          else "")
                              for s in SEPCONV_EDGES])
def test_sepconv_bn_matches_plain_at_its_edges(cuda, record_property, shape,
                                               dtype):
    """#24 against sepconv_bn_plain, one launch a call: f32 at atol = rtol
    = 1e-5 (three TF32 products a multiply-add), bf16 by the bf16
    criterion."""
    args = _sepconv_args(cuda, *shape, dtype)
    before = _lib.LAUNCHES["sepconv_bn"]
    with highest():
        got, want = conv.sepconv_bn(*args), conv.sepconv_bn_plain(*args)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["sepconv_bn"] == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.float32:
        ok, err = selfcheck.f32_close("sepconv_bn", got, want)
        record_property("max_abs_err", err)
        assert ok, err
    else:
        ok, rel, mx, scale = selfcheck.bf16_close(got, want)
        assert ok, (rel, mx, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sepconv_bn_takes_pw_off_16_bytes(cuda, dtype):
    """pw at an address off 16 bytes (a view one element into its storage,
    which the wrapper passes on as it is): its ring stages are copied
    element by element, the output is the plain version's."""
    args = _sepconv_args(cuda, 2, 13, 11, 64, 72, True, dtype, pw_offset=1)
    assert args[2].data_ptr() % 16 != 0
    with highest():
        got, want = conv.sepconv_bn(*args), conv.sepconv_bn_plain(*args)
    if dtype == torch.float32:
        assert selfcheck.f32_close("sepconv_bn", got, want)[0]
    else:
        assert selfcheck.bf16_close(got, want)[0]


def test_sepconv_bn_f32_same_output_with_the_opt_in_twice(cuda):
    """On an f32 input at block3.0's channels (193 KB of shared memory a
    block, past the 48 KB a launch gets without the opt-in), two calls in
    one process, each after the opt-in, give the same output bit for bit,
    and the plain version's at 1e-5."""
    args = _sepconv_args(cuda, 2, 37, 37, 256, 728, True, torch.float32)
    assert conv._sepconv_plan(2, 37, 37, 256, 728,
                              torch.float32).smem > 48 * 1024
    with highest():
        first = conv.sepconv_bn(*args)
        second = conv.sepconv_bn(*args)
        want = conv.sepconv_bn_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert selfcheck.f32_close("sepconv_bn", first, want)[0]


def test_kernel_api_rejects_what_the_kernels_cannot_take(cuda):
    # S = 392 and T1 = 9, past what the cores once took: run, and held to
    # the plain versions in f32 (summation order only; #17 per output
    # relative to its scale)
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(4, 392, 64, generator=g).to(cuda)
               for _ in range(3))
    with highest():
        got = attention.fused_frame_attention(q, k, v)
        want = attention.fused_frame_attention_plain(q, k, v)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    t = [torch.randn(1, 9, 8, 64, generator=g).to(cuda) for _ in range(4)]
    with highest():
        got = attention.fused_temporal_attention(*t[:3], 2)
        want = attention.fused_temporal_attention_plain(*t[:3], 2)
        assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
        got = attention.fused_temporal_attention_bwd(*t, 2)
        want = attention.fused_temporal_attention_bwd_plain(*t, 2)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert (a - w).abs().max() <= 1e-5 * w.abs().max()
    q = torch.zeros(4, 64, 96, device=cuda)                  # dh 48
    with pytest.raises(NotImplementedError, match="dim_head"):
        attention.fused_frame_attention_mh(q, q, q, 2)
    q = torch.zeros(4, 64, 256, device=cuda)                 # #13: dh 128
    with pytest.raises(NotImplementedError, match="dim_head"):
        attention.fused_frame_attention_bwd(q, q, q, q, 2)
    t = torch.zeros(1, 7, 8, 3 * 64, device=cuda)            # dh 192
    with pytest.raises(NotImplementedError, match="dim_head"):
        attention.fused_temporal_attention(t, t, t, 1)
    with pytest.raises(NotImplementedError, match="dim_head"):
        attention.fused_temporal_attention_bwd(t, t, t, t, 1)
    t = torch.zeros(1, 7, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="want"):
        attention.fused_temporal_attention(t, t.cpu(), t, 2)
    with pytest.raises(ValueError, match="contiguous"):
        attention.fused_temporal_attention(t, t.transpose(2, 3), t, 2)
    x = torch.zeros(1, 8, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="Cin"):
        conv.sepconv_bn(x, torch.zeros(9, 8, device=cuda),
                        torch.zeros(8, 8, device=cuda),
                        torch.ones(8, device=cuda),
                        torch.zeros(8, device=cuda))
