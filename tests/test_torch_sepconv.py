"""#24's kernel (csrc/sepconv_bn.cu) checked without a card: its f32
pointwise modelled as the kernel sums it, its launch plan
(kernels/conv._sepconv_plan), and its plain version against JAX's.

(a) The kernel computes the pointwise product of the depthwise sums and pw
in f32 as three TF32 products (a_lo b_hi + a_hi b_lo + a_hi b_hi of
operands split by kernels/linear.split_tf32) on mma.sync m16n8k8, whose
sums the tensor cores truncate, with a fresh sum every 32-deep k-step
folded in by an IEEE add: modelled by tests/test_torch_gemm_f32.py's
_tf32_products, on each stem unit's depthwise outputs and pw (drawn as
selfcheck draws them, on a crop of 2 frames) at its Cin (64, 128, 256),
then the unit's affine, that model meets the card's f32 criterion
(atol = rtol = 1e-5) against the same in f64 with room to spare, where
one TF32 product misses it.
(b) The plan gives every output pixel and channel exactly one block, and
fits the card's shared memory, for every SLICE and SMALL unit and more
Cin (chunked A past what fits) in both dtypes at 12 and 96 frames.
(c) sepconv_bn_plain (the CPU path of sepconv_bn, and what the card holds
the kernel to) against JAX's sepconv_bn (its Pallas kernel in interpret
mode) at the units' own channels, f32 at 1e-5.
Small tensors: a few seconds."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from istvt_tpu.core import precision as jprecision
from istvt_tpu.kernels import conv as jc
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.kernels import conv, selfcheck
from test_torch_gemm_f32 import THREE, _tf32_products

ONE = (("hi", "hi"),)
TOL = selfcheck.F32_TOL_FLOAT
CSRC = Path(conv.__file__).resolve().parent / "csrc"
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# (H, W, Cin, Cout) past the stem's units: the middle flow's 728 -> 728 and
# the exit flow's 1024 -> 1536, 2048 -> 2048 (A in chunks), an odd Cin
MORE_UNITS = {"middle": (19, 19, 728, 728), "exit": (10, 10, 1024, 1536),
              "exit2": (10, 10, 2048, 2048), "odd": (13, 11, 3, 24)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(name, frames=2, h=None, w=None, seed=0):
    """A SLICE unit's (x, dw, pw, a, b, relu_in), drawn as
    selfcheck.slice_cases draws them (x N(0, 0.25), dw and pw like a
    layer's init, the BN folded), on `frames` frames of h x w."""
    uh, uw, cin, cout, relu_in = selfcheck.SLICE["units"][name]
    g = torch.Generator().manual_seed(seed)
    bn = (torch.rand(cout, generator=g) + 0.5,
          torch.randn(cout, generator=g) * 0.1,
          torch.randn(cout, generator=g) * 0.05,
          torch.rand(cout, generator=g) + 0.5)
    x = torch.randn(frames, h or uh, w or uw, cin, generator=g) * 0.5
    dw = (torch.rand(9, cin, generator=g) * 2 - 1) / 3
    pw = (torch.rand(cin, cout, generator=g) * 2 - 1) * cin ** -0.5
    return (x, dw, pw, *conv.fold_bn(*bn), relu_in)


def _depthwise(x, dw, relu_in):
    """The depthwise sums, f32 (P, Cin): sepconv_bn_plain's, which the
    kernel's match bit for bit (the same f32 operations in order)."""
    xf = torch.clamp_min(x, 0) if relu_in else x
    n, h, w, cin = x.shape
    xp = torch.nn.functional.pad(xf, (0, 0, 1, 1, 1, 1))
    acc = None
    for di in range(3):
        for dj in range(3):
            tap = xp[:, di:di + h, dj:dj + w] * dw[di * 3 + dj]
            acc = tap if acc is None else acc + tap
    return acc.reshape(-1, cin)


@pytest.mark.parametrize("terms", [THREE, ONE], ids=["3xTF32", "1xTF32"])
@pytest.mark.parametrize("name", list(selfcheck.SLICE["units"]))
def test_f32_pointwise_as_three_tf32_products_meets_the_criterion(name,
                                                                   terms):
    """The kernel's f32 pointwise, modelled (_tf32_products, 32-deep fresh
    sums), then o * a + b in f32, against the product in f64 with the same
    affine: within atol = rtol = 1e-5 with room to spare (max|diff| at
    most half of it); one TF32 product misses by far."""
    x, dw, pw, a, b, relu_in = _unit(name, h=16, w=12)
    d = _depthwise(x, dw, relu_in)
    assert d.shape[1] in (64, 128, 256)
    got = _tf32_products(d, pw, terms) * a + b
    want = ((d.double() @ pw.double()) * a.double() + b.double()).float()
    close = torch.allclose(got, want, atol=TOL, rtol=TOL)
    err = (got - want).abs().max().item()
    if terms is THREE:
        assert close and err <= 0.5 * TOL, err
    else:
        assert not close and err >= 10 * TOL, err


def _geometries():
    out = []
    for gname in ("SLICE", "SMALL"):
        units = getattr(selfcheck, gname)["units"]
        out += [(f"{gname}-{u}", h, w, cin, cout)
                for u, (h, w, cin, cout, _) in units.items()]
    return out + [(k, *v) for k, v in MORE_UNITS.items()]


GEOMETRIES = _geometries()


@pytest.mark.parametrize("frames", [12, 96])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("name, h, w, cin, cout", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_plan_covers_every_output_once_and_fits(name, h, w, cin, cout,
                                                dtype, frames):
    """Over the plan's grid (frames x tiles_y x tiles_x, splits), decoded
    as the kernel decodes blockIdx (SepconvPlan.block), every pixel of
    each frame lies in exactly one pixel tile, each output channel in
    exactly one split, and no block is empty; A's chunks cover Cin (padded
    to the 32-deep k-step) and the block's shared memory (A, the halo
    chunk, the ring) fits the H100's 227 KB."""
    plan = conv._sepconv_plan(frames, h, w, cin, cout, dtype)
    assert plan.th * plan.tw == conv.SEP_M
    assert (plan.th, plan.tw) in conv.SEP_TILES
    grid_x = frames * plan.tiles_y * plan.tiles_x
    per_frame = np.zeros((frames, h, w), np.int32)
    for bx in range(grid_x):
        f, (y0, y1), (x0, x1), _ = plan.block(bx, 0, frames, cout)
        assert y0 < h and x0 < w
        per_frame[f, y0:min(y1, h), x0:min(x1, w)] += 1
    assert (per_frame == 1).all()
    chans = np.zeros(cout, np.int32)
    for by in range(plan.splits):
        _, _, _, (c0, c1) = plan.block(0, by, frames, cout)
        assert c0 < c1
        chans[c0:c1] += 1
    assert (chans == 1).all()
    assert plan.kp % conv.SEP_K == 0 and cin <= plan.kp < cin + conv.SEP_K
    if plan.kc < plan.kp:
        assert plan.kc % 64 == 0
    assert plan.kc % conv.SEP_K == 0 and plan.kc <= plan.kp
    esize = torch.finfo(dtype).bits // 8
    a_tile = conv.SEP_M * (plan.kc + 16 // esize) * esize
    halo = (plan.th + 2) * (plan.tw + 2) * conv.SEP_HALO_C
    ring = conv.SEP_STAGES * conv.SEP_K * (conv.SEP_N + 8) * esize
    assert plan.smem == a_tile + halo + ring <= 232_448


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_plan_holds_all_of_cin_where_it_fits(dtype):
    """The stem's units (Cin <= 256) and, in bf16, the middle flow's 728
    keep A whole: the depthwise runs once a pixel tile. Past what fits, A
    takes the fewest chunks."""
    for h, w, cin, cout, _ in selfcheck.SLICE["units"].values():
        plan = conv._sepconv_plan(12, h, w, cin, cout, dtype)
        assert plan.kc == plan.kp == cin
    middle = conv._sepconv_plan(12, 19, 19, 728, 728, dtype)
    assert (middle.kc == middle.kp) == (dtype == torch.bfloat16)
    exit2 = conv._sepconv_plan(12, 10, 10, 2048, 2048, dtype)
    assert -(-exit2.kp // exit2.kc) == (3 if dtype == torch.bfloat16 else 7)


@pytest.mark.parametrize("frames", [12, 96])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_plan_splits_cout_only_to_fill_the_card(dtype, frames):
    """Cout is split over blockIdx.y only where the pixel tiles alone give
    fewer blocks than the card keeps resident (132 SMs x the blocks an SM
    takes), and then until they do (or one N-tile a split): at 12 frames
    only block3.0 in bf16 (180 tiles, 2 splits); at 96 frames none."""
    for name, (h, w, cin, cout, _) in selfcheck.SLICE["units"].items():
        plan = conv._sepconv_plan(frames, h, w, cin, cout, dtype)
        tiles = frames * plan.tiles_y * plan.tiles_x
        per_sm = min(conv.SEP_BLOCKS_PER_SM[dtype],
                     conv.SMEM_SM // (plan.smem + conv.SMEM_RESERVED))
        resident = conv.H100_SMS * per_sm
        split = (frames, name, dtype) == (12, "block3.0", torch.bfloat16)
        assert plan.splits == (2 if split else 1), (name, plan)
        if plan.splits > 1:
            assert tiles < resident <= tiles * plan.splits


def test_kernel_tiles_are_the_plans():
    """csrc/sepconv_bn.cu's tile constants are the ones _sepconv_plan
    plans with."""
    src = (CSRC / "sepconv_bn.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", src).group(1))

    assert (const("kSepM"), const("kSepN"), const("kSepK"),
            const("kSepStages"), const("kSepHaloC"), const("kSepMaxSmem")) \
        == (conv.SEP_M, conv.SEP_N, conv.SEP_K, conv.SEP_STAGES,
            conv.SEP_HALO_C, conv.SMEM_BLOCK)
    assert re.search(r"kSepBS = kSepN \+ 8;", src)


@pytest.mark.parametrize("name", ["block2.0", "block3.0"])
def test_plain_matches_jax_at_the_units_channels(name):
    """sepconv_bn_plain (and sepconv_bn on CPU tensors, which runs it)
    against JAX's sepconv_bn, its Pallas kernel in interpret mode, at the
    unit's own channels and relu_in (128 -> 256, 256 -> 728, pre-ReLU) on
    2 frames of 19 x 21, f32 at atol = rtol = 1e-5."""
    x, dw, pw, a, b, relu_in = _unit(name, h=19, w=21, seed=3)
    with jprecision.highest():
        want = np.asarray(jc.sepconv_bn(
            jnp.asarray(x.numpy()), jnp.asarray(dw.numpy()),
            jnp.asarray(pw.numpy()), jnp.asarray(a.numpy()).reshape(1, -1),
            jnp.asarray(b.numpy()).reshape(1, -1), relu_in))
    with tprecision.highest():
        got = conv.sepconv_bn_plain(x, dw, pw, a, b, relu_in)
        via = conv.sepconv_bn(x, dw, pw, a, b, relu_in)
    assert torch.equal(got, via)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def small_cases():
    return selfcheck.slice_cases(torch.device("cpu"), selfcheck.SMALL)


@pytest.mark.parametrize("name", list(selfcheck.SMALL["units"]))
def test_cudnn_yardstick_computes_the_cases_function(small_cases, name):
    """#24's composition yardstick (selfcheck.sepconv_cudnn, timed beside
    the kernel in both dtypes) computes the case's function on the case's
    own inputs: in f32 the case's criterion against the plain version."""
    _, plain, make = small_cases[
        "sepconv_bn" + ("" if name == selfcheck.SEPCONV_UNIT else f"@{name}")]
    args = make(torch.float32)
    with tprecision.highest():
        got, want = selfcheck.sepconv_cudnn(args)(), plain(*args)
    ok, err = selfcheck.f32_close("sepconv_bn", got.permute(0, 2, 3, 1),
                                  want)
    assert ok, err


def test_f32_bound_counts_the_pointwise_as_three_tf32_products():
    """#24's f32 bound (selfcheck.case_ops_as_run): the pointwise 2 P Cin
    Cout as three TF32 products, the depthwise's 18 P Cin f32 operations on
    the FMA pipes; in bf16 the pointwise on the bf16 tensor cores."""
    x, dw, pw, a, b, relu_in = _unit("block3.0", h=5, w=6)
    args = [x, dw, pw, a, b, relu_in]
    p, cin, cout = x.numel() // x.shape[-1], x.shape[-1], pw.shape[1]
    assert selfcheck.case_ops_as_run("sepconv_bn", args, torch.float32) == {
        "tf32": 3 * 2 * p * cin * cout, "f32": 18 * p * cin}
    assert selfcheck.case_ops_as_run("sepconv_bn", args, torch.bfloat16) == {
        "bf16": 2 * p * cin * cout, "f32": 18 * p * cin}
