"""The f32 GEMM's arithmetic and launch planning, checked without a card
(istvt_tpu_torch/kernels/linear.py, selfcheck.py): the TF32 split of its
inputs (linear.split_tf32, the plain version of csrc/wgmma.cuh tf32_rna,
cvt.rna.tf32.f32); that three TF32 products, a_lo b_hi + a_hi b_lo + a_hi
b_hi, summed as the kernel has the tensor cores sum them (8 deep a wgmma,
each sum truncated, a fresh sum every 32-deep k-step), meet the card's f32
criterion (selfcheck.gemm_f32_close) at the callers' depths where one TF32
product, or one truncated sum over all of K, does not; the split-K plan of the f32 weight
gradients (32-deep k-steps); and that the GEMM takes no CPU tensor. Small
tensors: a few seconds."""
import numpy as np
import pytest
import torch

from istvt_tpu_torch.kernels import linear, selfcheck

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


def _rna_tf32(x: np.ndarray) -> np.ndarray:
    """x (normal f32) rounded to 11 significant bits, ties away from zero,
    through frexp: an independent statement of cvt.rna.tf32.f32."""
    m, e = np.frexp(x.astype(np.float64))          # |m| in [0.5, 1)
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return np.ldexp(r / 2.0 ** 11, e).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 7.5, 1e4, 1e30])
def test_split_tf32_is_rna_and_rebuilds_x(scale):
    """hi is x rounded to TF32 (low 13 bits zero, equal to the frexp
    rounding), lo the rounded rest, and hi + lo is x to 2^-22 of |x| (at
    scales where x and its rest are normal numbers: the frexp rounding is
    relative, a subnormal's is on a fixed grid)."""
    g = torch.Generator().manual_seed(int(np.log2(scale) + 200))
    x = torch.randn(4096, generator=g) * scale
    hi, lo = linear.split_tf32(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi, torch.from_numpy(_rna_tf32(x.numpy())))
    r = x.numpy() - hi.numpy()                      # exact in f32
    np.testing.assert_array_equal(lo.numpy()[r != 0], _rna_tf32(r[r != 0]))
    assert not lo[torch.from_numpy(r == 0)].any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()


def test_split_tf32_rounds_ties_away_from_zero():
    """A value half way between two TF32 numbers rounds to the one of larger
    magnitude, for either sign (cvt.rna)."""
    base = torch.tensor([1.0, 3.0, 1.5, 2.0 ** 20], dtype=torch.float32)
    tie = (base.view(torch.int32) | 0x1000).view(torch.float32)
    up = ((base.view(torch.int32) + 0x2000)).view(torch.float32)
    for sign in (1, -1):
        hi, lo = linear.split_tf32(sign * tie)
        assert torch.equal(hi, sign * up)
        assert torch.equal(hi + lo, sign * tie)


def _rz(x):
    """float64 x rounded to f32 toward zero, as the tensor cores round the
    f32 sum of each wgmma."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _tf32_products(a, b, terms, kstep=32):
    """a (M, K) @ b (K, N) in f32 from TF32 halves as the f32 GEMM sums
    them: for each 8-deep k-slice in order, the products `terms` of
    ("lo", "hi"), ("hi", "lo"), ("hi", "hi"), each added to a running f32
    sum and rounded toward zero (one wgmma each: the TF32 products are
    exact, their sum truncated); that sum restarts at zero every `kstep`
    rows of K and is folded into the result by an f32 add (IEEE, to
    nearest); kstep=None sums all K in the one truncated sum."""
    (ah, al), (bh, bl) = linear.split_tf32(a), linear.split_tf32(b)
    parts = {"hi": (ah.double(), bh.double()), "lo": (al.double(),
                                                    bl.double())}
    acc = torch.zeros(a.shape[0], b.shape[1])
    part = torch.zeros_like(acc)
    for k0 in range(0, a.shape[1], 8):
        for ta, tb in terms:
            part = _rz(part.double() + parts[ta][0][:, k0:k0 + 8]
                       @ parts[tb][1][k0:k0 + 8])
        if kstep and ((k0 + 8) % kstep == 0 or k0 + 8 >= a.shape[1]):
            acc, part = acc + part, torch.zeros_like(acc)
    return acc if kstep else part


THREE = (("lo", "hi"), ("hi", "lo"), ("hi", "hi"))
ONE = (("hi", "hi"),)
# (layout, K): the forward's and backward's depths (QKV / fc1 K = 728,
# out-projection 512, #19's dy 1536, fc2 and #23's dy 2912) and a TN weight
# gradient over the slice's 5,152 rows; M x N cut to 128 x 128
DEPTHS = [("nn", 512), ("nn", 728), ("nt", 1536), ("nn", 2912),
          ("tn", 5152)]


def _operands(layout, k):
    """(ops, a (M, K), b (K, N), the plain f32 product) of a 128 x 128 f32
    GEMM case of depth k drawn as the card's checks draw it."""
    ops = selfcheck.gemm_operands(layout, 128, 128, k, "plain", torch.float32,
                                  "cpu", seed=k, dtype=torch.float32)
    a, b = ops["a"], ops["b"]
    a = a.t().contiguous() if layout == "tn" else a
    b = b.t().contiguous() if layout == "nt" else b
    (want,) = selfcheck.gemm_plain(ops)
    return ops, a, b, want


@pytest.mark.parametrize("terms", [THREE, ONE], ids=["3xTF32", "1xTF32"])
@pytest.mark.parametrize("layout, k", DEPTHS,
                         ids=[f"{lay}-K{k}" for lay, k in DEPTHS])
def test_three_tf32_products_meet_the_f32_criterion(layout, k, terms):
    """On the card's operands (selfcheck.gemm_operands in f32), three TF32
    products summed as the kernel sums them meet the f32 criterion the
    card holds the GEMM to (atol = rtol = 1e-5; TN max|diff| <= 1e-5
    max|plain|) against the plain f32 product, with room to spare; one
    TF32 product misses it by far."""
    ops, a, b, want = _operands(layout, k)
    got = _tf32_products(a, b, terms)
    ok, err = selfcheck.gemm_f32_close(ops, (got,), (want,))
    if terms is THREE:
        assert ok and err <= 0.5 * selfcheck.F32_TOL_FLOAT, err
    else:
        assert not ok and err >= 10 * selfcheck.F32_TOL_FLOAT, err


def test_one_truncated_sum_over_k_misses_the_criterion():
    """Why each 32-deep k-step starts a fresh sum: three TF32 products
    summed over all of fc2's K = 2912 in one sum that each wgmma truncates
    drift from the f32 product by several times the tolerance (the card
    gave 6.5-7.1e-5 so, PERF.md), where the k-step sums stay well inside."""
    ops, a, b, want = _operands("nn", 2912)
    ok, err = selfcheck.gemm_f32_close(
        ops, (_tf32_products(a, b, THREE, kstep=None),), (want,))
    assert not ok and err >= 2 * selfcheck.F32_TOL_FLOAT, err


@pytest.mark.parametrize("k", [1, 32, 33, 728, 5152, 41216])
@pytest.mark.parametrize("m, n", DW_SHAPES)
def test_f32_splitk_slices_cover_k_in_order(m, n, k):
    """The f32 plan's slices cover [0, K) in order on 32-deep k-steps (the
    f32 GEMM's kFK), each non-empty; the partials are (splits, M, N)."""
    bk = linear.GEMM_TILES[torch.float32][2]
    assert bk == 32
    plan = linear.plan_splitk(m, n, k, SMS, torch.float32)
    assert plan.splits == len(plan.bounds) >= 1
    assert plan.part_shape == (plan.splits, m, n)
    assert plan.bounds[0][0] == 0 and plan.bounds[-1][1] == k
    for z, (b, e) in enumerate(plan.bounds):
        assert b < e and b == z * plan.kslice * bk
        assert e == min(k, (z + 1) * plan.kslice * bk)


@pytest.mark.parametrize("rows", ROWS.values(), ids=ROWS.keys())
@pytest.mark.parametrize("m, n", DW_SHAPES)
def test_f32_splitk_fills_the_waves(m, n, rows):
    """Each f32 dW product of a train step is split at least as far as its
    bf16 plan (an f32 k-step costs three bf16 ones, the partials the same)
    and leaves no more of its last wave empty than without a split; at
    B=16 its waves are at least 90% full."""
    def fill(splits):
        tiles = -(-m // 128) * -(-n // 128) * splits
        return tiles / (-(-tiles // SMS) * SMS)
    plan = linear.plan_splitk(m, n, rows, SMS, torch.float32)
    assert plan.splits >= linear.plan_splitk(m, n, rows, SMS).splits
    assert fill(plan.splits) >= fill(1)
    if rows == ROWS["B=16"]:
        assert fill(plan.splits) >= 0.9


@pytest.mark.parametrize("n, k", [(8, 8), (728, 2912), (1536, 5153)])
def test_planes_shape_pads_rows_to_16_bytes(n, k):
    """The B planes are (2, N, kp), kp = K rounded up to 4 f32: the
    kernel's kp and a TMA row stride."""
    two, rows, kp = linear.tf32_planes_shape(n, k)
    assert (two, rows) == (2, n) and kp % 4 == 0 and k <= kp < k + 4


def test_gemm_takes_no_cpu_tensor():
    """No other route: linear.gemm refuses CPU f32 operands rather than
    computing them another way (the wrappers send CPU tensors to their
    plain versions before it)."""
    ops = selfcheck.gemm_operands("nn", 16, 16, 16, "plain", torch.float32,
                                  "cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        selfcheck.run_gemm(ops)
