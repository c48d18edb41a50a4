"""The f32 spatial attention core's arithmetic, checked without a card
(csrc/attention_tf32.cuh, q8_attention.cuh, attention_bwd.cu): every
product of the f32 tiles is three TF32 products, a_lo b_hi + a_hi b_lo +
a_hi b_hi, of operands split by kernels/linear.split_tf32, summed as the
tensor cores sum them (8 deep an mma, each sum rounded toward zero) with a
fresh sum every 32-deep k-step folded in by an IEEE add: Q K^T over
dim_head, P V and the backward's products over 32-row chunks of keys or
queries. The forward and #13's pass (a) take one online sweep over 32-key
chunks, as the tiles do: a running max, and each quad thread's sums of
e = exp(s - max) (and, in the backward, of e dP) rescaled where the max
grows, in the threads' column order, then summed over the quad (p is not
rounded in f32, so the forward normalises after PV). On the card's inputs
at the model's S = 368 with 362 valid keys, this model meets the f32
criterion of the card's checks (selfcheck.f32_tol: atol = rtol = 1e-5
forward, max|diff| <= 1e-5 max|plain| per output backward) against
attention.spatial_packed_plain / spatial_packed_bwd_plain with room to
spare, where one TF32 product misses it some thirty-fold, and one
truncated sum over all the keys errs several times more than the k-step
sums. Last, the tiles' shared memory plans fit the card, and the
yardsticks the card's kernels line gives beside them (selfcheck.
library_call, the f32 bound's count of products) compute and count the
cases' own work. Small tensors: a few seconds."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from istvt_tpu_torch.kernels import attention, linear, selfcheck

CSRC = Path(attention.__file__).resolve().parent / "csrc"
S, N_VALID, HEADS = 368, 362, 2
DIMS = (16, 32, 64)
THREE = (("lo", "hi"), ("hi", "lo"), ("hi", "hi"))
ONE = (("hi", "hi"),)
TOL = selfcheck.F32_TOL_FLOAT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rz(x):
    """float64 x rounded to f32 toward zero, as the tensor cores round the
    f32 sum of each mma."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _products(a, b, terms=THREE, kstep=32, init=None):
    """a (..., M, K) @ b (..., K, N) from TF32 halves as the f32 tiles sum
    them: for each 8-deep k-slice in order, the products `terms`, each
    added to a running f32 sum rounded toward zero; that sum starts afresh
    every `kstep` rows of K and is folded into the result by an f32 add;
    kstep=None keeps the one truncated sum over all of K, from `init`."""
    (ah, al), (bh, bl) = linear.split_tf32(a), linear.split_tf32(b)
    parts = {"hi": (ah.double(), bh.double()),
             "lo": (al.double(), bl.double())}
    shape = a.shape[:-1] + b.shape[-1:]
    acc = torch.zeros(shape)
    part = torch.zeros(shape) if init is None else init.clone()
    depth = a.shape[-1]
    for k0 in range(0, depth, 8):
        for ta, tb in terms:
            part = _rz(part.double() + parts[ta][0][..., k0:k0 + 8]
                       @ parts[tb][1][..., k0:k0 + 8, :])
        if kstep and ((k0 + 8) % kstep == 0 or k0 + 8 >= depth):
            acc, part = acc + part, torch.zeros(shape)
    return acc if kstep else part


def _inputs(dh, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((1, S, 3 * HEADS * dh)).astype(np.float32)
    go = rng.standard_normal((1, S, HEADS * dh)).astype(np.float32)
    return torch.from_numpy(qkv), torch.from_numpy(go)


def _heads(t, dh):
    return t.reshape(1, S, HEADS, dh).permute(0, 2, 1, 3)


def _merge(t):
    return t.permute(0, 2, 1, 3).reshape(1, S, -1)


def _mask():
    return torch.where(torch.arange(S) < N_VALID, 0.0, -1e30)


def _thread_sums(acc, x, corr):
    """The tiles' running row sums (tf32_online): thread t of a quad holds
    columns 8 j + 2 t and 8 j + 2 t + 1 (j = 0..3) of a 32-key chunk and
    adds them in that order, by IEEE adds, to its own sum rescaled by
    corr. acc (..., 4) the four threads' sums, x (..., <= 32) the chunk."""
    x = torch.nn.functional.pad(x, (0, 32 - x.shape[-1]))
    x = x.reshape(*x.shape[:-1], 4, 4, 2).transpose(-3, -2).flatten(-2)
    acc = acc * corr
    for i in range(8):
        acc = acc + x[..., i]
    return acc


def _quad_sum(acc):
    """A row's sum over its quad's threads, as two xor shuffles add it."""
    return ((acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3]))[
        ..., None]


def _online_sweep(q, k, dh, terms, kstep, each=None):
    """One sweep over 32-key chunks: the masked scores (Q K^T, 32-deep
    k-steps over dim_head, x scale), the running max, corr = exp(old max -
    new max) and e = exp(s - max), the four threads' sums of e. each(c0,
    e, corr) sees every chunk. Returns (scores, max, the sums' quad sum)."""
    mask = _mask()
    mx = torch.full((1, HEADS, S, 1), -torch.inf)
    part = torch.zeros((1, HEADS, S, 4))
    scores = []
    for c0 in range(0, S, 32):
        sc = _products(q, k[:, :, c0:c0 + 32].transpose(-1, -2), terms,
                       kstep) * dh ** -0.5 + mask[c0:c0 + 32]
        new = torch.maximum(mx, sc.amax(-1, keepdim=True))
        corr, e = torch.exp(mx - new), torch.exp(sc - new)
        part, mx = _thread_sums(part, e, corr), new
        if each is not None:
            each(c0, e, corr)
        scores.append(sc)
    return torch.cat(scores, -1), mx, _quad_sum(part)


def _forward_model(qkv, dh, terms=THREE, kstep=32):
    """The f32 forward tile: the online sweep, the output rescaled by corr
    and PV summed afresh for each chunk; at the end x 1 / sum. kstep=None:
    one truncated sum over dim_head for the scores and over every key for
    PV."""
    q, k, v = (_heads(t, dh) for t in qkv.split(HEADS * dh, dim=-1))
    o = torch.zeros((1, HEADS, S, dh))

    def pv(c0, e, corr):
        nonlocal o
        vc = v[:, :, c0:c0 + 32]
        o = (o * corr + _products(e, vc, terms, kstep) if kstep
             else _products(e, vc, terms, None, init=o * corr))

    sm = _online_sweep(q, k, dh, terms, kstep, pv)[2]
    return _merge(o * (1 / sm))


def _backward_model(qkv, go, dh, terms=THREE, kstep=32):
    """#13's f32 passes. (a), sweep 1: the online sweep with dP = dO V^T
    over dim_head, each thread's sum of e dP rescaled by corr beside the
    sum of e, so rowsum(P o dP) = (sum of e dP) x (1 / sum); sweep 2: P =
    exp(s - max) x (1 / sum), dS = P o (dP - rowsum) x scale, dQ = dS K
    over the keys. (b) recomputes (a)'s P and dS bit for bit: dK = dS^T Q
    and dV = P^T dO over the queries. Each product in 32-row k-steps
    (kstep=None: one truncated sum over all)."""
    q, k, v = (_heads(t, dh) for t in qkv.split(HEADS * dh, dim=-1))
    do = _heads(go, dh)
    dp = _products(do, v.transpose(-1, -2), terms, kstep)
    pdp = torch.zeros((1, HEADS, S, 4))

    def e_dp(c0, e, corr):
        nonlocal pdp
        pdp = _thread_sums(pdp, e * dp[..., c0:c0 + 32], corr)

    sc, mx, sm = _online_sweep(q, k, dh, terms, kstep, e_dp)
    rinv = 1 / sm
    p = torch.exp(sc - mx) * rinv
    ds = p * (dp - _quad_sum(pdp) * rinv) * dh ** -0.5
    dq = _products(ds, k, terms, kstep)
    dk = _products(ds.transpose(-1, -2), q, terms, kstep)
    dv = _products(p.transpose(-1, -2), do, terms, kstep)
    return _merge(dq), _merge(dk), _merge(dv)


def _forward_err(dh, terms, kstep, seed=0):
    """(ok by the card's f32 criterion, max|diff|) of the forward model
    against the plain version."""
    qkv, _ = _inputs(dh, seed)
    want = attention.spatial_packed_plain(qkv, HEADS, N_VALID)
    got = _forward_model(qkv, dh, terms, kstep)
    return (torch.allclose(got, want, atol=TOL, rtol=TOL),
            (got - want).abs().max().item())


def _backward_err(dh, terms, kstep, seed=0):
    """The worst max|diff| / max|plain| over dq, dk, dv of the backward
    model against the plain version."""
    qkv, go = _inputs(dh, seed)
    want = attention.fused_frame_attention_bwd_plain(
        *qkv.split(HEADS * dh, dim=-1), go, HEADS, N_VALID)
    got = _backward_model(qkv, go, dh, terms, kstep)
    return max(((g - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("dh", DIMS)
def test_three_tf32_products_meet_the_f32_criterion_forward(dh):
    """The forward tile's sums meet atol = rtol = 1e-5 against the plain
    f32 version, with errors under a tenth of the tolerance (the card's
    check of #10, #2, #9's tile, #14 and #15 in f32)."""
    ok, err = _forward_err(dh, THREE, 32)
    assert ok and err <= 0.1 * TOL, err


@pytest.mark.parametrize("dh", DIMS)
def test_three_tf32_products_meet_the_f32_criterion_backward(dh):
    """#13's f32 sums meet max|diff| <= 1e-5 max|plain| for each of dq,
    dk, dv, with errors under a fifth of it."""
    err = _backward_err(dh, THREE, 32)
    assert err <= 0.2 * TOL, err


@pytest.mark.parametrize("dh", DIMS)
@pytest.mark.parametrize("way", ["forward", "backward"])
def test_one_tf32_product_misses_it(way, dh):
    """One TF32 product (the operands rounded to TF32 once) misses the
    criterion by more than ten times."""
    if way == "forward":
        ok, err = _forward_err(dh, ONE, 32)
        assert not ok and err >= 10 * TOL, err
    else:
        assert _backward_err(dh, ONE, 32) >= 10 * TOL


@pytest.mark.parametrize("dh", DIMS)
@pytest.mark.parametrize("way", ["forward", "backward"])
def test_one_truncated_sum_over_the_keys_errs_more(way, dh):
    """Why each 32-deep k-step sums afresh (the card's mma.sync rounds its
    f32 sums toward zero, as wgmma does: tests/test_torch_kernels_gpu.py
    -k mma_sync_tf32 runs tools/mma_tf32_probe.cu): one truncated sum over
    dim_head and over all 368 keys (or queries) errs at least twice as much
    as the k-step sums."""
    if way == "forward":
        one, steps = _forward_err(dh, THREE, None)[1], _forward_err(
            dh, THREE, 32)[1]
    else:
        one, steps = (_backward_err(dh, THREE, None),
                      _backward_err(dh, THREE, 32))
    assert one >= 2 * steps, (one, steps)


def _constant(name, header):
    """A `constexpr int NAME = value;` of a csrc header."""
    m = re.search(rf"\b{name} = (\d+)", (CSRC / header).read_text())
    return int(m.group(1))


def _f32_smem(dh, warps, held, nt, na, nx, ns=2):
    """Bytes of an f32 tile's shared memory (attention_tf32.cuh
    tf32_held_floats + tf32_stage_floats): `held` matrices of 16 rows a
    warp, and a stage of ns row sources in chunks of kTfC rows, nt of them
    split into T planes of kTfC (2 dh + 16) floats and na into A planes of
    64 (dh + 2), with nx extra floats a row and the raw rows."""
    c = _constant("kTfC", "attention_tf32.cuh")
    return 4 * (held * warps * 16 * dh + nt * c * (2 * dh + 16)
                + na * 16 * (dh + 2) * 4 + 2 * nx * c + ns * c * dh)


@pytest.mark.parametrize("dh", (16, 32, 64, 128))
def test_f32_tiles_fit_the_card(dh):
    """Every f32 tile's shared memory fits a block's 227 KB at 256 threads
    (the forward at every dim_head, #13's two passes at 16-64), and #9's
    f32 spatial phase (12 warps) fits the int8 GEMM ring it borrows
    (csrc/q8_layer.cu's static_assert) at the dim_heads it is built for;
    at dim_head 64 the forward leaves room for two blocks an SM."""
    block, sm = 227 * 1024, 228 * 1024
    ring = (2 * _constant("kQStages", "q8_rows_gemm.cuh")
            * _constant("kTileM", "wgmma.cuh")
            * _constant("kQBK", "q8_rows_gemm.cuh"))
    fwd = _f32_smem(dh, 8, 1, 1, 1, 0)
    assert fwd <= block
    if dh <= 64:
        assert _f32_smem(dh, 8, 2, 2, 1, 0) <= block           # pass (a)
        assert _f32_smem(dh, 8, 2, 2, 2, 3) <= block           # pass (b)
    if dh in (16, 64):
        assert _f32_smem(dh, 12, 1, 1, 1, 0) <= ring
    if dh == 64:
        assert 2 * (fwd + 1024) <= sm


# the cases whose yardstick is one PyTorch call (selfcheck.library_call)
LIBRARY_CASES = ("spatial_attention_packed", "spatial_attention_packed/bwd",
                 "fused_frame_attention", "fused_frame_attention_mh",
                 "fused_frame_attention_bwd", "matmul_bias_residual/no_r")


def _as_rows(t):
    """SDPA's (G, heads, S, dh) as the kernels' (G, S, heads dh)."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1)


@pytest.fixture(scope="module")
def small_cases():
    return selfcheck.slice_cases(torch.device("cpu"), selfcheck.SMALL)


@pytest.mark.parametrize("name", LIBRARY_CASES)
def test_library_call_computes_the_cases_function(small_cases, name):
    """The yardstick timed beside each kernel (the kernels line's
    library_ms, f32 and bf16) computes the case's function on the case's
    own inputs: in f32 it meets the case's criterion against the plain
    version (the packed backward's dq, dk, dv side by side as dqkv)."""
    _, plain, make = small_cases[name]
    args = make(torch.float32)
    got = selfcheck.library_call(name, args)()
    if name == "matmul_bias_residual/no_r":
        got = (got,)
    elif isinstance(got, tuple):
        got = tuple(_as_rows(t) for t in got)
        if name == "spatial_attention_packed/bwd":
            got = (torch.cat(got, -1),)
    else:
        got = (_as_rows(got),)
    want = selfcheck.outputs(plain(*args))
    assert [g.shape for g in got] == [w.shape for w in want]
    ok, err = selfcheck.f32_close(name, got, want)
    assert ok, err


@pytest.mark.parametrize("name", ("spatial_attention_packed",
                                  "spatial_attention_packed/bwd",
                                  "fused_frame_attention_mh",
                                  "temporal_attention_packed"))
def test_f32_bound_counts_the_products_as_they_run(small_cases, name):
    """The f32 bound of the kernels line (selfcheck.case_ops_as_run): the
    spatial cores' products as three TF32 products, those of the temporal
    core on the FMA pipes; bf16 products as they are. The spatial forward
    counts 4 G S n_valid inner (QK^T and PV over the valid keys), its
    backward 10 G S n_valid inner (five products)."""
    args = small_cases[name][2](torch.float32)
    n = selfcheck.case_ops(name, args)["bf16"]
    if name.startswith("spatial"):
        g, s, i3 = args[0].shape
        per = 10 if name.endswith("bwd") else 4
        assert n == per * g * s * args[-1] * (i3 // 3)
    f32 = selfcheck.case_ops_as_run(name, args, torch.float32)
    assert f32 == ({"f32": n} if name.startswith("temporal")
                   else {"tf32": 3 * n})
    assert selfcheck.case_ops_as_run(name, args, torch.bfloat16) == {
        "bf16": n}
