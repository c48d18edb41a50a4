"""The int8 GEMM's operand layouts and checks that need no card
(istvt_tpu_torch/kernels/quant.py, selfcheck.py, models/istvt.py): the
K-major weight copy (its codes, its padded rows), the model building it at
quantize_params and at every state_dict load (and the state_dict not
holding it), every int8 model path handing its copies to the wrappers,
the int8 GEMM table of chip_smoke.py's phase 3 and its plain version,
the operand check that refuses what the kernel cannot take, and the IGMMA
count of chip_smoke.py's build phase on a canned cuobjdump listing. Small
tensors and depth-1 models: a few seconds."""

import pytest
import torch

from istvt_tpu_torch.core.config import ISTVTConfig
from istvt_tpu_torch.kernels import _lib, quant, selfcheck
from istvt_tpu_torch.models import istvt
from istvt_tpu_torch.nn import attention as nn_attention

ROWS = 2 * 7 * 368                        # the slice's rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed=0, **cfg):
    """A depth-1, 2-frame int8 ISTVT at full width, quantized."""
    cfg = ISTVTConfig(num_frames=2, image_size=72, feat_hw=5, depth=1,
                      use_pallas=True, quantize="int8", **cfg)
    return istvt.quantize_params(
        istvt.init(cfg, torch.Generator().manual_seed(seed)))


def _copies(model):
    """{(layer, module, copy name): (the copy, its int8 weight)}."""
    return {(i, j, n): (getattr(m.fn, n), getattr(m.fn, src))
            for i, layer in enumerate(model.vit.transformer.layers)
            for j, m in enumerate(layer) for n, src in m.fn.kmajor_names}


@pytest.mark.parametrize("k, padded", [(728, 736), (512, 512), (2912, 2912),
                                       (1536, 1536), (4, 16), (20, 32)])
def test_padded_k_rounds_up_to_16_bytes(k, padded):
    assert quant.padded_k(k) == padded


@pytest.mark.parametrize("k, n", [(728, 1536), (512, 728), (728, 2912),
                                  (2912, 728), (20, 12)])
def test_kmajor_is_the_zero_padded_transpose(k, n):
    """kmajor(wq) holds wq's codes transposed, (N, padded_k(K)) contiguous,
    its pad columns zero: a layout change, no code changes."""
    wq, _ = quant.quantize_weight(torch.randn(k, n, generator=torch.Generator()
                                              .manual_seed(k + n)))
    wk = quant.kmajor(wq)
    assert wk.dtype == torch.int8 and wk.is_contiguous()
    assert wk.shape == (n, quant.padded_k(k))
    assert torch.equal(wk[:, :k], wq.t())
    assert not wk[:, k:].any()


def test_quantize_params_builds_the_copies():
    """Every int8 weight of every module gets its K-major copy beside it."""
    copies = _copies(_model())
    assert len(copies) == 6                   # qkv, out (x2), fc1, fc2
    for name, (wk, wq) in copies.items():
        assert torch.equal(wk, quant.kmajor(wq)), name


def test_state_dict_keeps_its_keys_and_shapes():
    """The state_dict holds the int8 copies in their (K, N) shapes and
    none of the K-major copies: the format is the float model's plus the
    int8 buffers."""
    model = _model()
    sd = model.state_dict()
    float_keys = set(istvt.init(model.cfg, torch.Generator().manual_seed(0))
                     .state_dict())
    q8 = {k for k in sd if k not in float_keys}
    layer = "vit.transformer.layers.0."
    assert q8 == {f"{layer}{i}.fn.{n}" for i, names in
                  ((0, istvt.TemporalAttention.q8_names),
                   (1, istvt.SpatialAttention.q8_names),
                   (2, istvt.FeedForward.q8_names)) for n in names}
    assert sd[f"{layer}0.fn.qkv_wq"].shape == (728, 1536)
    assert sd[f"{layer}1.fn.out_wq"].shape == (512, 728)
    assert sd[f"{layer}2.fn.w1q"].shape == (728, 2912)
    assert sd[f"{layer}2.fn.w2q"].shape == (2912, 728)


@pytest.mark.parametrize("into", ["float", "other_int8"])
def test_state_dict_load_rebuilds_the_copies(into):
    """Loading a state_dict that carries the int8 copies rebuilds the
    K-major ones from them: into a float model (which had none) and into
    one quantized from other weights (whose copies would be stale)."""
    sd = _model(seed=0).state_dict()
    target = (_model(seed=1) if into == "other_int8" else
              istvt.init(_model().cfg, torch.Generator().manual_seed(1)))
    target.load_state_dict(sd)
    want = _copies(_model(seed=0))
    got = _copies(target)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name][0], want[name][0]), name


# the int8 wrappers a model path calls, by module: name -> the module
_WRAPPERS = {n: quant for n in ("ln_qkv_q8_temporal_attention",
                                "mm_q8_ln_qkv_q8_spatial_attention",
                                "matmul_q8_res_ln_ff_q8_full", "ln_matmul_q8",
                                "matmul_q8_ln_matmul_q8", "ln_ff_residual_q8",
                                "ln_ff_residual_q8_full")}
_NN_WRAPPERS = ("ln_matmul_q8", "matmul_q8_bias_residual")


@pytest.mark.parametrize("q8_ff, q8_attn", [("full", "ingest"),
                                            ("full", "boundary"),
                                            ("mixed", "ingest"),
                                            ("int8", "ingest")])
def test_model_paths_hand_the_wrappers_their_copies(monkeypatch, q8_ff,
                                                    q8_attn):
    """Every int8 wrapper call of a forward gets `wk`: the model's own
    K-major copies (the very buffers), one per int8 weight argument in
    their order, so that no call builds one."""
    model = _model(q8_ff=q8_ff, q8_attn=q8_attn)
    if q8_ff == "mixed":
        istvt.pack_params(model)
    held = {id(wk) for wk, _ in _copies(model).values()}
    calls = []

    def spy(module, name):
        real = getattr(module, name)

        def wrapper(*args, wk=None, **kw):
            int8 = [a for a in args if torch.is_tensor(a)
                    and a.dtype == torch.int8]
            calls.append((name, wk, int8))
            return real(*args, wk=wk, **kw)
        monkeypatch.setattr(module, name, wrapper)

    for name, module in _WRAPPERS.items():
        spy(module, name)
    for name in _NN_WRAPPERS:
        spy(nn_attention, name)
    with torch.inference_mode():
        model(torch.randn(1, 2, 72, 72, 3,
                          generator=torch.Generator().manual_seed(1)))
    assert calls
    for name, wk, int8 in calls:
        assert wk is not None and len(wk) == len(int8), name
        assert all(id(c) in held for c in wk), name
        assert all(torch.equal(c, quant.kmajor(w)) for c, w in zip(wk, int8))


def test_gemm_q8_shapes_are_the_callers():
    """The int8 GEMM table of chip_smoke.py's phase 3 at the slice: every
    int8 GEMM launch of the wrappers, with the epilogue and dtypes each
    gives it."""
    shapes = selfcheck.gemm_q8_shapes()
    bf, f32 = torch.bfloat16, torch.float32
    assert shapes["#1 / #4 QKV"] == (ROWS, 1536, 728, bf, None, False, False)
    assert shapes["#2 / #8 t-out-projection"] == (ROWS, 728, 512, f32, None,
                                                  True, False)
    assert shapes["#3 s-out-projection + r"] == (ROWS, 728, 512, f32, bf,
                                                 True, False)
    assert shapes["#3 / #7 fc1 (GELU)"] == (ROWS, 2912, 728, f32, None, True,
                                            True)
    assert shapes["#3 fc2 + y"] == (ROWS, 728, 2912, bf, f32, True, False)
    assert shapes["#6 fc1 (GELU)"] == (ROWS, 2912, 728, bf, None, True, True)
    # the seven (output, residual, GELU) combinations the callers use
    assert len({(o, r, g) for _, _, _, o, r, _, g in shapes.values()}) == 7
    big = selfcheck.gemm_q8_shapes({**selfcheck.SLICE, "b": 16})
    assert {s[0] for s in big.values()} == {16 * 7 * 368}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_r", [False, True])
def test_gemm_q8_plain_is_the_wrappers_arithmetic(dtype, with_r):
    """The plain version the card tests hold the int8 GEMM to computes, on
    the same codes, what the wrappers' plain versions compute: #5's plain
    version equals row quant + gemm_q8_plain bit for bit."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(37, 512, generator=g).to(dtype)
    wq, ws = quant.quantize_weight(torch.randn(512, 728, generator=g) * 0.04)
    b = torch.randn(728, generator=g) * 0.02
    r = torch.randn(37, 728, generator=g).to(dtype) if with_r else None
    want = quant.matmul_q8_bias_residual_plain(x, wq, ws, b, r)
    q, rs = quant._quant_rows(x.float())
    ops = {"q": q, "wq": wq, "rs": rs.reshape(-1), "ws": ws, "bias": b,
           "out": torch.empty(37, 728, dtype=dtype)}
    if with_r:
        ops["res"] = r
    assert torch.equal(selfcheck.gemm_q8_plain(ops), want)


def test_gemm_q8_operands_pad_and_plain():
    """The operands of a GEMM case: codes (M, K) with rows padded_k(K)
    apart, the copy kmajor(wq), the pad bytes as asked; the plain version
    ignores the pad (it reads the (K, N) weight)."""
    ops0 = selfcheck.gemm_q8_operands(9, 16, 20, torch.float32, None, True,
                                      True, "cpu", seed=2)
    ops = selfcheck.gemm_q8_operands(9, 16, 20, torch.float32, None, True,
                                     True, "cpu", seed=2, pad=127)
    assert ops["q"].shape == (9, 20) and ops["q"].stride() == (32, 1)
    assert torch.equal(ops["wk"][:, :20], ops["wq"].t())
    assert (ops["wk"][:, 20:] == 127).all() and not ops0["wk"][:, 20:].any()
    base = ops["q"].as_strided((9, 32), (32, 1))
    assert (base[:, 20:] == 127).all()
    assert torch.equal(selfcheck.gemm_q8_plain(ops),
                       selfcheck.gemm_q8_plain(ops0))
    n_ops, n_bytes = selfcheck.gemm_q8_ops_bytes(ops)
    assert n_ops == 2 * 9 * 16 * 20
    assert n_bytes == 9 * 20 + 20 * 16 + 4 * (9 + 16 + 16 + 9 * 16)


def _gemm_operands(case):
    """(q, wk, out) for check_gemm_q8, on the CPU, each broken as `case`
    says."""
    m, k, n = 8, 728, 64
    q = torch.zeros(m, quant.padded_k(k), dtype=torch.int8)[:, :k]
    wk = torch.zeros(n, quant.padded_k(k), dtype=torch.int8)
    out = torch.empty(m, n)
    if case == "dense codes":                 # rows 728 apart, not 736
        q = torch.zeros(m, k, dtype=torch.int8)
    elif case == "k not divisible by 4":
        q = torch.zeros(m, 16, dtype=torch.int8)[:, :10]
        wk = torch.zeros(n, 16, dtype=torch.int8)
    elif case == "n not divisible by 4":
        wk = torch.zeros(62, quant.padded_k(k), dtype=torch.int8)
        out = torch.empty(m, 62)
    elif case == "unpadded copy":
        wk = torch.zeros(n, k, dtype=torch.int8)
    elif case == "copy of another K":
        wk = torch.zeros(n, 512, dtype=torch.int8)
    elif case == "float codes":
        q = torch.zeros(m, quant.padded_k(k))[:, :k]
    return q, wk, out


@pytest.mark.parametrize("case, match", [
    ("dense codes", "bytes apart"), ("float codes", "bytes apart"),
    ("k not divisible by 4", "divisible by 4"),
    ("n not divisible by 4", "divisible by 4"),
    ("unpadded copy", "K-major"), ("copy of another K", "K-major"),
    ("host tensors", "CUDA")])
def test_check_gemm_q8_refuses_what_the_kernel_cannot_take(case, match):
    """A wrong row stride, a weight that is not kmajor(wq), K or N not
    divisible by 4, or host tensors: ValueError, never another route."""
    with pytest.raises(ValueError, match=match):
        quant.check_gemm_q8(*_gemm_operands(case))


def test_wrappers_take_wk_on_the_cpu_and_count_nothing():
    """On CPU tensors every int8 wrapper, given its K-major copies as the
    selfcheck cases give them, returns its plain version's numbers and
    counts no launch and no copy."""
    cases = selfcheck.slice_cases(torch.device("cpu"), selfcheck.SMALL)
    _lib.reset_launches()
    for name in selfcheck.INT8_CASES:
        if name == "st_layer_q8":
            continue
        kern, plain, make = cases[name]
        assert "wk" in kern.keywords, name
        args = make(torch.float32)
        assert torch.equal(kern(*args), plain(*args)), name
    assert not any(_lib.LAUNCHES.values())
    assert _lib.KMAJOR_BUILDS == {"q8_kmajor": 0}


# a cuobjdump -sass excerpt in its layout: two instantiations of the int8
# GEMM (template parameters output type, residual type, GELU) and the
# row-quant kernel
_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN5istvt20gemm_q8_wgmma_kernelIf13__nv_bfloat16Lb0EEEv14CUtensorMap_stS2_PKfS4_S4_PKT0_PT_ii8TileGrid
        /*0a30*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], R24, gsb0 ;
        /*0a40*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR8], R24, gsb0 ;
\t\tFunction : _ZN5istvt20gemm_q8_wgmma_kernelI13__nv_bfloat16fLb1EEEv14CUtensorMap_stS2_PKfS4_S4_PKT0_PT_ii8TileGrid
        /*0a30*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], R24, gsb0 ;
\t\tFunction : _ZN5istvt17quant_rows_kernelIfEEvPKT_PaPfiii
        /*0100*/                   FMNMX R4, R2, R3, !PT ;
"""


def test_igmma_check_reads_the_sass():
    """The int8 GEMM's row of the tensor-core check: IGMMA is counted apart
    from the float products; every instantiation of the int8 GEMM must
    have it, whatever its template parameters; one on mma.sync (IMMA)
    alone, or no int8 GEMM at all, fails."""
    counts = _lib.tensor_ops_of_sass(_SASS)
    igmma = _lib.tensor_ops_of_sass(_SASS, (selfcheck.INT8_WGMMA_OP,))
    assert sorted(counts.values()) == [0, 0, 0]      # no float products
    assert sorted(igmma.values()) == [0, 1, 2]
    rows = {(k, d): (f, ok) for k, d, f, ok
            in selfcheck.tensor_core_check(counts, None, igmma)}
    found, ok = rows[("gemm_q8_wgmma_kernel", "int8")]
    assert ok and sorted(found.values()) == [1, 2]
    imma = _SASS.replace("IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], R24, gsb0 ;"
                         "\n\t\tFunction : _ZN5istvt17",
                         "IMMA.16832.S8.S8 R24, R4, R20, R24 ;\n"
                         "\t\tFunction : _ZN5istvt17")
    rows = {(k, d): ok for k, d, _, ok in selfcheck.tensor_core_check(
        counts, None, _lib.tensor_ops_of_sass(imma,
                                              (selfcheck.INT8_WGMMA_OP,)))}
    assert not rows[("gemm_q8_wgmma_kernel", "int8")]
    rows = {(k, d): ok for k, d, _, ok
            in selfcheck.tensor_core_check(counts)}   # no IGMMA counts given
    assert not rows[("gemm_q8_wgmma_kernel", "int8")]
    none = _SASS.split("\t\tFunction : _ZN5istvt17")[0].split(
        "\t\tFunction")[0]
    rows = {(k, d): ok for k, d, _, ok in selfcheck.tensor_core_check(
        {}, None, _lib.tensor_ops_of_sass(none, (selfcheck.INT8_WGMMA_OP,)))}
    assert not rows[("gemm_q8_wgmma_kernel", "int8")]
