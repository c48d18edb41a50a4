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
                                "ln_ff_residual_q8_full", "st_layer_q8")}
_NN_WRAPPERS = ("ln_matmul_q8", "matmul_q8_bias_residual")


@pytest.mark.parametrize("q8_ff, q8_attn", [("full", "ingest"),
                                            ("full", "boundary"),
                                            ("mixed", "ingest"),
                                            ("int8", "ingest"),
                                            ("full", "layer")])
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
        kern, plain, make = cases[name]
        assert "wk" in kern.keywords, name
        args = make(torch.float32)
        assert torch.equal(kern(*args), plain(*args)), name
    assert not any(_lib.LAUNCHES.values())
    assert _lib.KMAJOR_BUILDS == {"q8_kmajor": 0}


def _layer_case(geometry=selfcheck.SMALL):
    """st_layer_q8's selfcheck case on the CPU: (wrapper given its K-major
    copies, plain version, arguments in f32)."""
    kern, plain, make = selfcheck.slice_cases(torch.device("cpu"),
                                              geometry)["st_layer_q8"]
    return kern, plain, make(torch.float32)


def test_st_layer_q8_takes_its_copies_on_the_cpu():
    """#9 on CPU tensors, given the six K-major copies (the QKV_t, out_t,
    QKV_s, out_s, fc1 and fc2 weights', in that order) or none, returns its
    plain version's numbers; no launch, no copy built."""
    kern, plain, args = _layer_case()
    assert [tuple(c.shape) for c in kern.keywords["wk"]] == [
        (192, 128), (128, 64), (192, 128), (128, 64), (256, 128), (128, 256)]
    _lib.reset_launches()
    want = plain(*args)
    assert torch.equal(kern(*args), want)
    assert torch.equal(kern.func(*args), want)
    assert not any(_lib.LAUNCHES.values())
    assert _lib.KMAJOR_BUILDS == {"q8_kmajor": 0}


@pytest.mark.parametrize("case, match", [
    ("transposed back", "K-major copy"), ("unpadded", "K-major copy"),
    ("five copies", "6 int8 weights"), ("fc1's for fc2", "K-major copy"),
    ("not contiguous", "contiguous")])
def test_st_layer_q8_refuses_a_wrong_copy(case, match):
    """A `wk` that is not the six weights' kmajor copies raises, on any
    device, before anything runs."""
    kern, _, args = _layer_case(selfcheck.SLICE)
    wk = list(kern.keywords["wk"])
    if case == "transposed back":
        wk[0] = args[3].clone()                     # (728, 1536): (K, N)
    elif case == "unpadded":
        wk[4] = wk[4][:, :728].contiguous()         # fc1's (2912, 736)
    elif case == "five copies":
        wk = wk[:5]
    elif case == "fc1's for fc2":
        wk[5] = wk[4]
    else:
        wk[1] = wk[1].t().contiguous().t()          # the right shape, strided
    with pytest.raises(ValueError, match=match):
        kern.func(*args, wk=tuple(wk))


def test_st_layer_q8_phase_stamps_are_the_cards():
    """The stamped instantiation exists on the card only."""
    kern, _, args = _layer_case()
    with pytest.raises(ValueError, match="card"):
        kern(*args, stamps=torch.zeros(quant.LAYER_STAMPS,
                                       dtype=torch.int64))


@pytest.mark.parametrize("geometry", [selfcheck.SLICE, selfcheck.SMALL,
                                      {**selfcheck.SLICE, "b": 16}],
                         ids=["slice", "small", "B=16"])
def test_layer_codes_rows_are_tma_strides(geometry):
    """Every row pass of #9 writes its codes with rows a multiple of 16
    bytes apart, at least as wide as its rows (D, inner, hdim); the codes
    buffer holds every pass's rows at its stride, and the rest of the
    workspace is the intermediates' (rows x width, by dtype)."""
    d, inner, hid = (geometry[k] for k in ("d", "inner", "hid"))
    strides = quant.layer_code_strides(d, inner, hid)
    assert all(st % 16 == 0 and st >= w and st - w < 16
               for st, w in zip(strides, (d, inner, hid)))
    rows = 3 * 5 * 7                          # a few rows, on the CPU
    ws = quant.layer_workspace(rows, d, inner, hid, torch.bfloat16, "cpu")
    assert ws["q"].dtype == torch.int8
    assert ws["q"].numel() == rows * max(strides)
    assert {k: (t.numel(), t.dtype) for k, t in ws.items() if k != "q"} == {
        "rs": (rows, torch.float32), "qkv": (rows * 3 * inner, torch.bfloat16),
        "a": (rows * inner, torch.bfloat16), "y": (rows * d, torch.float32),
        "hid": (rows * hid, torch.float32)}
    if geometry is selfcheck.SLICE:
        assert strides == (736, 512, 2912)


# nvcc -Xptxas -v's report in its layout (build/build.log): two kernels and a
# device function that was not inlined
_PTXAS = """
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5istvt18st_layer_q8_kernelIfLi64ELb0EEEvNS_7LayerQ8ENS_9LayerMapsE' for 'sm_90a'
ptxas info    : Function properties for _ZN5istvt18st_layer_q8_kernelIfLi64ELb0EEEvNS_7LayerQ8ENS_9LayerMapsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, used 3 barriers, 1608 bytes cmem[0]
ptxas info    : Function properties for __internal_trig_reduction_slowpathd
    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN5istvt20gemm_q8_wgmma_kernelIffLb1EEEv14CUtensorMap_stS1_PKfS3_S3_PKT0_PT_ii8TileGrid' for 'sm_90a'
ptxas info    : Function properties for _ZN5istvt20gemm_q8_wgmma_kernelIffLb1EEEv14CUtensorMap_stS1_PKfS3_S3_PKT0_PT_ii8TileGrid
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 600 bytes cmem[0]
"""


def test_ptxas_report_reads_the_log():
    """The spill check of the card test reads each kernel's registers, stack
    frame and spilled bytes from the build log, and a device function's."""
    r = _lib.ptxas_report(_PTXAS)
    layer, gemm = (next(v for n, v in r.items() if k in n)
                   for k in ("st_layer_q8_kernel", "gemm_q8_wgmma_kernel"))
    assert layer == {"registers": 166, "stack_frame": 0, "spill_stores": 0,
                     "spill_loads": 0}
    assert gemm == {"registers": 168, "stack_frame": 8, "spill_stores": 12,
                    "spill_loads": 16}
    assert r["__internal_trig_reduction_slowpathd"] == {
        "stack_frame": 40, "spill_stores": 0, "spill_loads": 0}


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


_LAYER_SASS = """
\t\tFunction : _ZN5istvt20gemm_q8_wgmma_kernelIffLb0EEEv14CUtensorMap_stS1_PKfS3_S3_PKT0_PT_ii8TileGrid
        /*0a30*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], R24, gsb0 ;
\t\tFunction : _ZN5istvt18st_layer_q8_kernelIfLi64ELb0EEEvNS_7LayerQ8ENS_9LayerMapsE
        /*0a30*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], R24, gsb0 ;
\t\tFunction : _ZN5istvt18st_layer_q8_kernelI13__nv_bfloat16Li64ELb0EEEvNS_7LayerQ8ENS_9LayerMapsE
        /*0a30*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], R24, gsb0 ;
        /*0b30*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;
"""


def test_int8_wgmma_check_holds_the_layer_to_it():
    """#9 is an int8 wgmma kernel in the tensor-core check: every
    instantiation must have IGMMA and, given the IMMA counts, none of the
    mma.sync int8 tile it ran before."""
    def layer_row(sass, with_imma=True):
        imma = (_lib.tensor_ops_of_sass(sass, (selfcheck.INT8_MMA_SYNC_OP,))
                if with_imma else None)
        return {(k, d): ok for k, d, _, ok in selfcheck.tensor_core_check(
            _lib.tensor_ops_of_sass(sass), None,
            _lib.tensor_ops_of_sass(sass, (selfcheck.INT8_WGMMA_OP,)),
            imma)}
    assert layer_row(_LAYER_SASS)[("st_layer_q8_kernel", "int8")]
    assert layer_row(_LAYER_SASS)[("gemm_q8_wgmma_kernel", "int8")]
    mixed = _LAYER_SASS.replace(
        "HMMA.16816.F32.BF16", "IMMA.16832.S8.S8")
    assert not layer_row(mixed)[("st_layer_q8_kernel", "int8")]
    assert layer_row(mixed, with_imma=False)[("st_layer_q8_kernel", "int8")]
    old = mixed.replace("IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], R24, gsb0 ;"
                        "\n\t\tFunction : _ZN5istvt18st_layer_q8_kernelI13",
                        "FFMA R4, R2, R3, R4 ;\n"
                        "\t\tFunction : _ZN5istvt18st_layer_q8_kernelI13")
    assert not layer_row(old, with_imma=False)[("st_layer_q8_kernel",
                                                "int8")]
