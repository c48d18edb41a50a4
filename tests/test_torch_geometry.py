"""The fused paths at the geometries past the paper's that the JAX package
runs: longer clips (--seq_len 8 and 16: T1 = 9 and 17, past the temporal
cores' register lanes, csrc/temporal.cuh kTMax) and larger frames (-is 320:
a 20 x 20 feature grid, S = 408 with 401 valid keys, past the 384 the
spatial cores once took).

(a) The port's plain versions against the JAX package's Pallas kernels
(interpret mode on the CPU) on the same numpy inputs, at narrow widths
(heads 2; T1 = 9 at dim_head 64, T1 = 17 at dim_head 16): #11, #12, #16 /
#17 and #1 at T1 = 9 and 17; #9 at T1 = 9 and S = 408 (dim_head 64); #10,
#2, #13 and #14 / #15 at S = 408 with n_valid 401. Tolerances are those of the files that hold each kernel at the
paper geometry: the float kernels in f32 at atol = rtol = 1e-5
(tests/test_torch_attention.py, test_torch_kernel_api.py), the backward
kernels at max|diff| <= 1e-5 max|ref| per output
(test_torch_train_kernels.py), the int8 kernels at atol = rtol = 2e-3 and
#9 stage by stage at rel-L2 1e-3 (test_torch_quant.py); #11 and #10 in bf16
too, by the card's bf16 criterion.
(b) A TINY-width model at num_frames = 8 (T1 = 9) on JAX's weights
(compat.from_jax.params_from_jax): the int8 `ingest` forward's logits at
atol = rtol = 1e-2 and the float fused forward's at 1e-3
(tests/test_torch_istvt.py, test_torch_float_path.py).
(c) For every --seq_len in {4, 6, 8, 16} and --input_size in {224, 300,
320, 380, 448}: the port pads S as the JAX model does, and the port's
launch checks take the (T1, S, inner, heads) that the JAX model builds.
No compute.
"""
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from istvt_tpu.core import precision as jprecision
from istvt_tpu.core.config import ISTVTConfig as JaxConfig
from istvt_tpu.kernels import attention as ja
from istvt_tpu.kernels import quant as jq
from istvt_tpu.models import istvt as jistvt
from istvt_tpu_torch.compat.from_jax import params_from_jax
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.core.config import ISTVTConfig
from istvt_tpu_torch.kernels import _lib, selfcheck
from istvt_tpu_torch.kernels import attention as ta
from istvt_tpu_torch.kernels import quant as tq
from istvt_tpu_torch.models import istvt as tistvt

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
HEADS = 2
S_LARGE, N_VALID_LARGE = 408, 401           # -is 320: 20 x 20 + 1 -> 408


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a, dt="f32"):
    """numpy f32 -> (torch, jax) in the dtype (bf16 rounded once, the same
    on both sides)."""
    tdt, jdt = DTYPES[dt]
    t = torch.from_numpy(a).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _close(got, want, dt="f32", tol=1e-5):
    if dt == "f32":
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    else:
        ok, rel, mx, scale = selfcheck.bf16_close(torch.tensor(_np(got)),
                                                  torch.tensor(_np(want)))
        assert ok, (rel, mx, scale)


def _close_rel(got, want):
    """A backward output: max|diff| <= 1e-5 max|ref|."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _no_launch():
    assert all(v == 0 for v in _lib.LAUNCHES.values())


# (T1, dim_head): both clip lengths, each dim_head
LONG = [(9, 64), (17, 16)]


# ---------------------------------------------------------------------------
# (a) the kernels


def test_register_lanes_bound_is_the_sources():
    """attention.TEMPORAL_TMAX, past which the wrappers ask for the general
    lanes' scratch, is kTMax of csrc/temporal.cuh."""
    src = (Path(ta.__file__).resolve().parent / "csrc" /
           "temporal.cuh").read_text()
    assert re.search(r"constexpr int kTMax = (\d+);", src).group(1) == \
        str(ta.TEMPORAL_TMAX)


@pytest.mark.parametrize("t1, dh, dt", [(*c, "f32") for c in LONG]
                         + [(*LONG[0], "bf16")])
def test_temporal_packed_matches_jax_at_long_clips(t1, dh, dt):
    """#11 (and #1's, #9's core) at T1 = 9, 17."""
    rng = np.random.RandomState(t1 + dh)
    qkv, jqkv = _pair(_randn(rng, 1, t1, 5, 3 * HEADS * dh), dt)
    with jprecision.highest():
        want = ja.temporal_attention_packed(jqkv, HEADS)
    _lib.reset_launches()
    with tprecision.highest():
        got = ta.temporal_attention_packed(qkv, HEADS)
    _no_launch()
    _close(got, want, dt)


@pytest.mark.parametrize("t1, dh", LONG)
def test_temporal_packed_bwd_matches_jax_at_long_clips(t1, dh):
    """#12 at T1 = 9, 17 (dk, dv summed in the activation dtype)."""
    rng = np.random.RandomState(100 + t1 + dh)
    inner = HEADS * dh
    qkv, jqkv = _pair(_randn(rng, 1, t1, 5, 3 * inner))
    g, jg = _pair(_randn(rng, 1, t1, 5, inner))
    with jprecision.highest():
        want = ja.fused_temporal_attention_packed_bwd(jqkv, jg, heads=HEADS,
                                                      interpret=True)
    _lib.reset_launches()
    got = ta.temporal_attention_packed_bwd(qkv, g, HEADS)
    _no_launch()
    for i in range(3):
        _close_rel(got[..., i * inner:(i + 1) * inner],
                   want[..., i * inner:(i + 1) * inner])


@pytest.mark.parametrize("t1, dh", LONG)
def test_unpacked_temporal_matches_jax_at_long_clips(t1, dh):
    """#16 and #17 at T1 = 9, 17, in f32."""
    rng = np.random.RandomState(200 + t1 + dh)
    ins = [_pair(_randn(rng, 1, t1, 5, HEADS * dh)) for _ in range(4)]
    t, j = [a for a, _ in ins], [b for _, b in ins]
    with jprecision.highest():
        want = ja.fused_temporal_attention(*j[:3], heads=HEADS,
                                           interpret=True)
        want_bwd = ja.fused_temporal_attention_bwd(*j, heads=HEADS,
                                                   interpret=True)
    _lib.reset_launches()
    _close(ta.fused_temporal_attention(*t[:3], HEADS), want)
    for g, w in zip(ta.fused_temporal_attention_bwd(*t, HEADS), want_bwd):
        _close(g, w)
    _no_launch()


def _q8(rng, d_in, d_out):
    wq, ws = jq.quantize_weight(
        jnp.asarray(rng.randn(d_in, d_out) * 0.05, jnp.float32))
    return np.asarray(wq), np.asarray(ws)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _ln(rng, d):
    return ((rng.rand(d) + 0.5).astype(np.float32),
            (rng.randn(d) * 0.01).astype(np.float32))


@pytest.mark.parametrize("t1, dh", LONG)
def test_ln_qkv_q8_temporal_matches_jax_at_long_clips(t1, dh):
    """#1 (LN -> int8 QKV -> the temporal core) at T1 = 9, 17."""
    rng = np.random.RandomState(300 + t1 + dh)
    d = 64
    x = _randn(rng, 1, t1, 6, d, scale=0.8)
    x[:, :, 5:] = 0.0                                # an all-zero pad token
    arrs = (x, *_ln(rng, d), *_q8(rng, d, 3 * HEADS * dh))
    with jprecision.highest():
        want = np.asarray(jq.ln_qkv_q8_temporal_attention(*_j(*arrs),
                                                          HEADS))
    _lib.reset_launches()
    with tprecision.highest():
        got = tq.ln_qkv_q8_temporal_attention(*_t(*arrs), HEADS)
    _no_launch()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("dh, dt", [(16, "f32"), (64, "f32"), (64, "bf16")])
def test_spatial_packed_matches_jax_at_large_frames(dh, dt):
    """#10 (and #2's, #9's core) at S = 408, 401 valid keys."""
    rng = np.random.RandomState(400 + dh)
    qkv, jqkv = _pair(_randn(rng, 2, S_LARGE, 3 * HEADS * dh), dt)
    with jprecision.highest():
        want = ja.spatial_attention_packed(jqkv, HEADS, N_VALID_LARGE)
    _lib.reset_launches()
    with tprecision.highest():
        got = ta.spatial_attention_packed(qkv, HEADS, N_VALID_LARGE)
    _no_launch()
    _close(got, want, dt)


@pytest.mark.parametrize("dh", [16, 64])
def test_frame_attention_entries_match_jax_at_large_frames(dh):
    """#14 and #15 (no mask) and #13 (packed, masked; and its unpacked
    entry) at S = 408."""
    rng = np.random.RandomState(500 + dh)
    inner = HEADS * dh
    ins = [_pair(_randn(rng, 2, S_LARGE, inner)) for _ in range(4)]
    t, j = [a for a, _ in ins], [b for _, b in ins]
    one = [_pair(_randn(rng, 2, S_LARGE, dh)) for _ in range(3)]
    with jprecision.highest():
        want_mh = ja.fused_frame_attention_mh(*j[:3], heads=HEADS,
                                              interpret=True)
        want_one = ja.fused_frame_attention(*(b for _, b in one),
                                            interpret=True)
        want_bwd = ja.fused_frame_attention_bwd(*j, heads=HEADS,
                                                n_valid=N_VALID_LARGE,
                                                interpret=True)
    _lib.reset_launches()
    with tprecision.highest():
        _close(ta.fused_frame_attention_mh(*t[:3], HEADS), want_mh)
        _close(ta.fused_frame_attention(*(a for a, _ in one)), want_one)
        got = ta.fused_frame_attention_bwd(*t, HEADS, N_VALID_LARGE)
        packed = ta.spatial_attention_packed_bwd(torch.cat(t[:3], dim=-1),
                                                 t[3], HEADS, N_VALID_LARGE)
    for g, p, w in zip(got, packed.split(inner, dim=-1), want_bwd):
        _close_rel(g, w)
        _close_rel(p, w)
    _no_launch()


@pytest.mark.parametrize("dh", [16])
def test_mm_q8_ln_qkv_q8_spatial_matches_jax_at_large_frames(dh):
    """#2 (int8 out-projection -> LN -> int8 QKV -> the spatial core) at
    S = 408, 401 valid keys."""
    rng = np.random.RandomState(600 + dh)
    d, inner = 64, HEADS * dh
    arrs = (_randn(rng, 2, S_LARGE, inner, scale=0.3), *_q8(rng, inner, d),
            (rng.randn(d) * 0.01).astype(np.float32), *_ln(rng, d),
            *_q8(rng, d, 3 * inner))
    with jprecision.highest():
        want = np.asarray(jq.mm_q8_ln_qkv_q8_spatial_attention(
            *_j(*arrs), HEADS, N_VALID_LARGE))
    _lib.reset_launches()
    with tprecision.highest():
        got = tq.mm_q8_ln_qkv_q8_spatial_attention(*_t(*arrs), HEADS,
                                                   N_VALID_LARGE)
    _no_launch()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)


def _jax_layer(st, bt, wqt, wst, wot, sot, bot, ss, bs, wqs, wss, wos, sos,
               bos, sf, bf, w1q, w1s, b1, w2q, w2s, b2):
    """The quantized layer subtree jq.st_layer_q8 reads."""
    def attn(s_, b_, wq, ws, woq, wos_, bo):
        return {"norm": {"scale": s_, "bias": b_}, "to_out": {"b": bo},
                "q8": {"qkv_wq": wq, "qkv_ws": ws, "out_wq": woq,
                       "out_ws": wos_}}

    return {"attn_t": attn(st, bt, wqt, wst, wot, sot, bot),
            "attn_s": attn(ss, bs, wqs, wss, wos, sos, bos),
            "ff": {"norm": {"scale": sf, "bias": bf}, "fc1": {"b": b1},
                   "fc2": {"b": b2},
                   "q8": {"w1q": w1q, "w1s": w1s, "w2q": w2q, "w2s": w2s}}}


def _layer_stages(q, a, heads, n_valid):
    """One int8 ST layer as #1 -> #2 -> #3 of the quant module q."""
    x = a[0]
    b, t1, s, d = x.shape
    return [
        lambda _: q.ln_qkv_q8_temporal_attention(x, *a[1:5], heads),
        lambda a_t: q.mm_q8_ln_qkv_q8_spatial_attention(
            a_t.reshape(b * t1, s, -1), *a[5:12], heads, n_valid),
        lambda a_s: q.matmul_q8_res_ln_ff_q8_full(
            a_s.reshape(b, t1 * s, -1), x.reshape(b, t1 * s, d),
            *a[12:]).reshape(x.shape)]


@pytest.mark.parametrize("dh", [64])
def test_st_layer_q8_matches_jax_stage_by_stage_at_long_clips(dh):
    """#9 at T1 = 9, S = 408 (401 valid), as test_torch_quant.py holds it
    at the paper geometry: the port's plain layer equals the port's chain
    bit for bit, JAX's layer equals JAX's chain, and each stage of the
    port's chain fed the port's previous stage agrees with JAX's stage fed
    the same tensor within rel-L2 1e-3."""
    rng = np.random.RandomState(700 + dh)
    d, inner, hid = 64, HEADS * dh, 128
    x = _randn(rng, 1, 9, S_LARGE, d, scale=0.8)
    x[:, :, N_VALID_LARGE:] = 0.0

    def bias(n):
        return (rng.randn(n) * 0.01).astype(np.float32)

    arrs = (x, *_ln(rng, d), *_q8(rng, d, 3 * inner), *_q8(rng, inner, d),
            bias(d), *_ln(rng, d), *_q8(rng, d, 3 * inner),
            *_q8(rng, inner, d), bias(d), *_ln(rng, d), *_q8(rng, d, hid),
            bias(hid), *_q8(rng, hid, d), bias(d))
    jarr, tarr = _j(*arrs), _t(*arrs)
    with jprecision.highest():
        want = np.asarray(jq.st_layer_q8(jarr[0], _jax_layer(*jarr[1:]),
                                         HEADS, N_VALID_LARGE))
        v = None
        for stage in _layer_stages(jq, jarr, HEADS, N_VALID_LARGE):
            v = stage(v)
        np.testing.assert_array_equal(np.asarray(v), want)
    _lib.reset_launches()
    v = None
    with tprecision.highest():
        got = tq.st_layer_q8(*tarr, HEADS, N_VALID_LARGE)
        for i, (tstage, jstage) in enumerate(zip(
                _layer_stages(tq, tarr, HEADS, N_VALID_LARGE),
                _layer_stages(jq, jarr, HEADS, N_VALID_LARGE))):
            with jprecision.highest():
                ref = np.asarray(jstage(None if v is None
                                        else jnp.asarray(v.numpy())))
            v = tstage(v)
            rel = np.linalg.norm(v.numpy() - ref) / np.linalg.norm(ref)
            assert rel <= 1e-3, (i, rel)
    torch.testing.assert_close(got, v, atol=0, rtol=0)
    _no_launch()


# ---------------------------------------------------------------------------
# (b) a TINY-width model at num_frames = 8 (T1 = 9)

TINY8 = dict(num_frames=8, image_size=72, feat_hw=5, depth=1, num_classes=1,
             use_pallas=True)


@pytest.fixture(scope="module")
def tiny8_weights():
    """JAX's PRNGKey(0) init of the TINY8 model (float weights)."""
    return jistvt.init(jax.random.PRNGKey(0),
                       JaxConfig(**TINY8, quantize="none"))


@pytest.mark.parametrize("quantize, tol", [("int8", 1e-2), ("none", 1e-3)],
                         ids=["int8_ingest", "float"])
def test_tiny_model_at_seq_len_8_matches_jax(tiny8_weights, quantize, tol):
    """The int8 `ingest` forward and the float fused forward at T1 = 9 on
    JAX's PRNGKey(0) weights: logits within the paper geometry's limits,
    the padded S and n_valid JAX's, no kernel launched."""
    cfg = dict(TINY8, quantize=quantize)
    params, state = tiny8_weights
    if quantize == "int8":
        params = jistvt.quantize_params(params)
    clips = np.random.RandomState(8).randn(1, 8, 72, 72, 3).astype(
        np.float32)
    with jprecision.highest():
        want, _ = jistvt.apply(params, state, jnp.asarray(clips),
                               JaxConfig(**cfg))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    model = tistvt.init(ISTVTConfig(**cfg), torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(to_np(params), to_np(state)))
    if quantize == "none":
        tistvt.pack_params(model)
    _lib.reset_launches()
    with tprecision.highest(), torch.inference_mode():
        ct = torch.from_numpy(clips)
        _, s, n_valid = model.vit.tokens(model.features(ct))
        got = model(ct).numpy()
    _no_launch()
    assert (s, n_valid) == (32, 26)
    assert np.isfinite(got).all() and got.shape == (1, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# (c) geometry agreement, no compute

SEQ_LENS = (4, 6, 8, 16)
INPUT_SIZES = (224, 300, 320, 380, 448)


@pytest.mark.parametrize("input_size", INPUT_SIZES)
def test_fused_paths_take_every_geometry_jax_builds(input_size):
    """The feature grid is JAX's (models/istvt.infer_feat_hw); the port's
    token assembly (ISTVT.vit.tokens, with pad) gives the S and n_valid of
    JAX's apply (h w + 1 tokens padded to a multiple of 8,
    istvt_tpu/models/istvt.py:250-253) at every seq_len; and every launch
    check of the fused paths takes the paper config's (T1, S, inner,
    heads): the temporal cores (#11, #12, #16, #17, #1), the spatial cores
    (#10, #2, #14, #15), #13's dim_heads and #9's."""
    hw = jistvt.infer_feat_hw(input_size)
    assert tistvt.infer_feat_hw(input_size) == hw
    cfg = ISTVTConfig(image_size=input_size)
    inner, heads = cfg.inner_dim, cfg.heads
    s_valid = hw * hw + 1
    s_jax = s_valid + (-s_valid) % 8
    d = 4
    for seq_len in SEQ_LENS:
        # the token parameters tokens() reads, at a width of 4
        stub = SimpleNamespace(
            space_token=torch.zeros(1, 1, 1, d),
            pos_embedding=torch.zeros(1, seq_len, s_valid, d),
            temporal_token=torch.zeros(1, 1, d))
        x, s, n_valid = tistvt.DSTTr.tokens(
            stub, torch.zeros(1, seq_len, hw, hw, d))
        assert (s, n_valid) == (s_jax, s_valid), (seq_len, input_size)
        assert x.shape == (1, (seq_len + 1) * s, d)
        t1 = seq_len + 1
        ta.check_temporal(t1, inner, heads)
        ta.check_spatial(inner, heads)
        ta.check_spatial(inner, heads, dims=(16, 32, 64))
        ta.check_spatial(inner, heads, dims=(16, 64))
