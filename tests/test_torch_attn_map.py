"""The port's attention-map path and XLA-math forward vs the JAX package,
on the CPU at toy geometry (72^2, T = 3, feat_hw 5, depth 2, B = 2).

One set of weights runs through both packages: JAX `istvt.init`, carried
into the port by `compat.from_jax.params_from_jax`. The JAX side runs
under HIGHEST precision, its `fused_ff` Pallas kernel (#22) in interpret
mode; the port runs its plain versions in f32 with TF32 off. Both sides
compute the same f32 arithmetic in other summation orders, so:

  * exact GELU equals jax.nn.gelu(approximate=False) to 1e-6 (measured
    9.5e-7 absolute over [-8, 8]);
  * fused_ff_plain vs JAX fused_ff: f32 forward and every VJP output at
    max|diff| <= 1e-5 * max|ref| (measured <= 2.9e-7); bf16 at the card
    check's criterion (selfcheck.bf16_close; both round the hidden and
    the output to bf16 after other summation orders; measured rel-L2
    <= 1.9e-3, max|diff| <= 0.006 max|ref|);
  * the XLA-math attention branches with a bias: output and map at
    atol = rtol = 1e-5 in f32 (measured <= 1.8e-7 absolute), bf16 at
    bf16_close (measured rel-L2 <= 4.8e-5);
  * the use_pallas=False eval logits within 1e-3 absolute (ROADMAP queue 1
    item 1's criterion; measured 1.8e-7);
  * every layer's maps within atol 2e-6 (measured <= 4.8e-7), and every
    attn_bias gradient and the logits at rel-L2 <= 1e-4 (measured
    <= 1.2e-6), for both use_pallas values; the features-level entry
    (DSTTr.forward) the same.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from istvt_tpu.core import precision as jprecision
from istvt_tpu.core.config import ISTVTConfig as JaxConfig
from istvt_tpu.interpret.lrp import attention_maps_and_grads as j_amg
from istvt_tpu.kernels.mlp import fused_ff as j_fused_ff
from istvt_tpu.models import istvt as jistvt
from istvt_tpu.nn import attention as jattn
from istvt_tpu.nn.layers import gelu as j_gelu
from istvt_tpu_torch.compat.from_jax import params_from_jax
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.core.config import ISTVTConfig
from istvt_tpu_torch.interpret.lrp import (attention_maps_and_grads,
                                           bias_grads)
from istvt_tpu_torch.kernels import _lib, mlp, selfcheck
from istvt_tpu_torch.models import istvt as tistvt
from istvt_tpu_torch.nn import attention as tattn
from istvt_tpu_torch.nn.layers import gelu

TINY = dict(num_frames=3, image_size=72, feat_hw=5, depth=2, num_classes=1)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def weights():
    """JAX params / state as numpy, and a batch of two clips."""
    params, state = jistvt.init(jax.random.PRNGKey(0), JaxConfig(**TINY))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    clips = np.random.RandomState(5).randn(2, 3, 72, 72, 3).astype(
        np.float32)
    return to_np(params), to_np(state), clips


def _port(params, state, **kw):
    model = tistvt.init(ISTVTConfig(**TINY, **kw),
                        torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, state))   # strict
    return model


def test_gelu_is_exact_erf():
    x = np.linspace(-8, 8, 4001).astype(np.float32)
    want = np.asarray(j_gelu(jnp.asarray(x)))
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(), want,
                               atol=1e-6, rtol=1e-6)


def _ff_inputs(rows, d=128, hid=256, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(rows, d).astype(np.float32),
            (rng.rand(d, hid) * 2 - 1).astype(np.float32) * d ** -0.5,
            (rng.rand(hid) * 2 - 1).astype(np.float32) * d ** -0.5,
            (rng.rand(hid, d) * 2 - 1).astype(np.float32) * hid ** -0.5,
            (rng.rand(d) * 2 - 1).astype(np.float32) * hid ** -0.5,
            rng.randn(rows, d).astype(np.float32)]


@pytest.mark.parametrize("rows", [208, 203])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_fused_ff_plain_matches_pallas_forward_and_vjp(dt, rows):
    """#22: the port's fused_ff (its plain version on the CPU) vs JAX's
    fused_ff (the Pallas kernel in interpret mode), forward, and its
    backward (plain recompute on both sides) vs jax.vjp. 203 rows: not a
    multiple of 8, as the attention-map path's B * (T+1) * 362."""
    tdt, jdt = DTYPES[dt]
    x, w1, b1, w2, b2, g = _ff_inputs(rows)
    jin = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    jin[0] = jin[0].astype(jdt)
    with jprecision.highest():
        want, vjp = jax.vjp(j_fused_ff, *jin)
        want_grads = vjp(jnp.asarray(g).astype(jdt))
    tin = [torch.from_numpy(a).requires_grad_() for a in (x, w1, b1, w2, b2)]
    tx = tin[0].detach().to(tdt).requires_grad_()
    _lib.reset_launches()
    with tprecision.highest():
        got = mlp.fused_ff(tx, *tin[1:])
        got_grads = torch.autograd.grad(got, [tx, *tin[1:]],
                                        torch.from_numpy(g).to(tdt))
    assert all(v == 0 for v in _lib.LAUNCHES.values())
    assert got.dtype == tdt and got_grads[0].dtype == tdt
    pairs = [(got, want)] + list(zip(got_grads, want_grads))
    for i, (a, b) in enumerate(pairs):
        a = a.float().detach().numpy()
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        assert a.shape == b.shape, i
        if dt == "f32":
            err = np.abs(a - b).max() / np.abs(b).max()
            assert err <= 1e-5, (i, err)
        else:
            ok, rel, mx, scale = selfcheck.bf16_close(
                torch.from_numpy(a), torch.from_numpy(b.copy()))
            assert ok, (i, rel, mx, scale)


def _attn_module(branch, d, inner, rng):
    """A port attention module and the JAX params of the same weights."""
    lin = lambda i, o: ((rng.rand(i, o) * 2 - 1) * i ** -0.5).astype(  # noqa
        np.float32)
    w_out = lin(inner, d)
    b_out = ((rng.rand(d) * 2 - 1) * inner ** -0.5).astype(np.float32)
    if branch == "spatial":
        fn = tistvt.SpatialAttention(d, inner)
        w_qkv = lin(d, 3 * inner)
        p = {"to_qkv": {"w": w_qkv}}
        fn.to_qkv.weight.data = torch.from_numpy(w_qkv.T.copy())
    else:
        fn = tistvt.TemporalAttention(d, inner)
        w_qk, w_v = lin(d, 2 * inner), lin(d, inner)
        p = {"to_qk": {"w": w_qk}, "to_v": {"w": w_v}}
        fn.to_qk.weight.data = torch.from_numpy(w_qk.T.copy())
        fn.to_v.weight.data = torch.from_numpy(w_v.T.copy())
    p["to_out"] = {"w": w_out, "b": b_out}
    fn.to_out[0].weight.data = torch.from_numpy(w_out.T.copy())
    fn.to_out[0].bias.data = torch.from_numpy(b_out)
    return fn, p


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("branch", ["spatial", "temporal"])
def test_xla_attention_branch_matches_jax(branch, dt):
    """The XLA-math branches with a bias added after the softmax: output
    and the returned map (bias included) in the public order."""
    tdt, jdt = DTYPES[dt]
    b, t1, s, d, heads, dh = 2, 4, 26, 64, 4, 16
    rng = np.random.RandomState(3)
    fn, p = _attn_module(branch, d, heads * dh, rng)
    x = rng.randn(b, t1 * s, d).astype(np.float32)
    shape = ((b, heads, t1, s, s) if branch == "spatial"
             else (b, heads, s, t1, t1))
    bias = (0.01 * rng.randn(*shape)).astype(np.float32)
    jfn = (jattn.spatial_only_attention if branch == "spatial"
           else jattn.temporal_residual_attention)
    tfn = (tattn.spatial_only_attention if branch == "spatial"
           else tattn.temporal_residual_attention)
    with jprecision.highest():
        want_out, want_map = jfn(p, jnp.asarray(x).astype(jdt), heads, s,
                                 return_attn=True,
                                 attn_bias=jnp.asarray(bias))
    with tprecision.highest():
        got_out, got_map = tfn(fn.to(tdt), torch.from_numpy(x).to(tdt),
                               heads, s, return_attn=True,
                               attn_bias=torch.from_numpy(bias))
    assert got_out.dtype == tdt and got_map.dtype == torch.float32
    assert tuple(got_map.shape) == shape
    for got, want in ((got_out, want_out), (got_map, want_map)):
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        if dt == "f32":
            np.testing.assert_allclose(got.float().detach().numpy(), want,
                                       atol=1e-5, rtol=1e-5)
        else:
            ok, rel, mx, scale = selfcheck.bf16_close(
                got.float().detach(), torch.from_numpy(want.copy()))
            assert ok, (rel, mx, scale)


def test_xla_math_eval_logits_match_jax(weights):
    """ISTVTConfig(use_pallas=False): the eval forward through the unfused
    layer with exact GELU, and the same forward with every map returned."""
    params, state, clips = weights
    cfg = JaxConfig(**TINY)
    with jprecision.highest():
        want, _ = jistvt.apply(params, state, jnp.asarray(clips), cfg)
    want = np.asarray(want)
    model = _port(params, state, use_pallas=False)
    _lib.reset_launches()
    with tprecision.highest(), torch.no_grad():
        got = model(torch.from_numpy(clips)).numpy()
        got_attn, maps = model(torch.from_numpy(clips), return_attn=True)
    assert all(v == 0 for v in _lib.LAUNCHES.values())
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got_attn.numpy(), got)
    assert len(maps["t"]) == len(maps["s"]) == TINY["depth"]


_J_AMG = jax.jit(j_amg, static_argnames=("cfg", "index"))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_maps_and_grads_match_jax(weights, use_pallas):
    """Every layer's post-softmax maps and d logit / d attn_bias (the LRP
    inputs), and the logits, for both use_pallas values (True: the
    feed-forward is fused_ff, #22)."""
    params, state, clips = weights
    cfg = JaxConfig(**TINY, use_pallas=use_pallas)
    with jprecision.highest():
        want_a, want_g, want_l = _J_AMG(params, state, jnp.asarray(clips),
                                        cfg=cfg, index=0)
    model = _port(params, state, use_pallas=use_pallas)
    _lib.reset_launches()
    with tprecision.highest():
        got_a, got_g, got_l = attention_maps_and_grads(
            model, torch.from_numpy(clips), index=0)
    assert all(v == 0 for v in _lib.LAUNCHES.values())
    assert _rel_l2(got_l.numpy(), want_l) <= 1e-4
    for k in ("t", "s"):
        assert len(got_a[k]) == len(got_g[k]) == TINY["depth"]
        for i in range(TINY["depth"]):
            a, g = got_a[k][i].numpy(), got_g[k][i].numpy()
            assert a.shape == g.shape == want_a[k][i].shape
            np.testing.assert_allclose(a, want_a[k][i], atol=2e-6)
            assert _rel_l2(g, want_g[k][i]) <= 1e-4, (k, i)


def test_features_level_entry_matches_dsttr_apply(weights):
    """DSTTr.forward on (B, T, h, w, C) features: the counterpart of
    dsttr_apply with attn_bias (full_lrp's from_features)."""
    params, state, clips = weights
    cfg = JaxConfig(**TINY, use_pallas=True)
    feats = np.random.RandomState(6).randn(2, 3, 5, 5, 728).astype(
        np.float32)
    s, h, t1 = cfg.tokens_per_frame, cfg.heads, 4

    def f(bias):
        logits, attns = jistvt.dsttr_apply(params["vit"], feats, cfg,
                                           attn_bias=bias, return_attn=True)
        return jnp.sum(logits[:, 0]), (attns, logits)

    zero = {"t": [jnp.zeros((2, h, s, t1, t1))] * 2,
            "s": [jnp.zeros((2, h, t1, s, s))] * 2}
    with jprecision.highest():
        want_g, (want_a, want_l) = jax.jit(jax.grad(f, has_aux=True))(zero)
    model = _port(params, state, use_pallas=True)
    with tprecision.highest():
        got_a, got_g, got_l = bias_grads(model.vit, torch.from_numpy(feats),
                                         0, torch.device("cpu"))
    assert _rel_l2(got_l.numpy(), want_l) <= 1e-4
    for k in ("t", "s"):
        for i in range(2):
            np.testing.assert_allclose(got_a[k][i].numpy(), want_a[k][i],
                                       atol=2e-6)
            assert _rel_l2(got_g[k][i].numpy(), want_g[k][i]) <= 1e-4
