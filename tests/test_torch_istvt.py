"""The port's int8 ISTVT serving slice vs the JAX package at toy geometry.

One set of weights runs through both packages: JAX `istvt.init` +
`quantize_params`, carried into the port by `compat.from_jax`. The JAX side
runs `istvt.apply(cfg(use_pallas=True, quantize='int8'))` with its Pallas
kernels in interpret mode under HIGHEST precision; the port runs its plain
kernel versions in f32 on the CPU with TF32 off.

Every kernel of every layer, fed JAX's own input to that kernel, agrees
with JAX to rel-L2 <= 1e-3, and so does the stream after every layer
(measured 4e-8 to 1.3e-7, and 1.2e-5 for layer 1's last kernel, where one
int8 code flips inside it).

Run free from the clips, the two chains drift further apart, so there the
stream after every layer is held at rel-L2 <= 1e-2 beside the logits
(atol = rtol = 1e-2; random-init logits are nearly constant across clips,
which is why the stream is checked too). The chain rounds to f8 between
the stem's convs and to int8 at every kernel boundary, so an ulp-level
difference (a conv or softmax summation order) that lands on a rounding
boundary flips one code, and the next attention spreads it over the whole
frame: one flipped code at the input of layer 0's second kernel moves the
stream after layer 0 by 9.6e-4, and the stems differ in 967 of 72800 f8
features (rel-L2 9.6e-3). Measured at this geometry: 2.6e-3 and 4.6e-3
after layers 0 and 1 for these clips; 1e-5 for clips where no code flips.

The int8 A/B modes (ISTVTConfig.q8_ff / q8_attn: ('full', 'boundary'),
('full', 'layer'), ('mixed', *), ('bf16', *), and any other q8_ff, here
'int8'; models/istvt.py:258-356) are held the same way, each against one
JAX run of its own: every kernel of every layer on JAX's own inputs at
rel-L2 <= 1e-3, the free-running stream after every layer at rel-L2 <=
1e-2 and the logits at atol = rtol = 1e-2 (measured: kernels <= 6.4e-5,
where one int8 code flips in layer 1's first GEMM, else <= 1.2e-5;
'layer''s one kernel is a whole layer, inside which such a flip spreads
over its frame, 9.6e-4; streams <= 4.6e-3; |dlogit| <= 2.1e-3). The
'layer' and 'int8' models load JAX's quantized weights and run without
pack_params. In the 'mixed' and 'bf16' modes q8_attn is not read, so
('mixed', 'layer') equals ('mixed', 'ingest') bit for bit on the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from istvt_tpu.compat.torch_import import istvt_from_torch
from istvt_tpu.core import precision as jprecision
from istvt_tpu.core.config import ISTVTConfig as JaxConfig
from istvt_tpu.core.tree import flatten_with_paths
from istvt_tpu.kernels import attention as jattn
from istvt_tpu.kernels import mlp as jmlp
from istvt_tpu.kernels import quant as jq
from istvt_tpu.models import istvt as jistvt
from istvt_tpu.models import xception as jxception
from istvt_tpu.nn.layers import layernorm, linear
from istvt_tpu_torch.compat.from_jax import params_from_jax
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.core.config import ISTVTConfig
from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.kernels import attention as tattn
from istvt_tpu_torch.kernels import mlp as tmlp
from istvt_tpu_torch.kernels import quant as tq
from istvt_tpu_torch.models import istvt as tistvt

TINY = dict(num_frames=2, image_size=72, feat_hw=5, depth=2, num_classes=1,
            use_pallas=True, quantize="int8")
TINY_HEADS = ISTVTConfig(**TINY).heads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    params, state = jistvt.init(jax.random.PRNGKey(0), JaxConfig(**TINY))
    qparams = jistvt.quantize_params(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(qparams), to_np(state)


def _port(params, state) -> tistvt.ISTVT:
    model = tistvt.init(ISTVTConfig(**TINY), torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, state))
    return model


def test_params_from_jax_and_quantize_params_bitwise(weights):
    params, qparams, state = weights
    loaded = _port(qparams, state)            # strict load, q8 included
    requant = tistvt.quantize_params(_port(params, state))
    for i, (pt, ps, pf) in enumerate(requant.vit.transformer.layers):
        jl = qparams["vit"]["layers"][i]
        lt, ls, lf = loaded.vit.transformer.layers[i]
        for mod, lmod, key in ((pt.fn, lt.fn, "attn_t"), (ps.fn, ls.fn, "attn_s"),
                               (pf.fn, lf.fn, "ff")):
            for name, leaf in jl[key]["q8"].items():
                mine = getattr(mod, name)
                assert mine.dtype == torch.from_numpy(np.array(leaf)).dtype
                np.testing.assert_array_equal(mine.numpy(), leaf, err_msg=name)
                np.testing.assert_array_equal(getattr(lmod, name).numpy(), leaf)


def test_port_state_dict_loads_back_into_jax(weights):
    """The port's state_dict uses the reference torch names: the JAX
    package's own converter reads it back to the same float leaves."""
    params, _, state = weights
    model = _port(params, state)
    back_p, back_s = istvt_from_torch(model.state_dict(), depth=TINY["depth"])
    for tree, back in ((params, back_p), (state, back_s)):
        want, got = flatten_with_paths(tree), flatten_with_paths(back)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                          err_msg=k)


def _jax_tokens(qparams, state, clips):
    """The JAX int8 stem and token assembly (models/istvt.py:201-254): the
    padded stream (B, (T+1) * S, D), S and n_valid."""
    vp = qparams["vit"]
    b, t = clips.shape[:2]
    x = clips.reshape(b * t, *clips.shape[2:])
    feats, _ = jxception.low_level_features(
        qparams["xcep"], state["xcep"], x, False, use_pallas=True,
        store_dtype=jnp.float8_e4m3fn)
    fh, d = feats.shape[1], feats.shape[-1]
    x = feats.reshape(b, t, fh * fh, d)
    s = fh * fh + 1
    cls = jnp.broadcast_to(vp["space_token"].astype(x.dtype), (b, t, 1, d))
    x = jnp.concatenate([cls, x], axis=2) + vp["pos_embedding"][:, :t, :s]
    ct = jnp.broadcast_to(vp["temporal_token"][:, :, None, :], (b, 1, s, d))
    x = jnp.concatenate([ct, x], axis=1)
    s_valid, s = s, s + (-s) % 8
    x = jnp.pad(x, ((0, 0), (0, 0), (0, s - s_valid), (0, 0)))
    return x.reshape(b, (t + 1) * s, d), s, s_valid


def _jax_head(vp, x, s):
    """LN and mlp_head on the (temporal-CLS, spatial-CLS) token."""
    b, n, d = x.shape
    cls = layernorm(vp["norm"], x).reshape(b, n // s, s, d)[:, 0, 0]
    return linear(vp["mlp_head"]["fc"], layernorm(vp["mlp_head"]["norm"],
                                                  cls))


def _jax_streams(qparams, state, clips, cfg):
    """JAX int8 chain layer by layer (the calls of models/istvt.py:201-254,
    :284-318, :478-482): per layer the input x and the outputs a_t, a_s
    and x of its three kernels, then the logits."""
    vp = qparams["vit"]
    b, t = clips.shape[:2]
    x, s, s_valid = _jax_tokens(qparams, state, clips)
    d = x.shape[-1]
    per_layer = []
    for layer in vp["layers"]:
        x_in = x
        at, asp, pf = layer["attn_t"], layer["attn_s"], layer["ff"]
        q_t, q_s, q_f = at["q8"], asp["q8"], pf["q8"]
        inner = q_t["qkv_wq"].shape[1] // 3
        a_t = jq.ln_qkv_q8_temporal_attention(
            x.reshape(b, t + 1, s, d), at["norm"]["scale"],
            at["norm"]["bias"], q_t["qkv_wq"], q_t["qkv_ws"], cfg.heads)
        a_s = jq.mm_q8_ln_qkv_q8_spatial_attention(
            a_t.reshape(b * (t + 1), s, inner), q_t["out_wq"],
            q_t["out_ws"], at["to_out"]["b"], asp["norm"]["scale"],
            asp["norm"]["bias"], q_s["qkv_wq"], q_s["qkv_ws"], cfg.heads,
            s_valid)
        x = jq.matmul_q8_res_ln_ff_q8_full(
            a_s.reshape(b, (t + 1) * s, inner), x, q_s["out_wq"],
            q_s["out_ws"], asp["to_out"]["b"], pf["norm"]["scale"],
            pf["norm"]["bias"], q_f["w1q"], q_f["w1s"], pf["fc1"]["b"],
            q_f["w2q"], q_f["w2s"], pf["fc2"]["b"])
        per_layer.append(tuple(np.asarray(v) for v in (x_in, a_t, a_s, x)))
    return per_layer, np.asarray(_jax_head(vp, x, s))


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def jax_run(weights):
    """clips, JAX's per-layer kernel inputs/outputs, istvt.apply's logits."""
    _, qparams, state = weights
    cfg = JaxConfig(**TINY)
    clips = np.random.RandomState(3).randn(2, 2, 72, 72, 3).astype(np.float32)
    with jprecision.highest():
        want_logits, _ = jistvt.apply(qparams, state, jnp.asarray(clips), cfg)
        per_layer, chain_logits = _jax_streams(qparams, state,
                                               jnp.asarray(clips), cfg)
    want_logits = np.asarray(want_logits)
    np.testing.assert_allclose(chain_logits, want_logits, atol=1e-6)
    return clips, per_layer, want_logits


def test_int8_kernels_match_jax_on_the_models_own_activations(weights,
                                                              jax_run):
    """Every kernel of every layer, fed JAX's own input to that kernel: its
    output, and so the stream after every layer, within rel-L2 1e-3."""
    _, qparams, state = weights
    _, per_layer, _ = jax_run
    model = _port(qparams, state)
    heads, n_valid = TINY_HEADS, 26
    _lib.reset_launches()
    with tprecision.highest(), torch.inference_mode():
        for i, (pt, ps, pf) in enumerate(model.vit.transformer.layers):
            at, asp, ff = pt.fn, ps.fn, pf.fn
            x, a_t, a_s, want = (torch.tensor(v) for v in per_layer[i])
            b, nq, d = x.shape
            got = {
                "a_t": tq.ln_qkv_q8_temporal_attention(
                    x.reshape(a_t.shape[:3] + (d,)), pt.norm.weight,
                    pt.norm.bias, at.qkv_wq, at.qkv_ws, heads),
                "a_s": tq.mm_q8_ln_qkv_q8_spatial_attention(
                    a_t.reshape(a_s.shape[0], -1, a_t.shape[-1]), at.out_wq,
                    at.out_ws, at.to_out[0].bias, ps.norm.weight,
                    ps.norm.bias, asp.qkv_wq, asp.qkv_ws, heads, n_valid),
                "x": tq.matmul_q8_res_ln_ff_q8_full(
                    a_s.reshape(b, nq, -1), x, asp.out_wq, asp.out_ws,
                    asp.to_out[0].bias, pf.norm.weight, pf.norm.bias, ff.w1q,
                    ff.w1s, ff.net[0].bias, ff.w2q, ff.w2s, ff.net[3].bias),
            }
            for name, ref in (("a_t", a_t), ("a_s", a_s), ("x", want)):
                rel = _rel_l2(got[name].reshape(ref.shape).numpy(),
                              ref.numpy())
                assert rel <= 1e-3, (i, name, rel)
    assert all(v == 0 for v in _lib.LAUNCHES.values())


def test_int8_slice_matches_jax_per_layer_and_logits(weights, jax_run):
    _, qparams, state = weights
    clips, per_layer, want_logits = jax_run
    want_streams = [v[-1] for v in per_layer]
    model = _port(qparams, state)
    _lib.reset_launches()
    with tprecision.highest(), torch.inference_mode():
        ct = torch.from_numpy(clips)
        x, s, n_valid = model.vit.tokens(model.features(ct))
        assert (s, n_valid) == (32, 26)
        streams = []
        for layer in model.vit.transformer.layers:
            x = model.vit.run_layer(layer, x, s, n_valid)
            streams.append(x.numpy())
        logits = model.vit.head(x).numpy()
        np.testing.assert_array_equal(model(ct).numpy(), logits)
    assert all(v == 0 for v in _lib.LAUNCHES.values())
    for i, (got, want) in enumerate(zip(streams, want_streams)):
        rel = _rel_l2(got, want)
        assert rel <= 1e-2, (i, rel)
    assert np.isfinite(logits).all() and logits.shape == (2, 1)
    np.testing.assert_allclose(logits, want_logits, atol=1e-2, rtol=1e-2)


def test_unported_paths_raise(weights):
    """Every int8 mode runs: q8_attn='layer' (#9) and a q8_ff outside
    'full' / 'mixed' / 'bf16' (#7, models/istvt.py:350-356) on a model
    without pack_params (they read the int8 copies only), with finite
    logits; 'mixed' / 'bf16' without pack_params raise naming it; an int8
    model without its int8 copies raises; an int8 config off the fused
    path warns that it runs float."""
    params, qparams, state = weights
    model = _port(qparams, state)
    clips = torch.zeros(1, 2, 72, 72, 3)
    for kw in (dict(q8_attn="layer"), dict(q8_ff="int8")):
        model.cfg = ISTVTConfig(**{**TINY, **kw})
        with torch.no_grad():
            logits = model(clips)
        assert logits.shape == (1, 1) and torch.isfinite(logits).all()
    for ff in ("mixed", "bf16"):
        model.cfg = ISTVTConfig(**{**TINY, "q8_ff": ff})
        with pytest.raises(RuntimeError, match="pack_params"):
            model(clips)
    # an int8 config whose path is off the fused kernels (use_pallas=False,
    # attention maps) runs float and warns, as models/istvt.py:238-248
    # does; tests/test_torch_attn_map.py holds that path against JAX
    model.cfg = ISTVTConfig(**{**TINY, "use_pallas": False})
    with pytest.warns(UserWarning, match="running FLOAT"):
        with torch.no_grad():
            assert torch.isfinite(model(clips)).all()
    model.cfg = ISTVTConfig(**TINY)
    with pytest.warns(UserWarning, match="running FLOAT"):
        with torch.no_grad():
            logits, _ = model(clips, return_attn=True)
    assert torch.isfinite(logits).all()
    with pytest.raises(NotImplementedError):
        model.train()(clips)
    model.eval()
    with pytest.raises(RuntimeError, match="quantize_params"):
        _port(params, state)(clips)


# ---------------------------------------------------------------------------
# the int8 A/B modes: (q8_ff, q8_attn)

MODES = {"boundary": ("full", "boundary"), "mixed": ("mixed", "ingest"),
         "bf16": ("bf16", "ingest"), "mixed_layer": ("mixed", "layer"),
         "layer": ("full", "layer"), "ff_int8": ("int8", "ingest")}
_JAX_NS = (jq, jattn, jmlp)
_PORT_NS = (tq, tattn, tmlp)


def _st_layer(q, x, p, heads, n_valid):
    """kernels/quant.st_layer_q8 of either package on layer p (the JAX
    tree's layout): JAX's takes the tree, the port's its leaves in
    _st_layer_q8_impl's order."""
    if q is jq:
        return jq.st_layer_q8(x, p, heads, n_valid)
    at, asp, ff = p["attn_t"], p["attn_s"], p["ff"]
    args = []
    for blk in (at, asp):
        args += [blk["norm"]["scale"], blk["norm"]["bias"],
                 blk["q8"]["qkv_wq"], blk["q8"]["qkv_ws"],
                 blk["q8"]["out_wq"], blk["q8"]["out_ws"], blk["to_out"]["b"]]
    args += [ff["norm"]["scale"], ff["norm"]["bias"], ff["q8"]["w1q"],
             ff["q8"]["w1s"], ff["fc1"]["b"], ff["q8"]["w2q"],
             ff["q8"]["w2s"], ff["fc2"]["b"]]
    return tq.st_layer_q8(x, *args, heads, n_valid)


def _layer_steps(ns, p, mode, heads, s, n_valid, shape):
    """One ST layer of an A/B mode, (q8_ff, q8_attn), as its kernel calls,
    in order: [(name, fn(env) -> output)], env holding the layer input 'x'
    and each earlier output by name; 'out' is the layer's output. ns: the
    (quant, attention, mlp) kernel modules of one package, p the layer's
    weights in the JAX tree's layout (istvt.py:258-356;
    nn/attention.py:220-257)."""
    q, att, mlp = ns
    q8_ff, q8_attn = mode
    b, nq, d = shape
    t1 = nq // s
    at, asp, ff = p["attn_t"], p["attn_s"], p["ff"]
    inner = at["q8"]["qkv_wq"].shape[1] // 3
    if q8_ff == "full" and q8_attn == "layer":
        return [("out", lambda e: _st_layer(
            q, e["x"].reshape(b, t1, s, d), p, heads,
            n_valid).reshape(shape))]

    def ln_qkv(src, blk):
        return lambda e: q.ln_matmul_q8(
            e[src], blk["norm"]["scale"], blk["norm"]["bias"],
            blk["q8"]["qkv_wq"], blk["q8"]["qkv_ws"])

    def out_proj(src, blk, res):
        return lambda e: q.matmul_q8_bias_residual(
            e[src].reshape(b, nq, inner), blk["q8"]["out_wq"],
            blk["q8"]["out_ws"], blk["to_out"]["b"],
            e["x"] if res else None)

    t_core = ("a_t", lambda e: att.temporal_attention_packed(
        e["qkv_t"].reshape(b, t1, s, 3 * inner), heads))
    s_core = ("a_s", lambda e: att.spatial_attention_packed(
        e["qkv_s"].reshape(b * t1, s, 3 * inner), heads, n_valid))
    if q8_ff == "full":
        return [
            ("qkv_t", ln_qkv("x", at)), t_core,
            ("qkv_s", lambda e: q.matmul_q8_ln_matmul_q8(
                e["a_t"].reshape(b, nq, inner), at["q8"]["out_wq"],
                at["q8"]["out_ws"], at["to_out"]["b"],
                asp["norm"]["scale"], asp["norm"]["bias"],
                asp["q8"]["qkv_wq"], asp["q8"]["qkv_ws"])), s_core,
            ("out", lambda e: q.matmul_q8_res_ln_ff_q8_full(
                e["a_s"].reshape(b, nq, inner), e["x"], asp["q8"]["out_wq"],
                asp["q8"]["out_ws"], asp["to_out"]["b"],
                ff["norm"]["scale"], ff["norm"]["bias"], ff["q8"]["w1q"],
                ff["q8"]["w1s"], ff["fc1"]["b"], ff["q8"]["w2q"],
                ff["q8"]["w2s"], ff["fc2"]["b"]))]
    if q8_ff == "mixed":
        ff_step = lambda e: q.ln_ff_residual_q8(  # noqa: E731
            e["y"], ff["norm"]["scale"], ff["norm"]["bias"], ff["q8"]["w1q"],
            ff["q8"]["w1s"], ff["fc1"]["b"], ff["fc2"]["w"], ff["fc2"]["b"])
    elif q8_ff == "bf16":
        ff_step = lambda e: mlp.ln_ff_residual(  # noqa: E731
            e["y"], ff["norm"]["scale"], ff["norm"]["bias"], ff["fc1"]["w"],
            ff["fc1"]["b"], ff["fc2"]["w"], ff["fc2"]["b"])
    else:
        ff_step = lambda e: q.ln_ff_residual_q8_full(  # noqa: E731
            e["y"], ff["norm"]["scale"], ff["norm"]["bias"], ff["q8"]["w1q"],
            ff["q8"]["w1s"], ff["fc1"]["b"], ff["q8"]["w2q"], ff["q8"]["w2s"],
            ff["fc2"]["b"])
    return [("qkv_t", ln_qkv("x", at)), t_core,
            ("o_t", out_proj("a_t", at, False)),
            ("qkv_s", ln_qkv("o_t", asp)), s_core,
            ("y", out_proj("a_s", asp, True)), ("out", ff_step)]


def _port_layer_params(layer):
    """A port layer's weights in the JAX tree's layout: the int8 copies,
    and the FF's (in, out) copies that pack_params attached."""
    pt, ps, pf = layer

    def blk(pre, **rest):
        return {"norm": {"scale": pre.norm.weight, "bias": pre.norm.bias},
                "q8": {n: getattr(pre.fn, n) for n in pre.fn.q8_names},
                **rest}

    ff = pf.fn
    return {"attn_t": blk(pt, to_out={"b": pt.fn.to_out[0].bias}),
            "attn_s": blk(ps, to_out={"b": ps.fn.to_out[0].bias}),
            "ff": blk(pf, fc1={"w": ff.w1, "b": ff.net[0].bias},
                      fc2={"w": ff.w2, "b": ff.net[3].bias})}


@pytest.fixture(scope="module")
def jax_tokens(weights):
    """The clips of jax_run and JAX's stream entering layer 0."""
    _, qparams, state = weights
    clips = np.random.RandomState(3).randn(2, 2, 72, 72, 3).astype(np.float32)
    with jprecision.highest():
        x, s, s_valid = _jax_tokens(qparams, state, jnp.asarray(clips))
    return clips, np.asarray(x), s, s_valid


@pytest.fixture(scope="module", params=list(MODES))
def jax_mode_run(request, weights, jax_tokens):
    """One JAX run of a mode: istvt.apply's logits, and its chain layer by
    layer with every kernel's output (env per layer)."""
    _, qparams, state = weights
    clips, x, s, s_valid = jax_tokens
    q8_ff, q8_attn = MODES[request.param]
    cfg = JaxConfig(**TINY, q8_ff=q8_ff, q8_attn=q8_attn)
    jp = jax.tree_util.tree_map(jnp.asarray, qparams)
    envs = []
    with jprecision.highest():
        want_logits, _ = jistvt.apply(jp, state, jnp.asarray(clips), cfg)
        x = jnp.asarray(x)
        for layer in jp["vit"]["layers"]:
            env = {"x": x}
            for name, fn in _layer_steps(_JAX_NS, layer, MODES[request.param],
                                         cfg.heads, s, s_valid, x.shape):
                env[name] = fn(env)
            envs.append({k: np.asarray(v) for k, v in env.items()})
            x = env["out"]
        chain_logits = np.asarray(_jax_head(jp["vit"], x, s))
    want_logits = np.asarray(want_logits)
    np.testing.assert_allclose(chain_logits, want_logits, atol=1e-6)
    return request.param, envs, want_logits


def _port_mode(qparams, state, mode):
    """The port model from JAX's quantized weights (params_from_jax) in the
    mode; pack_params only for the modes whose FF reads float copies
    ('mixed', 'bf16'): the others run from the int8 copies alone."""
    model = _port(qparams, state)
    q8_ff, q8_attn = MODES[mode]
    if q8_ff in ("mixed", "bf16"):
        tistvt.pack_params(model)
    model.cfg = ISTVTConfig(**TINY, q8_ff=q8_ff, q8_attn=q8_attn)
    return model


def test_ab_mode_kernels_match_jax_on_the_models_own_activations(
        weights, jax_mode_run):
    """Every kernel of every layer of the mode, fed JAX's own inputs to
    it: its output within rel-L2 1e-3, every launch counter 0."""
    _, qparams, state = weights
    mode, envs, _ = jax_mode_run
    model = _port_mode(qparams, state, mode)
    _lib.reset_launches()
    with tprecision.highest(), torch.inference_mode():
        for i, layer in enumerate(model.vit.transformer.layers):
            env = {k: torch.tensor(v) for k, v in envs[i].items()}
            steps = _layer_steps(_PORT_NS, _port_layer_params(layer),
                                 MODES[mode], TINY_HEADS, 32, 26,
                                 env["x"].shape)
            assert [n for n, _ in steps] == list(envs[i])[1:]
            for name, fn in steps:
                got = fn(env).reshape(env[name].shape).numpy()
                rel = _rel_l2(got, envs[i][name])
                assert rel <= 1e-3, (mode, i, name, rel)
    assert all(v == 0 for v in _lib.LAUNCHES.values())


def test_ab_mode_slice_matches_jax_per_layer_and_logits(weights,
                                                        jax_mode_run):
    """The port's model path of the mode (DSTTr.run_layer) run free from
    the clips: the stream after every layer within rel-L2 1e-2 of JAX's,
    the logits within atol = rtol = 1e-2 of istvt.apply's; every launch
    counter 0. ('mixed', 'layer') equals ('mixed', 'ingest') bit for
    bit."""
    _, qparams, state = weights
    mode, envs, want_logits = jax_mode_run
    clips = np.random.RandomState(3).randn(2, 2, 72, 72, 3).astype(np.float32)
    ct = torch.from_numpy(clips)
    model = _port_mode(qparams, state, mode)
    _lib.reset_launches()
    with tprecision.highest(), torch.inference_mode():
        x, s, n_valid = model.vit.tokens(model.features(ct))
        streams = []
        for layer in model.vit.transformer.layers:
            x = model.vit.run_layer(layer, x, s, n_valid)
            streams.append(x.numpy())
        logits = model.vit.head(x).numpy()
        np.testing.assert_array_equal(model(ct).numpy(), logits)
        if mode == "mixed_layer":
            np.testing.assert_array_equal(
                _port_mode(qparams, state, "mixed")(ct).numpy(), logits)
    assert all(v == 0 for v in _lib.LAUNCHES.values())
    for i, env in enumerate(envs):
        rel = _rel_l2(streams[i], env["out"])
        assert rel <= 1e-2, (mode, i, rel)
    assert np.isfinite(logits).all() and logits.shape == (2, 1)
    np.testing.assert_allclose(logits, want_logits, atol=1e-2, rtol=1e-2)


def test_infer_feat_hw_matches_table():
    assert tistvt.infer_feat_hw(300) == 19
    tistvt._FEAT_HW.pop(75, None)
    assert tistvt.infer_feat_hw(75) == jistvt.infer_feat_hw(75) == 5
    assert tistvt.infer_feat_hw(100) == 6
