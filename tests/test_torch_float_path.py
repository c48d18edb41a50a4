"""The port's float fused ISTVT forward vs the JAX package at toy geometry.

One set of weights runs through both packages: JAX `istvt.init`, carried
into the port by `compat.from_jax.params_from_jax`. The JAX side runs
`istvt.apply(cfg(use_pallas=True))` (quantize='none') with its Pallas
kernels in interpret mode under HIGHEST precision; the port runs its plain
kernel versions in f32 on the CPU with TF32 off. There is no int8 or f8
rounding on this path, so the two chains differ only by summation order:
the stream after every layer and the logits are held at atol = rtol =
1e-3 and the stream at rel-L2 <= 1e-5 (measured rel-L2 2.1e-7 / 2.9e-7
after layers 0 / 1, max|dlogit| 3.6e-7).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from istvt_tpu.core import precision as jprecision
from istvt_tpu.core.config import ISTVTConfig as JaxConfig
from istvt_tpu.kernels.mlp import ln_ff_residual
from istvt_tpu.models import istvt as jistvt
from istvt_tpu.models import xception as jxception
from istvt_tpu.nn import attention as jattn
from istvt_tpu.nn.layers import layernorm, linear
from istvt_tpu_torch.compat.from_jax import params_from_jax
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.core.config import ISTVTConfig
from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.models import istvt as tistvt

TINY = dict(num_frames=2, image_size=72, feat_hw=5, depth=2, num_classes=1,
            use_pallas=True, quantize="none")


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
def jax_run():
    """Weights, clips, the JAX float chain's stream after every layer and
    istvt.apply's logits."""
    cfg = JaxConfig(**TINY)
    params, state = jistvt.init(jax.random.PRNGKey(1), cfg)
    clips = np.random.RandomState(4).randn(2, 2, 72, 72, 3).astype(
        np.float32)
    with jprecision.highest():
        want_logits, _ = jistvt.apply(params, state, jnp.asarray(clips), cfg)
        streams, chain_logits = _jax_streams(params, state,
                                             jnp.asarray(clips), cfg)
    want_logits = np.asarray(want_logits)
    np.testing.assert_allclose(chain_logits, want_logits, atol=1e-6)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(state), clips, streams, want_logits


def _jax_streams(params, state, clips, cfg):
    """The JAX float fused chain layer by layer (models/istvt.py:201-254,
    :357-373, :478-482): the stream after every layer, then the logits."""
    vp = params["vit"]
    b, t = clips.shape[:2]
    feats, _ = jxception.low_level_features(
        params["xcep"], state["xcep"], clips.reshape(b * t, *clips.shape[2:]),
        False, use_pallas=True)
    fh, d = feats.shape[1], feats.shape[-1]
    x = feats.reshape(b, t, fh * fh, d)
    s = fh * fh + 1
    cls = jnp.broadcast_to(vp["space_token"], (b, t, 1, d))
    x = jnp.concatenate([cls, x], axis=2) + vp["pos_embedding"][:, :t, :s]
    ct = jnp.broadcast_to(vp["temporal_token"][:, :, None, :], (b, 1, s, d))
    x = jnp.concatenate([ct, x], axis=1)
    s_valid, s = s, s + (-s) % 8
    x = jnp.pad(x, ((0, 0), (0, 0), (0, s - s_valid), (0, 0)))
    x = x.reshape(b, (t + 1) * s, d)
    streams = []
    for layer in vp["layers"]:
        out_t = jattn.temporal_block_fused(layer["attn_t"], x, cfg.heads, s)
        x = jattn.spatial_block_fused(layer["attn_s"], out_t, cfg.heads, s,
                                      residual=x, n_valid=s_valid)
        pf = layer["ff"]
        x = ln_ff_residual(x, pf["norm"]["scale"], pf["norm"]["bias"],
                           pf["fc1"]["w"], pf["fc1"]["b"], pf["fc2"]["w"],
                           pf["fc2"]["b"])
        streams.append(np.asarray(x))
    cls = layernorm(vp["norm"], x).reshape(b, t + 1, s, d)[:, 0, 0]
    logits = linear(vp["mlp_head"]["fc"], layernorm(vp["mlp_head"]["norm"],
                                                    cls))
    return streams, np.asarray(logits)


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_float_fused_forward_matches_jax_per_layer_and_logits(jax_run):
    params, state, clips, want_streams, want_logits = jax_run
    model = tistvt.init(ISTVTConfig(**TINY), torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, state))   # strict
    tistvt.pack_params(model)
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
        assert _rel_l2(got, want) <= 1e-5, (i, _rel_l2(got, want))
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    assert np.isfinite(logits).all() and logits.shape == (2, 1)
    np.testing.assert_allclose(logits, want_logits, atol=1e-3, rtol=1e-3)


def test_float_model_rejects_unported_options(jax_run):
    params, state, *_ = jax_run
    model = tistvt.init(ISTVTConfig(**TINY), torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, state))
    clips = torch.zeros(1, 2, 72, 72, 3)
    with pytest.raises(RuntimeError, match="pack_params"):
        model(clips)
    tistvt.pack_params(model)
    # the (in, out) copies are buffers outside the state_dict
    assert set(model.state_dict()) == set(params_from_jax(params, state))
    at = model.vit.transformer.layers[0][0].fn
    assert torch.equal(at.qkv_w, torch.cat([at.to_qk.weight.t(),
                                            at.to_v.weight.t()], dim=1))
    # attention maps run the unfused layer at S = 26, unpadded (ported:
    # tests/test_torch_attn_map.py holds them against JAX)
    with torch.no_grad():
        logits, attns = model(clips, return_attn=True)
    assert logits.shape == (1, 1)
    assert [a.shape for a in attns["s"]] == [(1, 8, 3, 26, 26)] * 2
    assert [a.shape for a in attns["t"]] == [(1, 8, 26, 3, 3)] * 2
    # in train mode too, the maps keeping their autograd graph (ported:
    # tests/test_torch_distill.py holds them against JAX); the int8 path
    # in train mode still raises
    _, attns = model.train()(clips, return_attn=True)
    assert all(a.requires_grad for a in attns["s"] + attns["t"])
    model.cfg = ISTVTConfig(**{**TINY, "quantize": "int8"})
    with pytest.raises(NotImplementedError, match="quantize='int8'"):
        model(clips, return_attn=True)
    model.eval()
    model.cfg = ISTVTConfig(**{**TINY, "quantize": "int4"})
    with pytest.raises(ValueError, match="quantize"):
        model(clips)
