"""Port Xception stem (istvt_tpu_torch/models/xception.py) vs the JAX
stem on the same weights (loaded through compat.from_jax), at 72^2 in
f32 with TF32 off on the port side and HIGHEST precision on the JAX side."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from istvt_tpu.core import precision as jprecision
from istvt_tpu.models import xception as jx
from istvt_tpu_torch.compat.from_jax import xception_state_dict
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.models import xception as tx


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
def stem():
    """JAX Xception params with non-trivial eval BN statistics, the port
    Xception loaded with the same weights, and a 2-frame 72^2 input."""
    p, s = jx.init(jax.random.PRNGKey(0), jx.XceptionConfig(num_classes=2))
    p, s = jax.tree_util.tree_map(np.asarray, (p, s))
    rng = np.random.RandomState(0)

    def randomize(pb, sb):
        c = pb["scale"].shape[0]
        pb["scale"] = (rng.rand(c) * 0.5 + 0.75).astype(np.float32)
        pb["bias"] = (rng.randn(c) * 0.1).astype(np.float32)
        sb["mean"] = (rng.randn(c) * 0.1).astype(np.float32)
        sb["var"] = (rng.rand(c) * 0.5 + 0.75).astype(np.float32)

    randomize(p["bn1"], s["bn1"])
    randomize(p["bn2"], s["bn2"])
    for b in (1, 2, 3):
        bp, bs = p[f"block{b}"], s[f"block{b}"]
        for u, us in zip(bp["rep"], bs["rep"]):
            randomize(u["bn"], us["bn"])
        randomize(bp["skipbn"], bs["skipbn"])
    model = tx.Xception(tx.XceptionConfig(num_classes=2))
    model.load_state_dict(xception_state_dict(p, s))
    x = rng.randn(2, 72, 72, 3).astype(np.float32)
    return p, s, model.eval(), x


def _jax_feats(p, s, x, store=None):
    with jprecision.highest():
        f, _ = jx.low_level_features(p, s, jnp.asarray(x), False,
                                     store_dtype=store)
    return np.asarray(f, np.float32)


def _port_feats(model, x, store=None):
    with tprecision.highest(), torch.inference_mode():
        return model.low_level_features(torch.from_numpy(x),
                                        store_dtype=store).numpy()


def test_low_level_features_eval_f32(stem):
    p, s, model, x = stem
    want = _jax_feats(p, s, x)
    got = _port_feats(model, x)
    assert got.shape == want.shape == (2, 5, 5, 728)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_f8_store_path_vs_jax_f8(stem):
    """Serving stem (f8 e4m3 storage between convs) vs JAX's: the f8 cast
    amplifies a last-ulp conv difference into a whole e4m3 step (1/16) at
    the elements that sit on a rounding boundary, so the aggregate gate is
    the existing f8 fidelity test's (tests/test_quant.py:290-293); away
    from those flips the two agree far closer."""
    p, s, model, x = stem
    want = _jax_feats(p, s, x, jnp.float8_e4m3fn)
    got = _port_feats(model, x, torch.float8_e4m3fn)
    assert got.dtype == np.float32 and got.shape == want.shape
    d = np.abs(got - want)
    assert d.mean() / (np.abs(want).mean() + 1e-9) < 0.08, d.mean()
    close = d <= 1e-4 + 1e-4 * np.abs(want)
    assert close.mean() > 0.95, close.mean()
    # and the f8 path is itself an e4m3 approximation of the f32 stem
    ref = _port_feats(model, x)
    dr = np.abs(got - ref)
    assert dr.mean() / (np.abs(ref).mean() + 1e-9) < 0.08


def _e4m3_probe_values():
    """Every finite e4m3 value, every midpoint between neighbours (the
    ties), tiny subnormal-range values, and values past the largest
    finite 448 (the tie with 480 is at 464)."""
    import ml_dtypes
    allv = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    fin = np.sort(allv.astype(np.float32)[np.isfinite(allv.astype(np.float32))])
    mids = (fin[:-1] + fin[1:]) / 2
    small = np.array([2.0 ** -10, 2.0 ** -10 * 1.5, 1e-12, 0.0], np.float32)
    big = np.array([449.0, 460.0, 464.0], np.float32)
    over = np.array([470.0, 480.0, 1e6, np.inf], np.float32)
    inrange = np.concatenate([fin, mids, small, -small, big, -big])
    return inrange.astype(np.float32), np.concatenate([over, -over])


@pytest.mark.parametrize("nonneg", [False, True])
@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16])
def test_f8_cast_matches_jax(src, nonneg):
    """The port's f8 store (xception.to_store) rounds exactly as
    jnp.astype(float8_e4m3fn) on every value: ties to even included, up to
    the +-464 tie, which both round to +-448, and NaN past it (torch's own
    cast saturates there to +-448; to_store puts JAX's NaN back). With
    nonneg (the ReLU outputs) on the values >= 0 only."""
    inrange, over = _e4m3_probe_values()
    for vals, is_over in ((inrange, False), (over, True)):
        if nonneg:
            vals = vals[vals >= 0]
        t_in = torch.from_numpy(vals).to(src)
        j_in = jnp.asarray(t_in.float().numpy()).astype(
            jnp.bfloat16 if src == torch.bfloat16 else jnp.float32)
        want = np.asarray(j_in.astype(jnp.float8_e4m3fn).astype(jnp.float32))
        got = tx.to_store(t_in, torch.float8_e4m3fn, nonneg=nonneg)
        assert got.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(got.float().numpy(), want)
        if is_over:
            assert np.isnan(want).all() and want.size >= 4
