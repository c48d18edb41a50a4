"""The port's train step with dropout (istvt_tpu_torch/models/istvt.py,
train/step.py) against JAX's make_train_step, on the CPU at the TINY
geometry of tests/test_torch_train_step.py (T = 2, 72^2, depth 2) in f32:
the XLA-math path (use_pallas=False) and the fused path with dropout 0.5
(its attention on the kernels, the feed-forward in plain math with its
two dropouts on the padded stream), both from one set of weights and the
same masks.

JAX's masks come from threefry, which torch cannot reproduce: the test
replaces istvt_tpu.models.istvt.dropout (monkeypatch on the module
attribute; no JAX file changes) by a stand-in that takes its masks, in
call order, from a numpy list, and hands the port the same list through
its mask source (nn/layers.dropout_mask's callable form). JAX's step is
jitted, so the stand-in runs at trace time and both of its steps apply
the list's masks; the port's source hands out the same list on each step.
Bounds: tests/test_torch_train_step.py's f32 ones (its TOL), measured
within them.

Then, on the port alone: remat (torch.utils.checkpoint a layer, the masks
drawn before the layer and passed in) gives the gradients of the run
without it, bit for bit; the port's own masks keep 1 - rate of the values
within 3 sigma and scale them by 1 / keep; and the static-patch and
graded-amplitude synthetic clips equal JAX's.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from istvt_tpu.compat.torch_import import istvt_from_torch
from istvt_tpu.core import config as jconfig
from istvt_tpu.core import precision as jprecision
from istvt_tpu.data.video_dataset import SyntheticVideoDataset as JaxSynth
from istvt_tpu.models import istvt as jistvt_module
from istvt_tpu.models.registry import model_selection as jax_model
from istvt_tpu.train import schedule as jsched
from istvt_tpu.train import step as jstep
from istvt_tpu_torch.compat.from_jax import params_from_jax
from istvt_tpu_torch.core import config as tconfig
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.data import SyntheticVideoDataset
from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.models import istvt as tistvt
from istvt_tpu_torch.nn.layers import dropout, dropout_mask
from istvt_tpu_torch.train import schedule as tsched
from istvt_tpu_torch.train import step as tstep
from test_torch_train_step import _batch, _check_step, _keep_grads

TINY = dict(num_frames=2, image_size=72, feat_hw=5, depth=2, num_classes=1,
            quantize="none", dropout=0.5)
LR, TOTAL, RATE = 1e-4, 100, 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(use_pallas, b=2):
    """Each layer's two keep masks, in call order: (B, N, 4D) after the
    GELU, (B, N, D) after fc2, N the (T+1) frames' tokens, padded from 26
    to 32 a frame on the fused path."""
    n = 3 * (32 if use_pallas else 26)
    rng = np.random.RandomState(5)
    out = []
    for _ in range(TINY["depth"]):
        out += [rng.rand(b, n, 4 * 728) < 1 - RATE,
                rng.rand(b, n, 728) < 1 - RATE]
    return out


class _Given:
    """A mask source handing out `masks` in order, cycling."""

    def __init__(self, masks):
        self.masks, self.calls = masks, 0

    def __call__(self, shape, device):
        m = self.masks[self.calls % len(self.masks)]
        self.calls += 1
        assert tuple(m.shape) == tuple(shape), (m.shape, shape)
        return torch.from_numpy(m).to(device)


def _weights(cfg_kw, seed=1):
    weights = tistvt.init(tconfig.ISTVTConfig(**cfg_kw),
                          torch.Generator().manual_seed(seed))
    params, state = istvt_from_torch(
        {k: v.numpy() for k, v in weights.state_dict().items()},
        depth=cfg_kw["depth"])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(state)


def _jax_run(cfg_kw, params, state, masks, batch, monkeypatch):
    """[(loss, grads, params, state)] after each of two steps, JAX's
    dropout taking `masks` in call order."""
    calls = []

    def given_dropout(key, x, rate, train):
        if not train or rate == 0.0 or key is None:
            return x
        m = masks[len(calls) % len(masks)]
        calls.append(m.shape)
        assert m.shape == x.shape, (m.shape, x.shape)
        return jnp.where(m, x / (1.0 - rate), 0.0)

    monkeypatch.setattr(jistvt_module, "dropout", given_dropout)
    cfg = jconfig.ISTVTConfig(**cfg_kw)
    model = jax_model("istvt", num_out_classes=1, dropout=RATE, cfg=cfg)
    opt = optax.chain(_keep_grads(), jstep.make_optimizer(
        jconfig.TrainConfig(), jsched.cosine_schedule(LR, TOTAL)))
    ts = jstep.TrainState(params=params, model_state=state,
                          opt_state=opt.init(params),
                          step=jnp.zeros((), jnp.int32))
    fn = jstep.make_train_step(model, opt, donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    with jprecision.highest():
        for _ in range(2):
            ts, m = fn(ts, jb, jax.random.PRNGKey(0))
            out.append((float(m["loss"]), ts.opt_state[0], ts.params,
                        ts.model_state))
    assert len(calls) == len(masks)         # one trace, every mask once
    return out


def _torch_run(cfg_kw, params, state, rng, batch, steps=2):
    model = tistvt.init(tconfig.ISTVTConfig(**cfg_kw),
                        torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, state))
    opt = tstep.make_optimizer(tconfig.TrainConfig(checkpoint_dir=""),
                               tsched.cosine_schedule(LR, TOTAL))
    ts = tstep.create_train_state(model, opt)
    step = tstep.make_train_step(rng=rng)
    out = []
    _lib.reset_launches()
    with tprecision.highest():
        for _ in range(steps):
            m = step(ts, batch)
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            out.append((float(m["loss"]), grads,
                        {k: v.clone() for k, v in model.state_dict().items()}))
    assert all(v == 0 for v in _lib.LAUNCHES.values())   # CPU: plain only
    return out


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla_math", "fused"])
def test_dropout_train_step_matches_jax(use_pallas, monkeypatch):
    cfg_kw = {**TINY, "use_pallas": use_pallas}
    params, state = _weights(cfg_kw)
    masks = _masks(use_pallas)
    batch = _batch(2)
    j_out = _jax_run(cfg_kw, params, state, masks, batch, monkeypatch)
    given = _Given(masks)
    t_out = _torch_run(cfg_kw, params, state, given, batch)
    assert given.calls == 2 * len(masks)
    names = [n for n, _ in tistvt.init(
        tconfig.ISTVTConfig(**cfg_kw), torch.Generator()).named_parameters()]
    for k, (t, j) in enumerate(zip(t_out, j_out), start=1):
        _check_step(k, t, j, state, names, bf16=False)
    # the masks took effect: without them the first loss differs
    no_drop = _torch_run(cfg_kw, params, state, None, batch, steps=1)
    assert abs(no_drop[0][0] - t_out[0][0]) > 1e-3


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla_math", "fused"])
def test_remat_gradients_equal_without(use_pallas):
    """cfg.remat recomputes each layer in the backward pass with the masks
    it was given: loss and every gradient equal the run without remat bit
    for bit, with masks drawn from a generator of the same seed."""
    batch = _batch(2)
    out = {}
    for remat in (False, True):
        cfg = tconfig.ISTVTConfig(**{**TINY, "use_pallas": use_pallas,
                                     "remat": remat})
        model = tistvt.init(cfg, torch.Generator().manual_seed(3))
        opt = tstep.make_optimizer(tconfig.TrainConfig(checkpoint_dir=""),
                                   tsched.cosine_schedule(LR, TOTAL))
        ts = tstep.create_train_state(model, opt)
        step = tstep.make_train_step(rng=torch.Generator().manual_seed(9))
        m = step(ts, batch)
        out[remat] = (float(m["loss"]), {n: p.grad.clone()
                                         for n, p in model.named_parameters()})
    assert out[True][0] == out[False][0]
    for n, g in out[False][1].items():
        assert torch.equal(out[True][1][n], g), n


def test_dropout_masks_keep_rate_and_scale():
    """The port's own masks (a torch.Generator) keep 1 - rate of the values
    within 3 sigma and scale the kept ones by 1 / keep; eval mode, rate 0
    and no mask are the identity."""
    x = torch.rand(64, 1024) + 0.5
    for rate in (0.1, 0.5, 0.8):
        mask = dropout_mask(x.shape, rate, torch.Generator().manual_seed(2),
                            x.device)
        y = dropout(x, rate, True, mask)
        keep, n = 1.0 - rate, x.numel()
        kept = (y != 0).float().mean().item()
        assert abs(kept - keep) <= 3 * (keep * rate / n) ** 0.5, (rate, kept)
        torch.testing.assert_close(y[mask], x[mask] / keep, rtol=0, atol=0)
    assert dropout(x, 0.5, False, mask) is x
    assert dropout(x, 0.0, True, mask) is x
    assert dropout(x, 0.5, True, None) is x


@pytest.mark.parametrize("kw", [
    dict(static_patch=True, patch_size=24),
    dict(amp_range=(0.5, 2.0)),
    dict(static_patch=True, amp_range=(0.2, 1.0))],
    ids=["static_patch", "amp_range", "both"])
def test_synthetic_variants_match_jax(kw):
    base = dict(num_clips=5, seq_len=3, size=72, seed=11)
    ours, theirs = SyntheticVideoDataset(**base, **kw), JaxSynth(**base, **kw)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
