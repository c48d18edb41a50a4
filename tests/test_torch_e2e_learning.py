"""Held-out end-to-end capability test of the port: tests/test_e2e_learning.py's
four tests, with the port trained by the JAX suite's `synthetic_trained`
recipe (tests/conftest.py: a depth-2 ISTVT on 3-frame 72^2 clips whose
fake class carries per-frame noise in a static 24^2 patch, the XLA-math
path of the default ISTVTConfig, adamw 3e-4 on a cosine over 10,000
steps, 6 passes over 3 batches of 8, the last loss under a tenth of the
first, then recalibrate_bn over the 3 batches) on the port's own train
path. Its initial weights are the recipe's, JAX's istvt.init at
PRNGKey(0), carried in by compat.from_jax. Under the JAX file's
thresholds:

  1. generalization: held-out val AUC >= 0.95 and accuracy >= 0.9;
  2. serving parity: the int8 W8A8 path's AUC >= 0.95 and max |d logit|
     <= 0.15 against the float eval;
  3. spatial localization: on held-out fakes, cam_s's share on the patch's
     cells over the uniform share >= 1.2 for each clip and >= 1.4 on
     average;
  4. temporal localization: cam_t's share on the manipulated frames >=
     0.85 (frames 1, 2) and >= 0.7 (frame 2 alone).

The spatial test holds for this initial draw, not for every draw: trained
the same way from the port's own init (istvt.init, seed 0), the held-out
fakes' ratios were 0.20, 1.77, 0.40, 1.81, 0.25, 1.09 (on the CPU), below
the thresholds, and JAX's generate_lrp on those same trained weights
gives the same cam_s (test_lrp_cams_are_jax_cams_from_port_init, which
computes both): a property of the recipe's init, which the reference
shares, not of the port. From PRNGKey(0) the port reaches 1.58-2.82, the
JAX file's calibration (1.59-2.82).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from istvt_tpu.compat.torch_import import istvt_from_torch
from istvt_tpu.core import precision as jprecision
from istvt_tpu.core.config import ISTVTConfig as JaxConfig
from istvt_tpu.interpret import lrp as jlrp
from istvt_tpu.models import istvt as jistvt
from istvt_tpu_torch.compat.from_jax import params_from_jax
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.core.config import ISTVTConfig, TrainConfig
from istvt_tpu_torch.data import SyntheticVideoDataset
from istvt_tpu_torch.interpret import generate_lrp
from istvt_tpu_torch.models import istvt
from istvt_tpu_torch.train import step as S
from istvt_tpu_torch.train.metrics import auc
from istvt_tpu_torch.train.schedule import cosine_schedule

T, SZ, PS = 3, 72, 24
CFG = ISTVTConfig(num_frames=T, image_size=SZ, feat_hw=5, depth=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch_of(ds, idx):
    items = [ds[i] for i in idx]
    return {"clips": np.stack([it["clips"] for it in items]),
            "labels": np.stack([it["labels"] for it in items])}


def _recipe(model):
    """The synthetic_trained recipe on the port, from model's weights:
    the model trained, BN-recalibrated, in eval mode."""
    opt = S.make_optimizer(TrainConfig(optimizer="adamw", checkpoint_dir=""),
                           cosine_schedule(3e-4, 10_000))
    ts = S.create_train_state(model, opt)
    step = S.make_train_step()
    train_ds = SyntheticVideoDataset(num_clips=24, seq_len=T, size=SZ,
                                     seed=0, static_patch=True,
                                     patch_size=PS)
    batches = [_batch_of(train_ds, range(i, i + 8)) for i in (0, 8, 16)]
    losses = []
    for _ in range(6):
        for b in batches:
            losses.append(float(step(ts, b)["loss"]))
    assert losses[-1] < 0.1 * losses[0], losses
    S.recalibrate_bn(model, batches)
    return model.eval()


JAX_CFG = JaxConfig(num_frames=T, image_size=SZ, feat_hw=5, depth=2)


@pytest.fixture(scope="module")
def trained():
    """The recipe from its own initial weights (JAX's init at
    PRNGKey(0))."""
    p, s = jistvt.init(jax.random.PRNGKey(0), JAX_CFG)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    model = istvt.init(CFG, torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(to_np(p), to_np(s)))
    return _recipe(model)


@pytest.fixture(scope="module")
def val_eval(trained):
    val_ds = SyntheticVideoDataset(num_clips=16, seq_len=T, size=SZ,
                                   seed=999, static_patch=True,
                                   patch_size=PS)
    vb = _batch_of(val_ds, range(16))
    out = S.make_eval_step()(trained, vb)
    return val_ds, vb, out


def test_heldout_val_auc(val_eval):
    _, _, out = val_eval
    va = float(auc(out["logits"], out["labels"]))
    lg, lab = out["logits"].numpy(), out["labels"].numpy()
    acc = float(np.mean((lg > 0) == (lab == 1)))
    assert va >= 0.95, va
    assert acc >= 0.9, (acc, lg)


def test_int8_path_matches_float_eval(trained, val_eval):
    _, vb, out = val_eval
    cfg_q = ISTVTConfig(num_frames=T, image_size=SZ, feat_hw=5, depth=2,
                        use_pallas=True, quantize="int8")
    model_q = istvt.init(cfg_q, torch.Generator().manual_seed(1))
    model_q.load_state_dict(trained.state_dict())
    istvt.quantize_params(model_q)
    out_q = S.make_eval_step()(model_q, vb)
    va_q = float(auc(out_q["logits"], out_q["labels"]))
    delta = float((out_q["logits"] - out["logits"]).abs().max())
    assert va_q >= 0.95, va_q
    assert delta <= 0.15, delta


def _lrp(model, clips):
    """generate_lrp with this file's share of the cores as intra-op
    threads (tests/test_torch_interpret.py: thousands of small parallel
    regions)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
    try:
        return generate_lrp(model, clips, index=0)
    finally:
        torch.set_num_threads(threads)


def test_lrp_localizes_spatially(trained, val_eval):
    """cam_s mass on the known manipulated cells of held-out fakes must
    beat the uniform share by a clear factor."""
    val_ds, _, _ = val_eval
    fakes = [val_ds[i] for i in range(16) if val_ds[i]["labels"] == 1][:6]
    clips = torch.from_numpy(np.stack([f["clips"] for f in fakes]))
    with torch.no_grad():
        logits = trained(clips)
    assert bool((logits > 0).all()), logits.ravel()
    cam_s, _ = _lrp(trained, clips)
    cam_s = cam_s.numpy()                            # (B, T, 25)
    cell = SZ / CFG.feat_hw
    ratios = []
    for j, f in enumerate(fakes):
        y, x = f["patch_yx"]
        rows = range(int(y // cell), int((y + PS - 1) // cell) + 1)
        cols = range(int(x // cell), int((x + PS - 1) // cell) + 1)
        cells = [r * CFG.feat_hw + c for r in rows for c in cols]
        sm = cam_s[j] / (cam_s[j].sum(axis=-1, keepdims=True) + 1e-9)
        share = sm[:, cells].sum(axis=-1).mean()
        ratios.append(share / (len(cells) / CFG.feat_hw ** 2))
    assert min(ratios) >= 1.2, ratios
    assert float(np.mean(ratios)) >= 1.4, ratios


def test_lrp_localizes_temporally(trained):
    """cam_t mass must concentrate on the manipulated frames of clips
    where only a subset of frames carries the artifact."""

    def subset_fake(seed, frames):
        rng = np.random.default_rng(seed)
        base = rng.normal(0, 0.3, (SZ, SZ, 3)).astype(np.float32)
        clip = np.stack([np.roll(base, t, axis=1) for t in range(T)])
        y = int(rng.integers(0, SZ - PS))
        x = int(rng.integers(0, SZ - PS))
        for t in frames:
            clip[t, y:y + PS, x:x + PS] += rng.normal(
                0, 1.0, (PS, PS, 3)).astype(np.float32)
        return clip

    for frames, uniform, floor in (((1, 2), 2 / 3, 0.85), ((2,), 1 / 3, 0.7)):
        clips = torch.from_numpy(np.stack([subset_fake(100 + k, frames)
                                           for k in range(6)]))
        with torch.no_grad():
            logits = trained(clips)
        assert bool((logits > 0).all()), logits.ravel()
        _, cam_t = _lrp(trained, clips)
        tm = cam_t.numpy().sum(axis=-1)
        tm = tm / (tm.sum(axis=-1, keepdims=True) + 1e-9)
        share = tm[:, list(frames)].sum(axis=-1)
        assert share.mean() >= floor, (frames, share, uniform)


def test_lrp_cams_are_jax_cams_from_port_init(val_eval):
    """The recipe from the port's own init (istvt.init, seed 0): JAX's
    generate_lrp on the trained weights (carried by
    istvt_tpu.compat.torch_import) gives the port's cam_s and cam_t on the
    held-out fakes, rel-L2 <= 1e-4 (tests/test_torch_interpret.py's bound,
    both sides at full f32 precision); their spatial ratios (module
    docstring) are the reference's on these weights."""
    model = _recipe(istvt.init(CFG, torch.Generator().manual_seed(0)))
    val_ds, _, _ = val_eval
    fakes = [val_ds[i] for i in range(16) if val_ds[i]["labels"] == 1][:6]
    clips = np.stack([f["clips"] for f in fakes])
    with tprecision.highest():
        cam_s, cam_t = _lrp(model, torch.from_numpy(clips))
    params, state = istvt_from_torch(
        {k: v.detach().numpy() for k, v in model.state_dict().items()},
        depth=2)
    with jprecision.highest():
        want_s, want_t = jlrp.generate_lrp(params, state, jnp.asarray(clips),
                                           JAX_CFG, index=0)
    for got, want in ((cam_s, want_s), (cam_t, want_t)):
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert err <= 1e-4, err
