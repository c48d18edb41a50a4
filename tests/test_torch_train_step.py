"""The port's training step (istvt_tpu_torch/train/step.py) against JAX's
make_train_step at the TINY geometry of tests/test_torch_float_path.py
(use_pallas=True, quantize='none', dropout 0), from one set of weights:
drawn by the port's init, read into JAX trees by the JAX package's
torch_import and loaded into the port by compat/from_jax. Then the stem in
train mode, the optimizers, schedules, metrics, loss, the synthetic data
and loader against JAX, and a 2-step CLI run.

The JAX step runs its Pallas forward kernels in interpret mode and, on the
CPU, the XLA VJPs of their references; the port runs its plain kernel
versions through the autograd.Functions. An identity transformation
chained before optax's adamw (`_keep_grads`) keeps each step's gradients
in the JAX optimizer state, so one compiled step gives loss, gradients,
parameters and BN running stats. f32 (also with grad_accum=2), after
the first AdamW step: loss |d| <= 1e-5, per-leaf gradient and parameter
rel-L2 <= 1e-4 for the transformer and head (the parameters, not the
updates: Adam's first step is sign-like) and <= 5e-2 for the stem, BN
running stats max|d| <= 1e-5; after the second: loss <= 1e-4, the
transformer and head <= 1e-3, the stem <= 2e-1, BN <= 1e-4. bf16 over
f32 masters, after each step: loss |d| <= 5e-2, cosine of the flattened
gradients >= 0.99.

Why those bounds and not 1e-4 everywhere: the stem's gradients pass
through train-mode BatchNorm, whose backward subtracts the per-channel
mean of a cotangent that is nearly constant over the tokens, over 2-4
frames a BatchNorm here; in f32 the cancellation leaves the stem's
gradients with rounding error of 1e-3 to 1e-1 relative in any
implementation, and Adam's sign-like first step carries it into every
parameter, so the second step's gradients and loss differ too. JAX shows
it against itself: the same steps on the batch with each clip repeated
(the same function, other summation orders) move its stem gradients by
up to 2.9e-3 / 2.3e-2 (f32 / grad_accum=2) after the first step and 5.1e-2
/ 9.0e-2 after the second, and the second loss by 1.0e-5. Port against
JAX on the same weights: stem 5.5e-6 / 1.9e-3 and 6.0e-6 / 4.0e-2,
transformer <= 2.8e-6 after the first step and 3.0e-4 after the second
(grad_accum=2), second loss 1.0e-5 / 1.1e-5, second BN running mean
1.4e-5 (grad_accum=2). The stem's own arithmetic is held at 1e-4 by
test_stem_train_mode_matches_jax, with a cotangent that has no
near-constant part.
"""
import dataclasses
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from istvt_tpu.compat.torch_import import istvt_from_torch
from istvt_tpu.core import config as jconfig
from istvt_tpu.core import precision as jprecision
from istvt_tpu.data.loader import ClipLoader as JaxLoader
from istvt_tpu.data.video_dataset import SyntheticVideoDataset as JaxSynth
from istvt_tpu.models import xception as jxception
from istvt_tpu.models.registry import model_selection as jax_model
from istvt_tpu.train import losses as jlosses
from istvt_tpu.train import metrics as jmetrics
from istvt_tpu.train import schedule as jsched
from istvt_tpu.train import step as jstep
from istvt_tpu_torch.cli import train as cli_train
from istvt_tpu_torch.compat.from_jax import params_from_jax, params_to_jax
from istvt_tpu_torch.core import config as tconfig
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.data import ClipLoader, SyntheticVideoDataset
from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.models import istvt as tistvt
from istvt_tpu_torch.train import losses as tlosses
from istvt_tpu_torch.train import metrics as tmetrics
from istvt_tpu_torch.train import schedule as tsched
from istvt_tpu_torch.train import step as tstep

TINY = dict(num_frames=2, image_size=72, feat_hw=5, depth=2, num_classes=1,
            use_pallas=True, quantize="none", dropout=0.0)
LR, TOTAL = 1e-4, 100
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keep_grads():
    """An identity transformation whose state is the last gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def _batch(b=2):
    rng = np.random.RandomState(0)
    return {"clips": rng.randn(b, 2, 72, 72, 3).astype(np.float32),
            "labels": np.array([0, 1] * (b // 2), np.int32)}


@pytest.fixture(scope="module")
def init():
    """The JAX model and one set of weights as numpy trees: drawn by the
    port's init (the JAX package's distributions; seconds faster than
    JAX's eager init of the whole Xception) and read into JAX trees by the
    JAX package's own torch_import."""
    cfg = jconfig.ISTVTConfig(**TINY)
    model = jax_model("istvt", num_out_classes=1, dropout=0.0, cfg=cfg)
    weights = tistvt.init(tconfig.ISTVTConfig(**TINY),
                          torch.Generator().manual_seed(1))
    params, state = istvt_from_torch(
        {k: v.numpy() for k, v in weights.state_dict().items()},
        depth=cfg.depth)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return model, to_np(params), to_np(state)


def _jax_run(init, compute_dtype, grad_accum, batch):
    """[(loss, grads, params, state)] after each of two steps."""
    model, params, state = init
    opt = optax.chain(_keep_grads(), jstep.make_optimizer(
        jconfig.TrainConfig(), jsched.cosine_schedule(LR, TOTAL)))
    ts = jstep.TrainState(params=params, model_state=state,
                          opt_state=opt.init(params),
                          step=jnp.zeros((), jnp.int32))
    fn = jstep.make_train_step(model, opt, donate=False,
                               compute_dtype=compute_dtype,
                               grad_accum=grad_accum)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    with jprecision.highest():
        for _ in range(2):
            ts, m = fn(ts, jb, jax.random.PRNGKey(0))
            out.append((float(m["loss"]), ts.opt_state[0], ts.params,
                        ts.model_state))
    return out


def _torch_run(init, compute_dtype, grad_accum, batch):
    _, params, state = init
    model = tistvt.init(tconfig.ISTVTConfig(**TINY),
                        torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, state))
    opt = tstep.make_optimizer(tconfig.TrainConfig(checkpoint_dir=""),
                               tsched.cosine_schedule(LR, TOTAL))
    ts = tstep.create_train_state(model, opt)
    step = tstep.make_train_step(compute_dtype=compute_dtype,
                                 grad_accum=grad_accum)
    out = []
    _lib.reset_launches()
    with tprecision.highest():
        for _ in range(2):
            m = step(ts, batch)
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            out.append((float(m["loss"]), grads,
                        {k: v.clone() for k, v in model.state_dict().items()}))
    assert all(v == 0 for v in _lib.LAUNCHES.values())   # CPU: plain only
    assert ts.step == 2
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return np.linalg.norm(a - b) / nb if nb > 0 else np.linalg.norm(a)


# the tolerances after steps 1 and 2 (see the module docstring): about
# twice what JAX shows against itself; the stem's own arithmetic is held
# at 1e-4 by test_stem_train_mode_matches_jax
TOL = {1: dict(loss=1e-5, vit=1e-4, stem=5e-2, bn=1e-5),
       2: dict(loss=1e-4, vit=1e-3, stem=2e-1, bn=1e-4)}


def _check_step(k, t_out, j_out, state0, names, bf16):
    t_loss, t_grads, t_sd = t_out
    j_loss, j_grads, j_params, j_state = j_out
    want_g = params_from_jax(jax.tree_util.tree_map(np.asarray, j_grads),
                             state0)
    if bf16:
        assert abs(t_loss - j_loss) <= 5e-2, (t_loss, j_loss)
        tg = np.concatenate([t_grads[n].numpy().ravel() for n in names])
        jg = np.concatenate([want_g[n].float().numpy().ravel()
                             for n in names])
        cos = tg @ jg / (np.linalg.norm(tg) * np.linalg.norm(jg))
        assert cos >= 0.99, cos
        return
    tol = TOL[k]
    assert abs(t_loss - j_loss) <= tol["loss"], (k, t_loss, j_loss)
    want_sd = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params),
                              jax.tree_util.tree_map(np.asarray, j_state))
    for n in names:
        lim = tol["stem" if n.startswith("xcep.") else "vit"]
        assert _rel(t_grads[n], want_g[n]) <= lim, \
            (k, n, "grad", _rel(t_grads[n], want_g[n]))
        assert _rel(t_sd[n], want_sd[n]) <= lim, \
            (k, n, "param", _rel(t_sd[n], want_sd[n]))
    got_state = params_to_jax(t_sd)[1]
    assert (jax.tree_util.tree_structure(got_state)
            == jax.tree_util.tree_structure(j_state))
    for (path, got), want in zip(
            jax.tree_util.tree_leaves_with_path(got_state),
            jax.tree_util.tree_leaves(j_state)):
        np.testing.assert_allclose(got, np.asarray(want), atol=tol["bn"],
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("mode", ["f32", "f32_grad_accum2", "bf16"])
def test_train_step_matches_jax(init, mode):
    bf16 = mode == "bf16"
    grad_accum = 2 if mode.endswith("accum2") else 1
    batch = _batch(BATCH)
    j_out = _jax_run(init, jnp.bfloat16 if bf16 else None, grad_accum,
                     batch)
    t_out = _torch_run(init, torch.bfloat16 if bf16 else None, grad_accum,
                       batch)
    names = [n for n, _ in tistvt.init(
        tconfig.ISTVTConfig(**TINY), torch.Generator()).named_parameters()]
    for k, (t, j) in enumerate(zip(t_out, j_out), start=1):
        _check_step(k, t, j, init[2], names, bf16)


def test_stem_train_mode_matches_jax(init):
    """The stem alone in train mode (batch-statistics BatchNorm), the port
    against xception.low_level_features(train=True): features rel-L2 <=
    1e-5, new BN running stats max|d| <= 1e-5, and the gradients of every
    stem leaf for a random cotangent on the features rel-L2 <= 1e-4 (a
    cotangent without the near-constant part that the model's own carries,
    so rounding stays at the f32 level: measured <= 2.1e-6)."""
    _, params, state = init
    clips = _batch(2)["clips"].reshape(4, 72, 72, 3)
    cot = np.random.RandomState(2).randn(4, 5, 5, 728).astype(np.float32)

    @jax.jit
    def stem_vjp(p):
        (feats, new_state), vjp = jax.vjp(
            lambda q: jxception.low_level_features(q, state["xcep"],
                                                   jnp.asarray(clips), True),
            p)
        zeros = jax.tree_util.tree_map(jnp.zeros_like, new_state)
        return feats, new_state, vjp((jnp.asarray(cot), zeros))[0]

    with jprecision.highest():
        feats, new_state, grads = stem_vjp(params["xcep"])
    model = tistvt.init(tconfig.ISTVTConfig(**TINY),
                        torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, state))
    xc = model.xcep.model.train()
    got = xc.low_level_features(torch.from_numpy(clips))
    (got * torch.from_numpy(cot)).sum().backward()
    assert _rel(got.detach().numpy(), np.asarray(feats)) <= 1e-5
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    want_sd = params_from_jax({"xcep": to_np(grads), "vit": params["vit"]},
                              {"xcep": to_np(new_state)})
    got_state = params_to_jax(model.state_dict())[1]["xcep"]
    for g, w in zip(jax.tree_util.tree_leaves(got_state),
                    jax.tree_util.tree_leaves(new_state)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)
    for n, p in xc.named_parameters():
        if p.grad is not None:
            key = "xcep.model." + n
            assert _rel(p.grad.numpy(), want_sd[key].numpy()) <= 1e-4, key


def test_config_copies_match_jax():
    for ours, theirs in ((tconfig.TrainConfig, jconfig.TrainConfig),
                         (tconfig.DataConfig, jconfig.DataConfig)):
        assert ({f.name: f.default for f in dataclasses.fields(ours)}
                == {f.name: f.default for f in dataclasses.fields(theirs)})


def test_schedules_match_optax():
    steps = np.arange(0, 260, 7)
    pairs = [
        (tsched.cosine_schedule(5e-4, 200, warmup_steps=20, min_lr=1e-6),
         jsched.cosine_schedule(5e-4, 200, warmup_steps=20, min_lr=1e-6)),
        (tsched.cosine_schedule(1e-3, 150), jsched.cosine_schedule(1e-3, 150)),
        (tsched.reference_epoch_schedule(5e-4, 3, 10),
         jsched.reference_epoch_schedule(5e-4, 3, 10)),
        (tsched.constant_schedule(3e-4), jsched.constant_schedule(3e-4)),
    ]
    for ours, theirs in pairs:
        got = np.array([ours(int(s)) for s in steps])
        want = np.array([float(theirs(jnp.asarray(s, jnp.int32)))
                         for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert tsched.cosine_schedule(1e-3, 100, warmup_steps=10)(0) == 0.0


def test_optimizers_match_optax():
    """AdamW (decoupled decay times lr, eps 1e-8) and SGD with momentum (a
    first buffer of g) as optax.adamw / optax.sgd, the lr set from a
    warmup schedule before each update (the first update at lr 0)."""
    rng = np.random.RandomState(4)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) for _ in range(4)]
    sched = (tsched.cosine_schedule(1e-2, 10, warmup_steps=2),
             jsched.cosine_schedule(1e-2, 10, warmup_steps=2))
    for name in ("adamw", "sgd"):
        tc = tconfig.TrainConfig(optimizer=name, checkpoint_dir="")
        param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        ours = tstep.make_optimizer(tc, sched[0])
        opt = ours.build([param])
        theirs = jstep.make_optimizer(jconfig.TrainConfig(optimizer=name),
                                      sched[1])
        jp = jnp.asarray(p0)
        state = theirs.init(jp)
        for k, g in enumerate(grads):
            for group in opt.param_groups:
                group["lr"] = ours.schedule(k)
            param.grad = torch.from_numpy(g)
            opt.step()
            upd, state = theirs.update(jnp.asarray(g), state, jp)
            jp = optax.apply_updates(jp, upd)
            np.testing.assert_allclose(param.detach().numpy(),
                                       np.asarray(jp), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} step {k}")


def test_loss_and_metrics_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(64).astype(np.float32) * 3
    logits[:8] = logits[8:16]                 # ties for the AUC ranks
    logits[16] = 0.0
    labels = rng.randint(0, 2, 64).astype(np.int32)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    jl, jlab = jnp.asarray(logits), jnp.asarray(labels)
    np.testing.assert_allclose(float(tlosses.bce_with_logits(tl, tlab)),
                               float(jlosses.bce_with_logits(jl, jlab)),
                               rtol=1e-6)
    np.testing.assert_array_equal(tmetrics.binary_predictions(tl).numpy(),
                                  np.asarray(jmetrics.binary_predictions(jl)))
    assert float(tmetrics.accuracy(tl, tlab)) == \
        float(jmetrics.accuracy(jl, jlab))
    for k, v in jmetrics.confusion_counts(jl, jlab).items():
        assert float(tmetrics.confusion_counts(tl, tlab)[k]) == float(v)
    np.testing.assert_allclose(float(tmetrics.auc(tl, tlab)),
                               float(jmetrics.auc(jl, jlab)), rtol=1e-6)


def test_synthetic_dataset_and_loader_match_jax():
    kw = dict(num_clips=6, seq_len=3, size=40, seed=5)
    ours, theirs = SyntheticVideoDataset(**kw), JaxSynth(**kw)
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ds = SyntheticVideoDataset(**kw)
    for drop_last in (False, True):
        ours = ClipLoader(ds, batch_size=4, shuffle=True, seed=7,
                          drop_last=drop_last)
        theirs = JaxLoader(JaxSynth(**kw), batch_size=4, shuffle=True,
                           seed=7, drop_last=drop_last, num_workers=1)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == len(ours) == len(theirs)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a["clips"], b["clips"])
                np.testing.assert_array_equal(a["labels"], b["labels"])


def test_unported_train_configurations_raise():
    """Train mode with dropout, without use_pallas and with remat runs
    (tests/test_torch_dropout_train.py holds it against JAX), and so does
    recalibrate_bn (tests/test_torch_checkpoint.py); int8 train mode and a
    mesh still raise, naming their ROADMAP items."""
    model = tistvt.init(tconfig.ISTVTConfig(**{**TINY, "dropout": 0.5}),
                        torch.Generator().manual_seed(0)).train()
    clips = torch.zeros(1, 2, 72, 72, 3)
    gen = torch.Generator().manual_seed(0)
    for works in ({}, {"use_pallas": False}, {"remat": True}):
        model.cfg = tconfig.ISTVTConfig(**{**TINY, "dropout": 0.5, **works})
        assert torch.isfinite(model(clips, rng=gen)).all(), works
    model.cfg = tconfig.ISTVTConfig(**{**TINY, "quantize": "int8"})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model(clips)
    model.cfg = tconfig.ISTVTConfig(**TINY)
    stats = tstep.recalibrate_bn(model, [{"clips": np.zeros(
        (2, 2, 72, 72, 3), np.float32), "labels": np.zeros(2, np.int32)}])
    assert stats and all(torch.isfinite(v).all() for v in stats.values())
    with pytest.raises(NotImplementedError, match="Parallelism"):
        tstep.make_train_step(mesh=object())


CLI = ["--device", "cpu", "--dataset", "synthetic", "--use_pallas",
       "--dropout", "0", "--input_size", "72", "--seq_len", "2",
       "--depth", "1", "--batch_size", "4", "--dataset_len", "8",
       "--epochs", "1"]


def test_cli_trains_two_steps_on_cpu(capsys, tmp_path):
    cli_train.main(CLI + ["-o", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if "train loss" in ln][-1]
    assert np.isfinite(float(line.split("train loss")[1].split()[0])), line
    assert "val {" in out
    assert sorted(os.listdir(tmp_path / "ck"))[:2] == ["2.json", "2.pt"]
    parser = cli_train.build_parser()
    for bad in (["--dump_attns_every", "2"], ["--mesh_model", "2"]):
        with pytest.raises(SystemExit, match="ROADMAP"):
            cli_train.check_args(parser.parse_args(CLI + bad), parser)
    # the reference's defaults, the checkpoint flags, the real datasets
    # and distillation are ported (tests/test_torch_checkpoint.py,
    # tests/test_torch_data_cli.py and tests/test_torch_distill.py run
    # them)
    for works in (["--dropout", "0.5"], ["--checkpoint_dir", "out"],
                  ["--remat"], ["--recal_bn", "2"], ["--continue_train"],
                  ["--test_mode"], ["--model_path", "x"],
                  ["--dataset", "ff++"], ["--num_workers", "2"],
                  ["--data_root", "x"], ["--use_native_decode"],
                  ["--distill_from", "x", "--teacher_depth", "1",
                   "--teacher_input_size", "96", "--teacher_optimizer",
                   "sgd", "--distill_alpha", "0", "--distill_T", "4"]):
        cli_train.check_args(parser.parse_args(CLI + works), parser)
    assert parser.parse_args([]).checkpoint_dir == "./output"
