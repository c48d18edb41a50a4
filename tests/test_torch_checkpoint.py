"""Checkpoints, resume, BN recalibration and the CLIs that read them back
(istvt_tpu_torch/core/checkpoint.py, train/trainer.py, train/step.py
recalibrate_bn, compat/from_jax.py's TrainState, cli/{train,serve,
visualize}.py), on the CPU at toy geometry (72^2, T = 2-3, depth 1-2):

  * the manager: save / restore, max_to_keep and the best step as the
    JAX package's Orbax options keep them, an async save on its thread,
    and a write killed in mid-file that latest_step never picks;
  * a TrainState round trip bit for bit, and 3 trainer steps equal to 2
    steps, a save, a fresh restore and 1 step, bit for bit (dropout 0.5 on
    the XLA-math path: the dropout generator's state is restored too);
  * a JAX TrainState (adamw after one step) carried in through
    compat.from_jax, then one step in each package within the f32 bounds
    of tests/test_torch_train_step.py (TOL[1]), and carried back equal; an
    SGD state there and back;
  * recalibrate_bn against JAX's on the same weights and batches (running
    mean and variance rel-L2 <= 1e-5);
  * the train CLI's --test_mode, --continue_train and --recal_bn, serve's
    --checkpoint_dir (the predictor's logits equal the trained model's eval
    logits within 1e-5) and visualize's --model_path (a checkpoint
    directory and a save_pytree file);
  * SIGTERM: the train CLI in a subprocess, signalled after a logged step,
    exits 143 with a snapshot at or past that step, and --continue_train
    resumes from it;
  * the metrics logger's JSONL records and TensorBoard scalars.
"""
import json
import os
import shutil
import signal
import struct
import subprocess
import sys
import threading

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from istvt_tpu.compat.torch_import import istvt_from_torch
from istvt_tpu.core import config as jconfig
from istvt_tpu.core import precision as jprecision
from istvt_tpu.models.registry import model_selection as jax_model
from istvt_tpu.train import schedule as jsched
from istvt_tpu.train import step as jstep
from istvt_tpu_torch.cli import serve as cli_serve
from istvt_tpu_torch.cli import train as cli_train
from istvt_tpu_torch.cli import visualize as cli_vis
from istvt_tpu_torch.compat.from_jax import (params_from_jax,
                                             train_state_from_jax,
                                             train_state_to_jax)
from istvt_tpu_torch.core import config as tconfig
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.core.checkpoint import (CheckpointManager, load_pytree,
                                             save_pytree)
from istvt_tpu_torch.models import istvt as tistvt
from istvt_tpu_torch.train import schedule as tsched
from istvt_tpu_torch.train import step as tstep
from test_torch_train_step import TOL, _batch, _rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_frames=2, image_size=72, feat_hw=5, depth=2, num_classes=1,
            quantize="none", dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _drop_tmp_path(request):
    """A checkpoint of the toy model holds the whole Xception stem and its
    AdamW moments (~340 MB): a test's tmp_path goes when the test ends, so
    that the suite's kept temporary directories stay small."""
    path = request.getfixturevalue("tmp_path") \
        if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def _equal_nests(a, b, path="") -> None:
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal_nests(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_nests(x, y, f"{path}/{i}")
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------------
# the manager


def test_manager_keeps_best_and_unscored_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    metrics = [0.1, 0.5, 0.3, 0.9, 0.2, 0.8, 0.4]
    for step, metric in enumerate(metrics, start=1):
        mgr.save(step, {"w": torch.full((3,), float(step))}, metric=metric)
    mgr.save(8, {"w": torch.full((3,), 8.0)})          # no metric: kept
    assert mgr.all_steps() == [2, 4, 6, 8]
    assert mgr.latest_step() == 8 and mgr.best_step() == 4
    assert torch.equal(mgr.restore()["w"], torch.full((3,), 8.0))
    assert torch.equal(mgr.restore(6)["w"], torch.full((3,), 6.0))
    low = CheckpointManager(str(tmp_path / "low"), best_mode="min")
    for step, metric in ((1, 0.3), (2, 0.1), (3, 0.2)):
        low.save(step, {"s": step}, metric=metric)
    assert low.best_step() == 2
    assert CheckpointManager(str(tmp_path / "none")).restore() is None


def test_manager_async_save_and_atomic_write(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    w = torch.arange(6.0)
    mgr.save(1, {"w": w, "n": 1, "t": (1.5, None)}, metric=0.5)
    w.add_(100.0)          # after save: the snapshot was taken already
    _equal_nests(mgr.restore(1), {"w": torch.arange(6.0), "n": 1,
                                  "t": (1.5, None)})

    def fails_mid_write(obj, f, *a, **k):
        f.write(b"\x80partial")
        raise OSError("the write stopped half way")

    monkeypatch.setattr(torch, "save", fails_mid_write)
    mgr.save(2, {"w": w}, wait=False)
    with pytest.raises(OSError, match="half way"):
        mgr.wait()
    monkeypatch.undo()
    assert any(n.startswith(".2.pt.tmp") for n in os.listdir(tmp_path))
    assert mgr.latest_step() == 1 and mgr.all_steps() == [1]
    mgr.save(3, {"w": w}, wait=True)
    assert mgr.latest_step() == 3
    mgr.close()


def test_save_pytree_round_trip(tmp_path):
    model = tistvt.init(tconfig.ISTVTConfig(**TINY),
                        torch.Generator().manual_seed(0))
    names = {n for n, _ in model.named_parameters()}
    sd = model.state_dict()
    tree = {"params": {k: v for k, v in sd.items() if k in names},
            "state": {k: v for k, v in sd.items() if k not in names}}
    save_pytree(str(tmp_path / "w.pt"), tree)
    _equal_nests(load_pytree(str(tmp_path / "w.pt")), tree)


# ---------------------------------------------------------------------------
# train state and resume


def _train_state(cfg_kw, seed=0, optimizer="adamw"):
    model = tistvt.init(tconfig.ISTVTConfig(**cfg_kw),
                        torch.Generator().manual_seed(seed))
    opt = tstep.make_optimizer(
        tconfig.TrainConfig(optimizer=optimizer, checkpoint_dir=""),
        tsched.cosine_schedule(1e-4, 100))
    return tstep.create_train_state(model, opt)


def test_train_state_round_trip_bit_for_bit(tmp_path):
    ts = _train_state(TINY)
    tstep.make_train_step()(ts, _batch(2))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(ts.step, tstep.train_state_dict(ts))
    fresh = _train_state(TINY, seed=5)
    tstep.load_train_state(fresh, mgr.restore())
    assert fresh.step == ts.step == 1
    _equal_nests(tstep.train_state_dict(fresh), tstep.train_state_dict(ts))


CLI_TOY = ["--device", "cpu", "--dataset", "synthetic", "-is", "72", "-sl",
           "2", "--depth", "1", "-bs", "2", "--dataset_len", "2"]


def _cli_trainer(ck, epochs, extra=()):
    args = cli_train.build_parser().parse_args(
        CLI_TOY + ["-e", str(epochs), "-o", str(ck), "--reference_schedule",
                   *extra])
    cli_train.check_args(args)
    trainer, loader, _ = cli_train.build(args)
    trainer.log = lambda msg: None
    return trainer, loader


def test_resume_equals_uninterrupted_run(tmp_path):
    """The reference's default recipe (XLA-math, dropout 0.5), one step an
    epoch: 2 epochs, a save, a fresh Trainer that restores and takes the
    third step equals 3 uninterrupted steps bit for bit (the reference
    schedule does not depend on the epoch count)."""
    full, loader = _cli_trainer(tmp_path / "full", 3)
    init = {k: v.clone() for k, v in full.model.state_dict().items()}
    ts_full = full.fit(loader)
    first, loader = _cli_trainer(tmp_path / "cut", 2)
    assert first.fit(loader).step == 2
    resumed, loader = _cli_trainer(tmp_path / "cut", 3)
    ts = resumed.fit(loader)
    assert ts.step == ts_full.step == 3
    assert resumed.ckpt.all_steps() == [1, 2, 3]
    _equal_nests(tstep.train_state_dict(ts), tstep.train_state_dict(ts_full))
    moved = [k for k, v in ts_full.model.state_dict().items()
             if v.is_floating_point() and not torch.equal(v, init[k])]
    assert len(moved) > 100, len(moved)


@pytest.fixture(scope="module")
def jax_adamw_state():
    """A JAX TrainState after one adamw step (XLA-math, dropout 0) on the
    port's init weights, its model, optimizer and the batch."""
    cfg_kw = {**TINY, "use_pallas": False}
    weights = tistvt.init(tconfig.ISTVTConfig(**cfg_kw),
                          torch.Generator().manual_seed(1))
    params, state = istvt_from_torch(
        {k: v.numpy() for k, v in weights.state_dict().items()}, depth=2)
    model = jax_model("istvt", num_out_classes=1, dropout=0.0,
                      cfg=jconfig.ISTVTConfig(**cfg_kw))
    opt = jstep.make_optimizer(jconfig.TrainConfig(),
                               jsched.cosine_schedule(1e-4, 100))
    ts = jstep.TrainState(params=params, model_state=state,
                          opt_state=opt.init(params),
                          step=jnp.zeros((), jnp.int32))
    fn = jstep.make_train_step(model, opt, donate=False)
    batch = _batch(2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jprecision.highest():
        ts, _ = fn(ts, jb, None)
        after, m = fn(ts, jb, None)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return cfg_kw, to_np(ts), to_np(after), float(m["loss"]), batch


def test_jax_train_state_resumes_in_port_and_back(jax_adamw_state):
    cfg_kw, jts, j_after, j_loss, batch = jax_adamw_state
    ts = _train_state(cfg_kw, seed=7)
    ts.step = train_state_from_jax(jts, ts.model, ts.opt)
    assert ts.step == 1
    back = train_state_to_jax(ts.model, ts.opt, ts.step)
    adam, _, sched = jts.opt_state
    want = {"params": jts.params, "model_state": jts.model_state,
            "opt_state": {"count": adam.count, "mu": adam.mu, "nu": adam.nu},
            "step": jts.step}
    assert int(sched.count) == int(back["opt_state"]["count"]) == 1
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(want))
    for got, exp in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(want)):
        assert got.dtype == np.asarray(exp).dtype
        np.testing.assert_array_equal(got, exp)
    with tprecision.highest():
        m = tstep.make_train_step()(ts, batch)
    tol = TOL[1]
    assert abs(float(m["loss"]) - j_loss) <= tol["loss"]
    want_sd = params_from_jax(j_after.params, j_after.model_state)
    for n, p in ts.model.named_parameters():
        lim = tol["stem" if n.startswith("xcep.") else "vit"]
        assert _rel(p.detach(), want_sd[n]) <= lim, (n, _rel(p.detach(),
                                                          want_sd[n]))
    for n, b in ts.model.named_buffers():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), want_sd[n].numpy(),
                                       atol=tol["bn"], rtol=0, err_msg=n)


def test_sgd_state_to_jax_and_back():
    ts = _train_state(TINY, optimizer="sgd")
    tstep.make_train_step()(ts, _batch(2))
    tree = train_state_to_jax(ts.model, ts.opt, ts.step)
    jts = {**tree, "opt_state": (optax.TraceState(
        trace=tree["opt_state"]["trace"]), optax.EmptyState())}
    fresh = _train_state(TINY, seed=3, optimizer="sgd")
    fresh.step = train_state_from_jax(jts, fresh.model, fresh.opt)
    # the lr is the schedule's, set before every update, in neither state
    fresh.opt.param_groups[0]["lr"] = ts.opt.param_groups[0]["lr"]
    _equal_nests(tstep.train_state_dict(fresh), tstep.train_state_dict(ts))


def test_recalibrate_bn_matches_jax():
    """Two batches, trained-looking weights (one port step first): the
    installed running mean and variance of every BN equal JAX's
    recalibrate_bn on the same weights within rel-L2 1e-5; the parameters
    are untouched."""
    cfg_kw = {**TINY, "use_pallas": True, "dropout": 0.5}
    ts = _train_state(cfg_kw)
    tstep.make_train_step(rng=torch.Generator().manual_seed(0))(
        ts, _batch(2))
    batches = [_batch(2), {k: v[::-1].copy() * (1.5 if k == "clips" else 1)
                           for k, v in _batch(2).items()}]
    before = {n: p.clone() for n, p in ts.model.named_parameters()}
    params, state = istvt_from_torch(
        {k: v.numpy() for k, v in ts.model.state_dict().items()}, depth=2)
    model = jax_model("istvt", num_out_classes=1, dropout=0.5,
                      cfg=jconfig.ISTVTConfig(**cfg_kw))
    with jprecision.highest():
        want = jstep.recalibrate_bn(
            model, params, state,
            [{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
    with tprecision.highest():
        got = tstep.recalibrate_bn(ts.model, batches)
    assert ts.model.training
    want_sd = params_from_jax(params, jax.tree_util.tree_map(np.asarray,
                                                             want))
    assert len(got) == 2 * sum(k.endswith("running_var") for k in want_sd)
    for n, v in got.items():
        assert _rel(v, want_sd[n]) <= 1e-5, (n, _rel(v, want_sd[n]))
        assert torch.equal(ts.model.state_dict()[n], v)
    for n, p in ts.model.named_parameters():
        assert torch.equal(p, before[n]), n


# ---------------------------------------------------------------------------
# the CLIs


CLI = ["--device", "cpu", "--dataset", "synthetic", "-is", "72", "-sl", "3",
       "--depth", "2", "-bs", "4", "--dataset_len", "8"]


def test_cli_continue_test_mode_serve_and_visualize(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    cli_train.main(CLI + ["-e", "1", "-o", ck, "--use_pallas",
                          "--recal_bn", "1"])
    out = capsys.readouterr().out
    assert "recalibrated BN stats over 1 batches" in out
    mgr = CheckpointManager(ck)
    # the recalibrated state is saved at step + 1 with the best metric so
    # far; of equal metrics the later step is the best, as in Orbax
    assert mgr.all_steps() == [2, 3] and mgr.best_step() == 3
    assert os.path.getsize(os.path.join(ck, "metrics.jsonl")) > 0

    cli_train.main(CLI + ["-e", "2", "-o", ck, "--use_pallas",
                          "--continue_train"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "epoch 1: train loss" in out
    assert "epoch 0:" not in out
    assert mgr.latest_step() == 4

    cli_train.main(CLI + ["-o", ck, "--use_pallas", "--test_mode"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "hq {'accuracy'" in out

    # serve: the trained weights, restored before packing
    args = cli_serve.build_parser().parse_args(
        ["-sl", "3", "-is", "72", "--depth", "2", "--max_batch", "2",
         "-o", ck])
    pred = cli_serve.build_predictor(args, device="cpu")
    assert "restored step 4" in capsys.readouterr().out
    clips = _batch(2)["clips"][:, :1].repeat(3, axis=1)
    model = tistvt.init(tconfig.ISTVTConfig(
        num_frames=3, image_size=72, feat_hw=5, depth=2, use_pallas=True),
        torch.Generator().manual_seed(0))
    model.load_state_dict(mgr.restore()["model"])
    tistvt.pack_params(model)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(clips)).reshape(-1).numpy()
    got = np.asarray(pred.predict(clips)["logits"]).reshape(-1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    init = tistvt.init(model.cfg, torch.Generator().manual_seed(0))
    tistvt.pack_params(init)
    with torch.no_grad():
        assert np.abs(init.eval()(torch.from_numpy(clips)).reshape(-1)
                      .numpy() - want).max() > 1e-3

    # visualize: the checkpoint directory, then a bare save_pytree file
    vis = ["--device", "cpu", "--dataset", "synthetic", "-is", "72", "-sl",
           "3", "--depth", "2", "--max_clips", "1"]
    pngs = cli_vis.main(vis + ["--model_path", ck, "--out_dir",
                               str(tmp_path / "v1")])
    assert "restored trainer step 4" in capsys.readouterr().out
    assert len(pngs) == 9 and all(os.path.getsize(p) > 0 for p in pngs)
    names = {n for n, _ in model.named_parameters()}
    sd = model.state_dict()
    save_pytree(str(tmp_path / "w.pt"),
                {"params": {k: v for k, v in sd.items() if k in names},
                 "state": {k: v for k, v in sd.items() if k not in names}})
    pngs2 = cli_vis.main(vis + ["--model_path", str(tmp_path / "w.pt"),
                                "--out_dir", str(tmp_path / "v2")])
    for a, b in zip(pngs, pngs2):
        assert open(a, "rb").read() == open(b, "rb").read(), (a, b)


def test_sigterm_snapshot_resumes(tmp_path):
    """The train CLI in a subprocess (pytest owns this process's signal
    handlers), one step an epoch, SIGTERM after a logged epoch: exit 143,
    a snapshot at or past the logged step, and --continue_train resumes
    from it. A watchdog timer kills a hung child; each child has its own
    timeout."""
    ck = str(tmp_path / "ck")
    args = [sys.executable, "-u", "-m", "istvt_tpu_torch.cli.train",
            "--device", "cpu", "--dataset", "synthetic", "-is", "72", "-sl",
            "2", "--depth", "1", "-bs", "2", "--dataset_len", "2",
            "-o", ck]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(args + ["-e", "500"], cwd=str(tmp_path), env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(600.0, proc.kill)
    watchdog.start()
    lines, logged = [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("epoch 1: val"):
                logged = 2          # one step an epoch: step 2 is done
                break
        assert logged, "trainer died before epoch 1:\n" + "".join(lines)
        proc.send_signal(signal.SIGTERM)
        tail, _ = proc.communicate(timeout=240)
        lines.append(tail)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines)
    assert proc.returncode == 128 + signal.SIGTERM, (proc.returncode, out)
    saved = CheckpointManager(ck).latest_step()
    assert saved is not None and saved >= logged, (saved, out)
    assert f"checkpointing step {saved} before exit" in out, out
    r = subprocess.run(args + ["-e", str(saved + 1), "--continue_train"],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"resumed from step {saved}" in r.stdout, r.stdout
    assert CheckpointManager(ck).latest_step() == saved + 1, r.stdout


def test_metrics_logger_writes_jsonl_and_tensorboard_scalars(tmp_path):
    """metrics.jsonl gets one record a call; the event file holds the same
    scalars as TensorBoard Event protos in TFRecord framing; building the
    logger imports no TensorFlow (a fresh process)."""
    from tensorboard.compat.proto import event_pb2
    code = ("import sys; from istvt_tpu_torch.train.logging import "
            "MetricsLogger as M; m = M(sys.argv[1]); "
            "m.log(3, {'loss': 0.5, 'acc': 0.25, 'name': 'x'}, 'train_'); "
            "m.log(4, {'loss': 0.125}); m.close(); "
            "assert 'tensorflow' not in sys.modules")
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], check=True,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [{k: v for k, v in r.items() if k != "time"} for r in recs] == [
        {"step": 3, "train_loss": 0.5, "train_acc": 0.25},
        {"step": 4, "loss": 0.125}]
    (events,) = tmp_path.glob("events.out.tfevents.*")
    data, got = events.read_bytes(), []
    while data:
        (n,) = struct.unpack("<Q", data[:8])
        got.append(event_pb2.Event.FromString(data[12:12 + n]))
        data = data[16 + n:]
    assert got[0].file_version == "brain.Event:2"
    assert [(e.step, v.tag, v.simple_value) for e in got[1:]
            for v in e.summary.value] == [
        (3, "train_loss", 0.5), (3, "train_acc", 0.25), (4, "loss", 0.125)]
