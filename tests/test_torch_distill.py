"""Distillation in the port (istvt_tpu_torch/train/losses.py, distill.py,
the train-mode attention maps of models/istvt.py, train/step.py's loss_fn,
the train CLI's --distill_from) against the JAX package on the CPU, at
toy sizes: a 72^2 / depth-2 teacher, a 56^2 / depth-1 student, seq_len 3,
f32, the XLA-math path (use_pallas=False, as train/certify.py trains).

Weights are drawn by the port's init, read into JAX trees by the JAX
package's torch_import and loaded into the port by compat/from_jax, as in
tests/test_torch_train_step.py. Bounds: the losses and their gradients
1e-6; the resize 1e-5 (one 300 -> 224 frame 1e-4); the teacher hook's
logits and clips 1e-5, its cams rel-L2 1e-4; the train-mode forward's
logits and maps 1e-5; the distill step tests/test_torch_train_step.py's
first-step bounds (its _check_step).

JAX's step is compiled once per attn_weight at microbatch size 2 (each
compile takes tens of seconds here); its grad_accum=2 reference is that
step run on the two microbatches from the same parameters, the BN state
threaded, the gradients averaged and one AdamW update applied, which is
what JAX's _accumulate computes.
"""
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
from istvt_tpu.models import istvt as jistvt_module
from istvt_tpu.models.registry import model_selection as jax_model
from istvt_tpu.train import distill as jdistill
from istvt_tpu.train import losses as jlosses
from istvt_tpu.train import schedule as jsched
from istvt_tpu.train import step as jstep
from istvt_tpu_torch.cli import train as cli_train
from istvt_tpu_torch.compat.from_jax import params_from_jax
from istvt_tpu_torch.core import config as tconfig
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.core.checkpoint import CheckpointManager
from istvt_tpu_torch.kernels import _lib
from istvt_tpu_torch.models import istvt as tistvt
from istvt_tpu_torch.train import distill as tdistill
from istvt_tpu_torch.train import losses as tlosses
from istvt_tpu_torch.train import schedule as tsched
from istvt_tpu_torch.train import step as tstep
from test_torch_dropout_train import _Given
from test_torch_train_step import _check_step, _keep_grads, _rel

T = 3
TEACHER = dict(num_frames=T, image_size=72, feat_hw=5, depth=2)
STUDENT = dict(num_frames=T, image_size=56, feat_hw=4, depth=1)
LR, TOTAL = 1e-4, 100


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(cfg_kw, seed):
    """(JAX model, params, state as numpy trees) of the port's init."""
    w = tistvt.init(tconfig.ISTVTConfig(**cfg_kw),
                    torch.Generator().manual_seed(seed))
    params, state = istvt_from_torch(
        {k: v.numpy() for k, v in w.state_dict().items()},
        depth=cfg_kw["depth"])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    model = jax_model("istvt", num_out_classes=1, dropout=0.0,
                      cfg=jconfig.ISTVTConfig(**cfg_kw))
    return model, to_np(params), to_np(state)


def _port(cfg_kw, params, state):
    model = tistvt.init(tconfig.ISTVTConfig(**cfg_kw),
                        torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, state))
    return model


@pytest.fixture(scope="module")
def teacher():
    return _weights(TEACHER, 1)


@pytest.fixture(scope="module")
def student():
    return _weights(STUDENT, 2)


# ---------------------------------------------------------------------------
# the losses


def _loss_inputs(case):
    """Logits, teacher logits, labels, maps and cams, from a seed."""
    rng = np.random.RandomState(3)
    b, h, s, layers = 4, 2, 17, 2

    def maps(shape):
        a = rng.randn(*shape).astype(np.float32)
        e = np.exp(a - a.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    x = {"z": rng.randn(b, 1).astype(np.float32),
         "t": rng.randn(b, 1).astype(np.float32),
         "labels": np.array([1, 0, 1, 1], np.int32),
         "s": [maps((b, h, T + 1, s, s)) for _ in range(layers)],
         "tm": [maps((b, h, s, T + 1, T + 1)) for _ in range(layers)],
         "cam_s": rng.dirichlet(np.ones(s - 1), (b, T)).astype(np.float32),
         "cam_t": rng.dirichlet(np.ones(T), b).astype(np.float32),
         "mask": np.array([1, 1, 0, 1], np.float32)}
    if case == "no_targets":
        x["cam_s"] = x["cam_t"] = None
    if case == "no_fakes":
        x["labels"] = np.zeros(b, np.int32)
    if case == "cam_s_mask_zero":
        x["mask"] = np.zeros(b, np.float32)
    return x


@pytest.mark.parametrize("case", ["full", "no_targets", "no_fakes",
                                  "cam_s_mask_zero"])
def test_distill_losses_match_jax(case):
    """distillation_bce, attention_transfer_ce and make_distill_loss(2.0):
    values, and gradients in the logits and every map, vs jax.grad."""
    x = _loss_inputs(case)

    def both(lib, arr, grad_of):
        def total(z, s_maps, t_maps):
            batch = {"teacher_logits": arr(x["t"]),
                     "labels": arr(x["labels"]),
                     "teacher_cam_s": None if x["cam_s"] is None
                     else arr(x["cam_s"]),
                     "teacher_cam_t": None if x["cam_t"] is None
                     else arr(x["cam_t"]),
                     "cam_s_mask": arr(x["mask"])}
            attns = {"s": s_maps, "t": t_maps}
            d = lib.distillation_bce(z, batch["teacher_logits"],
                                     batch["labels"], 0.3, 3.0)
            s_ce, t_ce = lib.attention_transfer_ce(
                attns, batch["teacher_cam_s"], batch["teacher_cam_t"],
                batch["labels"], cam_s_mask=batch["cam_s_mask"])
            full = lib.make_distill_loss(0.3, 3.0, 2.0)(z, batch, attns)
            return d, s_ce, t_ce, full
        return grad_of(total)

    def jax_side(total):
        args = (jnp.asarray(x["z"]), [jnp.asarray(a) for a in x["s"]],
                [jnp.asarray(a) for a in x["tm"]])
        vals, grads = jax.jit(lambda *a: (total(*a), jax.grad(
            lambda *b: total(*b)[3], argnums=(0, 1, 2))(*a)))(*args)
        return ([float(v) for v in vals],
                jax.tree_util.tree_map(np.asarray, grads))

    def torch_side(total):
        z = torch.tensor(x["z"], requires_grad=True)
        s_maps = [torch.tensor(a, requires_grad=True) for a in x["s"]]
        t_maps = [torch.tensor(a, requires_grad=True) for a in x["tm"]]
        out = total(z, s_maps, t_maps)
        leaves = [z] + s_maps + t_maps
        g = torch.autograd.grad(out[3], leaves, allow_unused=True)
        g = [np.zeros(leaf.shape, np.float32) if v is None else v.numpy()
             for v, leaf in zip(g, leaves)]
        return [float(v.detach()) for v in out], (g[0], g[1:3], g[3:])

    j_vals, j_grads = both(jlosses, jnp.asarray, jax_side)
    t_vals, t_grads = both(tlosses, torch.as_tensor, torch_side)
    np.testing.assert_allclose(t_vals, j_vals, atol=1e-6, rtol=1e-6)
    for got, want in zip(jax.tree_util.tree_leaves(t_grads),
                         jax.tree_util.tree_leaves(j_grads)):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if case in ("no_targets", "no_fakes"):
        assert t_vals[1] == t_vals[2] == 0.0
    if case == "cam_s_mask_zero":
        assert t_vals[1] == 0.0 and t_vals[2] > 0.0
    fn = tlosses.make_distill_loss(attn_weight=2.0)
    assert fn.needs_attn and not tlosses.make_distill_loss().needs_attn


@pytest.mark.parametrize("case", ["clips_72_56", "cams_19_14",
                                  "frame_300_224"])
def test_resize_matches_jax_image_resize(case):
    """resize_bilinear vs jax.image.resize(..., 'bilinear'), which
    antialiases when it downscales."""
    rng = np.random.RandomState(4)
    x, size, last, tol = {
        "clips_72_56": (rng.randn(2, T, 72, 72, 3), 56, True, 1e-5),
        "cams_19_14": (rng.randn(2, T, 19, 19), 14, False, 1e-5),
        "frame_300_224": (rng.randn(1, 1, 300, 300, 3), 224, True, 1e-4),
    }[case]
    x = x.astype(np.float32)
    shape = (*x.shape[:2], size, size) + ((3,) if last else ())
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape, "bilinear"))
    got = tdistill.resize_bilinear(torch.from_numpy(x), size,
                                   channels_last=last).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the teacher hook


def test_augment_with_teacher_matches_jax(teacher):
    """The cross-geometry hook with cams (72^2 teacher -> 56^2 / 4^2
    student) vs JAX's on one batch: the port computes the cams in slices
    of 2 over a batch of 3 (a ragged last slice), JAX in one piece."""
    model, params, state = teacher
    clips = np.random.RandomState(5).randn(3, T, 72, 72, 3).astype(
        np.float32)
    batch = {"clips": clips, "labels": np.array([1, 0, 1], np.int32)}
    cfg = jconfig.ISTVTConfig(**TEACHER)
    with jprecision.highest():
        want = jdistill.augment_with_teacher(
            jdistill.make_teacher_fn(model, params, state, cam_cfg=cfg),
            student_size=56, student_feat_hw=4)(
                {k: jnp.asarray(v) for k, v in batch.items()})
    port = _port(TEACHER, params, state)
    with tprecision.highest():
        got = tdistill.augment_with_teacher(
            tdistill.make_teacher_fn(port, cam_cfg=port.cfg, cam_chunk=2),
            student_size=56, student_feat_hw=4)(
                {k: torch.as_tensor(v) for k, v in batch.items()})
    assert set(got) == set(want)
    assert not port.training
    np.testing.assert_allclose(got["teacher_logits"].numpy(),
                               np.asarray(want["teacher_logits"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["clips"].numpy(),
                               np.asarray(want["clips"]), atol=1e-5, rtol=0)
    for k, shape in (("teacher_cam_s", (3, T, 16)),
                     ("teacher_cam_t", (3, T))):
        assert tuple(got[k].shape) == shape
        assert _rel(got[k].numpy(), np.asarray(want[k])) <= 1e-4, k
    # logit-only, no resize: the logits alone; compute_dtype scores with a
    # bf16 copy (the serving gate 5e-2) and leaves the teacher in f32
    logits = tdistill.make_teacher_fn(port)(batch)
    assert torch.equal(logits, got["teacher_logits"])
    bf16 = tdistill.make_teacher_fn(port, compute_dtype=torch.bfloat16)(
        batch)
    assert bf16.dtype == torch.bfloat16
    assert float((bf16.float() - logits).abs().max()) <= 5e-2
    assert next(port.parameters()).dtype == torch.float32
    with pytest.raises(ValueError, match="cam_cfg"):
        tdistill.make_teacher_fn(port, cam_cfg=tconfig.ISTVTConfig(**{
            **TEACHER, "depth": 1}))
    with pytest.raises(NotImplementedError, match="Parallelism"):
        tdistill.make_teacher_fn(port, mesh=object())


# ---------------------------------------------------------------------------
# attention maps in train mode


def _train_masks(b, rate):
    """The layer's two keep masks on the unpadded stream: (B, N, 4D) and
    (B, N, D), N = (T+1) * 17."""
    rng = np.random.RandomState(6)
    n = (T + 1) * 17
    return [rng.rand(b, n, 4 * 728) < 1 - rate, rng.rand(b, n, 728) < 1 - rate]


@pytest.mark.parametrize("rate", [0.0, 0.5], ids=["dropout0", "masks"])
def test_train_mode_maps_match_jax(student, rate, monkeypatch):
    """forward(return_attn=True) in train mode vs JAX's apply(train=True,
    return_attn=True): logits and every map 1e-5; with dropout 0.5 both
    take the same masks (JAX's dropout replaced by a stand-in that hands
    them out in call order, as tests/test_torch_dropout_train.py does)."""
    _, params, state = student
    cfg_kw = {**STUDENT, "dropout": rate}
    clips = np.random.RandomState(7).randn(2, T, 56, 56, 3).astype(
        np.float32)
    masks = _train_masks(2, rate) if rate else []

    def given_dropout(key, x, r, train):
        if not train or r == 0.0 or key is None:
            return x
        m = masks.pop(0)
        assert m.shape == x.shape, (m.shape, x.shape)
        return jnp.where(m, x / (1.0 - r), 0.0)

    rng = _Given(list(masks)) if rate else None
    monkeypatch.setattr(jistvt_module, "dropout", given_dropout)
    jmodel = jax_model("istvt", num_out_classes=1, dropout=rate,
                       cfg=jconfig.ISTVTConfig(**cfg_kw))
    with jprecision.highest():
        (j_logits, j_attns), _ = jax.jit(lambda p, s, x: jmodel.apply(
            p, s, x, train=True, rng=jax.random.PRNGKey(0),
            return_attn=True))(params, state, jnp.asarray(clips))
    port = _port(cfg_kw, params, state).train()
    with tprecision.highest():
        logits, attns = port(torch.from_numpy(clips), return_attn=True,
                             rng=rng)
    assert not masks and (rng is None or rng.calls == 2)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               atol=1e-5, rtol=0)
    for k in ("s", "t"):
        assert len(attns[k]) == STUDENT["depth"]
        for got, want in zip(attns[k], j_attns[k]):
            assert got.requires_grad
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the distill step


def _distill_batch(b):
    rng = np.random.RandomState(8)
    return {"clips": rng.randn(b, T, 56, 56, 3).astype(np.float32),
            "labels": np.array([1, 0, 1, 1][:b] * (b // 4 or 1),
                               np.int32)[:b],
            "teacher_logits": rng.randn(b, 1).astype(np.float32),
            "teacher_cam_s": rng.dirichlet(np.ones(16), (b, T)).astype(
                np.float32),
            "teacher_cam_t": rng.dirichlet(np.ones(T), b).astype(np.float32),
            "cam_s_mask": np.array([1, 1, 0, 1] * (b // 4 or 1),
                                   np.float32)[:b]}


_JAX_STEPS = {}


def _jax_step(student, attn_weight):
    """JAX's make_train_step(loss_fn=make_distill_loss(0.5, 2,
    attn_weight)) with _keep_grads before its AdamW, compiled once."""
    if attn_weight not in _JAX_STEPS:
        model = student[0]
        opt = optax.chain(_keep_grads(), jstep.make_optimizer(
            jconfig.TrainConfig(), jsched.cosine_schedule(LR, TOTAL)))
        fn = jstep.make_train_step(
            model, opt, donate=False,
            loss_fn=jlosses.make_distill_loss(0.5, 2.0, attn_weight))
        _JAX_STEPS[attn_weight] = (opt, fn)
    return _JAX_STEPS[attn_weight]


def _jax_distill(student, attn_weight, grad_accum, batch):
    """(loss, grads, params, state) of one JAX step with grad_accum
    microbatches of 2 (see the module docstring)."""
    _, params, state = student
    opt, fn = _jax_step(student, attn_weight)
    ts0 = jstep.TrainState(params=params, model_state=state,
                           opt_state=opt.init(params),
                           step=jnp.zeros((), jnp.int32))
    mstate, losses, grads = state, [], []
    with jprecision.highest():
        for i in range(grad_accum):
            mb = {k: jnp.asarray(v[2 * i:2 * i + 2])
                  for k, v in batch.items()}
            ts, m = fn(jstep.TrainState(params=params, model_state=mstate,
                                        opt_state=ts0.opt_state,
                                        step=ts0.step), mb,
                       jax.random.PRNGKey(0))
            mstate = ts.model_state
            losses.append(float(m["loss"]))
            grads.append(ts.opt_state[0])
        if grad_accum == 1:
            return losses[0], grads[0], ts.params, mstate
        adamw = jstep.make_optimizer(jconfig.TrainConfig(),
                                     jsched.cosine_schedule(LR, TOTAL))

        @jax.jit
        def update(grads, p):
            g = jax.tree_util.tree_map(lambda *v: sum(v) / grad_accum,
                                       *grads)
            upd, _ = adamw.update(g, adamw.init(p), p)
            return g, optax.apply_updates(p, upd)

        g, new = update(grads, params)
    return float(np.mean(losses)), g, new, mstate


def _torch_distill(student, attn_weight, grad_accum, batch):
    _, params, state = student
    model = _port(STUDENT, params, state)
    opt = tstep.make_optimizer(tconfig.TrainConfig(checkpoint_dir=""),
                               tsched.cosine_schedule(LR, TOTAL))
    ts = tstep.create_train_state(model, opt)
    step = tstep.make_train_step(
        grad_accum=grad_accum,
        loss_fn=tlosses.make_distill_loss(0.5, 2.0, attn_weight))
    _lib.reset_launches()
    with tprecision.highest():
        m = step(ts, batch)
    assert all(v == 0 for v in _lib.LAUNCHES.values())   # CPU: plain only
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return float(m["loss"]), grads, {k: v.clone() for k, v in
                                     model.state_dict().items()}


_PORT_GRADS = {}


@pytest.mark.parametrize("attn_weight", [0.0, 2.0], ids=["logits", "attn2"])
@pytest.mark.parametrize("grad_accum", [1, 2], ids=["ga1", "ga2"])
def test_distill_step_matches_jax(student, attn_weight, grad_accum):
    """One f32 distill step, port vs JAX: loss, gradients, updated
    parameters and BN state at tests/test_torch_train_step.py's first-step
    bounds. With grad_accum=2 the teacher's entries are split with the
    clips. The transfer term moves the transformer's gradients: the
    attn_weight 0 and 2 steps' gradients differ."""
    batch = _distill_batch(2 * grad_accum)
    t_out = _torch_distill(student, attn_weight, grad_accum, batch)
    j_out = _jax_distill(student, attn_weight, grad_accum, batch)
    names = list(t_out[1])
    _check_step(1, t_out, j_out, student[2], names, bf16=False)
    _PORT_GRADS[(attn_weight, grad_accum)] = t_out[1]
    other = _PORT_GRADS.get((2.0 - attn_weight, grad_accum))
    if other is not None:
        vit = [n for n in names if n.startswith("vit.transformer.")]
        assert all(_rel(t_out[1][n], other[n]) > 1e-3 for n in vit
                   if "to_q" in n or "to_v" in n)


# ---------------------------------------------------------------------------
# the train CLI


def test_cli_distills_cross_geometry(tmp_path, capsys):
    """cli/train.py --device cpu --distill_from: a 72^2 / depth-1 teacher
    checkpoint (its model state only, as a Trainer saves it, under an
    SGD-trained name) distills a 56^2 student for 2 steps and one val
    pass; no checkpoint under the directory exits as JAX's CLI does."""
    teacher = tistvt.init(tconfig.ISTVTConfig(**{**TEACHER, "depth": 1}),
                          torch.Generator().manual_seed(3))
    CheckpointManager(str(tmp_path / "teacher")).save(
        4, {"model": teacher.state_dict(), "step": 4})
    args = ["--device", "cpu", "--dataset", "synthetic", "-is", "56",
            "-sl", str(T), "--depth", "1", "-bs", "2", "--dataset_len", "4",
            "-e", "1", "--dropout", "0", "--num_workers", "1",
            "--teacher_depth", "1", "--teacher_input_size", "72",
            "--teacher_optimizer", "sgd", "-o", str(tmp_path / "student")]
    cli_train.main(args + ["--distill_from", str(tmp_path / "teacher")])
    out = capsys.readouterr().out
    assert (f"distilling from {tmp_path / 'teacher'} (teacher depth 1, "
            f"size 72, alpha=0.5, T=2.0)") in out
    line = [ln for ln in out.splitlines() if "train loss" in ln][-1]
    assert np.isfinite(float(line.split("train loss")[1].split()[0])), line
    assert "val {" in out
    assert sorted(os.listdir(tmp_path / "student"))[:2] == ["2.json", "2.pt"]
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli_train.main(args + ["--distill_from", str(tmp_path / "nope")])
