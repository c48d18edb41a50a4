"""The port's tooling (istvt_tpu_torch/utils, compat/parity.py, the
registry's resnet_3d key) against the JAX package's, on the CPU.

StepTimer, finite_fraction / assert_finite, compare_stages / format_report
are copies and are held equal to JAX's on the same inputs (StepTimer on
the same patched clock). debug_nans is held to what jax_debug_nans does:
a train step with one NaN pixel raises FloatingPointError in both (JAX's
step on a linear stand-in model: its debug_nans re-runs a failing program
op by op, which for the whole ISTVT step costs minutes on one core; the
port's on the tiny ISTVT itself), a clean step under the mode gives a loss
bit-equal to the step without it, and the mode is gone on exit. The trace
summary is held to a hand-written chrome trace (kernels filed under the
outermost operator that launched them, the rest under their names, copies
flagged and left out of busy time) and to a live CPU trace of a tiny
forward.
"""
import copy
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from istvt_tpu.compat import parity as jparity
from istvt_tpu.models.registry import Model as JaxModel
from istvt_tpu.train import step as jstep
from istvt_tpu.utils import debug as jdebug
from istvt_tpu.utils import profiling as jprofiling
from istvt_tpu_torch.compat import parity as tparity
from istvt_tpu_torch.core.config import DataConfig, ISTVTConfig, TrainConfig
from istvt_tpu_torch.data import ClipLoader, SyntheticVideoDataset
from istvt_tpu_torch.models import istvt as tistvt
from istvt_tpu_torch.models.registry import available_models, model_selection
from istvt_tpu_torch.train import step as tstep
from istvt_tpu_torch.train.trainer import Trainer
from istvt_tpu_torch.utils import debug as tdebug
from istvt_tpu_torch.utils import profiling as tprofiling
from istvt_tpu_torch.utils import trace_summary as ts

TINY = dict(num_frames=3, image_size=72, feat_hw=5, depth=1,
            use_pallas=True, quantize="none", dropout=0.0)
B = 2


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
def tiny():
    """A factory of copies of one seed-0 tiny ISTVT."""
    base = tistvt.init(ISTVTConfig(**TINY), torch.Generator().manual_seed(0))
    return lambda: copy.deepcopy(base)


def _clips(nan=False):
    x = np.random.RandomState(0).randn(B, 3, 72, 72, 3).astype(np.float32)
    if nan:
        x[0, 1, 10, 20, 0] = np.nan
    return x


def _mode_gone():
    assert _get_current_dispatch_mode_stack() == []
    assert not torch.is_anomaly_enabled()


# ---------------------------------------------------------------------------
# StepTimer, finite checks


def test_step_timer_matches_jax(monkeypatch):
    ticks = [0.0, 0.5, 1.0, 1.25, 2.0, 2.125, 3.0, 3.75, 4.0, 4.0625,
             5.0, 5.5]

    def summary(cls):
        it = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(it))
        t = cls(warmup=1, items_per_step=4)
        for _ in range(len(ticks) // 2):
            with t.step():
                pass
        return t.summary()

    want = summary(jprofiling.StepTimer)
    assert summary(tprofiling.StepTimer) == want
    assert want["steps"] == 5
    assert tprofiling.StepTimer().summary() == {}


def _trees():
    r = np.random.RandomState(3)
    a = r.randn(4, 5).astype(np.float32)
    b = r.randn(7).astype(np.float32)
    b[[1, 4]] = [np.nan, np.inf]
    c = np.arange(6, dtype=np.int32)
    return [{"a": a}, {"a": a, "b": [b, (c, a[:2])]}, {"c": c}, [b, b]]


@pytest.mark.parametrize("i", range(4))
def test_finite_checks_match_jax(i):
    tree = _trees()[i]
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = jax.tree_util.tree_map(torch.from_numpy, tree)
    assert float(tdebug.finite_fraction(tt)) == float(
        jdebug.finite_fraction(jt))
    try:
        want = jdebug.assert_finite(jt, "t")
    except FloatingPointError as e:
        with pytest.raises(FloatingPointError) as got:
            tdebug.assert_finite(tt, "t")
        assert str(got.value) == str(e)
    else:
        assert tdebug.assert_finite(tt, "t") is want


# ---------------------------------------------------------------------------
# debug_nans


def _jax_linear_step():
    """JAX's make_train_step on a linear stand-in for a clip model."""
    def apply(params, state, clips, train=False, rng=None, **kw):
        return jnp.mean(clips, axis=(1, 2, 3)) @ params["w"], state

    model = JaxModel("linear", None,
                     lambda rng: ({"w": jnp.full((3, 1), 0.1)}, {}), apply)
    opt = optax.adamw(1e-3)
    return (jstep.create_train_state(model, jax.random.PRNGKey(0), opt),
            jstep.make_train_step(model, opt, donate=False))


def _port_step(model, clips):
    step = tstep.make_train_step()
    ts_ = tstep.create_train_state(model, tstep.make_optimizer(
        TrainConfig(), lambda i: 1e-3))
    return step(ts_, {"clips": torch.from_numpy(clips),
                      "labels": torch.zeros(B, dtype=torch.int32)})


def test_nan_pixel_raises_in_both(tiny):
    clips = _clips(nan=True)
    state, step = _jax_linear_step()
    batch = {"clips": jnp.asarray(clips), "labels": jnp.zeros(B, jnp.int32)}
    with jdebug.debug_nans():
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(step(state, batch, jax.random.PRNGKey(0)))
    with pytest.raises(FloatingPointError, match=r"encountered in aten\."):
        with tdebug.debug_nans():
            _port_step(tiny(), clips)
    _mode_gone()
    # without the mode the step runs through to a NaN loss, as JAX's
    assert np.isnan(float(_port_step(tiny(), clips)["loss"]))


def test_clean_step_is_bit_equal_under_debug_nans(tiny):
    clips = _clips()
    plain, checked = tiny(), tiny()
    want = _port_step(plain, clips)
    with tdebug.debug_nans():
        got = _port_step(checked, clips)
    _mode_gone()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for (n, p), q in zip(plain.named_parameters(), checked.parameters()):
        assert torch.equal(p, q), n


class _NanBackward(torch.autograd.Function):
    """A backward that returns NaN made outside the checked region, as a
    ctypes kernel would write it."""
    nan = None

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _NanBackward.nan


def test_backward_nan_and_ctypes_outputs_raise():
    _NanBackward.nan = torch.full((3,), float("nan"))
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="_NanBackward"):
        with tdebug.debug_nans():
            _NanBackward.apply(x).sum().backward()
    _mode_gone()
    tdebug.check_outputs("kernel", _NanBackward.nan)   # outside: no check
    with pytest.raises(FloatingPointError, match="in kernel"):
        with tdebug.debug_nans():
            assert tdebug.nan_check_active()
            tdebug.check_outputs("kernel", torch.ones(2), _NanBackward.nan)
    _mode_gone()
    with tdebug.debug_nans(False):
        assert not tdebug.nan_check_active()
        torch.zeros(1) / 0.0
    # an uninitialized buffer is not a NaN an operator made
    with tdebug.debug_nans():
        torch.empty(1 << 16).view(-1, 2).fill_(1.0)


@pytest.mark.parametrize("flag", [True, False])
def test_trainer_debug_nans_fits_a_step(flag, tiny):
    logs, seen = [], []

    def hook(batch):        # runs inside fit, before each step
        seen.append((tdebug.nan_check_active(), torch.is_anomaly_enabled()))
        return batch

    tc = TrainConfig(debug_nans=flag, num_epochs=1, checkpoint_dir="",
                     log_every=1)
    ds = SyntheticVideoDataset(B, seq_len=3, size=72)
    trainer = Trainer(tiny(), tc, DataConfig(batch_size=B),
                      log_fn=logs.append, batch_hook=hook)
    state = trainer.fit(ClipLoader(ds, batch_size=B, shuffle=False,
                                   num_workers=1))
    assert state.step == 1
    assert ("debug_nans: enabled" in logs) == flag
    # without the flag no mode is entered at all
    assert seen == [(flag, flag)]
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    _mode_gone()


# ---------------------------------------------------------------------------
# trace summary


def _x(cat, name, ts_, dur, pid=1, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
          "ts": ts_, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


HAND_TRACE = [
    # aten::conv2d > aten::convolution > aten::cudnn_convolution launches 1
    _x("cpu_op", "aten::conv2d", 0, 100),
    _x("cpu_op", "aten::convolution", 1, 98),
    _x("cpu_op", "aten::cudnn_convolution", 2, 96),
    _x("cuda_runtime", "cudaLaunchKernel", 10, 5, corr=1),
    # an autograd node (not an operator) around an operator launching 2
    _x("cpu_op", "autograd::engine::evaluate_function: XBackward0", 200, 50),
    _x("cpu_op", "aten::mul", 210, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 215, 3, corr=2),
    # a ctypes kernel (3) and a copy (4) outside any operator; a copy (5)
    # inside aten::to
    _x("cuda_runtime", "cudaLaunchKernel", 300, 4, corr=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 310, 4, corr=4),
    _x("cpu_op", "aten::to", 400, 30),
    _x("cpu_op", "aten::_to_copy", 401, 28),
    _x("cuda_runtime", "cudaMemcpyAsync", 405, 4, corr=5),
    # a launch on another thread inside no operator of its own thread
    _x("cuda_runtime", "cudaLaunchKernel", 12, 2, tid=2, corr=6),
    _x("kernel", "sm90_xmma_fprop_implicit_gemm_bf16", 20, 400.0, pid=0,
       tid=7, corr=1),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4, "
       "at::native::Mul>(int, at::native::Mul)", 230, 100.0, pid=0, tid=7,
       corr=2),
    _x("kernel", "void istvt::gemm_bf16_wgmma_kernel<128, 2>(istvt::P)",
       320, 1500.0, pid=0, tid=7, corr=3),
    _x("kernel", "void istvt::gemm_bf16_wgmma_kernel<64, 2>(istvt::P)",
       1900, 500.0, pid=0, tid=7),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 320, 2000.0,
       pid=0, tid=8, corr=4),
    _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 420, 50.0, pid=0,
       tid=8, corr=5),
    _x("gpu_memset", "Memset (Device)", 500, 10.0, pid=0, tid=8),
    _x("kernel", "void k2(float*)", 600, 30.0, pid=0, tid=7, corr=6),
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 1, "tid": 1,
     "ts": 10},
]


def test_aggregate_files_kernels_under_their_launching_operator(tmp_path):
    path = tmp_path / "h.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": HAND_TRACE}))
    rows = ts.aggregate(ts.parse_file(str(path)))
    got = {(r.prefix, r.asynchronous): (r.count, r.total_ms) for r in rows}
    assert got == {
        ("aten::conv2d", False): (1, 0.4),
        ("aten::mul", False): (1, 0.1),
        ("istvt::gemm_bf16_wgmma_kernel", False): (2, 2.0),
        ("Memcpy HtoD", True): (1, 2.0),
        ("aten::to", True): (1, 0.05),
        ("Memset", True): (1, 0.01),
        ("k2", False): (1, 0.03),
    }
    assert [r.prefix for r in rows][:2] == ["istvt::gemm_bf16_wgmma_kernel",
                                            "Memcpy HtoD"]
    table = ts.format_table(rows, top=3)
    lines = table.splitlines()
    assert lines[0].split() == ["prefix", "count", "total", "ms", "mean",
                                "us", "async"]
    assert len(lines) == 5 and lines[2].rstrip().endswith("Y")
    assert lines[-1] == ("-- busy (non-async) total: 2.530 ms over 5 "
                         "events")
    assert ts.find_traces(str(tmp_path)) == [str(path)]


def test_live_cpu_trace_of_a_forward(tmp_path, capsys, tiny):
    model = tiny()
    tistvt.pack_params(model)
    with tprofiling.trace(str(tmp_path)) as d:
        with tprofiling.annotate("bench_forward"), torch.no_grad():
            model(torch.from_numpy(_clips()))
    assert d == str(tmp_path)
    (path,) = ts.find_traces(d)
    events = ts.parse_file(path)
    assert any(e.get("name") == "bench_forward" for e in events)
    rows = {r.prefix: r for r in ts.aggregate(events, cat_filter=("cpu_op",))}
    # the stem's convolutions: conv1, conv2 and the entry flow's
    conv = rows["aten::conv2d"]
    assert conv.count >= 2 and conv.total_ms > 0
    assert ts.aggregate(events) == []      # no device events on the CPU
    ts.main([d])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"# {path}"
    assert out[-1] == "-- busy (non-async) total: 0.000 ms over 0 events"


# ---------------------------------------------------------------------------
# parity harness, registry


def test_compare_stages_matches_jax():
    x = np.random.RandomState(1).randn(3, 4)
    base = [("scale", lambda v: v * 2.0), ("shift", lambda v: v + 1.0),
            ("square", lambda v: v * v), ("neg", lambda v: -v)]
    # side b departs from side a at the third stage
    other = base[:2] + [("square", lambda v: v * v * 1.01), base[3]]
    for stop in (True, False):
        want = jparity.compare_stages(base, other, x, x, stop_on_fail=stop)
        got = tparity.compare_stages(base, other, torch.from_numpy(x),
                                     torch.from_numpy(x), stop_on_fail=stop)
        assert [tuple(vars(r).values()) for r in got] == \
            [tuple(vars(r).values()) for r in want]
        assert tparity.format_report(got) == jparity.format_report(want)
    assert [r.ok for r in got] == [True, True, False, False]
    assert tparity.to_numpy(torch.ones(2, dtype=torch.bfloat16)).dtype \
        == np.float32


def test_resnet_3d_is_istvt():
    assert available_models() == ["istvt", "resnet_3d"]
    cfg = ISTVTConfig(**TINY)
    cpu = torch.device("cpu")
    a = model_selection("istvt", cfg=cfg, device=cpu, seed=0).state_dict()
    b = model_selection("resnet_3d", cfg=cfg, device=cpu, seed=0)
    assert isinstance(b, tistvt.ISTVT)
    b = b.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(NotImplementedError, match="Rest of the model zoo"):
        model_selection("vivit", cfg=cfg, device=cpu)
