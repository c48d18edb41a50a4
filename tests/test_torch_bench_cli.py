"""The port's bench CLI (istvt_tpu_torch/cli/bench.py) against the JAX
package's (istvt_tpu/cli/bench.py), on the CPU at 72^2, T=3, depth 1, B=2.

For the same argv (the port's with `--device cpu`), each mode's JSON line
has JAX's keys and JAX's non-timing values. JAX's CLI runs with a linear
stand-in for its model (the registry's model_selection and, for
--pipeline, the istvt module's init / apply are patched): the keys and values come from
the CLI's own code, and compiling the depth-1 ISTVT in JAX's four modes
takes ~85 s on one core. The port runs its own tiny ISTVT. Then the int8
guard as tests/test_cli_bench.py holds JAX's, the chained scalar against
the separate forwards it sums, and the synthetic frame tree byte for byte
against JAX's.
"""
import json
import os

import jax.numpy as jnp
import pytest
import torch

from istvt_tpu.cli import bench as jbench
from istvt_tpu.models import istvt as jistvt
from istvt_tpu.models import registry as jregistry
from istvt_tpu.models.registry import Model as JaxModel
from istvt_tpu_torch.cli import bench as tbench

ARGV = ["-bs", "2", "-is", "72", "-sl", "3", "--depth", "1", "--iters", "2",
        "--dtype", "float32"]
MODES = {"forward": [], "chained": ["--chained"],
         "train_step": ["--train_step", "--grad_accum", "2"],
         "pipeline": ["--pipeline", "--num_workers", "2"]}
SAME = ("model", "mode", "batch", "input_size", "quantize", "grad_accum",
        "remat", "ingest", "h2d_mb_per_batch", "batches", "platform",
        "native_decode", "num_workers")


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
def tree(tmp_path_factory):
    return tbench._ensure_frame_tree(str(tmp_path_factory.mktemp("tree")), 72)


def _stand_in(params, state, clips, *a, **kw):
    return jnp.mean(clips, axis=(1, 2, 3)) @ params["w"], state


def _stand_in_init(*a):
    return {"w": jnp.full((3, 1), 0.1)}, {}


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", list(MODES))
def test_json_line_matches_jax(mode, tree, monkeypatch, capsys):
    argv = ARGV + MODES[mode] + (["--data_root", tree]
                                 if mode == "pipeline" else [])
    with monkeypatch.context() as m:
        m.setattr(jregistry, "model_selection",
                  lambda name, **kw: JaxModel(name, kw.get("cfg"),
                                              _stand_in_init, _stand_in))
        m.setattr(jistvt, "init", _stand_in_init)
        m.setattr(jistvt, "apply", _stand_in)
        jbench.main(argv)
        want = _last_json(capsys)
    got = tbench.main(argv + ["--device", "cpu"])
    assert _last_json(capsys) == got
    assert list(got) == list(want)
    assert {k: got[k] for k in SAME if k in got} == \
        {k: want[k] for k in SAME if k in want}
    rate = "items_per_sec" if mode != "pipeline" else "e2e_clips_per_sec"
    assert got[rate] > 0


@pytest.mark.parametrize("argv", [
    ["--quantize", "int8", "--device", "cpu"],
    ["--quantize", "int8", "--train_step"],
    ["-mn", "mesonet4", "--quantize", "int8"],
])
def test_int8_guard(argv):
    with pytest.raises(SystemExit):
        tbench.main(argv + ["--depth", "1", "-is", "72"])


def test_chained_sums_every_forward():
    args = tbench.build_parser().parse_args(ARGV + ["--device", "cpu"])
    cpu = torch.device("cpu")
    fwd = tbench.forward_fn(tbench.build_model("istvt", args, cpu, False, 1))
    x = torch.randn(2, 3, 72, 72, 3,
                    generator=torch.Generator().manual_seed(1))
    got = float(tbench.chained(fwd, x, 3))
    want = sum(float(fwd(x + 0.01 * (i + 1)).float().sum()) for i in range(3))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
    # the third forward is in the sum
    assert abs(got - float(tbench.chained(fwd, x, 2))) > 1e-4


def test_frame_tree_is_jax_s(tmp_path, tree):
    want = jbench._ensure_frame_tree(str(tmp_path / "jax"), 72)
    files = []
    for root, _, names in os.walk(tree):
        files += [os.path.relpath(os.path.join(root, n), tree) for n in names]
    assert len(files) == 32 * 12 + 1 and ".complete" in files
    for f in files:
        with open(os.path.join(tree, f), "rb") as a, \
                open(os.path.join(want, f), "rb") as b:
            assert a.read() == b.read(), f
