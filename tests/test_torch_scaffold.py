"""Port scaffold: no jax reachable from istvt_tpu_torch, the ISTVTConfig copy
equals the JAX one, CPU tensors take the plain path, and nothing falls
back to the CPU or to the plain versions where the card is asked for."""
import dataclasses
import subprocess
import sys
import textwrap

import pytest
import torch

from istvt_tpu.core.config import ISTVTConfig as JaxConfig
from istvt_tpu_torch.core.config import ISTVTConfig
from istvt_tpu_torch.core.device import require_cuda
from istvt_tpu_torch.kernels import _lib, selfcheck


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import sys
        import istvt_tpu_torch, istvt_tpu_torch.models.istvt
        import istvt_tpu_torch.serve, istvt_tpu_torch.serve_daemon
        import istvt_tpu_torch.cli.serve, istvt_tpu_torch.compat
        import istvt_tpu_torch.kernels.selfcheck
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'istvt_tpu'))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_config_copy_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(ISTVTConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert ours == theirs
    cfg, jcfg = ISTVTConfig(feat_hw=5, heads=4), JaxConfig(feat_hw=5, heads=4)
    assert (cfg.tokens_per_frame, cfg.inner_dim) == \
        (jcfg.tokens_per_frame, jcfg.inner_dim)


def test_cpu_tensors_take_plain_path_and_count_nothing():
    cases = selfcheck.slice_cases(torch.device("cpu"))
    assert list(cases) == list(selfcheck.CASES)
    # one case per counter, and the rest ("name@shape") count under one
    assert [c for c in cases if "@" not in c] == list(_lib.LAUNCHES)
    assert {selfcheck.counter(c) for c in cases} == set(_lib.LAUNCHES)
    _lib.reset_launches()
    kern, plain, make = cases["ln_qkv_q8_temporal_attention"]
    args = make(torch.float32)
    args[0] = args[0][:, :3, :16].contiguous()         # a few rows only
    assert torch.equal(kern(*args), plain(*args))
    assert all(v == 0 for v in _lib.LAUNCHES.values())


def test_require_cuda():
    if torch.cuda.is_available():
        assert require_cuda().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            require_cuda()


def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel library that cannot be built raises (no nvcc here, or a
    source that does not compile on the card); nothing falls back."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cu").write_text("this is not C++\n")
    monkeypatch.setattr(_lib, "CSRC", src)
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_lib, "LIB_PATH", tmp_path / "build" / "lib.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        _lib.build(force=True)
