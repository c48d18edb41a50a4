"""Serving artifacts of the port (istvt_tpu_torch/serve_export.py,
kernels/ops.py, cli/export.py, cli/serve.py --artifact) on the CPU at toy
geometry (2 frames, 72^2, depth 1), against the JAX package's
istvt_tpu/serve_export.py.

The fourteen forward kernels are dispatcher ops: `torch.library.opcheck`
holds each one's schema, fake function and dispatch on the arguments its
wrapper gives it (kernels/selfcheck's small cases), and its CPU output
equals its plain version bit for bit. Exported models carry exactly their
path's ops (int8 `ingest`: #1-#3 once a layer; the float fused path in
bf16 and f32: #11, #10, #18 x 2, #20 x 2, #21; each int8 A/B mode its
own) and none of the plain versions' softmax or GELU math. An artifact
round-trips: over 5 clips in buckets (2, 4) its logits equal the live
Predictor's bit for bit, its bf16 / int8 / f32 tensors come back with their
dtypes and bits, the directory holds the weights once, and loading it
imports no model code. Over the same weights (compat/from_jax) the port's
artifacts agree with JAX's: f32 float within test_torch_float_path.py's
1e-3, int8 within test_torch_istvt.py's atol = rtol = 1e-2.
"""
import copy
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from istvt_tpu import serve_export as JSE
from istvt_tpu.cli import export as jcli
from istvt_tpu.compat.torch_import import istvt_from_torch
from istvt_tpu.core import precision as jprecision
from istvt_tpu.core import tree as jtree
from istvt_tpu.core.config import ISTVTConfig as JaxConfig
from istvt_tpu.models import istvt as jistvt
from istvt_tpu.models.registry import model_selection as jax_model
from istvt_tpu_torch import serve_export as SE
from istvt_tpu_torch.cli import export as tcli
from istvt_tpu_torch.cli.serve import build_parser, build_predictor
from istvt_tpu_torch.compat.from_jax import params_from_jax
from istvt_tpu_torch.core import tree
from istvt_tpu_torch.core.config import ISTVTConfig
from istvt_tpu_torch.kernels import (_lib, attention, linear, mlp, ops,
                                     quant, selfcheck)
from istvt_tpu_torch.models import istvt
from istvt_tpu_torch.serve import Predictor
from istvt_tpu_torch.serve_daemon import ServeDaemon

CPU = torch.device("cpu")
TINY = dict(num_frames=2, image_size=72, feat_hw=5, depth=1, num_classes=1,
            use_pallas=True)
CLIP = (2, 72, 72, 3)
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)

# istvt:: ops a layer, by serving path (chip_smoke.SERVE_PER_LAYER and
# MODE_PER_LAYER, #20's two counters one op)
INGEST = {"ln_qkv_q8_temporal_attention": 1,
          "mm_q8_ln_qkv_q8_spatial_attention": 1,
          "matmul_q8_res_ln_ff_q8_full": 1}
FLOAT = {"ln_matmul": 2, "temporal_attention_packed": 1,
         "spatial_attention_packed": 1, "matmul_bias_residual": 2,
         "ln_ff_residual": 1}
_Q8_BLOCKS = {"ln_matmul_q8": 2, "temporal_attention_packed": 1,
              "spatial_attention_packed": 1, "matmul_q8_bias_residual": 2}
MODES = {
    ("full", "boundary"): {"ln_matmul_q8": 1, "temporal_attention_packed": 1,
                           "matmul_q8_ln_matmul_q8": 1,
                           "spatial_attention_packed": 1,
                           "matmul_q8_res_ln_ff_q8_full": 1},
    ("mixed", "ingest"): {**_Q8_BLOCKS, "ln_ff_residual_q8": 1},
    ("bf16", "ingest"): {**_Q8_BLOCKS, "ln_ff_residual": 1},
    ("full", "layer"): {"st_layer_q8": 1},
    ("int8", "ingest"): {**_Q8_BLOCKS, "ln_ff_residual_q8_full": 1},
}
# aten ops of the plain versions' attention and feed-forward math: none is
# in a serving graph (the stem, token assembly and head use none of them)
PLAIN_MATH = {"exp", "tanh", "amax", "einsum", "softmax", "_softmax"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clips(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n,) + CLIP).astype(np.float32)


def _counts(graph):
    return {n: k for n, k in ops.op_counts(graph).items() if k}


def _plain_math(graph):
    return {n.target._opname for n in graph.nodes
            if n.op == "call_function"
            and isinstance(n.target, torch._ops.OpOverload)
            and n.target._opname in PLAIN_MATH}


# ---------------------------------------------------------------------------
# the ops


class _Recorder:
    """Stands in for a kernel module's `_ops`: records each op call's
    arguments and makes it."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return getattr(torch.ops.istvt, name)(*args)
        return call


# op -> the selfcheck cases whose wrapper calls make it
_OP_CASES = {n: (n,) for n in ops.OPS}
_OP_CASES["matmul_q8_bias_residual"] += ("matmul_q8_bias_residual/no_r",)
_OP_CASES["matmul_bias_residual"] += ("matmul_bias_residual/no_r",)


@pytest.fixture(scope="module")
def small_cases():
    return selfcheck.slice_cases(CPU, selfcheck.SMALL)


@pytest.mark.parametrize("name", list(ops.OPS))
def test_op_passes_opcheck_and_equals_its_plain_version(name, small_cases,
                                                        monkeypatch):
    """opcheck (schema, fake function, dispatch) on the arguments the
    wrapper hands its op, with and without the residual where it is
    optional; the op's CPU output equals the plain version bit for bit; no
    launch is counted."""
    calls = []
    for module in (quant, attention, linear, mlp):
        monkeypatch.setattr(module, "_ops", _Recorder(calls))
    _lib.reset_launches()
    for case in _OP_CASES[name]:
        kern, plain, make = small_cases[case]
        args = make(torch.float32)
        calls.clear()
        got = kern(*args)
        assert [c[0] for c in calls] == [name], calls
        assert got.is_contiguous()
        assert torch.equal(got, plain(*args)), case
        op_args = calls[0][1]
        assert torch.equal(getattr(ops, name)(*op_args), got)
        torch.library.opcheck(getattr(ops, name), op_args)
    assert not any(_lib.LAUNCHES.values())
    assert _lib.KMAJOR_BUILDS == {"q8_kmajor": 0}


# ---------------------------------------------------------------------------
# the graphs


@pytest.fixture(scope="module")
def weights():
    """JAX trees of the port's seed-0 init (torch_import) and their bf16
    int8-quantized copy (JAX's quantize_params), as numpy."""
    w = istvt.init(ISTVTConfig(**TINY), torch.Generator().manual_seed(0))
    params, state = istvt_from_torch(
        {k: v.numpy() for k, v in w.state_dict().items()}, depth=1)
    qparams = jax.jit(lambda p: jistvt.quantize_params(
        jtree.cast(p, jnp.bfloat16)))(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(qparams), to_np(state)


def _port(params, state, **cfg):
    model = istvt.init(ISTVTConfig(**TINY, **cfg),
                       torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, state))
    return model


@pytest.fixture(scope="module")
def int8_live(weights):
    """The int8 `ingest` Predictor over JAX's quantized weights, as
    cli/serve.py --int8 serves them (bf16 parameters, bf16 inputs)."""
    _, qparams, state = weights
    model = tree.cast(_port(qparams, state, quantize="int8"), torch.bfloat16)
    return Predictor(model, CPU, batch_sizes=(2, 4),
                     input_dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def int8_artifact(int8_live, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("int8") / "artifact")
    manifest = SE.save_artifact(path, int8_live.model, input_shape=CLIP,
                                batch_sizes=(2, 4),
                                input_dtype=torch.bfloat16)
    return path, manifest


@pytest.fixture(scope="module")
def int8_scorer(int8_artifact):
    return SE.load_artifact(int8_artifact[0])


@pytest.fixture(scope="module")
def f32_live(weights):
    params, _, state = weights
    model = istvt.pack_params(_port(params, state))
    return Predictor(model, CPU, batch_sizes=(2,))


def test_int8_graph_holds_the_ingest_ops(int8_artifact, int8_scorer):
    _, manifest = int8_artifact
    assert manifest["custom_ops"] == {f"istvt::{n}": k
                                      for n, k in INGEST.items()}
    program = int8_scorer.program
    assert _counts(program.graph) == INGEST
    assert not _plain_math(program.graph)


@pytest.fixture(scope="module")
def f32_program(f32_live):
    """save_artifact's program of the f32 float model (not written)."""
    return SE.export_program(f32_live.model, input_shape=CLIP, max_batch=2)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_float_graph_holds_the_float_ops(bf16, f32_program):
    """The float fused path in f32 (the whole model) and in bf16
    (cli/serve.py --bf16: cast, then pack_params; its transformer on the
    stem's features)."""
    program = f32_program
    if bf16:
        args = build_parser().parse_args(
            ["--bf16", "-sl", "2", "-is", "72", "--depth", "1"])
        program = SE.export_program(
            build_predictor(args, CPU).model.vit,
            input_shape=(2, 5, 5, 728), max_batch=4,
            input_dtype=torch.bfloat16)
    assert _counts(program.graph) == FLOAT
    assert not _plain_math(program.graph)


@pytest.mark.parametrize("mode", list(MODES), ids="-".join)
def test_int8_mode_graph_holds_its_ops(mode, int8_live):
    """Each int8 A/B mode (ISTVTConfig.q8_ff, q8_attn) on a copy of the same
    weights; 'mixed' and 'bf16' read the feed-forward's (in, out) copies
    (pack_params). The transformer (DSTTr) is exported on the stem's
    features: the stem holds no op, in any mode."""
    q8_ff, q8_attn = mode
    model = copy.deepcopy(int8_live.model)
    model.cfg = ISTVTConfig(**TINY, quantize="int8", q8_ff=q8_ff,
                            q8_attn=q8_attn)
    if q8_ff in ("mixed", "bf16"):
        istvt.pack_params(model)
    program = SE.export_program(model.vit, input_shape=(2, 5, 5, 728),
                                max_batch=4, input_dtype=torch.bfloat16)
    assert _counts(program.graph) == MODES[mode]
    assert not _plain_math(program.graph)


# ---------------------------------------------------------------------------
# the artifact


def test_roundtrip_equals_the_live_predictor(int8_live, int8_scorer):
    """5 clips in buckets (2, 4) (4 + 1 padded to 2): the artifact's logits
    equal the live Predictor's bit for bit, with its bucketing and
    output contract; no launch counted, no K-major copy built."""
    scorer = int8_scorer
    scorer.n_forwards = 0
    assert isinstance(scorer, Predictor) and scorer.batch_sizes == [2, 4]
    clips = _clips(5)
    _lib.reset_launches()
    got, want = scorer.predict(clips), int8_live.predict(clips)
    assert got["logits"].shape == (5,) and scorer.n_forwards == 2
    for k in ("logits", "probs", "preds"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(scorer.predict(clips[:1])["logits"],
                                  int8_live.predict(clips[:1])["logits"])
    assert not any(_lib.LAUNCHES.values())
    assert _lib.KMAJOR_BUILDS == {"q8_kmajor": 0}


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def test_weights_come_back_bit_for_bit_and_once(int8_live, int8_artifact,
                                                 int8_scorer):
    """Every parameter and buffer of the model, the non-persistent K-major
    copies too, is in the program with its dtype and bits (bf16 parameters,
    int8 codes, f32 scales and BN statistics; the f8 of the int8 stem is a
    store between its convolutions, no tensor of the model); the directory
    is under 1.5x the model's bytes with two buckets."""
    path, _ = int8_artifact
    program = int8_scorer.program
    held = {**program.state_dict, **program.constants}
    model = int8_live.model
    mine = dict(model.named_parameters())
    mine.update(model.named_buffers())
    assert any(n.endswith("qkv_wk") for n in mine)
    dtypes = set()
    for name, t in mine.items():
        got = held[f"model.{name}"]
        assert got.dtype == t.dtype and got.shape == t.shape, name
        assert torch.equal(_bits(got), _bits(t)), name
        dtypes.add(t.dtype)
    assert {torch.bfloat16, torch.int8, torch.float32} <= dtypes
    nbytes = sum(t.numel() * t.element_size() for t in mine.values())
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    assert size < 1.5 * nbytes, (size, nbytes)


def test_manifest_keys_version_gate_and_device(int8_artifact, tmp_path):
    """The manifest on disk is the one returned (JAX's keys are held in
    test_artifacts_agree_with_jax); a newer format raises 'newer'; a device
    type other than the exported one raises."""
    path, manifest = int8_artifact
    assert manifest["platforms"] == ["cpu"]
    assert manifest["input_dtype"] == "bfloat16"
    assert manifest["model_config"]["quantize"] == "int8"
    assert manifest["model_name"] == "istvt"
    assert json.load(open(os.path.join(path, "manifest.json"))) == manifest
    newer = str(tmp_path / "newer")
    shutil.copytree(path, newer)
    on_disk = dict(manifest, format_version=SE.FORMAT_VERSION + 1)
    with open(os.path.join(newer, "manifest.json"), "w") as f:
        json.dump(on_disk, f)
    with pytest.raises(ValueError, match="newer"):
        SE.load_artifact(newer)
    with pytest.raises(ValueError, match="exported on 'cpu'"):
        SE.load_artifact(path, device="cuda")
    with pytest.raises(ValueError, match="exported on 'cpu'"):
        SE.load_artifact(path, device="meta")


def test_load_artifact_imports_no_model_code(int8_artifact):
    path, _ = int8_artifact
    code = ("import sys; sys.path.insert(0, %r); "
            "import torch; torch.set_num_threads(1); "
            "from istvt_tpu_torch.serve_export import load_artifact; "
            "p = load_artifact(%r); assert p.batch_sizes == [2, 4]; "
            "bad = [m for m in sys.modules if m.startswith("
            "'istvt_tpu_torch.models') or m == 'jax' or "
            "m.startswith('istvt_tpu.')]; "
            "assert not bad, bad; print('ok')") % (os.path.abspath(ROOT),
                                                   path)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cli_export_selftest_then_daemon(tmp_path, capsys):
    """cli/export.py --device cpu --selftest (JAX's flags and defaults,
    and --device), then ServeDaemon over the loaded artifact on port 0
    answers one request with the artifact's own logit (as JAX's
    test_serve_cli_artifact_flag)."""
    import http.client
    import io

    opts = lambda p: {o for a in p._actions for o in a.option_strings}  # noqa
    t_parser = tcli.build_parser()
    assert opts(t_parser) == opts(jcli.build_parser()) | {"--device"}
    defaults = vars(t_parser.parse_args(["--out", "x"]))
    assert defaults.pop("device") == "cuda"
    assert defaults == vars(jcli.build_parser().parse_args(["--out", "x"]))

    out = str(tmp_path / "cli")
    tcli.main(["--device", "cpu", "--int8", "-sl", "2", "-is", "72",
               "--depth", "1", "--batch_sizes", "2", "--out", out,
               "--selftest"])
    lines = capsys.readouterr().out.splitlines()
    head = json.loads(lines[0])
    assert head["platforms"] == ["cpu"] and head["batch_sizes"] == [2]
    assert head["custom_ops"] == {f"istvt::{n}": k for n, k in INGEST.items()}
    assert lines[-1].startswith("selftest: reloaded in ")
    assert float(lines[-1].split("= ")[1].split()[0]) <= 1e-3

    scorer = SE.load_artifact(out)
    clip = _clips(1, seed=7)
    want = scorer.predict(clip)["logits"]
    daemon = ServeDaemon(scorer, tuple(scorer.manifest["input_shape"]),
                         host="127.0.0.1", port=0, max_batch=2,
                         max_wait_ms=1.0).start()
    try:
        buf = io.BytesIO()
        np.save(buf, clip[0], allow_pickle=False)
        conn = http.client.HTTPConnection("127.0.0.1", daemon.port,
                                          timeout=120)
        conn.request("POST", "/v1/predict", body=buf.getvalue(),
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
    finally:
        daemon.close()
    assert resp.status == 200
    np.testing.assert_array_equal(np.asarray(body["logits"], np.float32),
                                  want)


# ---------------------------------------------------------------------------
# against JAX's artifacts


def _jax_artifact(path, params, state, quantize, input_dtype):
    cfg = JaxConfig(**TINY, quantize=quantize)
    model = jax_model("istvt", num_out_classes=1, cfg=cfg)
    with jprecision.highest():
        manifest = JSE.save_artifact(path, model, params, state,
                                     input_shape=CLIP, batch_sizes=(2,),
                                     input_dtype=input_dtype)
        logits = JSE.load_artifact(path).predict(_clips(2, 3))["logits"]
    return manifest, logits


def test_artifacts_agree_with_jax(weights, f32_program, int8_artifact,
                                  int8_scorer, tmp_path):
    """Over the same weights: the port's f32 float program (save_artifact's,
    not written) and JAX's f32 artifact (its Pallas kernels in interpret
    mode) within 1e-3; the int8 artifacts within atol = rtol = 1e-2. The
    port's manifest has JAX's keys, but for the two that name the
    framework."""
    params, qparams, state = weights
    clips = _clips(2, 3)
    with torch.inference_mode():
        got = f32_program.module()(torch.from_numpy(clips)).numpy()
    j_manifest, j_f32 = _jax_artifact(str(tmp_path / "jf32"), params, state,
                                      "none", None)
    np.testing.assert_allclose(got, j_f32, atol=1e-3, rtol=1e-3)
    _, j_int8 = _jax_artifact(str(tmp_path / "jint8"), qparams, state,
                              "int8", jnp.bfloat16)
    np.testing.assert_allclose(int8_scorer.predict(clips)["logits"], j_int8,
                               atol=1e-2, rtol=1e-2)
    assert set(int8_artifact[1]) == (
        set(j_manifest) - {"jax_version", "waived_custom_calls"}
        | {"torch_version", "custom_ops"})
