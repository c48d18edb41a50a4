"""Port serving (istvt_tpu_torch/serve.py, serve_daemon.py, cli/serve.py)
on the CPU at toy geometry, mirroring tests/test_serve.py and
tests/test_serve_daemon.py."""
import ast
import copy
import dataclasses
import http.client
import inspect
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import istvt_tpu.serve_daemon as jax_daemon
import istvt_tpu_torch.serve_daemon as port_daemon
from istvt_tpu_torch.cli.serve import build_parser, build_predictor
from istvt_tpu_torch.core import tree
from istvt_tpu_torch.core.config import ISTVTConfig
from istvt_tpu_torch.models import istvt
from istvt_tpu_torch.models.registry import model_selection
from istvt_tpu_torch.serve import Predictor

CPU = torch.device("cpu")
TINY = ISTVTConfig(num_frames=2, image_size=72, feat_hw=5, depth=1,
                   use_pallas=True, quantize="int8")
CLIP = (2, 72, 72, 3)


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
def predictor():
    model = model_selection("istvt", cfg=TINY, device=CPU)
    tree.cast(model, torch.bfloat16)
    istvt.quantize_params(model)
    return Predictor(model, CPU, batch_sizes=(1, 4), input_dtype=torch.bfloat16)


def test_cast_leaves_q8_and_bn_state_alone(predictor):
    m = predictor.model
    assert m.vit.pos_embedding.dtype == torch.bfloat16
    assert m.xcep.model.bn1.weight.dtype == torch.bfloat16
    assert m.xcep.model.bn1.running_var.dtype == torch.float32
    fn = m.vit.transformer.layers[0][0].fn
    assert fn.qkv_wq.dtype == torch.int8 and fn.qkv_ws.dtype == torch.float32


def test_predictor_buckets_pad_and_slice(predictor):
    clips = np.random.RandomState(0).randn(6, *CLIP).astype(np.float32)
    predictor.n_forwards = 0
    out = predictor.predict(clips)                   # buckets 4 + 2->4
    assert predictor.n_forwards == 2
    assert out["logits"].shape == out["probs"].shape == (6,)
    assert out["logits"].dtype == np.float32
    # pad rows never leak into real rows: same clips, other grouping
    np.testing.assert_allclose(predictor.predict(clips[:3])["logits"],
                               out["logits"][:3], atol=1e-6)
    np.testing.assert_allclose(predictor.predict(clips[5:])["logits"],
                               out["logits"][5:], atol=1e-6)
    np.testing.assert_array_equal(out["preds"],
                                  (out["logits"] > 0).astype(np.int32))
    np.testing.assert_allclose(out["probs"],
                               1 / (1 + np.exp(-out["logits"])), atol=1e-6)


def _post(port, arr):
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/predict", body=buf.getvalue())
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_daemon_answers_float32_and_uint8(predictor):
    rng = np.random.RandomState(1)
    x32 = rng.randn(*CLIP).astype(np.float32)
    x8 = rng.randint(0, 256, (2,) + CLIP).astype(np.uint8)
    daemon = port_daemon.ServeDaemon(predictor, CLIP, port=0, max_batch=4,
                                     max_wait_ms=1.0).start()
    try:
        st, body = _post(daemon.port, x32)
        assert st == 200 and len(body["logits"]) == 1
        np.testing.assert_allclose(body["logits"],
                                   predictor.predict(x32[None])["logits"],
                                   atol=1e-6)
        st, body = _post(daemon.port, x8)
        assert st == 200 and len(body["preds"]) == 2
        want = predictor.predict(port_daemon.normalize_uint8(x8))["logits"]
        np.testing.assert_allclose(body["logits"], want, atol=1e-6)
        st, _ = _post(daemon.port, np.zeros((3, 3), np.float32))
        assert st == 400
    finally:
        daemon.close()


def _body(module):
    tree_ = ast.parse(inspect.getsource(module))
    tree_.body = [n for n in tree_.body
                  if not (isinstance(n, ast.Expr)
                          and isinstance(n.value, ast.Constant))]
    return ast.dump(tree_)


def test_daemon_copy_matches_jax_package():
    """The port carries a framework-free copy of the JAX package's serving
    daemon (so it never imports istvt_tpu); only the docstring differs."""
    assert _body(port_daemon) == _body(jax_daemon)


def test_cli_build_predictor_int8_only():
    args = build_parser().parse_args(
        ["--int8", "-sl", "2", "-is", "72", "--depth", "1", "--max_batch",
         "4"])
    pred = build_predictor(args, device=CPU)
    assert pred.batch_sizes == [1, 2, 4]
    assert pred.input_dtype == torch.bfloat16 and pred.compute_dtype is None
    assert pred.model.cfg.quantize == "int8" and pred.model.cfg.feat_hw == 5
    out = pred.predict(np.zeros((1,) + CLIP, np.float32))
    assert np.isfinite(out["logits"]).all()
    with pytest.raises(ValueError, match="load_artifact"):
        build_predictor(SimpleNamespace(int8=True, artifact="x",
                                        checkpoint_dir=None), device=CPU)


@pytest.mark.parametrize("bf16", [True, False])
def test_cli_build_predictor_float(bf16):
    """Without --int8 the CLI serves the float fused model: bf16 parameters
    and inputs with --bf16 (istvt_tpu/cli/serve.py:83-84), f32 otherwise."""
    argv = ["-sl", "2", "-is", "72", "--depth", "1", "--max_batch", "2"]
    pred = build_predictor(build_parser().parse_args(
        argv + (["--bf16"] if bf16 else [])), device=CPU)
    want = torch.bfloat16 if bf16 else torch.float32
    m = pred.model
    assert m.cfg.quantize == "none" and m.cfg.use_pallas
    assert pred.compute_dtype == (want if bf16 else None)
    assert pred.input_dtype is None
    assert m.vit.transformer.layers[0][2].fn.net[0].weight.dtype == want
    assert m.vit.transformer.layers[0][2].fn.w1.dtype == want   # packed
    assert m.xcep.model.bn1.running_var.dtype == torch.float32
    assert not m.vit.transformer.layers[0][0].fn.has_q8()
    out = pred.predict(np.random.RandomState(2).randn(3, *CLIP)
                       .astype(np.float32))
    assert out["logits"].shape == (3,) and np.isfinite(out["logits"]).all()


def test_predictor_compute_dtype_casts_params_and_inputs():
    """compute_dtype casts the model's float parameters once and every input
    (istvt_tpu/serve.py:29-33,70-73): the same logits as a model cast by
    hand and fed inputs in that dtype."""
    cfg = ISTVTConfig(num_frames=2, image_size=72, feat_hw=5, depth=1,
                      use_pallas=True)
    model = model_selection("istvt", cfg=cfg, device=CPU)
    by_hand = istvt.pack_params(tree.cast(copy.deepcopy(model),
                                          torch.bfloat16))
    pred = Predictor(model, CPU, batch_sizes=(2,),
                     compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    istvt.pack_params(model)              # after the cast, as the CLI does
    clips = np.random.RandomState(5).randn(2, *CLIP).astype(np.float32)
    with torch.inference_mode():
        want = by_hand(torch.from_numpy(clips).to(torch.bfloat16))
    np.testing.assert_array_equal(pred.predict(clips)["logits"],
                                  want.reshape(-1).float().numpy())


@pytest.mark.parametrize("path", ["int8", "float"])
def test_predictor_runs_a_train_mode_model_in_eval_mode(path):
    """A model handed over in train mode (make_train_step and Trainer.fit
    without a val_loader leave it so) serves the eval-mode logits, as the
    JAX Predictor applies train=False (istvt_tpu/serve.py:76): a clip's
    logit is the same alone and in a batch of three and equals the eval
    model's, and no buffer (the BatchNorm statistics among them) moves."""
    cfg = dataclasses.replace(TINY, quantize="int8" if path == "int8"
                              else "none")
    model = model_selection("istvt", cfg=cfg, device=CPU)
    if path == "int8":
        istvt.quantize_params(model)
    else:
        istvt.pack_params(model)
    clips = np.random.RandomState(6).randn(3, *CLIP).astype(np.float32)
    with torch.inference_mode():
        want = copy.deepcopy(model).eval()(torch.from_numpy(clips))
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    pred = Predictor(model.train(), CPU, batch_sizes=(1, 3))
    alone = pred.predict(clips[:1])["logits"]
    batch = pred.predict(clips)["logits"]
    np.testing.assert_allclose(alone, batch[:1], atol=1e-6)
    np.testing.assert_allclose(batch, want.reshape(-1).numpy(), atol=1e-6)
    assert not any(m.training for m in model.modules())
    for n, b in model.named_buffers():
        assert torch.equal(b, buffers[n]), n
