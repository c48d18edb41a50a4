"""The port's CLIs on face-crop frame trees, on the CPU, against the JAX
package: the train CLI's datasets (make_datasets) and a run of each of
ff++ / celeb / oulu with --test_mode (hq and lq lines, ACER for oulu);
evaluate(compute_acer=True) with the per-type accuracies; cli/score.py in
f32 and with --int8 against JAX's Predictor over JAX's VideoSeqDataset;
cli/visualize.py --dataset ff++. The model weights are JAX's
PRNGKey(0) init carried into the port (compat.from_jax), through a port
checkpoint where a CLI restores them (-o)."""
import argparse
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from istvt_tpu.cli import train as jtrain
from istvt_tpu.core import precision as jprecision
from istvt_tpu.core import tree as jtree
from istvt_tpu.core.config import ISTVTConfig as JaxConfig
from istvt_tpu.data import ClipLoader as JaxLoader
from istvt_tpu.data import Transform as JaxTransform
from istvt_tpu.data import VideoSeqDataset as JaxVideoSeq
from istvt_tpu.models import istvt as jistvt
from istvt_tpu.models.registry import model_selection as jax_model
from istvt_tpu.serve import Predictor as JaxPredictor
from istvt_tpu.train import trainer as jtrainer
from istvt_tpu_torch.cli import score as tscore
from istvt_tpu_torch.cli import serve as cli_serve
from istvt_tpu_torch.cli import train as ttrain
from istvt_tpu_torch.cli import visualize as tvis
from istvt_tpu_torch.compat.from_jax import params_from_jax
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.core.checkpoint import CheckpointManager
from istvt_tpu_torch.core.config import ISTVTConfig
from istvt_tpu_torch.data import ClipLoader, Transform, VideoSeqDataset
from istvt_tpu_torch.data.transforms import PRESETS
from istvt_tpu_torch.models import istvt as tistvt
from istvt_tpu_torch.train import trainer as ttrainer

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

TINY = dict(num_frames=2, image_size=72, feat_hw=5, depth=1)
GEOM = ["--input_size", "72", "--seq_len", "2", "--depth", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(d, n, size, rng):
    os.makedirs(d, exist_ok=True)
    for f in range(n):
        img = rng.randint(0, 255, (size, size, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(d, f"{f:04d}.png"))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """FF++ (hq / lq x original, Deepfakes, FaceSwap x 2 videos x 6
    frames of 40^2), Celeb-DF and OULU trees (2 x 2 videos of 5 frames)."""
    root = tmp_path_factory.mktemp("cli_trees")
    rng = np.random.RandomState(1)
    ff = str(root / "ff")
    for q in ("hq", "lq"):
        for m in ("original", "Deepfakes", "FaceSwap"):
            for v in range(2):
                _frames(os.path.join(ff, q, m, f"{v:03d}"), 6, 40, rng)
    out = {"ff": ff}
    for name, classes in (("celeb", ("Celeb-real", "Celeb-synthesis")),
                          ("oulu", ("live", "spoof"))):
        for c in classes:
            for v in range(2):
                _frames(os.path.join(str(root / name), c, f"v{v}"), 5, 40,
                        rng)
        out[name] = str(root / name)
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's PRNGKey(0) init of the TINY model (numpy trees), and a port
    checkpoint directory holding them."""
    cfg = JaxConfig(**TINY, use_pallas=True)
    params, state = jax_model("istvt", num_out_classes=1, cfg=cfg).init(
        jax.random.PRNGKey(0))
    params, state = jax.tree_util.tree_map(np.asarray, (params, state))
    ck = str(tmp_path_factory.mktemp("ck"))
    CheckpointManager(ck).save(3, {"model": params_from_jax(params, state)})
    return params, state, ck


def _first(loader):
    """The loader's first batch, its iterator closed (its producer told to
    stop) before returning."""
    it = iter(loader)
    try:
        return next(it)
    finally:
        it.close()


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("argv", [
    ["-d", "ff++", "-tf", "aug"], ["-d", "ff++", "-q", "lq", "-tf", "300"],
    ["-d", "celeb", "-tf", "shuffle"], ["-d", "dfdc"], ["-d", "oulu"]])
def test_make_datasets_matches_jax(trees, argv):
    """The first train and val batch of each dataset at the CLI's default
    geometry equal the JAX make_datasets' bit for bit."""
    root = trees[{"ff++": "ff", "celeb": "celeb", "dfdc": "celeb",
                  "oulu": "oulu"}[argv[1]]]
    flags = argv + ["--data_root", root, "-sl", "2", "--dataset_len", "5"]
    ours = ttrain.make_datasets(ttrain.build_parser().parse_args(flags))
    theirs = jtrain.make_datasets(jtrain.build_parser().parse_args(flags))
    for a, b, shuffle in zip(ours, theirs, (True, False)):
        assert len(a) == len(b)
        kw = dict(batch_size=3, shuffle=shuffle, seed=0, num_workers=2)
        _same(_first(ClipLoader(a, **kw)), _first(JaxLoader(b, **kw)))


def test_make_datasets_resizes_to_input_size(trees):
    """Where the preset's frames would give another feature grid than
    --input_size, the port's transforms resize to --input_size: the items
    of JAX's dataset with that Transform."""
    args = ttrain.build_parser().parse_args(
        ["--data_root", trees["ff"], *GEOM, "-tf", "aug"])
    train, val = ttrain.make_datasets(args)
    assert train.transform.size == val.transform.size == 72
    assert train.transform.augment and not val.transform.augment
    want = JaxVideoSeq(root=trees["ff"], quality="hq", size=72, seq_len=2,
                       mode="Train", transform=JaxTransform(72, augment=True))
    _same(train[4], want[4])
    assert PRESETS["aug"]["train"].size == 299     # the preset is untouched


@pytest.mark.parametrize("dataset", ["ff++", "celeb", "oulu"])
def test_train_cli_on_frame_trees(trees, tmp_path, capsys, dataset):
    """Two steps and an eval from the tree, then --test_mode: hq and lq for
    ff++, ACER for oulu."""
    root = trees[{"ff++": "ff", "celeb": "celeb", "oulu": "oulu"}[dataset]]
    cli = ["--device", "cpu", "--dataset", dataset, "--data_root", root,
           *GEOM, "-bs", "4", "--dataset_len", "8", "--epochs", "1",
           "--num_workers", "2", "-o", str(tmp_path / "ck")]
    ttrain.main(cli)
    out = capsys.readouterr().out
    assert "epoch 0: train loss" in out and "epoch 0: val {" in out, out
    ttrain.main(cli + ["--test_mode"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(("hq {", "lq {"))]
    assert [ln[:2] for ln in lines] == (["hq", "lq"] if dataset == "ff++"
                                        else ["hq"]), lines
    for ln in lines:
        assert ("'acer'" in ln) == (dataset == "oulu"), ln
    if dataset == "ff++":
        assert "'acc_type_0'" in lines[0] and "'acc_type_3'" in lines[0]


def _logit_spy(module, monkeypatch):
    """Record the logits of every eval step that `module`'s evaluate makes
    (module.S.make_eval_step wrapped)."""
    seen, make = [], module.S.make_eval_step

    def spy(*args, **kwargs):
        fn = make(*args, **kwargs)

        def step(*a):
            out = fn(*a)
            seen.append(np.asarray(out["logits"]).ravel())
            return out
        return step

    monkeypatch.setattr(module.S, "make_eval_step", spy)
    return seen


def test_evaluate_matches_jax(trees, weights, monkeypatch):
    """evaluate(compute_acer=True) on JAX's weights (the XLA-math eval path
    in both): every eval logit within 1e-5 of JAX's, and the same
    accuracy, counts, ACER and per-type accuracies."""
    params, state, _ = weights
    cfg = JaxConfig(**TINY)
    jmodel = jax_model("istvt", num_out_classes=1, cfg=cfg)
    model = tistvt.init(ISTVTConfig(**TINY), torch.Generator())
    model.load_state_dict(params_from_jax(params, state))
    ds = dict(root=trees["ff"], quality="hq", size=72, seq_len=2,
              mode="Test", return_fake_type=True)
    ours = ClipLoader(VideoSeqDataset(transform=Transform(72), **ds),
                      batch_size=4, shuffle=False, num_workers=2)
    theirs = JaxLoader(JaxVideoSeq(transform=JaxTransform(72), **ds),
                       batch_size=4, shuffle=False, num_workers=2)
    jlog, tlog = (_logit_spy(m, monkeypatch) for m in (jtrainer, ttrainer))
    with jprecision.highest():
        want = jtrainer.evaluate(jmodel, params, state, theirs,
                                 compute_acer=True)
    with tprecision.highest():
        got = ttrainer.evaluate(model, ours, compute_acer=True)
    assert len(tlog) == len(jlog) == 2
    np.testing.assert_allclose(np.concatenate(tlog), np.concatenate(jlog),
                               atol=1e-5)
    assert got.keys() == want.keys()
    assert {"acc_type_0", "acc_type_1", "acc_type_3", "acer"} <= got.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("path", ["f32", "int8"])
def test_score_cli_matches_jax_predictor(trees, weights, tmp_path, path,
                                         capsys):
    """score.py's scoring on JAX's weights restored from a port checkpoint
    (-o), through cli/serve.build_predictor's model at depth 1 (the CLI
    itself builds depth 12) and the CLI's own dataset and loader: one JSON
    line per clip, the logits of JAX's Predictor over JAX's dataset within
    1e-4 in f32 and within the int8 gate (5e-2) with --int8; the summary
    from the same logits."""
    params, state, ck = weights
    int8 = path == "int8"
    cfg = JaxConfig(**TINY, use_pallas=True,
                    quantize="int8" if int8 else "none")
    jmodel = jax_model("istvt", num_out_classes=1, cfg=cfg)
    kw = {}
    if int8:
        params = jistvt.quantize_params(jtree.cast(params, jnp.bfloat16))
        kw = {"input_dtype": jnp.bfloat16}
    pred = JaxPredictor(jmodel, params, state, batch_sizes=(4,), **kw)
    ds = JaxVideoSeq(root=trees["ff"], quality="hq", transform=JaxTransform(
        72), size=72, mode="Test", seq_len=2, return_fake_type=True,
        dataset_len=5)
    with jprecision.highest():
        want = np.concatenate([pred.predict(b["clips"])["logits"] for b in
                               JaxLoader(ds, batch_size=4, shuffle=False)])
    out = str(tmp_path / "scores.jsonl")
    args = tscore.build_parser().parse_args(
        ["--device", "cpu", "--data_root", trees["ff"], "--input_size", "72",
         "--seq_len", "2", "-bs", "4", "--max_clips", "5", "--acer", "-o", ck,
         "--out", out] + (["--int8"] if int8 else []))
    predictor = cli_serve.build_predictor(argparse.Namespace(
        model_name="istvt", seq_len=2, input_size=72, depth=1,
        checkpoint_dir=ck, artifact=None, bf16=False, int8=int8, buckets=[4],
        max_batch=4), "cpu")
    assert "restored step 3" in capsys.readouterr().out
    loader = ClipLoader(tscore.make_dataset(args), batch_size=4,
                        shuffle=False)
    with tprecision.highest():
        summary = tscore.score(predictor, loader, out, acer=True)
    rows = [json.loads(ln) for ln in open(out)]
    assert [r["index"] for r in rows] == list(range(5))
    got = np.array([r["logit"] for r in rows])
    np.testing.assert_allclose(got, want, atol=5e-2 if int8 else 1e-4)
    labels = np.array([r["label"] for r in rows])
    np.testing.assert_array_equal(labels, [ds[i]["labels"] for i in
                                           range(5)])
    assert [r["pred"] for r in rows] == [int(v > 0) for v in got]
    assert summary["n"] == 5 and {"acer", "apcer", "bpcer"} <= summary.keys()
    assert summary["accuracy"] == pytest.approx(np.mean((got > 0) ==
                                                        (labels == 1)))


def test_visualize_cli_explains_frame_tree_clips(trees, tmp_path):
    """--dataset ff++: the PNGs of each Vis clip are named after its frame
    files, and each plain frame is the clip's own frame (JAX's Vis item)."""
    out = str(tmp_path / "vis")
    written = tvis.main(["--device", "cpu", "--dataset", "ff++",
                         "--data_root", trees["ff"], *GEOM, "--max_clips",
                         "1", "--out_dir", out])
    item = JaxVideoSeq(root=trees["ff"], quality="hq", size=72, seq_len=2,
                       mode="Vis", transform=JaxTransform(72))[0]
    names = [os.path.basename(p) for p in item["paths"]]
    assert sorted(map(os.path.basename, written)) == sorted(
        f"{n}{s}.png" for n in names for s in ("", "_s", "_t"))
    for t, n in enumerate(names):
        frame = np.asarray(Image.open(os.path.join(out, f"{n}.png")))
        want = np.uint8(255 * np.clip(item["clips"][t] * 0.5 + 0.5, 0, 1))
        np.testing.assert_array_equal(frame, want)
