"""Recipe certification in the port (istvt_tpu_torch/train/certify.py,
cli/certify.py) against the JAX package on the CPU, at toy sizes: a
72^2 / depth-2 teacher, 56^2 students, seq_len 3, patch 24.

The numpy helpers equal JAX's bit for bit, spearman within 1e-12. The
chain runs the port's certify_recipe from one teacher (the port's init,
carried into JAX trees by torch_import and back by compat/from_jax) with
distill_epochs=0, and holds its teacher figures (teacher_auc, the
teacher's LRP spatial ratios, each temporal check's teacher_share) to
JAX's, computed by JAX's own certify helpers (_eval_logits, _lrp_eval,
_spatial_ratios) on the same val split and probes, within 1e-4; the
whole JAX chain takes about two minutes on one core of a CPU, past this
file's share of the suite. The result's keys and criteria names are held
to CERT_RECIPE.json, the JAX CLI's production result (less its export
keys and the CLI's 'backend'); a reduced run with export_dir adds the
export keys and artifact_matches, the reloaded artifact's val logits
within 1e-3 of the certified int8 ones. Then the guards of the JAX
advisor's findings that the port does not carry over: a ragged cam_chunk,
a teacher checkpoint restored under other settings, --train_amp with one
value, and --export without the int8 leg.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from istvt_tpu.cli import certify as jcli
from istvt_tpu.compat.torch_import import istvt_from_torch
from istvt_tpu.core import config as jconfig
from istvt_tpu.core import precision as jprecision
from istvt_tpu.data.video_dataset import SyntheticVideoDataset as JaxSynth
from istvt_tpu.models.registry import model_selection as jax_model
from istvt_tpu.train import certify as jcert
from istvt_tpu.train.metrics import auc as jauc
from istvt_tpu_torch.cli import certify as tcli
from istvt_tpu_torch.compat.from_jax import params_from_jax
from istvt_tpu_torch.core import config as tconfig
from istvt_tpu_torch.core import precision as tprecision
from istvt_tpu_torch.data import SyntheticVideoDataset
from istvt_tpu_torch.models import istvt as tistvt
from istvt_tpu_torch.train import certify as tcert

T, SIZE, PS = 3, 72, 24
TEACHER = dict(num_frames=T, image_size=SIZE, feat_hw=5, depth=2)
CERT = os.path.join(os.path.dirname(__file__), os.pardir, "CERT_RECIPE.json")


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
def teacher():
    """(JAX model, params, state, the port's ISTVT) from one set of
    weights."""
    w = tistvt.init(tconfig.ISTVTConfig(**TEACHER),
                    torch.Generator().manual_seed(1))
    params, state = istvt_from_torch(
        {k: v.numpy() for k, v in w.state_dict().items()}, depth=2)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params, state = to_np(params), to_np(state)
    model = jax_model("istvt", num_out_classes=1,
                      cfg=jconfig.ISTVTConfig(**TEACHER))
    port = tistvt.init(tconfig.ISTVTConfig(**TEACHER),
                       torch.Generator().manual_seed(0))
    port.load_state_dict(params_from_jax(params, state))
    return model, params, state, port


def test_certify_helpers_match_jax():
    """_batches, _patch_cells, _spatial_ratios, _subset_frame_fakes and
    _temporal_aug_batches bit for bit; spearman within 1e-12."""
    kw = dict(num_clips=6, seq_len=T, size=SIZE, seed=0, static_patch=True,
              patch_size=PS, amp_range=(0.3, 1.5))
    j_items, j_b = jcert._batches(JaxSynth(**kw), 4)
    t_items, t_b = tcert._batches(SyntheticVideoDataset(**kw), 4)
    assert len(t_b) == len(j_b) == 1 and len(t_items) == len(j_items) == 6
    for k in ("clips", "labels"):
        np.testing.assert_array_equal(t_b[0][k].numpy(), np.asarray(j_b[0][k]))
    for args in [(0, 0, 24, 72, 5), (47, 13, 24, 72, 5), (71, 71, 24, 72, 5),
                 (10.5, 33.3, 17.9, 56, 4), (290, 5, 100, 300, 19)]:
        assert tcert._patch_cells(*args) == jcert._patch_cells(*args), args
    fakes = [it for it in t_items if it["labels"] == 1]
    cam_s = np.random.RandomState(0).rand(len(fakes), T, 16).astype(
        np.float32)
    assert (tcert._spatial_ratios(cam_s, fakes, 56 / 72, 56, 4, PS)
            == jcert._spatial_ratios(cam_s, fakes, 56 / 72, 56, 4, PS))
    np.testing.assert_array_equal(
        tcert._subset_frame_fakes(3, T, SIZE, PS, (1, 2), 4242),
        jcert._subset_frame_fakes(3, T, SIZE, PS, (1, 2), 4242))
    for t_aug, j_aug in zip(tcert._temporal_aug_batches(2, 4, T, SIZE, PS, 0),
                            jcert._temporal_aug_batches(2, 4, T, SIZE, PS,
                                                        0)):
        assert set(t_aug) == set(j_aug)
        for k in t_aug:
            np.testing.assert_array_equal(t_aug[k].numpy(),
                                          np.asarray(j_aug[k]))
    rng = np.random.RandomState(1)
    for a, b in [(rng.randn(16), rng.randn(16)),
                 (np.round(rng.randn(16)), np.round(rng.randn(16))),
                 (np.ones(4), rng.randn(4))]:
        assert abs(tcert.spearman(a, b) - jcert.spearman(a, b)) <= 1e-12


def _cert_keys():
    """JAX's result keys and criteria names (CERT_RECIPE.json, less the
    export's and the CLI's), the temporal criteria by their frames."""
    with open(CERT) as f:
        rec = json.load(f)
    keys = set(rec) - {"export_dir", "artifact_max_logit_delta", "backend"}
    crit = set(rec["criteria"]) - {"artifact_matches"}
    return (keys, {c for c in crit if not c.startswith("lrp_temporal_")},
            set(rec["lrp_temporal"][0]))


def test_certify_chain_matches_jax_teacher(teacher):
    model, params, state, port = teacher
    kw = dict(teacher_size=SIZE, teacher_depth=2, student_size=56,
              student_depth=2, seq_len=T, train_clips=4, val_clips=8,
              batch_size=4, patch_size=PS, distill_epochs=0, lrp_fakes=2,
              attn_weight=2.0, seed=0)
    legs, lines = {}, []
    with tprecision.highest():
        res = tcert.certify_recipe(**kw, teacher_bundle=port,
                                   device=torch.device("cpu"), legs=legs,
                                   log=lines.append)
    keys, crit, entry = _cert_keys()
    assert set(res) == keys
    assert {c for c in res["criteria"]
            if not c.startswith("lrp_temporal_")} == crit
    assert [c for c in res["criteria"] if c.startswith("lrp_temporal_")] \
        == ["lrp_temporal_1_2", "lrp_temporal_2"]
    assert all(set(e) == entry for e in res["lrp_temporal"])
    assert res["pass"] == all(res["criteria"].values())
    assert set(legs) == {"data", "teacher", "hook", "student", "int8", "lrp"}
    assert all(v["peak_gib"] is None and v["wall_s"] > 0
               for v in legs.values())
    assert lines[-1].startswith("[certify] PASS=")
    assert not port.training

    # JAX's teacher figures from JAX's own helpers on the same data
    val = JaxSynth(num_clips=8, seq_len=T, size=SIZE, seed=999,
                   static_patch=True, patch_size=PS, amp_range=(0.5, 1.5))
    items = [val[i] for i in range(8)]
    vb = {"clips": jnp.asarray(np.stack([it["clips"] for it in items])),
          "labels": jnp.asarray(np.stack([it["labels"] for it in items]))}
    cfg = jconfig.ISTVTConfig(**TEACHER)
    with jprecision.highest():
        t_logits = jcert._eval_logits(model, params, state, vb)
        assert abs(res["teacher_auc"] - float(jauc(jnp.asarray(t_logits),
                                                   vb["labels"]))) <= 1e-4
        fakes = sorted([it for it in items if it["labels"] == 1],
                       key=lambda it: -float(it.get("amp", 1.0)))[:2]
        _, cam_s, _ = jcert._lrp_eval(
            params, state, jnp.asarray(np.stack([f["clips"] for f in fakes])),
            cfg)
        ratios = jcert._spatial_ratios(cam_s, fakes, 1.0, SIZE, 5, PS)
        assert abs(res["teacher_lrp_spatial_ratio_min"] - min(ratios)) <= 1e-4
        assert abs(res["teacher_lrp_spatial_ratio_mean"]
                   - float(np.mean(ratios))) <= 1e-4
        for e in res["lrp_temporal"]:
            sub = jcert._subset_frame_fakes(2, T, SIZE, PS, e["frames"],
                                            seed=4242)
            _, _, cam_t = jcert._lrp_eval(params, state, jnp.asarray(sub),
                                          cfg)
            tm = cam_t.sum(axis=-1)
            tm = tm / (tm.sum(axis=-1, keepdims=True) + 1e-9)
            share = float(tm[:, e["frames"]].sum(axis=-1).mean())
            assert abs(e["teacher_share"] - share) <= 1e-4, (e, share)


def test_certify_export_dir_ships_the_certified_student(teacher, tmp_path):
    """export_dir: the int8 student just scored is exported, reloaded
    (serve_export.load_artifact) and its val logits held to the certified
    int8 logits (artifact_matches, <= 1e-3); the result gains JAX's export
    keys; the artifact holds the int8 chain's ops, one each a layer."""
    port = teacher[3]
    out = str(tmp_path / "art")
    res = tcert.certify_recipe(
        teacher_size=SIZE, teacher_depth=2, student_size=56,
        student_depth=1, seq_len=T, train_clips=4, val_clips=8,
        batch_size=4, patch_size=PS, distill_epochs=0, attn_weight=0.0,
        seed=0, run_lrp=False, teacher_bundle=port, export_dir=out,
        device=torch.device("cpu"), log=lambda *_: None)
    with open(CERT) as f:
        rec = json.load(f)
    assert {"export_dir", "artifact_max_logit_delta"} <= set(res) <= set(rec)
    assert res["export_dir"] == out
    assert res["criteria"]["artifact_matches"] is True
    assert 0.0 <= res["artifact_max_logit_delta"] <= 1e-3
    with open(os.path.join(out, "manifest.json")) as f:
        man = json.load(f)
    assert man["batch_sizes"] == [1, 4, 8] and man["platforms"] == ["cpu"]
    assert man["extra"]["certified"] is True
    assert man["custom_ops"] == {
        "istvt::ln_qkv_q8_temporal_attention": 1,
        "istvt::mm_q8_ln_qkv_q8_spatial_attention": 1,
        "istvt::matmul_q8_res_ln_ff_q8_full": 1}


def test_ragged_cam_chunk_is_one_more_slice(teacher):
    """A cam_chunk that does not divide the batch: 3 clips in slices of 2
    equal the whole batch's logits and cams (JAX's _lrp_eval ran the whole
    batch instead, and its teacher hook asserted)."""
    port = teacher[3]
    clips = torch.from_numpy(np.random.RandomState(2).randn(
        3, T, SIZE, SIZE, 3).astype(np.float32))
    whole = tcert._lrp_eval(port, clips)
    ragged = tcert._lrp_eval(port, clips, chunk=2)
    for got, want in zip(ragged, whole):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_cli_teacher_checkpoint_round_trip(tmp_path, capsys):
    """cli/certify.py --cpu saves its teacher with a meta record, a second
    run restores it (the same teacher_auc), and a run under another seed
    refuses it."""
    ckpt, out = str(tmp_path / "teacher.pt"), str(tmp_path / "cert.json")
    argv = ["--cpu", "--teacher_size", "72", "--teacher_depth", "1",
            "--student_size", "56", "--student_depth", "1", "-sl", str(T),
            "--train_clips", "4", "--val_clips", "4", "-bs", "4",
            "--teacher_epochs", "1", "--distill_epochs", "0",
            "--attn_weight", "0", "--no_int8", "--no_lrp",
            "--teacher_ckpt", ckpt, "--out", out]
    assert tcli.main(argv) in (0, 1)
    with open(out) as f:
        first = json.load(f)
    assert first["backend"] == "cpu"
    assert set(first["legs"]) == {"data", "teacher", "hook", "student"}
    assert os.path.exists(ckpt)
    tcli.main(argv)
    assert "teacher restored from" in capsys.readouterr().out
    with open(out) as f:
        assert json.load(f)["teacher_auc"] == first["teacher_auc"]
    with pytest.raises(ValueError, match="teacher_ckpt"):
        tcli.main(argv + ["--seed", "1"])


def test_cli_flags_and_refusals(capsys):
    """JAX's flags and defaults; --train_amp wants exactly 'lo,hi' with lo
    <= hi or 'none'; --export / export_dir without the int8 leg raise
    before anything runs (JAX exported nothing then, silently)."""
    j_parser, t_parser = jcli.build_parser(), tcli.build_parser()
    opts = lambda p: {o for a in p._actions for o in a.option_strings}  # noqa
    assert opts(t_parser) == opts(j_parser)
    j_def, t_def = vars(j_parser.parse_args([])), vars(t_parser.parse_args([]))
    assert t_def.pop("train_amp") == (0.3, 1.5) and j_def.pop("train_amp")
    assert t_def == j_def
    assert t_parser.parse_args(["--train_amp", "none"]).train_amp is None
    for bad in ("0.8", "1.5,0.3", "0.1,0.2,0.3", "a,b"):
        with pytest.raises(SystemExit):
            t_parser.parse_args(["--train_amp", bad])
    assert "--train_amp" in capsys.readouterr().err
    with pytest.raises(ValueError, match="int8 leg"):
        tcli.main(["--cpu", "--export", "art", "--no_int8"])
    with pytest.raises(ValueError, match="int8 leg"):
        tcert.certify_recipe(export_dir="art", run_int8=False,
                             device=torch.device("cpu"))
