"""The port's raw-video front end (istvt_tpu_torch/data/video_frontend.py)
and cli/preprocess.py against the JAX package's on the same videos, through
cv2: probe, decode_clip (with crops, unsorted indices), face_box,
clip_face_crops, BoxManifest, RawVideoDataset items bit for bit,
extract_frames / preprocess.py file for file, and the train CLI's
--dataset ff++video. The native video decoder's case skips where FFmpeg's
headers are missing, as tests/test_video_frontend.py skips."""
import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from istvt_tpu import native as jnative  # noqa: E402
from istvt_tpu.cli import preprocess as jpre  # noqa: E402
from istvt_tpu.data import video_frontend as jvf  # noqa: E402
from istvt_tpu_torch import native  # noqa: E402
from istvt_tpu_torch.cli import preprocess as tpre  # noqa: E402
from istvt_tpu_torch.cli import train as ttrain  # noqa: E402
from istvt_tpu_torch.data import video_frontend as tvf  # noqa: E402

W, H, NF = 96, 72, 16
SKIN_BGR = (140, 160, 220)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_face_video(path, seed, n=NF):
    """A dark scene with a skin-coloured ellipse drifting slowly."""
    rng = np.random.RandomState(seed)
    wtr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (W, H))
    assert wtr.isOpened()
    for t in range(n):
        img = (rng.rand(H, W, 3) * 40).astype(np.uint8)
        cv2.ellipse(img, (48 + t // 3, 36 + t // 6), (13, 18), 0, 0, 360,
                    SKIN_BGR, -1)
        wtr.write(img)
    wtr.release()


@pytest.fixture(scope="module")
def video_tree(tmp_path_factory):
    """root/hq/{original,Deepfakes}/vid<s>.mp4, 2 videos each."""
    root = tmp_path_factory.mktemp("rawvids")
    for method, seeds in (("original", (0, 1)), ("Deepfakes", (2, 3))):
        d = root / "hq" / method
        d.mkdir(parents=True)
        for s in seeds:
            _write_face_video(str(d / f"vid{s}.mp4"), s)
    return str(root)


def _vid(root, s=0, method="original"):
    return os.path.join(root, "hq", method, f"vid{s}.mp4")


def test_probe_and_decode_match_jax(video_tree):
    path = _vid(video_tree)
    assert tvf.probe(path) == jvf.probe(path)
    assert tvf.probe(path)[:3] == (NF, W, H)
    crops = np.asarray([[0, 0, 40, 40], [20, 30, 40, 40], [-4, 90, 30, 30],
                        [10, 10, 1, 50]], np.int32)
    for kw in ({}, {"crops": crops}, {"mean": 0.0, "std": 1 / 255.0}):
        got = tvf.decode_clip(path, [11, 0, 5, NF - 1], 40, use_native=False,
                              **kw)
        want = jvf.decode_clip(path, [11, 0, 5, NF - 1], 40,
                               use_native=False, **kw)
        assert got.shape == (4, 40, 40, 3)
        np.testing.assert_array_equal(got, want)
    assert tvf.scan_ffpp_videos(video_tree, "hq") == \
        jvf.scan_ffpp_videos(video_tree, "hq")
    assert tvf.scan_ffpp_videos(video_tree, "hq", ["Deepfakes"]) == \
        jvf.scan_ffpp_videos(video_tree, "hq", ["Deepfakes"])


def test_face_box_matches_jax(video_tree):
    frame = tvf.decode_clip(_vid(video_tree), [0], 72, use_native=False)[0]
    for f in (frame, np.uint8((frame * 0.5 + 0.5) * 255),
              np.zeros((50, 80, 3), np.uint8)):
        for mode, margin in (("skin", 1.3), ("skin", 1.6), ("center", 1.3)):
            assert tvf.face_box(f, margin, mode) == \
                jvf.face_box(f, margin, mode)
    y0, x0, bh, bw = tvf.face_box(frame)
    assert bh == bw < 72             # it found the ellipse


@pytest.mark.parametrize("mode", ["skin", "center", "none"])
def test_clip_face_crops_match_jax(video_tree, mode):
    for s in (0, 3):
        path = _vid(video_tree, s, "original" if s < 2 else "Deepfakes")
        got = tvf.clip_face_crops(path, [4, 5, 6, 7], mode=mode,
                                  use_native=False)
        np.testing.assert_array_equal(got, jvf.clip_face_crops(
            path, [4, 5, 6, 7], mode=mode, use_native=False))
        assert (got == got[0]).all()


def test_box_manifest_matches_jax(video_tree, tmp_path):
    path = _vid(video_tree)
    man = {"vid0": {"0": [10, 20, 40, 40], "8": [12, 24, 40, 40]}}
    (tmp_path / "boxes.json").write_text(json.dumps(man))
    for src in (str(tmp_path / "boxes.json"), man, {"vid0.mp4": man["vid0"]},
                {path: man["vid0"]}):
        ours, theirs = tvf.BoxManifest(src), jvf.BoxManifest(src)
        np.testing.assert_array_equal(
            ours.boxes_for(path, [0, 3, 8, 9, 2]),
            theirs.boxes_for(path, [0, 3, 8, 9, 2]))
        assert ours.boxes_for(_vid(video_tree, 1), [0]) is None
    with pytest.raises(ValueError, match="y0, x0, h, w"):
        tvf.BoxManifest({"vid0": {"0": [1, 2, 3]}})
    got = tvf.clip_face_crops(path, [0, 3, 8, 9],
                              boxes=tvf.BoxManifest(man), use_native=False)
    np.testing.assert_array_equal(got, [[10, 20, 40, 40]] * 2
                                  + [[12, 24, 40, 40]] * 2)


@pytest.mark.parametrize("mode, kw", [
    ("Train", {"seed": 3, "dataset_len": 6, "return_fake_type": True}),
    ("Test", {"frame_stride": 2, "crop_mode": "center"}),
    ("Test", {"boxes": {"vid1": {"0": [8, 10, 48, 48]}}, "seq_len": 3}),
])
def test_raw_video_dataset_matches_jax(video_tree, mode, kw):
    kw = {"seq_len": 4, **kw}
    ours = tvf.RawVideoDataset(video_tree, quality="hq", size=48, mode=mode,
                               use_native=False, **kw)
    theirs = jvf.RawVideoDataset(video_tree, quality="hq", size=48,
                                 mode=mode, use_native=False, **kw)
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(FileNotFoundError):
        tvf.RawVideoDataset(os.path.join(video_tree, "nothing"))


def _tree_files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_preprocess_cli_matches_jax(video_tree, tmp_path, capsys):
    """preprocess.py writes the JAX CLI's frame tree file for file, byte for
    byte (cv2 decode, PIL JPEGs); a broken video among good ones exits 0,
    a tree of broken ones exits 1."""
    boxes = tmp_path / "boxes.json"
    boxes.write_text(json.dumps({"vid2": {"0": [8, 16, 40, 40]}}))
    argv = ["--root", video_tree, "--quality", "hq", "--every-n", "3",
            "--size", "40", "--workers", "2", "--no-native",
            "--redetect-every", "2", "--boxes", str(boxes)]
    assert tpre.main(argv + ["--out", str(tmp_path / "port")]) == 0
    assert jpre.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    ours, theirs = (_tree_files(tmp_path / n) for n in ("port", "jax"))
    assert len(ours) == 4 * 6 and ours.keys() == theirs.keys()
    assert all(ours[k] == theirs[k] for k in ours)
    bad = tmp_path / "bad" / "hq" / "original"
    bad.mkdir(parents=True)
    (bad / "broken.mp4").write_bytes(b"not a video")
    out = str(tmp_path / "out_bad")
    assert tpre.main(["--root", str(tmp_path / "bad"), "--out", out,
                      "--quality", "hq", "--no-native"]) == 1
    os.link(_vid(video_tree), bad / "vid0.mp4")
    assert tpre.main(["--root", str(tmp_path / "bad"), "--out", out,
                      "--quality", "hq", "--no-native",
                      "--limit-frames", "2"]) == 0
    assert "1 failed" in capsys.readouterr().out
    assert tpre.main(["--root", str(tmp_path / "none"), "--out", out]) == 1


def test_train_cli_from_raw_videos(video_tree, tmp_path, capsys):
    """--dataset ff++video (cv2, external boxes for one video): two steps
    and an eval with per-type accuracies."""
    boxes = tmp_path / "boxes.json"
    boxes.write_text(json.dumps({"vid0": {"0": [4, 8, 48, 48]}}))
    ttrain.main(["--device", "cpu", "--dataset", "ff++video", "--data_root",
                 video_tree, "--input_size", "72", "--seq_len", "2",
                 "--depth", "1", "-bs", "4", "--dataset_len", "8",
                 "--epochs", "1", "--num_workers", "2", "--boxes",
                 str(boxes), "-o", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "epoch 0: train loss" in out
    val = [ln for ln in out.splitlines() if ln.startswith("epoch 0: val")]
    assert val and "'acc_type_1'" in val[0], out


def test_native_video_decode_matches_jax(video_tree):
    if not native.video_available():
        pytest.skip("native videodecode unavailable (FFmpeg headers)")
    if not jnative.video_available():
        pytest.skip("the JAX package's videodecode did not build")
    path = _vid(video_tree)
    assert tvf.probe(path) == jvf.probe(path)
    crops = np.asarray([[0, 0, 40, 40], [20, 30, 40, 40]], np.int32)
    np.testing.assert_array_equal(
        tvf.decode_clip(path, [9, 2], 40, crops=crops, use_native=True),
        jvf.decode_clip(path, [9, 2], 40, crops=crops, use_native=True))
