"""The port's data pipeline (istvt_tpu_torch/data: manifest, transforms,
the frame-tree datasets, the prefetching loader, device_normalize and
device_feed) and its eval metrics (train/metrics: confusion counts with a
mask, ACER, per-type and top-k accuracy) against the JAX package's on the
same frame trees and seeds: items and batches bit for bit."""
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from istvt_tpu.data import loader as jloader
from istvt_tpu.data import manifest as jmanifest
from istvt_tpu.data import transforms as jtransforms
from istvt_tpu.data import video_dataset as jvd
from istvt_tpu.train import metrics as jmetrics
from istvt_tpu_torch import native
from istvt_tpu_torch.data import loader as tloader
from istvt_tpu_torch.data import manifest as tmanifest
from istvt_tpu_torch.data import transforms as ttransforms
from istvt_tpu_torch.data import video_dataset as tvd
from istvt_tpu_torch.train import metrics as tmetrics

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

METHODS = ("original", "Deepfakes", "FaceSwap")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this file: the suite runs its files
    in parallel workers, where torch's default of a thread per core
    oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(d, n, size, rng, fmt="png"):
    os.makedirs(d, exist_ok=True)
    for f in range(n):
        img = rng.randint(0, 255, (size, size, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(d, f"{f:04d}.{fmt}"))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """An FF++ tree (hq / lq x 3 methods x 2 videos x 8 frames of 40^2, one
    video of 3 frames), a Celeb-DF tree and an OULU tree."""
    root = tmp_path_factory.mktemp("trees")
    rng = np.random.RandomState(0)
    ff = str(root / "ff")
    for q in ("hq", "lq"):
        for m in METHODS:
            for v in range(2):
                _frames(os.path.join(ff, q, m, f"{v:03d}"), 8, 40, rng)
    _frames(os.path.join(ff, "hq", "original", "short"), 3, 40, rng)
    os.makedirs(os.path.join(ff, "hq", "notes"), exist_ok=True)
    celeb, oulu = str(root / "celeb"), str(root / "oulu")
    for d, classes in ((celeb, ("Celeb-real", "Celeb-synthesis", "other")),
                       (oulu, ("live", "spoof"))):
        for c in classes:
            for v in range(2):
                _frames(os.path.join(d, c, f"id{v}"), 7, 36, rng)
    return {"ff": ff, "celeb": celeb, "oulu": oulu}


def _entries(es):
    return [(e.video_id, e.frames, e.label, e.fake_type, e.quality)
            for e in es]


def test_manifest_scans_match_jax(trees):
    ff = trees["ff"]
    for kw in ({}, {"quality": "hq"}, {"quality": "lq"},
               {"quality": "hq", "methods": ["original", "FaceSwap"]},
               {"quality": "hq", "min_frames": 4}):
        got = tmanifest.scan_ffpp(ff, **kw)
        assert got and _entries(got) == _entries(
            jmanifest.scan_ffpp(ff, **kw)), kw
    flat = os.path.join(ff, "hq")              # no quality level
    assert _entries(tmanifest.scan_ffpp(flat)) == _entries(
        jmanifest.scan_ffpp(flat))
    assert tmanifest.scan_ffpp(os.path.join(ff, "missing")) == []
    for d in (trees["celeb"], trees["oulu"]):
        got = tmanifest.scan_binary_tree(d, min_frames=6)
        assert len(got) == 4 and _entries(got) == _entries(
            jmanifest.scan_binary_tree(d, min_frames=6))
    assert tmanifest.FFPP_METHODS == jmanifest.FFPP_METHODS
    es = tmanifest.scan_ffpp(ff)
    for frac, seed in ((0.25, 0), (0.5, 3)):
        for a, b in zip(tmanifest.split_train_val(es, frac, seed),
                        jmanifest.split_train_val(
                            jmanifest.scan_ffpp(ff), frac, seed)):
            assert _entries(a) == _entries(b)


@pytest.mark.parametrize("name", sorted(ttransforms.PRESETS))
def test_transform_presets_match_jax(name):
    """Each preset's transforms: the same fields, and the same output and
    permutation for the same frame and seed."""
    frame = np.random.RandomState(1).randint(0, 255, (48, 40, 3), np.uint8)
    tp, jp = ttransforms.select_transform(name), \
        jtransforms.select_transform(name)
    assert tp.keys() == jp.keys()
    for split in tp:
        t, j = tp[split], jp[split]
        assert vars(t) == vars(j), (name, split)
        pt = t.sample_params(np.random.default_rng((3, 1)))
        pj = j.sample_params(np.random.default_rng((3, 1)))
        assert pt.keys() == pj.keys()
        got, want = t(frame, pt), j(frame, pj)
        if isinstance(want, tuple):
            np.testing.assert_array_equal(got[1], want[1])
            got, want = got[0], want[0]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError):
        ttransforms.select_transform("nope")


def test_transform_helpers_match_jax(monkeypatch):
    img = np.random.RandomState(2).randint(0, 255, (30, 36, 3), np.uint8)
    for size in (30, 17, 64):
        np.testing.assert_array_equal(ttransforms.resize(img, size),
                                      jtransforms.resize(img, size))
    np.testing.assert_array_equal(ttransforms.normalize(img, (0.4, 0.5, 0.6),
                                                        (0.2, 0.3, 0.4)),
                                  jtransforms.normalize(img, (0.4, 0.5, 0.6),
                                                        (0.2, 0.3, 0.4)))
    for q in (10, 75, 95):
        np.testing.assert_array_equal(ttransforms.jpeg_compress(img, q),
                                      jtransforms.jpeg_compress(img, q))
    np.testing.assert_array_equal(ttransforms.hflip(img),
                                  jtransforms.hflip(img))
    for grid in (2, 3):
        a = ttransforms.shuffle_patches(img, grid, np.random.default_rng(4))
        b = jtransforms.shuffle_patches(img, grid, np.random.default_rng(4))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # every option at once, then raw uint8 ingest
    kw = dict(size=24, augment=True, shuffle_grid=2, compress_range=(30, 90))
    t, j = ttransforms.Transform(**kw), jtransforms.Transform(**kw)
    pt = t.sample_params(np.random.default_rng(9))
    pj = j.sample_params(np.random.default_rng(9))
    assert {k: v for k, v in pt.items() if k != "perm_rng"} == \
        {k: v for k, v in pj.items() if k != "perm_rng"}
    for x, y in zip(t(img, pt), j(img, pj)):
        np.testing.assert_array_equal(x, y)
    u8 = ttransforms.Transform(24, raw_uint8=True)(img)
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(
        u8, jtransforms.Transform(24, raw_uint8=True)(img))
    # without PIL: the nearest-neighbour resize, and no JPEG re-encoding
    monkeypatch.setattr(ttransforms, "_HAS_PIL", False)
    monkeypatch.setattr(jtransforms, "_HAS_PIL", False)
    np.testing.assert_array_equal(ttransforms.resize(img, 50),
                                  jtransforms.resize(img, 50))
    np.testing.assert_array_equal(ttransforms.jpeg_compress(img, 20), img)


def _first(loader):
    """The loader's first batch, its iterator closed (its producer told to
    stop) before returning."""
    it = iter(loader)
    try:
        return next(it)
    finally:
        it.close()


def _same_item(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "paths":
            assert a[k] == b[k]
            continue
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


_TF = {"plain": dict(size=32), "aug": dict(size=32, augment=True),
       "shuffle": dict(size=32, shuffle_grid=3),
       "jpeg": dict(size=32, compress_range=(40, 80)),
       "u8": dict(size=32, raw_uint8=True)}


@pytest.mark.parametrize("kind, mode, tf, extra", [
    ("ff", "Train", "aug", {"return_fake_type": True}),
    ("ff", "Train", "shuffle", {"dataset_len": 17, "seed": 3}),
    ("ff", "Test", "plain", {"return_fake_type": True, "quality": "lq"}),
    ("ff", "Vis", "jpeg", {"subset": "FaceSwap"}),
    ("ff", "Test", "u8", {"short": True}),
    ("celeb", "Train", "aug", {"seed": 5}),
    ("celeb", "Test", "plain", {"dataset_len": 6}),
    ("oulu", "Train", "plain", {}),
    ("oulu", "Test", "jpeg", {"seq_len": 7}),
])
def test_dataset_items_match_jax(trees, kind, mode, tf, extra):
    """Every item of the port's dataset equals the JAX class's bit for bit
    (the draws of (seed, index) in JAX's order; dataset_len wraps; 'short'
    gives a video of fewer frames than seq_len, whose last is repeated)."""
    extra = dict(extra)
    short = extra.pop("short", False)
    kw = dict(mode=mode, size=32, seq_len=extra.pop("seq_len", 4), **extra)
    root = trees[kind]
    ents = {}
    if short:
        ents = {pkg: {"entries": pkg.scan_ffpp(root, "hq")}
                for pkg in (tmanifest, jmanifest)}
        assert min(len(e.frames) for e in ents[tmanifest]["entries"]) < 4
    cls = {"ff": "VideoSeqDataset", "celeb": "Celeb", "oulu": "OULU"}[kind]
    if kind == "ff":
        kw.setdefault("quality", "hq")
    ours = getattr(tvd, cls)(root=root,
                                transform=ttransforms.Transform(**_TF[tf]),
                                **kw, **ents.get(tmanifest, {}))
    theirs = getattr(jvd, cls)(root=root,
                                  transform=jtransforms.Transform(**_TF[tf]),
                                  **kw, **ents.get(jmanifest, {}))
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        _same_item(ours[i], theirs[i])


def test_dataset_options_without_a_caller_raise(trees):
    for kw in ({"get_triplet": "BCE"}, {"require_idx": True},
               {"random_compress": True, "compress_param": [30, 90]},
               {"compress_param": [30]}, {"diverse_quality": True}):
        with pytest.raises(NotImplementedError, match="'Training'"):
            tvd.VideoSeqDataset(root=trees["ff"], **kw)
    for kw in ({"pair_return": True, "compress_param": [30]},
               {"random_test_qual": True}):
        with pytest.raises(NotImplementedError, match="'Training'"):
            tvd.Celeb(root=trees["celeb"], **kw)
    with pytest.raises(NotImplementedError, match="'Training'"):
        tvd.MixedVideoDataset(root=trees["ff"])


def test_frame_decoder_counts_clips(trees):
    ds = tvd.VideoSeqDataset(root=trees["ff"], size=32, seq_len=4,
                             transform=ttransforms.Transform(32))
    native.reset_clips()
    for i in range(3):
        ds[i]
    assert native.CLIPS == {"clipdecode": 0, "per_frame": 3}


def _ff(pkg_vd, pkg_tf, root, **kw):
    return pkg_vd.VideoSeqDataset(root=root, quality="hq", size=32,
                                  seq_len=4, mode="Train",
                                  transform=pkg_tf.Transform(32,
                                                             augment=True),
                                  return_fake_type=True, **kw)


@pytest.mark.parametrize("num_workers", [1, 4])
def test_loader_batches_match_jax(trees, num_workers):
    """Batches in the epoch's order, equal to the JAX ClipLoader's, over
    two epochs; iter_from(k) is the tail; Vis paths stay lists."""
    kw = dict(batch_size=3, shuffle=True, seed=7, num_workers=num_workers)
    ours = tloader.ClipLoader(_ff(tvd, ttransforms, trees["ff"],
                                  dataset_len=11), **kw)
    theirs = jloader.ClipLoader(_ff(jvd, jtransforms, trees["ff"],
                                    dataset_len=11), **kw)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours) == 4
        for a, b in zip(got, want):
            _same_item(a, b)
        for k in (1, 3, 4):
            tail = list(ours.iter_from(k))
            assert len(tail) == 4 - k
            for a, b in zip(tail, got[k:]):
                _same_item(a, b)
    vis = dict(root=trees["ff"], size=32, seq_len=4, mode="Vis")
    a = _first(tloader.ClipLoader(
        tvd.VideoSeqDataset(transform=ttransforms.Transform(32), **vis),
        batch_size=2, shuffle=False, num_workers=num_workers))
    b = _first(jloader.ClipLoader(
        jvd.VideoSeqDataset(transform=jtransforms.Transform(32), **vis),
        batch_size=2, shuffle=False, num_workers=num_workers))
    _same_item(a, b)
    assert isinstance(a["paths"], list) and len(a["paths"]) == 2


def test_iter_from_decodes_no_skipped_batch(trees):
    """A resumed epoch makes only its remaining batches' items."""
    ds = _ff(tvd, ttransforms, trees["ff"], dataset_len=10)
    made = []
    get = ds.__getitem__
    ds.__getitem__ = lambda i: made.append(i) or get(i)
    loader = tloader.ClipLoader(ds, batch_size=4, seed=1, num_workers=2)
    order = loader.index_batches()
    list(loader.iter_from(2))
    assert sorted(made) == sorted(order[2].tolist())


class _Slow:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"bad clip {i}")
        time.sleep(0.01)
        return {"clips": np.full((2,), i, np.float32),
                "labels": np.int32(i % 2)}


def _producers():
    return [t for t in threading.enumerate()
            if t.name == "ClipLoader-producer"]


def test_loader_stops_its_producer_and_raises_its_errors():
    assert not _producers()
    loader = tloader.ClipLoader(_Slow(40), batch_size=2, shuffle=False,
                                num_workers=2, prefetch=1)
    for i, batch in enumerate(loader):
        if i == 2:
            break                      # the consumer leaves early
    deadline = time.time() + 5
    while _producers() and time.time() < deadline:
        time.sleep(0.02)
    assert not _producers()
    with pytest.raises(ValueError, match="bad clip 5"):
        list(tloader.ClipLoader(_Slow(8, fail_at=5), batch_size=2,
                                shuffle=False, num_workers=2))
    with pytest.raises(NotImplementedError, match="Parallelism"):
        tloader.ClipLoader(_Slow(8), batch_size=2, host_count=2)
    items = [{"clips": np.zeros(2), "labels": 1, "paths": ["a"]},
             {"clips": np.ones(2), "labels": 0, "paths": ["b"]}]
    out, ref = tloader.collate(items), jloader.collate(items)
    assert out.keys() == ref.keys() and out["paths"] == [["a"], ["b"]]
    np.testing.assert_array_equal(out["labels"], ref["labels"])


def test_device_normalize_matches_jax(trees):
    """raw_uint8 clips normalized by device_normalize equal the host f32
    normalize and JAX's device_normalize within 1e-6; in bf16 the cast
    comes first, as in JAX, and the two are equal bit for bit."""
    kw = dict(root=trees["ff"], quality="hq", size=32, mode="Test",
              seq_len=2)
    f32 = tvd.VideoSeqDataset(transform=ttransforms.Transform(32), **kw)[0]
    u8 = tvd.VideoSeqDataset(transform=ttransforms.Transform(
        32, raw_uint8=True), **kw)[0]["clips"]
    assert u8.dtype == np.uint8
    got = tloader.device_normalize(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), f32["clips"], atol=1e-6)
    want = np.asarray(jloader.device_normalize(jnp.asarray(u8)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    half = tloader.device_normalize(torch.from_numpy(u8), 0.4, 0.3,
                                    dtype=torch.bfloat16)
    jhalf = np.asarray(jloader.device_normalize(
        jnp.asarray(u8), 0.4, 0.3, dtype=jnp.bfloat16)).astype(np.float32)
    assert half.dtype == torch.bfloat16
    np.testing.assert_array_equal(half.float().numpy(), jhalf)


def test_device_feed_on_the_cpu(trees):
    loader = tloader.ClipLoader(
        tvd.VideoSeqDataset(root=trees["ff"], size=32, seq_len=2, mode="Vis",
                            transform=ttransforms.Transform(32)),
        batch_size=3, shuffle=False, num_workers=2)
    host = list(loader)
    fed = list(tloader.device_feed(loader, "cpu"))
    assert len(fed) == len(host) == 3
    for a, b in zip(fed, host):
        assert a["clips"].device.type == "cpu"
        assert isinstance(a["clips"], torch.Tensor)
        np.testing.assert_array_equal(a["clips"].numpy(), b["clips"])
        np.testing.assert_array_equal(a["labels"].numpy(), b["labels"])
        assert a["paths"] == b["paths"]


def test_device_feed_stops_its_threads_and_raises_their_errors():
    """Leaving device_feed early stops its staging thread and the loader's
    producer; an error made on either side reaches the consumer."""
    names = ("ClipLoader-producer", "device_feed-stage")
    alive = lambda: [t for t in threading.enumerate()   # noqa: E731
                     if t.name in names]
    assert not alive()
    loader = tloader.ClipLoader(_Slow(40), batch_size=2, shuffle=False,
                                num_workers=2, prefetch=1)
    feed = tloader.device_feed(loader, "cpu")
    for i, batch in enumerate(feed):
        np.testing.assert_array_equal(batch["clips"][:, 0].numpy(),
                                      [2 * i, 2 * i + 1])
        if i == 2:
            break
    feed.close()
    deadline = time.time() + 5
    while alive() and time.time() < deadline:
        time.sleep(0.02)
    assert not alive()
    with pytest.raises(ValueError, match="bad clip 5"):
        list(tloader.device_feed(tloader.ClipLoader(
            _Slow(8, fail_at=5), batch_size=2, shuffle=False,
            num_workers=2), "cpu"))


def test_eval_metrics_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(40).astype(np.float32)
    labels = rng.randint(0, 2, 40).astype(np.int32)
    ftypes = rng.randint(0, 6, 40).astype(np.int32)   # 5: outside the table
    mask = (rng.rand(40) > 0.3).astype(np.float32)
    t = lambda a: torch.from_numpy(a)   # noqa: E731
    j = jnp.asarray
    for m in (None, mask):
        got = tmetrics.confusion_counts(t(logits), t(labels),
                                        None if m is None else t(m))
        want = jmetrics.confusion_counts(j(logits), j(labels),
                                         None if m is None else j(m))
        assert {k: float(v) for k, v in got.items()} == \
            {k: float(v) for k, v in want.items()}
        a, b = tmetrics.acer(got), jmetrics.acer(want)
        for k in ("apcer", "bpcer", "acer"):
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-7)
    zero = {k: torch.zeros(()) for k in ("tp", "fp", "tn", "fn")}
    assert float(tmetrics.acer(zero)["acer"]) == 0.0
    acc, cnt = tmetrics.per_type_accuracy(t(logits), t(labels), t(ftypes))
    jacc, jcnt = jmetrics.per_type_accuracy(j(logits), j(labels), j(ftypes))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-7)
    multi = rng.randn(12, 7).astype(np.float32)
    cls = rng.randint(0, 7, 12).astype(np.int32)
    got = tmetrics.topk_accuracy(t(multi), t(cls), ks=(1, 3, 5))
    want = jmetrics.topk_accuracy(j(multi), j(cls), ks=(1, 3, 5))
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}
