"""The port's native frame decoder (istvt_tpu_torch/native: its own copy of
clipdecode.cpp, built with g++ into native/build/) against the JAX
package's build of the same source: frames bit for bit, and the datasets'
native clips (use_native=True) bit for bit. Skipped where g++ / libjpeg /
libpng are missing, as tests/test_native.py skips."""
import os
import subprocess

import numpy as np
import pytest
import torch

from istvt_tpu import native as jnative
from istvt_tpu.data import transforms as jtransforms
from istvt_tpu.data import video_dataset as jvd
from istvt_tpu_torch import native
from istvt_tpu_torch.data import transforms as ttransforms
from istvt_tpu_torch.data import video_dataset as tvd

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def libs():
    if not native.available():
        pytest.skip("native toolchain unavailable (g++, libjpeg, libpng)")
    if not jnative.available():
        pytest.skip("the JAX package's clipdecode did not build")
    return True


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """PNG and JPEG frames of 40^2 and 32^2, and a clip tree of both."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(0)
    out = {}
    for fmt, ext in (("PNG", "png"), ("JPEG", "jpg")):
        for size in (32, 40):
            arr = rng.randint(0, 255, (size, size, 3), dtype=np.uint8)
            p = str(root / f"f{size}.{ext}")
            Image.fromarray(arr).save(p, format=fmt)
            out[(ext, size)] = (p, arr)
    tree = root / "tree"
    for m in ("original", "Deepfakes"):
        for v in range(2):
            d = tree / "hq" / m / f"{v:03d}"
            d.mkdir(parents=True)
            for f in range(6):
                img = rng.randint(0, 255, (40, 40, 3), dtype=np.uint8)
                Image.fromarray(img).save(str(d / f"{f:04d}.jpg"), quality=90)
    out["tree"] = str(tree)
    return out


def test_build_lands_in_the_build_directory(libs):
    so = os.path.join(native.BUILD_DIR, "libclipdecode.so")
    assert os.path.exists(so)
    assert not os.path.exists(os.path.join(os.path.dirname(native.__file__),
                                           "libclipdecode.so"))
    r = subprocess.run(["git", "check-ignore", "-q", so], cwd=REPO)
    assert r.returncode == 0, "native/build/ is not gitignored"


def test_png_exact_without_resize(frames, libs):
    p, arr = frames[("png", 32)]
    got = native.decode_frames([p], 32)
    want = (arr.astype(np.float32) / 255.0 - 0.5) / 0.5
    np.testing.assert_allclose(got[0], want, atol=1e-6)
    np.testing.assert_array_equal(got, jnative.decode_frames([p], 32))


@pytest.mark.parametrize("ext", ["png", "jpg"])
@pytest.mark.parametrize("out_size, threads", [(40, 1), (24, 3), (56, 2)])
def test_decode_matches_jax_native(frames, libs, ext, out_size, threads):
    """Decode, resize and normalize: the port's library and JAX's give the
    same floats, over the pthread pool too."""
    paths = [frames[(ext, 32)][0], frames[(ext, 40)][0]] * 2
    kw = dict(mean=0.4, std=0.3, n_threads=threads)
    got = native.decode_frames(paths, out_size, **kw)
    want = jnative.decode_frames(paths, out_size, **kw)
    assert got.shape == (4, out_size, out_size, 3)
    np.testing.assert_array_equal(got, want)


def test_missing_file_zeroed(frames, libs, tmp_path):
    p = frames[("png", 40)][0]
    with pytest.warns(UserWarning, match="1/2 frames failed"):
        got = native.decode_frames([p, str(tmp_path / "none.png")], 16)
    assert (got[1] == 0).all() and np.abs(got[0]).sum() > 0
    with pytest.warns(UserWarning):
        np.testing.assert_array_equal(got, jnative.decode_frames(
            [p, str(tmp_path / "none.png")], 16))


@pytest.mark.parametrize("mode", ["Train", "Test"])
def test_dataset_native_clips_match_jax(frames, libs, mode):
    """use_native=True: the port's clips equal JAX's native clips bit for
    bit and are counted under 'clipdecode'; an augmenting transform falls
    back to the frame loader (PIL), as in JAX."""
    kw = dict(root=frames["tree"], quality="hq", size=32, seq_len=4,
              mode=mode, use_native=True, return_fake_type=True)
    ours = tvd.VideoSeqDataset(transform=ttransforms.Transform(32), **kw)
    theirs = jvd.VideoSeqDataset(transform=jtransforms.Transform(32), **kw)
    native.reset_clips()
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert native.CLIPS == {"clipdecode": len(ours), "per_frame": 0}
    aug = tvd.VideoSeqDataset(transform=ttransforms.Transform(
        32, augment=True), **kw)
    jaug = jvd.VideoSeqDataset(transform=jtransforms.Transform(
        32, augment=True), **kw)
    np.testing.assert_array_equal(aug[1]["clips"], jaug[1]["clips"])
    assert native.CLIPS["per_frame"] == 1
