"""Port parity for the MNIST data path (qgemm_tpu_torch/data/mnist.py and
data/native.py over the port's copy of csrc/idx_loader.cpp) against
qgemm_tpu/data/{mnist,native}.py: the idx files each package writes the
other reads, a bad magic raises on every route, ``MNIST.load`` on the
checked-in 256-sample fixture and ``MNIST.synthetic`` give JAX's arrays
exactly, and the shuffled batch order equals JAX's on the numpy route and
on the native route (the JAX package's library built from
csrc/idx_loader.cpp into the test's temporary directory). Each route is
fixed on both sides: none depends on whether another test built a
library."""

import os
import struct
import subprocess

import numpy as np
import pytest

import qgemm_tpu.data.mnist as j_mnist
import qgemm_tpu.data.native as j_native
from qgemm_tpu_torch.data import mnist, native
from qgemm_tpu_torch.utils import host_build

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mnist_mini")


@pytest.fixture
def numpy_route(monkeypatch):
    """Both packages' parsers and shuffles on their numpy route."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(j_native, "available", lambda: False)


@pytest.fixture
def native_route(tmp_path, monkeypatch):
    """Both packages on their native route: the port's library built by
    ``native.build()``, the JAX package's from csrc/idx_loader.cpp with the
    Makefile's flags into this test's directory."""
    native.build()
    lib = tmp_path / "libqgemm_data.so"
    src = host_build.CSRC.parents[1] / "csrc" / "idx_loader.cpp"
    subprocess.run([host_build.gxx_path(), *host_build.GXX_FLAGS, str(src),
                    *host_build.GXX_LDFLAGS, "-o", str(lib)], check=True)
    monkeypatch.setattr(j_native, "_LIB_PATH", str(lib))
    monkeypatch.setattr(j_native, "_lib", None)
    assert native.available() and j_native.available()


def _images(seed, n=5):
    return np.random.default_rng(seed).uniform(0, 1, (n, 784)).astype(np.float32)


@pytest.mark.parametrize("use_native", [False, True])
def test_idx_round_trips_across_packages(tmp_path, use_native):
    if use_native:
        native.build()
    imgs, labels = _images(1), np.array([3, 1, 4, 1, 5])
    mnist.write_idx_images(str(tmp_path / "p-img"), imgs)
    mnist.write_idx_labels(str(tmp_path / "p-lbl"), labels)
    j_mnist.write_idx_images(str(tmp_path / "j-img"), imgs)
    j_mnist.write_idx_labels(str(tmp_path / "j-lbl"), labels)
    for kind in ("img", "lbl"):
        assert (tmp_path / f"p-{kind}").read_bytes() == (tmp_path / f"j-{kind}").read_bytes()
    got = mnist.load_idx_images(str(tmp_path / "j-img"), use_native=use_native)
    want = j_mnist.load_idx_images(str(tmp_path / "p-img"), use_native=False)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, imgs, atol=0.5 / 255 + 1e-7)
    got = mnist.load_idx_labels(str(tmp_path / "j-lbl"), use_native=use_native)
    assert got.dtype == np.int32 and got.tolist() == labels.tolist()
    with pytest.raises(ValueError, match="non-square"):
        mnist.write_idx_images(str(tmp_path / "bad"), np.zeros((2, 10), np.float32))


@pytest.mark.parametrize("use_native", [False, True])
def test_bad_magic_and_truncation_raise(tmp_path, use_native):
    if use_native:
        native.build()
    bad = tmp_path / "bad"
    bad.write_bytes(struct.pack(">iiii", 1234, 1, 28, 28) + bytes(784))
    with pytest.raises(ValueError, match="magic"):
        mnist.load_idx_images(str(bad), use_native=use_native)
    bad.write_bytes(struct.pack(">ii", mnist.IMAGE_MAGIC, 3))
    with pytest.raises(ValueError, match="magic"):
        mnist.load_idx_labels(str(bad), use_native=use_native)
    bad.write_bytes(struct.pack(">ii", mnist.LABEL_MAGIC, 9) + bytes(4))
    with pytest.raises(ValueError, match="truncated"):
        mnist.load_idx_labels(str(bad), use_native=use_native)


@pytest.mark.parametrize("use_native", [False, True])
def test_load_fixture_equals_jax(use_native, monkeypatch):
    if use_native:
        native.build()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    for split in ("train", "test"):
        got = mnist.MNIST.load(FIXTURE, split)
        want = j_mnist.MNIST.load(FIXTURE, split)
        assert got.images.dtype == np.float32 and got.targets.dtype == np.int32
        assert got.images.shape == want.images.shape and len(got) == len(want) > 0
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.targets, want.targets)
    with pytest.raises(FileNotFoundError):
        mnist.MNIST.load(os.path.dirname(FIXTURE), "train")


@pytest.mark.parametrize("noise", [0.3, 2.0])
def test_synthetic_equals_jax(noise):
    for seed in (0, 1):
        got = mnist.MNIST.synthetic(300, seed=seed, noise=noise)
        want = j_mnist.MNIST.synthetic(300, seed=seed, noise=noise)
        assert got.images.dtype == want.images.dtype
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.targets, want.targets)


def _batches(ds, batch, seed):
    return [(x.copy(), y.copy()) for x, y in ds.batches(batch, seed=seed)]


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_batches_equal_jax_on_numpy_route(numpy_route):
    ds, jds = mnist.MNIST.synthetic(203, seed=4), j_mnist.MNIST.synthetic(203, seed=4)
    for seed in (None, 0, 7):
        _assert_same_batches(_batches(ds, 32, seed), _batches(jds, 32, seed))
    assert len(_batches(ds, 32, 3)) == 203 // 32          # the ragged tail dropped
    np.testing.assert_array_equal(ds.order(7), np.random.default_rng(7).permutation(203))


def test_native_loader_equals_numpy_parser():
    native.build()
    for split in ("train", "test"):
        img, lbl = mnist._SPLIT_FILES[split]
        for name, load in ((img, mnist.load_idx_images), (lbl, mnist.load_idx_labels)):
            path = os.path.join(FIXTURE, name)
            got = native.load_idx_images(path) if load is mnist.load_idx_images \
                else native.load_idx_labels(path)
            want = load(path, use_native=False)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="open failed"):
        native.load_idx_labels(os.path.join(FIXTURE, "missing"))


def test_native_shuffle_equals_jax_native_shuffle(native_route):
    for n, seed in ((1, 0), (97, 3), (1000, 12345)):
        got, want = native.shuffle_indices(n, seed), j_native.shuffle_indices(n, seed)
        assert got.dtype == np.int64 and sorted(got.tolist()) == list(range(n))
        np.testing.assert_array_equal(got, want)
    ds, jds = mnist.MNIST.synthetic(203, seed=4), j_mnist.MNIST.synthetic(203, seed=4)
    _assert_same_batches(_batches(ds, 32, 5), _batches(jds, 32, 5))
    assert not np.array_equal(ds.order(5), np.random.default_rng(5).permutation(203))
