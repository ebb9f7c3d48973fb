"""The port's data loaders (cliffordtpu_torch/data/loaders.py) against
cliffordtpu/data/loaders.py: ``load_dataset`` on the committed MNIST
shard (``tests/data/mnist``: 28 px byte-equal; mnist32, resized to 32 px
by half-pixel bilinear sampling, within 1e-6 of ``jax.image.resize``),
the synthetic fallback of fashionmnist and cifar10 (byte-equal images and
labels), a checksum mismatch, idx files (plain and gzip) and a corrupt
one, and the keyed ``iterate_batches`` stream (the same order)."""

import gzip
import os
import shutil
import struct

import jax
import numpy as np
import pytest

from cliffordtpu.data import loaders as jloaders
from cliffordtpu_torch.data import loaders

SHARD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
RESIZE_BAR = 1e-6


def _same(got, want, exact=True):
    assert got["source"] == want["source"]
    assert tuple(got["shape"]) == tuple(want["shape"])
    assert got["n_classes"] == want["n_classes"]
    for k in ("x_train", "y_train", "x_test", "y_test"):
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        if exact or k.startswith("y"):
            assert np.array_equal(got[k], want[k]), k
        else:
            assert np.abs(got[k] - want[k]).max() <= RESIZE_BAR, k


@pytest.mark.parametrize("name", ["mnist", "mnist32"])
def test_committed_shard_loads_as_in_jax(name, monkeypatch):
    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", SHARD)
    got = loaders.load_dataset(name, n_train=300, n_test=100)
    want = jloaders.load_dataset(name, n_train=300, n_test=100)
    assert got["source"] == "real"
    _same(got, want, exact=name == "mnist")
    if name == "mnist32":
        assert got["x_train"].shape[1:] == (32, 32, 1)
        assert got["x_train"].min() >= -1 and got["x_train"].max() <= 1


@pytest.mark.parametrize("name", ["fashionmnist", "cifar10"])
def test_synthetic_fallback_is_byte_equal(name, tmp_path, monkeypatch):
    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    got = loaders.load_dataset(name, n_train=48, n_test=16)
    want = jloaders.load_dataset(name, n_train=48, n_test=16)
    assert got["source"] == "synthetic"
    _same(got, want)


def test_checksum_mismatch_raises_in_both(tmp_path, monkeypatch):
    base = tmp_path / "mnist"
    base.mkdir()
    shutil.copy(os.path.join(SHARD, "mnist", "mnist.npz"), base)
    (base / "SHA256SUMS").write_text("0" * 64 + "  mnist.npz\n")
    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", str(tmp_path))
    for mod in (loaders, jloaders):
        with pytest.raises(ValueError, match="checksum mismatch"):
            mod.load_dataset("mnist")


def _write_idx(path, arr, gz):
    head = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


def test_idx_files_load_as_in_jax(tmp_path, monkeypatch):
    """Fashion idx files, the train pair gzipped: the same arrays (28 px
    resized to 32) from both packages; a corrupt file raises in both."""
    rng = np.random.default_rng(3)
    base = tmp_path / "fashionmnist"
    base.mkdir()
    names = jloaders._IDX_NAMES["fashionmnist"]
    arrays = (rng.integers(0, 256, (40, 28, 28)), rng.integers(0, 10, 40),
              rng.integers(0, 256, (12, 28, 28)), rng.integers(0, 10, 12))
    for i, (n, a) in enumerate(zip(names, arrays)):
        _write_idx(base / (n + (".gz" if i < 2 else "")), a, i < 2)
    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", str(tmp_path))
    got = loaders.load_dataset("fashionmnist")
    want = jloaders.load_dataset("fashionmnist")
    assert got["source"] == "real" and got["x_train"].shape == (40, 32, 32, 1)
    _same(got, want, exact=False)
    bad = tmp_path / "bad-idx"
    bad.write_bytes(b"\x01\x02\x03\x04rest")
    for mod in (loaders, jloaders):
        with pytest.raises(ValueError, match="corrupt or non-idx"):
            mod._read_idx(str(bad))


@pytest.mark.parametrize("drop", [False, True], ids=["all", "drop_remainder"])
def test_iterate_batches_follows_the_jax_order(drop):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(37, 3)).astype(np.float32)
    y = rng.integers(0, 10, 37).astype(np.int64)
    key = jax.random.PRNGKey(9)
    got = list(loaders.iterate_batches(x, y, 8, key=np.asarray(key),
                                       drop_remainder=drop))
    want = list(jloaders.iterate_batches(x, y, 8, key=key,
                                         drop_remainder=drop))
    assert len(got) == len(want) == (4 if drop else 5)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert np.array_equal(gx, np.asarray(wx))
        assert np.array_equal(gy, np.asarray(wy))
    plain = list(loaders.iterate_batches(x, y, 16))
    assert np.array_equal(np.concatenate([b for b, _ in plain]), x)
