"""The native data engine (cliffordtpu_torch/native/dataio.cc through
cliffordtpu_torch/data/native.py) against the JAX package's Python paths:
the engine changes WHERE the host input pipeline runs, never WHAT it
produces.  Unlike the JAX engine, a failed build raises."""

import gzip
import os
import struct

import jax
import numpy as np
import pytest

from cliffordtpu.data.loaders import _read_idx as jax_read_idx
from cliffordtpu.data.loaders import iterate_batches as jax_iterate_batches
from cliffordtpu_torch import random
from cliffordtpu_torch.data import loaders, native


def _write_idx(path, arr: np.ndarray, gz=False):
    payload = struct.pack(">HBB", 0, 8, arr.ndim)
    payload += struct.pack(">" + "I" * arr.ndim, *arr.shape)
    payload += arr.astype(np.uint8).tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(payload)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_read_idx_matches_jax(tmp_path, gz):
    arr = np.random.default_rng(0).integers(0, 256, (7, 9, 4), np.uint8)
    p = str(tmp_path / ("a.idx" + (".gz" if gz else "")))
    _write_idx(p, arr, gz=gz)
    want = jax_read_idx(p)
    np.testing.assert_array_equal(native.read_idx(p), want)
    np.testing.assert_array_equal(loaders._read_idx(p), want)
    labels = str(tmp_path / "labels.idx")
    _write_idx(labels, np.arange(10, dtype=np.uint8))
    np.testing.assert_array_equal(native.read_idx(labels), np.arange(10))


@pytest.mark.parametrize("corrupt", ["magic", "short"])
def test_read_idx_corrupt_raises(tmp_path, corrupt):
    p = str(tmp_path / "bad.idx")
    with open(p, "wb") as f:
        if corrupt == "magic":
            f.write(b"\x01\x02\x03\x04garbage")
        else:  # payload shorter than the header promises
            f.write(struct.pack(">HBB", 0, 8, 2) + struct.pack(">II", 100, 100)
                    + b"\x00" * 10)
    for read in (native.read_idx, loaders._read_idx, jax_read_idx):
        with pytest.raises(ValueError, match="corrupt or non-idx"):
            read(p)


@pytest.mark.parametrize("keyed,drop,n,bs", [
    (True, False, 103, 16),   # shuffled, ragged tail batch
    (True, True, 103, 16),    # shuffled, drop_remainder
    (False, False, 64, 16),   # sequential, exact multiple
    (True, False, 7, 16),     # single short batch
])
def test_batch_stream_bit_identical_to_jax(keyed, drop, n, bs):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 5, 3, 2)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int64)
    key = jax.random.PRNGKey(42) if keyed else None
    want = list(jax_iterate_batches(x, y, bs, key=key, drop_remainder=drop))
    with native.NativeBatchIterator(
            x, y, bs, key=None if key is None else np.asarray(key),
            drop_remainder=drop) as it:
        got = list(it)
    assert len(got) == len(want) == it.n_batches
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, np.asarray(wx))
        np.testing.assert_array_equal(gy, np.asarray(wy))


def test_iterate_batches_routes_native_and_python_agree(monkeypatch):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(50, 4, 4, 1)).astype(np.float32)
    y = rng.integers(0, 10, 50).astype(np.int64)
    key = (0, 7)
    monkeypatch.setenv("CLIFFORDTPU_DATA_ENGINE", "native")
    seen = []
    monkeypatch.setattr(native.NativeBatchIterator, "__enter__",
                        lambda self: seen.append(self) or self)
    native_stream = list(loaders.iterate_batches(x, y, 8, key=key))
    assert len(seen) == 1
    monkeypatch.setenv("CLIFFORDTPU_DATA_ENGINE", "python")
    python_stream = list(loaders.iterate_batches(x, y, 8, key=key))
    assert len(seen) == 1
    assert len(native_stream) == len(python_stream) == 7
    for (gx, gy), (wx, wy) in zip(native_stream, python_stream):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_prefetch_policy(monkeypatch):
    """Forced by =native, switched off by =python (the engine too), and by
    default tied to a spare core for the worker thread."""
    monkeypatch.setenv("CLIFFORDTPU_DATA_ENGINE", "native")
    assert native.available() and native.prefetch_enabled()
    monkeypatch.setenv("CLIFFORDTPU_DATA_ENGINE", "python")
    assert not native.available() and not native.prefetch_enabled()
    monkeypatch.delenv("CLIFFORDTPU_DATA_ENGINE")
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    assert native.available() and not native.prefetch_enabled()
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    assert native.prefetch_enabled()


def test_iterator_close_is_idempotent_and_early():
    x = np.zeros((40, 3), np.float32)
    y = np.zeros((40,), np.int64)
    it = native.NativeBatchIterator(x, y, 8, prefetch=3)
    gen = iter(it)
    next(gen)  # consume one, leave the worker mid-epoch
    it.close()
    it.close()
    assert list(gen) == []


def test_multiple_epochs_fresh_iterators():
    """Per-epoch construction with distinct keys, each epoch JAX's."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(33, 2)).astype(np.float32)
    y = rng.integers(0, 10, 33).astype(np.int64)
    seen = []
    for epoch in range(3):
        key = random.fold_in((0, 0), epoch)
        with native.NativeBatchIterator(x, y, 8, key=key) as it:
            seen.append(np.concatenate([b[1] for b in it]))
        want = jax_iterate_batches(
            x, y, 8, key=jax.random.fold_in(jax.random.PRNGKey(0), epoch))
        np.testing.assert_array_equal(
            seen[-1], np.concatenate([np.asarray(b[1]) for b in want]))
    assert not np.array_equal(seen[0], seen[1])


def test_non_float32_inputs_stay_on_the_python_path(monkeypatch):
    monkeypatch.setenv("CLIFFORDTPU_DATA_ENGINE", "native")
    x = np.arange(160, dtype=np.uint8).reshape(20, 8)
    y = np.zeros((20,), np.int64)
    out = list(loaders.iterate_batches(x, y, 6))
    assert out[0][0].dtype == np.uint8
    assert sum(b[0].shape[0] for b in out) == 20


def test_a_failed_build_raises(monkeypatch):
    """No compiler: the engine raises where the JAX one falls back, and so
    do the loaders' entry points that reach it."""
    monkeypatch.setenv("CXX", "/nonexistent/g++")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="could not run"):
        native.available()
    x = np.zeros((4, 2), np.float32)
    y = np.zeros((4,), np.int64)
    with pytest.raises(RuntimeError):
        list(loaders.iterate_batches(x, y, 2))
    monkeypatch.setenv("CLIFFORDTPU_DATA_ENGINE", "python")
    assert len(list(loaders.iterate_batches(x, y, 2))) == 2
