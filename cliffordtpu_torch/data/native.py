"""ctypes bindings of the native data engine (port of
``cliffordtpu/data/native.py``; the library is ``native/dataio.cc``): idx
parsing and a worker-thread batch assembler in C++, which gathers batches
ahead of their use so the host's gather overlaps the device's work.

Determinism: the shuffle permutation is computed by the CALLER with
``random.permutation`` (``jax.random.permutation``'s stream, bit for bit)
and handed to C++, so the batch stream is the numpy ``iterate_batches``
path's, bit for bit: the engine changes WHERE the gather runs, never WHAT
is gathered.

``CLIFFORDTPU_DATA_ENGINE=python`` switches the engine off (the numpy
paths run); ``=native`` forces the batcher on a host of one CPU, where it
is off by default (``prefetch_enabled``).

One difference from the JAX package, whose engine "degrades gracefully"
to the numpy paths: here a missing compiler, a failed build or a library
that does not load raises (``RuntimeError``, ``OSError``), so a run never
leaves the engine without being asked to.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, Tuple

import numpy as np

from cliffordtpu_torch import random

ABI_VERSION = 1

_lib = None
_lock = threading.Lock()


def _switched_off() -> bool:
    return os.environ.get("CLIFFORDTPU_DATA_ENGINE", "").lower() == "python"


def _load():
    """The loaded library, built first if needed; raises when it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from cliffordtpu_torch.native.build import build

        lib = ctypes.CDLL(build())
        lib.idx_header.restype = ctypes.c_int64
        lib.idx_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint32)]
        lib.idx_payload.restype = ctypes.c_int32
        lib.idx_payload.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
        lib.batcher_create.restype = ctypes.c_void_p
        lib.batcher_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32]
        lib.batcher_next.restype = ctypes.c_int64
        lib.batcher_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.batcher_n_batches.restype = ctypes.c_int64
        lib.batcher_n_batches.argtypes = [ctypes.c_void_p]
        lib.batcher_destroy.restype = None
        lib.batcher_destroy.argtypes = [ctypes.c_void_p]
        version = lib.dataio_abi_version()
        if version != ABI_VERSION:
            raise RuntimeError(f"native data engine: ABI {version}, "
                               f"expected {ABI_VERSION}")
        _lib = lib
        return _lib


def available() -> bool:
    """True unless ``CLIFFORDTPU_DATA_ENGINE=python``; otherwise the engine
    is built and loaded here, and a failure raises."""
    if _switched_off():
        return False
    _load()
    return True


def prefetch_enabled() -> bool:
    """Whether ``iterate_batches`` routes through the C++ batcher: with
    ``CLIFFORDTPU_DATA_ENGINE=native`` always, with ``python`` never, and
    by default on a host of at least 2 CPUs (the worker thread needs a
    spare core: on one core it loses to the numpy gather, as the JAX
    package measured, BASELINE.md)."""
    if not available():
        return False
    if os.environ.get("CLIFFORDTPU_DATA_ENGINE", "").lower() == "native":
        return True
    return (os.cpu_count() or 1) >= 2


def read_idx(path: str) -> np.ndarray:
    """Native idx parse (plain or .gz); raises ValueError on a corrupt file,
    as ``loaders._read_idx`` does."""
    lib = _load()
    ndim = ctypes.c_int32(0)
    dims = (ctypes.c_uint32 * 3)()
    total = lib.idx_header(path.encode(), ctypes.byref(ndim), dims)
    if total < 0:
        raise ValueError(f"corrupt or non-idx file {path!r} (native parser)")
    out = np.empty(int(total), np.uint8)
    if lib.idx_payload(path.encode(), out.ctypes.data_as(ctypes.c_void_p),
                       int(total)) != 0:
        raise ValueError(f"corrupt or non-idx file {path!r}: short payload")
    return out.reshape(tuple(int(dims[i]) for i in range(ndim.value)))


class NativeBatchIterator:
    """Prefetching minibatch iterator over float32 / int64 host arrays:
    ``loaders.iterate_batches``' stream (``random.permutation(key, n)``
    when keyed), gathered by a C++ worker thread ``prefetch`` batches
    ahead.  Use as an iterator or context manager; ``close()`` is
    idempotent and also runs at garbage collection."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int, *,
                 key=None, drop_remainder: bool = False, prefetch: int = 2):
        lib = _load()
        n = x.shape[0]
        if key is not None:
            perm = random.permutation(key, n).numpy().astype(np.int64)
        else:
            perm = np.arange(n, dtype=np.int64)
        # C-contiguous float32 / int64 copies only when needed, kept as
        # attributes so the borrowed pointers outlive the C++ batcher
        self._x = np.ascontiguousarray(x, np.float32).reshape(n, -1)
        self._y = np.ascontiguousarray(y, np.int64)
        self._perm = perm
        self._shape = x.shape[1:]
        self._batch = int(batch_size)
        self._row = int(self._x.shape[1])
        self._lib = lib
        self._handle = lib.batcher_create(
            self._x.ctypes.data_as(ctypes.c_void_p),
            self._y.ctypes.data_as(ctypes.c_void_p),
            n, self._row, perm.ctypes.data_as(ctypes.c_void_p),
            self._batch, int(drop_remainder), max(1, int(prefetch)))
        if not self._handle:
            raise RuntimeError("batcher_create failed")
        self.n_batches = int(lib.batcher_n_batches(self._handle))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        # a one-pass stream: the C++ batcher drains once; the finally
        # releases the worker as soon as iteration ends, a consumer's
        # exception or an abandoned generator included
        xb = np.empty((self._batch, self._row), np.float32)
        yb = np.empty((self._batch,), np.int64)
        try:
            while self._handle is not None:
                got = self._lib.batcher_next(
                    self._handle, xb.ctypes.data_as(ctypes.c_void_p),
                    yb.ctypes.data_as(ctypes.c_void_p))
                if got <= 0:
                    return
                g = int(got)
                yield (xb[:g].reshape((g,) + self._shape).copy(),
                       yb[:g].copy())
        finally:
            self.close()

    def close(self):
        h, self._handle = self._handle, None
        if h is not None:
            self._lib.batcher_destroy(h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
