"""Dataset loading (port of ``cliffordtpu/data/loaders.py``): real idx /
npz files when present, the procedural fallback otherwise, and the
train loop's binarisation.

Loading is host preprocessing that returns numpy, as in JAX; the files are
looked up in the JAX package's places (``_data_dirs``:
``$CLIFFORDTPU_DATA_DIR`` first), so one set serves both packages.
Transforms match the reference runners:

* MNIST: pixels in [0, 1]; the dynamic binarisation ``x > U(0, 1)`` is
  applied inside the train step (keyed), not here;
* FashionMNIST / CIFAR-10 / mnist32: 32 px (28 px images resized
  bilinearly), [-1, 1].

The fallback (``_synthesize``) is the JAX package's numpy code, so it
gives the same bytes.  The 28 -> 32 resize is ``F.interpolate`` with
half-pixel bilinear sampling, which equals ``jax.image.resize(...,
"bilinear")`` when upsampling, edges included.  ``iterate_batches`` is
shuffled by the bit-exact ``random.permutation``.  Both ``_read_idx`` and
``iterate_batches`` go through the native data engine (``data/native.py``)
unless ``CLIFFORDTPU_DATA_ENGINE=python``, as the JAX functions do.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import struct
import zlib
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cliffordtpu_torch import random


def _data_dirs():
    # read the env var at call time so tests/callers can set it dynamically
    return [os.environ.get("CLIFFORDTPU_DATA_DIR", ""), "data", "/root/data"]


_SPECS = {
    "mnist": dict(shape=(28, 28, 1), n_classes=10, norm="unit"),
    # mnist32 = the same mnist digit files served at the CNN runners'
    # geometry (32 px bilinear resize, [-1, 1] range, like fashionmnist)
    "mnist32": dict(shape=(32, 32, 1), n_classes=10, norm="pm1"),
    "fashionmnist": dict(shape=(32, 32, 1), n_classes=10, norm="pm1"),
    "cifar10": dict(shape=(32, 32, 3), n_classes=10, norm="pm1"),
}

_IDX_NAMES = {
    "mnist": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
              "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    "fashionmnist": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                     "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _read_idx(path: str) -> np.ndarray:
    from cliffordtpu_torch.data import native

    if native.available():
        return native.read_idx(path)  # ValueError on corrupt, like below
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rb") as f:
            magic = struct.unpack(">HBB", f.read(4))
            zero, dtype_code, ndim = magic
            if zero != 0 or dtype_code != 8 or not 1 <= ndim <= 3:
                raise ValueError(f"bad idx magic {magic}")
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)
    except (struct.error, ValueError, OSError) as e:
        raise ValueError(
            f"corrupt or non-idx file {path!r}: {e}") from e


def _verify_checksums(base: str, paths) -> None:
    """If a ``SHA256SUMS`` manifest sits next to the data files, verify
    every loaded file that it lists (``<hex digest>  <filename>`` per
    line, the ``sha256sum`` convention); raises on a mismatch."""
    manifest = os.path.join(base, "SHA256SUMS")
    if not os.path.exists(manifest):
        return
    want = {}
    with open(manifest) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                want[parts[1].lstrip("*")] = parts[0].lower()
    for p in paths:
        fname = os.path.basename(p)
        if fname not in want:
            continue
        h = hashlib.sha256()
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != want[fname]:
            raise ValueError(
                f"checksum mismatch for {p}: got {h.hexdigest()}, "
                f"manifest says {want[fname]} — re-download the file")


def _find_real(name: str):
    sub = {"mnist": "MNIST/raw", "fashionmnist": "FashionMNIST/raw"}.get(name)
    for root in _data_dirs():
        if not root:
            continue
        for base in filter(None, [os.path.join(root, name), root,
                                  os.path.join(root, sub) if sub else None]):
            npz = os.path.join(base, f"{name}.npz")
            if os.path.exists(npz):
                _verify_checksums(base, [npz])
                z = np.load(npz)
                return {k: z[k] for k in
                        ("x_train", "y_train", "x_test", "y_test")}
            if name in _IDX_NAMES:
                paths = []
                for n in _IDX_NAMES[name]:
                    p = os.path.join(base, n)
                    if os.path.exists(p):
                        paths.append(p)
                    elif os.path.exists(p + ".gz"):
                        paths.append(p + ".gz")
                    else:
                        break
                else:
                    _verify_checksums(base, paths)
                    return {
                        "x_train": _read_idx(paths[0]),
                        "y_train": _read_idx(paths[1]),
                        "x_test": _read_idx(paths[2]),
                        "y_test": _read_idx(paths[3]),
                    }
    return None


# ---------------- procedural fallback ----------------

_DIGIT_GLYPHS = [
    "01110100011000110001100011000101110",  # 0
    "00100011000010000100001000010011111",  # 1
    "01110100010000100110010001000011111",  # 2
    "11110000010000101110000010000111110",  # 3
    "00010001100101010010111110001000010",  # 4
    "11111100001111000001000011000101110",  # 5
    "01110100001000011110100011000101110",  # 6
    "11111000010001000100010001000010000",  # 7
    "01110100010111010001100011000101110",  # 8
    "01110100011000101111000010000101110",  # 9
]


def _glyph(c: int) -> np.ndarray:
    return np.array(
        [int(ch) for ch in _DIGIT_GLYPHS[c]], np.float32
    ).reshape(7, 5)


def _synth_gray(n: int, cls: np.ndarray, rng: np.random.Generator,
                size: int) -> np.ndarray:
    """Digit-glyph images with random shift/scale/noise — class-separable."""
    imgs = np.zeros((n, size, size), np.float32)
    scale = (size * 5) // 7  # glyph height in pixels
    for i in range(n):
        g = _glyph(int(cls[i]))
        h = max(8, scale + int(rng.integers(-3, 4)))
        w = max(6, int(h * 5 / 7))
        ys = np.clip((np.arange(h)[:, None] * 7 / h).astype(int), 0, 6)
        xs = np.clip((np.arange(w)[None, :] * 5 / w).astype(int), 0, 4)
        big = g[ys, xs]
        oy = int(rng.integers(0, size - h + 1))
        ox = int(rng.integers(0, size - w + 1))
        imgs[i, oy:oy + h, ox:ox + w] = big
    imgs += rng.normal(0, 0.05, imgs.shape).astype(np.float32)
    return np.clip(imgs, 0, 1)


def _synth_color(n: int, cls: np.ndarray, rng: np.random.Generator,
                 size: int) -> np.ndarray:
    """Per-class frequency/color motifs — class-separable RGB textures."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    imgs = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        c = int(cls[i])
        fy, fx = 1 + c % 4, 1 + (c // 4)
        phase = rng.uniform(0, 2 * np.pi, 3)
        for ch in range(3):
            imgs[i, :, :, ch] = 0.5 + 0.4 * np.sin(
                2 * np.pi * (fy * yy + fx * xx) / size + phase[ch] + c
            )
        imgs[i] += rng.normal(0, 0.08, (size, size, 3))
    return np.clip(imgs, 0, 1)


def _synthesize(name: str, n_train: int, n_test: int) -> Dict[str, np.ndarray]:
    spec = _SPECS[name]
    h, w, c = spec["shape"] if name != "mnist" else (28, 28, 1)
    # stable across processes (python's str hash is randomized per process)
    rng = np.random.default_rng(zlib.crc32(name.encode()) % (2**31))
    out = {}
    for split, n in [("train", n_train), ("test", n_test)]:
        cls = rng.integers(0, spec["n_classes"], n)
        if c == 1:
            x = (_synth_gray(n, cls, rng, h) * 255).astype(np.uint8)
        else:
            x = (_synth_color(n, cls, rng, h) * 255).astype(np.uint8)
        out[f"x_{split}"] = x
        out[f"y_{split}"] = cls.astype(np.int64)
    return out


# ---------------- public API ----------------


def resize_bilinear(x: np.ndarray, height: int, width: int) -> np.ndarray:
    """(N, H, W, C) float32 -> (N, height, width, C), half-pixel bilinear
    without antialiasing: ``jax.image.resize(..., "bilinear")`` when
    upsampling."""
    t = torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)
    out = F.interpolate(t, size=(height, width), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1).contiguous().numpy()


def load_dataset(
    name: str,
    n_train: int | None = None,
    n_test: int | None = None,
) -> Dict:
    """Return dict with x_train/y_train/x_test/y_test (float32 numpy, HWC
    in the reference's value range) plus ``source`` in {"real",
    "synthetic"}, ``shape`` and ``n_classes``."""
    name = name.lower().replace("-", "").replace("_", "")
    if name not in _SPECS:
        raise ValueError(f"unknown dataset {name}")
    spec = _SPECS[name]
    raw_name = "mnist" if name == "mnist32" else name  # same digit files
    raw = _find_real(raw_name)
    source = "real"
    if raw is None:
        source = "synthetic"
        raw = _synthesize(raw_name, n_train or 10000, n_test or 2000)

    def prep(x):
        x = np.asarray(x, np.float32) / 255.0
        if x.ndim == 3:  # (N, H, W) grayscale
            x = x[..., None]
        th, tw, _ = spec["shape"]
        if x.shape[1] != th:  # 28 -> 32 bilinear resize (Resize(32))
            x = resize_bilinear(x, th, tw)
        if spec["norm"] == "pm1":
            x = x * 2.0 - 1.0
        return x

    out = {
        "x_train": prep(raw["x_train"]),
        "y_train": np.asarray(raw["y_train"], np.int64),
        "x_test": prep(raw["x_test"]),
        "y_test": np.asarray(raw["y_test"], np.int64),
        "source": source,
        "shape": spec["shape"],
        "n_classes": spec["n_classes"],
    }
    if n_train:
        out["x_train"], out["y_train"] = (
            out["x_train"][:n_train], out["y_train"][:n_train])
    if n_test:
        out["x_test"], out["y_test"] = (
            out["x_test"][:n_test], out["y_test"][:n_test])
    return out


def iterate_batches(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    *,
    key=None,
    drop_remainder: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Minibatches of host arrays, in the order of ``permutation(key, n)``
    when keyed (the JAX function's stream, bit for bit), else in order.
    float32 images with int64 labels go through the native engine's
    prefetching batcher where ``native.prefetch_enabled()``; the stream is
    the same."""
    if (isinstance(x, np.ndarray) and x.dtype == np.float32
            and isinstance(y, np.ndarray) and y.dtype == np.int64):
        from cliffordtpu_torch.data import native

        if native.prefetch_enabled():
            with native.NativeBatchIterator(
                    x, y, batch_size, key=key,
                    drop_remainder=drop_remainder) as it:
                yield from it
            return
    n = x.shape[0]
    idx = np.arange(n)
    if key is not None:
        idx = random.permutation(key, n).numpy()
    end = (n // batch_size) * batch_size if drop_remainder else n
    for s in range(0, end, batch_size):
        sel = idx[s:s + batch_size]
        yield x[sel], y[sel]


def binarize_with_random_threshold(key, x: torch.Tensor) -> torch.Tensor:
    """Dynamic binarisation, keyed: ``x > uniform(key, x.shape)`` in x's
    dtype, the threshold words those of ``jax.random.uniform``."""
    return (x > random.uniform(key, x.shape, device=x.device)).to(x.dtype)


def binarize_lanes(keys: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``binarize_with_random_threshold`` for T lanes at once: ``keys``
    int64 (T, 2) on x's device, ``x`` (T, ...), lane t thresholded by the
    draw of its own key."""
    return (x > random.lane_uniform(keys, x.shape[1:])).to(x.dtype)
