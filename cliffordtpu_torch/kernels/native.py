"""The C++ operators of the Python-free serving path, from Python.

``csrc/native_ops.cpp`` registers ``torch.ops.cliffordtpu_native.*``
(``attention_fwd``, ``sample_embed``, ``draw_latent``; ``cast`` and
``group_norm`` for ``native/compile.py::eager_calls``) through
``TORCH_LIBRARY``; ``build.build_native_ops`` builds it.  ``load(cuda)``
builds and loads it into this process once: the CUDA variant launches
kernels A, F, E and C and counts them inside the library
(``launch_counts``), the CPU variant runs the plain versions only.  A
process holds one variant.

While ``tracing()`` is active, the two places that call the Python
operators of ``kernels/ops.py`` in a serving program
(``attention._fwd_op`` and ``serving.serving_fns``' ``encode_z``) call
these instead, so that ``serving.export_serving(native=True)`` traces
programs that AOTInductor compiles and a process without Python runs.
The draw's distribution and route are ints in the schema
(``FAMILIES``, ``ROUTES``).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Optional

import torch

from cliffordtpu_torch.kernels import build

LIBRARY = "cliffordtpu_native"
ABI = 2  # csrc/native_ops.cpp::cliffordtpu_native_abi
FAMILIES = {"normal": 0, "gaussian": 0, "powerspherical": 1, "vmf": 2,
            "clifford": 3}
ROUTES = {"keyed": 0, "unfused": 1, "rng": 2}
# the dtype codes of ``cliffordtpu_native::cast`` (csrc/native_ops.cpp)
CAST_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
NO_ROUTE = -1

_lock = threading.Lock()
_loaded: Dict[str, object] = {}  # "path", "cuda", "lib" once loaded
_tracing = False


def load(cuda: bool) -> str:
    """Build (if needed) and load the operator library; returns its path.
    The cuda variant also serves the CPU; asking for it once the cpu
    variant is loaded raises."""
    with _lock:
        if _loaded:
            if cuda and not _loaded["cuda"]:
                raise RuntimeError(
                    "the cpu operator library is loaded in this process; it "
                    "holds one variant")
            return _loaded["path"]
        path = build.build_native_ops(cuda)
        torch.ops.load_library(path)
        lib = ctypes.CDLL(path)
        lib.cliffordtpu_native_abi.restype = ctypes.c_int64
        lib.cliffordtpu_native_kernels.restype = ctypes.c_char_p
        if lib.cliffordtpu_native_abi() != ABI:
            raise RuntimeError(f"{path}: operator ABI "
                               f"{lib.cliffordtpu_native_abi()}, want {ABI}")
        _loaded.update(path=path, cuda=cuda, lib=lib)
        return path


def _lib():
    if not _loaded:
        raise RuntimeError("the operator library is not loaded (native.load)")
    return _loaded["lib"]


def launch_counts() -> Dict[str, int]:
    """The launches of each kernel inside the operator library so far."""
    lib = _lib()
    names = lib.cliffordtpu_native_kernels().decode().split(",")
    counts = (ctypes.c_int64 * len(names))()
    lib.cliffordtpu_native_launches(counts)
    return dict(zip(names, counts))


def reset_launches():
    _lib().cliffordtpu_native_reset_launches()


@contextlib.contextmanager
def tracing():
    """Route the serving programs' kernel calls to the C++ operators while
    a native export traces."""
    global _tracing
    if not _loaded:
        raise RuntimeError("load the operator library before tracing")
    _tracing, saved = True, _tracing
    try:
        yield
    finally:
        _tracing = saved


def active() -> bool:
    return _tracing


def route_code(distribution: str, sampler: Optional[str]) -> int:
    """The schema's route of a draw: a clifford route (default "keyed"),
    or ``NO_ROUTE`` for the other families, which take no sampler."""
    if distribution != "clifford":
        if sampler is not None:
            raise ValueError(f"sampler={sampler!r} names a route of the "
                             f"clifford draw; the {distribution} latent has "
                             f"none")
        return NO_ROUTE
    if (sampler or "keyed") not in ROUTES:
        raise ValueError(f"sampler must be one of {tuple(ROUTES)}, got "
                         f"{sampler!r}")
    return ROUTES[sampler or "keyed"]


def draw_latent(rng, mu, param2, distribution: str, l2_normalize: bool,
                sampler: Optional[str], scale: float) -> torch.Tensor:
    """``ops.draw_latent``'s meaning through the C++ operator."""
    if distribution not in FAMILIES:
        raise ValueError(f"unknown distribution: {distribution}")
    return torch.ops.cliffordtpu_native.draw_latent(
        rng, mu, param2, FAMILIES[distribution], int(bool(l2_normalize)),
        route_code(distribution, sampler), float(scale))
