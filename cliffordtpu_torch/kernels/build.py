"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into
``build/cliffordtpu_torch/lib<name>-<hash>.so`` at the root of the
checkout (a git-ignored directory), with a plain C interface and no
PyTorch headers, so a build takes seconds.  The hash covers the source,
every ``csrc/*.cuh`` header and the flags, so an edit rebuilds.  Sources
compile in parallel: ``build_all()`` starts one ``nvcc`` per file and then
waits for all of them.  ``--ptxas-options=-v`` leaves each kernel's
registers, shared memory and spills beside the library (``build_log``).

No ``--use_fast_math``: the sampler's uniforms must stay bit-exact with
``jax.random`` and its angles within 1e-5, which needs IEEE division and
square root and the accurate ``logf``/``expm1f``/``atanf``/``sincosf``.

A missing ``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cliffordtpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "--ptxas-options=-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """``nvcc`` from PATH, else under ``$CUDA_HOME``/``$CUDA_PATH``, else
    the toolkit PyTorch itself found."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    from torch.utils.cpp_extension import CUDA_HOME

    homes.append(CUDA_HOME)
    for home in homes:
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, CUDA_PATH); the port's CUDA "
        "kernels cannot be built")


def sources():
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start one nvcc; returns (process, temp output, final output)."""
    out = _library_path(name)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all() -> Dict[str, float]:
    """Compile every kernel source that has no current library, all at
    once; returns the wall seconds per compiled source (empty if all were
    built already)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in sources() if not _library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    started = {n: _start(n, nvcc) for n in todo}
    seconds, errors = {}, []
    for name, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on {name}.cu "
                          f"(rc {proc.returncode}):\n{log}")
        else:
            out.with_suffix(".log").write_text(log)  # ptxas -v report
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def build_log(name: str) -> List[str]:
    """The compiler's report (``--ptxas-options=-v``) of the current build."""
    path = _library_path(name).with_suffix(".log")
    return path.read_text().splitlines() if path.exists() else []


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
