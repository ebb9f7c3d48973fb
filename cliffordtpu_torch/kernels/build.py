"""Build the port's CUDA kernels at first use and load them with ctypes;
build the operator library of the Python-free serving path.

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

``build_native_ops(cuda)`` builds ``csrc/native_ops.cpp``, the kernels
of the serving path as C++ operators (``TORCH_LIBRARY`` namespace
``cliffordtpu_native``), into ``libcliffordtpu_native-<cpu|cuda>-<hash>.so``
beside the kernels: ``g++`` against the installed torch's headers and
libraries (its ``_GLIBCXX_USE_CXX11_ABI``, an rpath to ``torch/lib``),
and with ``cuda=True`` linked to objects of the four serving kernels'
``.cu`` files, which ``nvcc`` compiles with the flags above (``-c`` in
place of ``-shared``) while ``g++`` compiles the binding, all at once.
``cuda=False`` (the CPU tests) needs ``g++`` only and registers no CUDA
implementation.  The hash covers the sources, the flags, the torch
version and the variant; a build writes a temporary file and moves it
into place, so builders in parallel processes race benignly.

A missing ``nvcc`` or ``g++`` or a failed build raises; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
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


NATIVE_SOURCE = CSRC / "native_ops.cpp"
# the kernels the serving path launches, linked into the operator library
NATIVE_KERNELS = ("attention_fwd", "sampler_keyed", "sampler_rng",
                  "torus_fwd")
CXX_FLAGS = ("-O2", "-std=c++20", "-fPIC")


def torch_flags():
    """(compile flags, link flags) for a C++ file against the installed
    torch: its headers, its C++ ABI, its libraries with an rpath."""
    import torch

    root = Path(torch.__file__).resolve().parent
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    cflags = [f"-D_GLIBCXX_USE_CXX11_ABI={abi}", "-I", str(root / "include"),
              "-I", str(root / "include" / "torch" / "csrc" / "api" /
                        "include")]
    lflags = ["-L", str(root / "lib"), f"-Wl,-rpath,{root / 'lib'}",
              "-ltorch", "-ltorch_cpu", "-lc10"]
    return cflags, lflags


def find_cxx() -> str:
    """``$CXX`` when set, else ``g++`` from PATH; raises when neither is
    there."""
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(f"{cxx} not found; the C++ operators of the "
                           f"serving path cannot be built")
    return found


def cuda_home(nvcc: str) -> Path:
    return Path(nvcc).resolve().parents[1]


def native_ops_path(cuda: bool) -> Path:
    """Where ``build_native_ops(cuda)`` puts the operator library."""
    import torch

    h = hashlib.sha256()
    for src in [NATIVE_SOURCE, *(CSRC / f"{n}.cu" for n in NATIVE_KERNELS),
                *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join((*CXX_FLAGS, *NVCC_FLAGS, torch.__version__,
                       str(cuda))).encode())
    variant = "cuda" if cuda else "cpu"
    return BUILD_DIR / f"libcliffordtpu_native-{variant}-{h.hexdigest()[:16]}.so"


def _run(procs):
    """Wait for (name, process) pairs; raise with every failure's log."""
    errors = []
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name} failed (rc {proc.returncode}):\n{log}")
    if errors:
        raise RuntimeError("\n".join(errors))


def build_native_ops(cuda: bool) -> str:
    """The path of the operator library (module docstring), built first if
    needed; ``cuda=True`` raises when ``nvcc`` is missing."""
    out = native_ops_path(cuda)
    if out.exists():
        return str(out)
    nvcc = find_nvcc() if cuda else None
    cxx = find_cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"{out.stem}.", dir=BUILD_DIR))
    try:
        cflags, lflags = torch_flags()
        objects, procs = [], []
        defs = []
        if cuda:
            home = cuda_home(nvcc)
            defs = ["-DCLIFFORDTPU_CUDA", "-I", str(home / "include")]
            lflags += ["-ltorch_cuda", "-lc10_cuda", "-L",
                       str(home / "lib64"), "-lcudart_static", "-lrt",
                       "-lpthread", "-ldl"]
            flags = [f for f in NVCC_FLAGS if f != "-shared"]
            for name in NATIVE_KERNELS:
                obj = work / f"{name}.o"
                objects.append(obj)
                procs.append((f"nvcc {name}.cu", subprocess.Popen(
                    [nvcc, *flags, "-c", "-I", str(CSRC), "-o", str(obj),
                     str(CSRC / f"{name}.cu")], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
        obj = work / "native_ops.o"
        objects.insert(0, obj)
        procs.append((f"{cxx} native_ops.cpp", subprocess.Popen(
            [cxx, *CXX_FLAGS, *defs, *cflags, "-c", "-o", str(obj),
             str(NATIVE_SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
        _run(procs)
        tmp = work / out.name
        _run([(f"{cxx} -shared", subprocess.Popen(
            [cxx, "-shared", "-o", str(tmp), *map(str, objects), *lflags],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return str(out)


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
