"""Build the native data engine (port of ``cliffordtpu/native/build.py``,
its ``dataio`` target) and the Python-free serving host (the port's
counterpart of its PJRT host).

``dataio.cc`` is compiled with the host's ``g++`` (``$CXX`` when set)
at first use, ``-O3 -std=c++17 -fPIC -pthread -shared ... -lz``, into
``build/cliffordtpu_torch/`` at the root of the checkout (git-ignored),
under a name keyed by a hash of the source and the command.  A cache hit
skips the compile.  Unlike the JAX package's build, which returns None,
a missing compiler or a failed build raises ``RuntimeError``.

``build_host(cuda)`` compiles ``serve.cc`` into the executable
``cliffordtpu_serve-<cpu|cuda>-<hash>`` beside it, against the installed
torch's headers and libraries (``kernels/build.py::torch_flags``: its
C++ ABI, an rpath to ``torch/lib``) with ``torch``, ``torch_cpu`` and
``c10``, and for the card ``torch_cuda`` and ``c10_cuda``; ``-ldl -lz``.
It links no ``libpython``.

    python -m cliffordtpu_torch.native.build [--host cpu|cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "dataio.cc"
HOST_SOURCE = Path(__file__).resolve().parent / "serve.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cliffordtpu_torch"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
LIBS = ("-lz",)


def _compile(cmd, out: Path, what: str, timeout: int = 300) -> str:
    """Run ``cmd + [-o tmp]`` and move tmp to ``out`` (atomic: concurrent
    builders race benignly); raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True,
                              text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{what}: {cmd[0]} could not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what}: {' '.join(cmd)} failed "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


def build() -> str:
    """The path of the built ``dataio`` library, compiled first if needed."""
    cxx = os.environ.get("CXX", "g++")
    cmd = [cxx, *FLAGS, str(SOURCE)]
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(cmd + list(LIBS)).encode())
    out = BUILD_DIR / f"libdataio-{h.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    return _compile([*cmd, *LIBS], out, "native data engine")


def build_host(cuda: bool) -> str:
    """The path of the serving host for the card (``cuda=True``) or the
    CPU, compiled first if needed."""
    import torch

    from cliffordtpu_torch.kernels import build as kbuild

    cxx = kbuild.find_cxx()
    cflags, lflags = kbuild.torch_flags()
    if cuda:
        home = kbuild.cuda_home(kbuild.find_nvcc())
        cflags += ["-DCLIFFORDTPU_CUDA", "-I", str(home / "include")]
        lflags += ["-ltorch_cuda", "-lc10_cuda"]
    cmd = [cxx, *kbuild.CXX_FLAGS, *cflags, str(HOST_SOURCE), *lflags,
           "-ldl", *LIBS]
    h = hashlib.sha256(HOST_SOURCE.read_bytes())
    h.update(" ".join([*cmd, torch.__version__]).encode())
    variant = "cuda" if cuda else "cpu"
    out = BUILD_DIR / f"cliffordtpu_serve-{variant}-{h.hexdigest()[:16]}"
    if out.exists():
        return str(out)
    return _compile(cmd, out, "serving host", timeout=600)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--host", choices=("cpu", "cuda"),
                        help="build the serving host instead of dataio")
    a = parser.parse_args()
    print(build() if a.host is None else build_host(a.host == "cuda"))
