"""Build the native data engine (port of ``cliffordtpu/native/build.py``,
its ``dataio`` target; the PJRT targets are not ported).

``dataio.cc`` is compiled with the host's ``g++`` (``$CXX`` when set)
at first use, ``-O3 -std=c++17 -fPIC -pthread -shared ... -lz``, into
``build/cliffordtpu_torch/`` at the root of the checkout (git-ignored),
under a name keyed by a hash of the source and the command.  A cache hit
skips the compile.  Unlike the JAX package's build, which returns None,
a missing compiler or a failed build raises ``RuntimeError``.

    python -m cliffordtpu_torch.native.build
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "dataio.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cliffordtpu_torch"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
LIBS = ("-lz",)


def build() -> str:
    """The path of the built ``dataio`` library, compiled first if needed."""
    cxx = os.environ.get("CXX", "g++")
    cmd = [cxx, *FLAGS, str(SOURCE)]
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(cmd + list(LIBS)).encode())
    out = BUILD_DIR / f"libdataio-{h.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([*cmd, "-o", str(tmp), *LIBS],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native data engine: {cxx} could not run: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native data engine: {' '.join(cmd)} failed "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders race benignly
    return str(out)


if __name__ == "__main__":
    print(build())
