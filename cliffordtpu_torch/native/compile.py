"""Compile exported serving programs into AOTInductor packages, in a
process of its own (``serving.export_serving(native=True)`` starts one
such child per group of programs, several groups at once):

    python -m cliffordtpu_torch.native.compile --ops LIB \\
        --program EP.pt2 --out PACKAGE.pt2 [--program ... --out ...]

``LIB`` is the operator library (``kernels/build.py::build_native_ops``),
loaded before the programs so that their ``cliffordtpu_native`` calls
resolve.  The programs compile one after another, so they share the
process's warm Inductor state.  Each compile's example inputs are zeros
of its program's input shapes.  TF32 is off for cuBLAS and cuDNN, as
every float32 bar of the port assumes.

A program that computes in bfloat16 (or float16) compiles with
Inductor's ``emulate_precision_casts``: its fused kernels round to the
low precision where eager rounds after each op, instead of carrying
float32 from op to op.  What is left between such a package and eager
(Inductor's own reductions and math functions) is measured by
``scripts/torch_native_bf16_parity.py``.

Inductor builds a package with ``$CXX`` (default ``g++``) and
``-fopenmp -lgomp``.  Where that compiler has no OpenMP runtime
(``openmp_cxx``), a CUDA program, whose generated code has no CPU kernel
and so no OpenMP, is built through a wrapper that drops those two flags,
and a CPU program fails to compile.  A CUDA program compiles without
AOTInductor's precompiled header and without its probe of the host's
vector ISA.  Prints one JSON line with each
package's compile seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch


def _takes_openmp(cxx: str) -> bool:
    try:
        return subprocess.run(
            [cxx, "-fopenmp", "-x", "c++", "-", "-o", os.devnull],
            input="int main() { return 0; }", capture_output=True,
            text=True, timeout=60).returncode == 0
    except OSError:
        return False


def openmp_cxx():
    """(compiler, whether it takes ``-fopenmp``): ``$CXX`` or ``g++``."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX or g++) for AOTInductor")
    return cxx, _takes_openmp(cxx)


def _without_openmp(cxx: str, work: str) -> str:
    """A compiler command that runs ``cxx`` without -fopenmp and -lgomp."""
    path = os.path.join(work, "cxx-without-openmp")
    with open(path, "w") as f:
        f.write(f"#!{sys.executable}\n"
                "import os, sys\n"
                "args = [a for a in sys.argv[1:]\n"
                "        if a not in ('-fopenmp', '-lgomp')]\n"
                f"os.execv({cxx!r}, [{cxx!r}, *args])\n")
    os.chmod(path, 0o755)
    return path


LOW_PRECISION = (torch.bfloat16, torch.float16)


def low_precision(program) -> bool:
    """Whether any value of the program is bfloat16 or float16."""
    return any(isinstance(n.meta.get("val"), torch.Tensor)
               and n.meta["val"].dtype in LOW_PRECISION
               for n in program.graph.nodes)


def _load(path: str):
    """The exported program at ``path`` with zeros as example inputs (the
    saved program holds none: they would be the weights); whether it runs
    on CUDA; whether it computes in low precision."""
    program = torch.export.load(path)
    vals = {n.name: n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder"}
    inputs = tuple(torch.zeros(vals[name].shape, dtype=vals[name].dtype,
                               device=vals[name].device)
                   for name in program.graph_signature.user_inputs)
    program.example_inputs = (inputs, {})
    return (program, any(t.device.type == "cuda" for t in inputs),
            low_precision(program))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ops", required=True)
    parser.add_argument("--program", action="append", required=True)
    parser.add_argument("--out", action="append", required=True)
    a = parser.parse_args(argv)
    if len(a.program) != len(a.out):
        parser.error("give one --out for each --program")
    import torch._inductor.config as inductor_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one launch configuration a pointwise kernel: fewer Triton compiles
    inductor_config.triton.autotune_pointwise = False
    torch.ops.load_library(a.ops)
    cxx, openmp = openmp_cxx()
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        for path, out in zip(a.program, a.out):
            program, cuda, lowp = _load(path)
            # a CUDA program has no CPU kernel: no precompiled AOTI header
            # (~100 s of g++ with the CUDA headers) and no probe of the
            # host's vector ISA (test builds, each dlopened by a Python
            # child), both paid by every compile process
            inductor_config.aot_inductor.precompile_headers = not cuda
            inductor_config.cpp.vec_isa_ok = False if cuda else None
            inductor_config.cpp.cxx = (
                (None, _without_openmp(cxx, work)) if cuda and not openmp
                else (None, cxx))
            t0 = time.perf_counter()
            torch._inductor.aoti_compile_and_package(
                program, package_path=out,
                inductor_configs={"emulate_precision_casts": lowp})
            seconds[os.path.basename(out)] = time.perf_counter() - t0
    print(json.dumps({"compile_s": seconds, "cxx_openmp": openmp}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
