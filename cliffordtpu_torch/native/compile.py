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

A program that computes in bfloat16 (or float16) compiles as eager runs
it (``eager_calls``, Inductor's lite mode without its channels-last
rewrite): every op a call of its ATen kernel, nothing fused, so the
package answers as eager ``Serving`` does, bit for bit on the CPU and on
the card.  Its graph is decomposed only where eager decomposes (the
CompositeImplicit ops, such as ``conv2d`` into ``convolution``).  Some
calls are written otherwise, for torch 2.11's proxy executor, which runs
the ATen calls that have no C shim: a cast is the operator library's
``cast`` (the executor misreads a dtype argument); a group norm its
``group_norm`` (``at::group_norm`` itself, whose copy to a contiguous
layout depends on strides known only at run time, while a traced graph
fixes it); an int Scalar argument a float (the executor does not read
int Scalars).
Fused kernels part from eager wherever they round, reduce or evaluate a
math function otherwise, and in bfloat16 one such step of an angle moves
a latent by more than ``EXPORT_BF16_BAR``
(``scripts/torch_native_bf16_parity.py`` measures each mode).  A float32
program compiles with Inductor's defaults.

Inductor builds a package with ``$CXX`` (default ``g++``) and
``-fopenmp -lgomp``.  Where that compiler has no OpenMP runtime
(``openmp_cxx``), a CUDA program, whose generated code has no CPU kernel
and so no OpenMP, is built through a wrapper that drops those two flags,
and a CPU program fails to compile.  A CUDA program compiles without
AOTInductor's precompiled header and without its probe of the host's
vector ISA.  Prints one JSON line with each package's compile seconds.
"""

from __future__ import annotations

import argparse
import functools
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


@functools.lru_cache(maxsize=None)
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


def _int_scalars_as_floats(program) -> None:
    """Each int Scalar argument (given or by default) of an op with a
    floating output, written as a float of the same value: AOTInductor
    passes int Scalars of a proxy-executor call at run time and the
    executor does not consume them."""
    for node in program.graph.nodes:
        val = node.meta.get("val")
        if (node.op != "call_function"
                or not isinstance(node.target, torch._ops.OpOverload)
                or not isinstance(val, torch.Tensor)
                or not val.dtype.is_floating_point):
            continue
        args, kwargs = list(node.args), dict(node.kwargs)
        for i, arg in enumerate(node.target._schema.arguments):
            if not isinstance(arg.type, torch.NumberType):
                continue
            if i < len(args):
                if type(args[i]) is int:
                    args[i] = float(args[i])
            elif arg.name in kwargs:
                if type(kwargs[arg.name]) is int:
                    kwargs[arg.name] = float(kwargs[arg.name])
            elif arg.has_default_value() and type(arg.default_value) is int:
                kwargs[arg.name] = float(arg.default_value)
        node.args, node.kwargs = tuple(args), kwargs


def _replace(graph, node, target, args) -> None:
    with graph.inserting_before(node):
        call = graph.call_function(target, tuple(args))
    call.meta = dict(node.meta)
    node.replace_all_uses_with(call)
    graph.erase_node(node)


def eager_calls(program):
    """The program as eager runs it, for Inductor's lite mode: each group
    norm a call of the operator library's ``group_norm`` (``at::group_norm``,
    which picks its layout at run time), then only the CompositeImplicit
    ops decomposed (by their own ATen implementation, as eager dispatches
    them: a linear layer into ``addmm``), export's
    ``_assert_tensor_metadata`` checks dropped, each cast a call of the library's ``cast`` (torch 2.11's proxy
    executor misreads the dtype argument of ``_to_copy``), int Scalars as
    floats (``_int_scalars_as_floats``).  Keeps the example inputs; needs
    the operator library loaded."""
    from cliffordtpu_torch.kernels.native import CAST_DTYPES

    native = torch.ops.cliffordtpu_native
    example = getattr(program, "example_inputs", None)
    for node in list(program.graph.nodes):
        if node.target is torch.ops.aten.group_norm.default:
            # the library's group_norm takes the first five of its arguments
            schema = node.target._schema.arguments
            given = {a.name: v for a, v in zip(schema, node.args)}
            given.update(node.kwargs)
            _replace(program.graph, node, native.group_norm.default,
                     [given.get(a.name, a.default_value) for a in schema[:5]])
    program.graph_module.recompile()
    table = torch.export.default_decompositions()
    for op in list(table.keys()):
        if not torch._C._dispatch_has_kernel_for_dispatch_key(
                op.name(), "CompositeImplicitAutograd"):
            del table[op]
    program = program.run_decompositions(table)
    graph = program.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif node.target is torch.ops.aten._to_copy.default:
            if set(node.kwargs) != {"dtype"} or (
                    node.kwargs["dtype"] not in CAST_DTYPES):
                raise ValueError(f"eager_calls: no cast operator for "
                                 f"{node.format_node()}")
            _replace(graph, node, native.cast.default,
                     (node.args[0], CAST_DTYPES[node.kwargs["dtype"]]))
    _int_scalars_as_floats(program)
    program.graph_module.recompile()
    program.example_inputs = example
    return program


def inductor_configs(lowp: bool) -> dict:
    """Inductor's configs for a program: the defaults, or for one that
    computes in low precision lite mode with eager's layouts (no
    channels-last rewrite around the convolutions).  Such a package has no
    generated kernel, only the wrapper's calls: no probe of the host's
    vector ISA, and the wrapper built at -O0 (a third less compile)."""
    if not lowp:
        return {}
    return {**torch._inductor.lite_mode_options, "layout_optimization": False,
            "cpp.vec_isa_ok": False,
            "aot_inductor.compile_wrapper_opt_level": "O0"}


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


def init_process(ops: str) -> None:
    """What every compile process sets first: TF32 off, one launch
    configuration a pointwise kernel (fewer Triton compiles), the operator
    library loaded."""
    import torch._inductor.config as inductor_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inductor_config.triton.autotune_pointwise = False
    torch.ops.load_library(ops)


def compile_package(program, out: str, cuda: bool, configs: dict,
                    work: str) -> float:
    """Compile ``program`` into the package ``out`` with Inductor's
    ``configs``; returns the seconds."""
    import torch._inductor.config as inductor_config

    cxx, openmp = openmp_cxx()
    # a CUDA program has no CPU kernel: no precompiled AOTI header (~100 s
    # of g++ with the CUDA headers) and no probe of the host's vector ISA
    # (test builds, each dlopened by a Python child), both paid by every
    # compile process
    inductor_config.aot_inductor.precompile_headers = not cuda
    inductor_config.cpp.vec_isa_ok = False if cuda else None
    inductor_config.cpp.cxx = (
        (None, _without_openmp(cxx, work)) if cuda and not openmp
        else (None, cxx))
    t0 = time.perf_counter()
    torch._inductor.aoti_compile_and_package(
        program, package_path=out, inductor_configs=configs)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ops", required=True)
    parser.add_argument("--program", action="append", required=True)
    parser.add_argument("--out", action="append", required=True)
    a = parser.parse_args(argv)
    if len(a.program) != len(a.out):
        parser.error("give one --out for each --program")
    init_process(a.ops)
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        for path, out in zip(a.program, a.out):
            program, cuda, lowp = _load(path)
            seconds[os.path.basename(out)] = compile_package(
                eager_calls(program) if lowp else program, out, cuda,
                inductor_configs(lowp), work)
    print(json.dumps({"compile_s": seconds,
                      "cxx_openmp": openmp_cxx()[1]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
