"""How far a bfloat16 native serving program parts from eager bfloat16,
by how Inductor compiles it: its default (fused kernels), with
``emulate_precision_casts`` (fused, rounding where eager rounds: what
``cliffordtpu_torch/native/compile.py`` does for a low-precision
program), and lite mode (every op a call of its ATen kernel, nothing
generated; ``aten_calls`` prepares the program for it).

    python scripts/torch_native_bf16_parity.py [--batch 4] [--out FILE]

On the CPU, at the tiny flagship ``CliffordARVAE`` (the serving tests'
model) in bfloat16 compute: ``encode_z`` and ``decode`` are traced with
the C++ operators (``kernels/native.py``), compiled three ways in
parallel child processes, loaded with ``torch._inductor.aoti_load_package``
and held against eager bfloat16 and float32 ``Serving`` on the same
weights and inputs (largest error over largest magnitude).  Prints one
JSON line.  CPU only: the card's reading is chip_smoke's ``native``
phase, through the C++ host (a Python process that loads a CUDA package
beside the operator library crashes there, and torch 2.11's CUDA
runtime failed a lite-mode package at its first convolution).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

VARIANTS = ("default", "emulate", "lite")
RNG = (0, 5)


def tiny_model(dtype):
    from cliffordtpu_torch.nn.vit_vae import CliffordARVAE

    return CliffordARVAE(latent_dim=8, image_size=32, in_channels=1,
                         cnn_chs=[16, 32, 64], z_channels=64,
                         encoder_vit_layers=1, decoder_vit_layers=2,
                         patch_size=4, compute_dtype=dtype, seed=0).eval()


def aten_calls(program):
    """The program in core ATen ops for lite mode, without export's
    ``_assert_tensor_metadata`` checks (Inductor's passes, off in lite
    mode, drop them), each ``addmm(bias, a, b)`` written as
    ``mm(a, b) + bias``: torch's proxy executor, which runs an ATen call
    that has no C shim, miscounts addmm's default Scalar arguments."""
    program = program.run_decompositions()
    graph = program.graph
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif node.target is torch.ops.aten.addmm.default and not node.kwargs:
            bias, a, b = node.args
            with graph.inserting_before(node):
                mm = graph.call_function(torch.ops.aten.mm.default, (a, b))
                add = graph.call_function(torch.ops.aten.add.Tensor,
                                          (mm, bias))
            mm.meta["val"] = add.meta["val"] = node.meta["val"]
            node.replace_all_uses_with(add)
            graph.erase_node(node)
    program.graph_module.recompile()
    return program


def compile_child(variant: str, ops: str, path: str, out: str) -> int:
    """Compile one saved CPU program in ``variant``'s mode; prints its
    compile seconds."""
    import time

    from cliffordtpu_torch.native import compile as ncompile

    torch.ops.load_library(ops)
    program, _, _ = ncompile._load(path)
    configs = {"emulate_precision_casts": variant == "emulate"}
    if variant == "lite":
        example = program.example_inputs
        program = aten_calls(program)
        program.example_inputs = example
        configs = dict(torch._inductor.lite_mode_options)
    t0 = time.perf_counter()
    torch._inductor.aoti_compile_and_package(program, package_path=out,
                                             inductor_configs=configs)
    print(json.dumps({"compile_s": time.perf_counter() - t0}))
    return 0


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--out", default=None, help="also write the JSON")
    a = parser.parse_args(argv)
    from cliffordtpu_torch import random as trandom
    from cliffordtpu_torch import serving
    from cliffordtpu_torch.kernels import build as kbuild
    from cliffordtpu_torch.kernels import native as knative

    torch.set_num_threads(1)
    ops = knative.load(cuda=False)
    mbf, m32 = tiny_model(torch.bfloat16), tiny_model(torch.float32)
    names = [n for n, _ in mbf.named_parameters()]
    weights = [p.detach() for _, p in mbf.named_parameters()]
    gen = np.random.default_rng(0)
    x = gen.uniform(-1, 1, (a.batch, 32, 32, 1)).astype(np.float32)
    key = trandom.sample_key(RNG)
    sbf, s32 = serving.Serving(mbf, device="cpu"), serving.Serving(
        m32, device="cpu")
    with torch.no_grad():
        z = sbf.encode_z(key, x).float().numpy()
        want = {("encode_z", "bf16"): z,
                ("encode_z", "f32"): s32.encode_z(key, x).float().numpy(),
                ("decode", "bf16"): sbf.decode(z).float().numpy(),
                ("decode", "f32"): s32.decode(z).float().numpy()}
    args = {"encode_z": (torch.tensor(RNG, dtype=torch.int64),
                         torch.from_numpy(x)),
            "decode": (torch.from_numpy(z),)}
    result = {"batch": a.batch, "torch": torch.__version__,
              "eager_bf16_vs_f32": {fn: rel_err(want[fn, "bf16"],
                                                want[fn, "f32"])
                                    for fn in args}}
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               TORCHINDUCTOR_COMPILE_THREADS="1",
               TORCHINDUCTOR_CACHE_DIR=str(kbuild.BUILD_DIR / "inductor"))
    with tempfile.TemporaryDirectory() as work:
        programs = {}
        for fn, fn_args in args.items():
            with knative.tracing(), torch.no_grad():
                program = torch.export.export(
                    serving._NativeProgram(mbf, fn, names),
                    (*weights, *fn_args), strict=False)
            program.example_inputs = None
            programs[fn] = os.path.join(work, f"{fn}.ep.pt2")
            torch.export.save(program, programs[fn])
        children = {
            (v, fn): subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child", v,
                 ops, path, os.path.join(work, f"{v}.{fn}.pt2")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env)
            for v in VARIANTS for fn, path in programs.items()}
        for (v, fn), proc in children.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{v} {fn} compile failed:\n{log[-3000:]}")
            package = torch._inductor.aoti_load_package(
                os.path.join(work, f"{v}.{fn}.pt2"))
            with torch.no_grad():
                got = package(*weights, *args[fn])
            got = (got[0] if isinstance(got, (list, tuple)) else got)
            got = got.float().numpy()
            result[f"{v}/{fn}"] = {
                "vs_bf16_serving": rel_err(got, want[fn, "bf16"]),
                "vs_f32_serving": rel_err(got, want[fn, "f32"]),
                "compile_s": json.loads(log.strip().splitlines()[-1])[
                    "compile_s"]}
    line = json.dumps(result)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        raise SystemExit(compile_child(*sys.argv[2:6]))
    raise SystemExit(main())
