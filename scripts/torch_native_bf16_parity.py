"""How far a bfloat16 native serving program parts from eager bfloat16,
by how Inductor compiles it: "default" (fused kernels), "emulate"
(``emulate_precision_casts``: fused kernels that round where eager
rounds), "emulate_aten_norms" (emulate with the group norms and means as
ATen calls) and "eager" (``native/compile.py``'s mode for a low-precision
program: ``eager_calls`` in Inductor's lite mode, every op a call of its
ATen kernel, which is what ``export_serving(native=True)`` builds).

    python scripts/torch_native_bf16_parity.py [--device cpu|cuda]
        [--batch N] [--out FILE]

On the CPU (default) the tiny flagship ``CliffordARVAE`` (the serving
tests' model) at batch 4, its packages loaded in this process.  On the
card (``--device cuda``) flagship32 (``default_config(32)``) at batch 64,
its packages answered by the C++ host (``native/serve.cc``): on the
card's torch 2.11 a Python process segfaults in ``aoti_load_package`` for
any CUDA package, with or without the operator library.  Each variant's
``encode_z`` and ``decode`` compile in parallel child processes and are
held against eager bfloat16 and float32 ``Serving`` on the same weights
and inputs (largest error over largest magnitude).  For each fused
variant the script also finds where the program first parts from eager:
it JIT-compiles the program with every bfloat16 value as an output and
lists the first of those values that differ from the same graph run op
by op (the op, its source line, how many elements differ, the largest
difference).  Prints one JSON line, the card's name and power limit
first on the card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# "emulate_aten_norms": emulate's fused kernels with the reductions where
# they first part (GroupNorm, RMSNorm's mean) left to their ATen kernels as
# Inductor fallbacks (``aten_norm_fallbacks``): whether a fused program can
# answer as eager does.  Its fallbacks stay registered in a process, so it
# comes last
ATEN_NORMS = "emulate_aten_norms"
FUSED = {"default": {}, "emulate": {"emulate_precision_casts": True},
         ATEN_NORMS: {"emulate_precision_casts": True}}
RNG = (0, 5)
IMG = (32, 32, 1)
FIRST_PARTINGS = 6  # nodes listed per fused variant and function


def tiny_model(dtype):
    from cliffordtpu_torch.nn.vit_vae import CliffordARVAE

    return CliffordARVAE(latent_dim=8, image_size=32, in_channels=1,
                         cnn_chs=[16, 32, 64], z_channels=64,
                         encoder_vit_layers=1, decoder_vit_layers=2,
                         patch_size=4, compute_dtype=dtype, seed=0).eval()


def flagship32(dtype):
    from cliffordtpu_torch.nn.vit_vae import CliffordARVAE

    return CliffordARVAE(latent_dim=16, image_size=32, in_channels=1,
                         compute_dtype=dtype, seed=0).eval()


def compile_child(variant: str, ops: str, path: str, out: str) -> int:
    """Compile one saved program in ``variant``'s mode, as
    ``native/compile.py`` compiles (its process settings, its CUDA
    compiler handling); prints the compile seconds."""
    from cliffordtpu_torch.native import compile as ncompile

    ncompile.init_process(ops)
    if variant == ATEN_NORMS:
        aten_norm_fallbacks()
    program, cuda, _ = ncompile._load(path)
    with tempfile.TemporaryDirectory() as work:
        seconds = ncompile.compile_package(program, out, cuda,
                                           FUSED[variant], work)
    print(json.dumps({"compile_s": seconds}))
    return 0


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def first_parting(program, user_args, configs) -> dict:
    """The program JIT-compiled with ``configs``, every bfloat16 value an
    output, against the same graph run op by op: the final output's error
    and the first ``FIRST_PARTINGS`` values that differ."""
    import torch._dynamo

    gm = copy.deepcopy(program.graph_module)
    out = next(n for n in gm.graph.nodes if n.op == "output")
    n_out = len(out.args[0])
    watched = [n for n in gm.graph.nodes if n.op == "call_function"
               and isinstance(n.meta.get("val"), torch.Tensor)
               and n.meta["val"].dtype == torch.bfloat16]
    out.args = (tuple(out.args[0]) + tuple(watched),)
    gm.recompile()
    inputs, users = [], iter(user_args)
    for spec in program.graph_signature.input_specs:
        inputs.append(next(users) if spec.kind.name == "USER_INPUT"
                      else program.constants[spec.target])
    torch._dynamo.reset()
    with torch.no_grad():
        want = gm(*inputs)
        got = torch.compile(gm, backend="inductor", options=configs,
                            fullgraph=True)(*inputs)
    parts = []
    for node, a, b in zip(watched, got[n_out:], want[n_out:]):
        if torch.equal(a, b):
            continue
        trace = (node.meta.get("stack_trace") or "").strip().splitlines()
        diff = (a.double() - b.double()).abs()
        parts.append({"node": node.name, "op": str(node.target),
                      "line": trace[-1].strip() if trace else "",
                      "shape": list(a.shape),
                      "elements_differ": int((a != b).sum()),
                      "max_abs": float(diff.max()),
                      "rel": float(diff.max() / b.double().abs().max())})
        if len(parts) == FIRST_PARTINGS:
            break
    return {"output_rel": rel_err(got[0].float().cpu(),
                                  want[0].float().cpu()),
            "watched": len(watched), "first_parting": parts}


def aten_norm_fallbacks() -> None:
    """``ATEN_NORMS``' fallbacks, registered in this process; the group
    norm's input made contiguous on CUDA, as ``at::group_norm`` makes it
    there (on the CPU it keeps the input's layout).  Inductor's caches,
    which do not key on the fallbacks, are off from here on."""
    from torch._inductor import config, decomposition, lowering

    config.force_disable_caches = True

    def eager_layout(node, *args, **kwargs):
        if args[0].get_device().type == "cuda":
            return lowering.require_contiguous(node, *args, **kwargs)
        return args, kwargs

    for op, layout in ((torch.ops.aten.native_group_norm.default,
                        eager_layout), (torch.ops.aten.mean.dim, None)):
        decomposition.decompositions.pop(op, None)
        lowering.make_fallback(op, layout, warn=False, override_decomp=True)
    decomposition.fast_random_decomps.cache_clear()


def _host_answers(host, lib, bundle, fn, inputs, work) -> dict:
    """One function answered by the C++ host: its output and its run."""
    out = os.path.join(work, f"{os.path.basename(bundle)}.{fn}.npy")
    proc = subprocess.run(
        [host, "--ops", lib, "--bundle", bundle, "--fn", fn, "--device",
         "cuda", *[a for p in inputs for a in ("--input", p)], "--output",
         out, "--bench", "100", "--warmup", "5"], capture_output=True,
        text=True, timeout=600,
        env={k: v for k, v in os.environ.items()
             if not k.startswith("PYTHON")})
    if proc.returncode != 0:
        raise RuntimeError(f"host {bundle} {fn} failed:\n"
                           f"{proc.stderr[:3000]}")
    return {"out": np.load(out),
            "run": json.loads(proc.stdout.strip().splitlines()[-1])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    parser.add_argument("--batch", type=int, default=None,
                        help="default 4 on the CPU, 64 on the card")
    parser.add_argument("--out", default=None, help="also write the JSON")
    a = parser.parse_args(argv)
    from cliffordtpu_torch import random as trandom
    from cliffordtpu_torch import serving
    from cliffordtpu_torch.kernels import build as kbuild
    from cliffordtpu_torch.kernels import native as knative
    from cliffordtpu_torch.native import build as nbuild

    variants = ["eager", *FUSED]
    card = a.device == "cuda"
    batch = a.batch or (64 if card else 4)
    dev = torch.device(a.device)
    result = {"device": a.device, "batch": batch, "torch": torch.__version__}
    if card:
        if not torch.cuda.is_available():
            print("--device cuda needs a CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        result["gpu"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(result["gpu"], flush=True)
        host = nbuild.build_host(True)
    else:
        torch.set_num_threads(1)
    ops = knative.load(card)
    make = flagship32 if card else tiny_model
    result["model"] = make.__name__
    mbf, m32 = make(torch.bfloat16).to(dev), make(torch.float32).to(dev)
    names = [n for n, _ in mbf.named_parameters()]
    weights = [p.detach() for _, p in mbf.named_parameters()]
    x = np.random.default_rng(0).uniform(-1, 1, (batch, *IMG)).astype(
        np.float32)
    key = trandom.sample_key(RNG)
    sbf = serving.Serving(mbf, device=dev)
    s32 = serving.Serving(m32, device=dev)
    with torch.no_grad():
        z = sbf.encode_z(key, x).float().cpu().numpy()
        want = {("encode_z", "bf16"): z,
                ("encode_z", "f32"): s32.encode_z(key, x).float().cpu()
                .numpy(),
                ("decode", "bf16"): sbf.decode(z).float().cpu().numpy(),
                ("decode", "f32"): s32.decode(z).float().cpu().numpy()}
    args = {"encode_z": (torch.tensor(RNG, dtype=torch.int64, device=dev),
                         torch.from_numpy(x).to(dev)),
            "decode": (torch.from_numpy(z).to(dev),)}
    result["eager_bf16_vs_f32"] = {fn: rel_err(want[fn, "bf16"],
                                               want[fn, "f32"])
                                   for fn in args}
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               TORCHINDUCTOR_COMPILE_THREADS="1",
               TORCHINDUCTOR_CACHE_DIR=str(kbuild.BUILD_DIR / "inductor"))
    with tempfile.TemporaryDirectory() as work:
        programs, exported = {}, {}
        for fn, fn_args in args.items():
            with knative.tracing(), torch.no_grad():
                exported[fn] = torch.export.export(
                    serving._NativeProgram(mbf, fn, names),
                    (*weights, *fn_args), strict=False)
            program = copy.deepcopy(exported[fn])
            program.example_inputs = None
            programs[fn] = os.path.join(work, f"{fn}.ep.pt2")
            torch.export.save(program, programs[fn])
        children = {
            (v, fn): subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child", v,
                 ops, path, os.path.join(work, f"{v}.{fn}.pt2")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env)
            for v in FUSED for fn, path in programs.items()}
        bundle = os.path.join(work, "eager")
        manifest = serving.export_serving(mbf, None, IMG, out_dir=bundle,
                                          platforms=(a.device,))["manifest"]
        # what export_serving(native=True) builds
        manifest["native"], eager_s = serving._export_native(
            mbf, IMG, z.shape[1], bundle, (a.device,), batch, tuple(args))
        with open(os.path.join(bundle, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        compile_s = {("eager", fn.split(".")[0]): s
                     for fn, s in eager_s.items()}
        for v in FUSED:  # the same bundle, its packages swapped
            d = os.path.join(work, v)
            os.makedirs(d)
            shutil.copy(os.path.join(bundle, "params.npz"), d)
            section = copy.deepcopy(manifest["native"])
            for fn in args:
                section["functions"][fn]["packages"] = {
                    a.device: f"{v}.{fn}.pt2"}
            with open(os.path.join(d, "manifest.json"), "w") as f:
                json.dump({**manifest, "native": section}, f)
        for (v, fn), proc in children.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{v} {fn} compile failed:\n{log[-3000:]}")
            compile_s[v, fn] = json.loads(log.strip().splitlines()[-1])[
                "compile_s"]
            os.replace(os.path.join(work, f"{v}.{fn}.pt2"),
                       os.path.join(work, v, f"{v}.{fn}.pt2"))
        for v in variants:
            d = os.path.join(work, v)
            with open(os.path.join(d, "manifest.json")) as f:
                section = json.load(f)["native"]
            for fn in args:
                package = os.path.join(d, section["functions"][fn][
                    "packages"][a.device])
                entry = {"compile_s": compile_s[v, fn]}
                if card:
                    inputs = []
                    for i, arr in enumerate(
                            [np.asarray(RNG, np.uint32), x] if fn ==
                            "encode_z" else [z]):
                        inputs.append(os.path.join(work, f"{fn}.{i}.npy"))
                        np.save(inputs[-1], arr)
                    answer = _host_answers(host, ops, d, fn, inputs, work)
                    got = answer["out"]
                    entry.update(p50_ms=answer["run"]["p50_ms"],
                                 launches={k: n for k, n in answer["run"][
                                     "launches"].items() if n})
                else:
                    loaded = torch._inductor.aoti_load_package(package)
                    with torch.no_grad():
                        got = loaded(*weights, *args[fn])
                    got = got[0] if isinstance(got, (list, tuple)) else got
                    got = got.float().numpy()
                entry.update(vs_bf16_serving=rel_err(got, want[fn, "bf16"]),
                             vs_f32_serving=rel_err(got, want[fn, "f32"]))
                result[f"{v}/{fn}"] = entry
    for v in FUSED:
        if v == ATEN_NORMS:
            aten_norm_fallbacks()
        for fn in args:
            result[f"first_parting/{v}/{fn}"] = first_parting(
                exported[fn], [*weights, *args[fn]], FUSED[v])
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
