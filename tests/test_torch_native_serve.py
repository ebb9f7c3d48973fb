"""``export_serving(native=True)`` and the Python-free host
(cliffordtpu_torch/native/serve.cc, the CPU build): one AOTInductor
package, ``encode_z`` of the tiny flagship ``CliffordARVAE`` (both C++
operators on its path), compiled once for the module; the host's answers
against the JAX package's ``serving_fns`` and against ``LoadedServing``
on the float32, bfloat16 and int8 storage of ``params.npz``; the manifest;
the error paths."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from cliffordtpu.serving import _unflatten_params, serving_fns
from cliffordtpu_torch import serving
from cliffordtpu_torch.kernels import build, native
from cliffordtpu_torch.nn.param_import import to_jax
from cliffordtpu_torch.nn.vit_vae import CliffordARVAE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAR = 1e-5  # tests/test_torch_export.py's bar against JAX
BATCH = 3  # the package's fixed batch
RNG = (0, 5)
IMG = (32, 32, 1)


def _port_model():
    return CliffordARVAE(latent_dim=8, image_size=32, in_channels=1,
                         cnn_chs=[16, 32, 64], z_channels=64,
                         encoder_vit_layers=1, decoder_vit_layers=2,
                         patch_size=4)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """The CPU operator library and host (built at once; hash-keyed files
    under build/ that other workers reuse), then one package: encode_z at
    batch 3, compiled by one child with one OpenMP thread and the
    Inductor cache under build/."""
    host = subprocess.Popen([sys.executable, "-m",
                             "cliffordtpu_torch.native.build", "--host",
                             "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lib = build.build_native_ops(False)
    out, err = host.communicate()
    assert host.returncode == 0, err
    d = str(tmp_path_factory.mktemp("native"))
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        # the bundle, then what native=True adds, for encode_z alone: one
        # package compile
        model = _port_model()
        res = serving.export_serving(model, None, IMG, out_dir=d,
                                     platforms=("cpu",))
        manifest = res["manifest"]
        manifest["native"], res["native_compile_s"] = serving._export_native(
            model, IMG, manifest["flat_z_dim"], d, ("cpu",), BATCH,
            ("encode_z",))
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    work = tmp_path_factory.mktemp("inputs")
    x = np.random.default_rng(0).uniform(-1, 1, (BATCH, *IMG)).astype(
        np.float32)
    np.save(work / "x.npy", x)
    np.save(work / "rng.npy", np.asarray(RNG, np.uint32))
    return {"dir": d, "lib": lib, "host": out.strip().splitlines()[-1],
            "result": res, "x": x, "work": work}


def _serve(b, *args, bundle_dir=None, fn="encode_z", ops=None, inputs=None):
    """Run the host with a clean environment (no Python variables);
    returns the process."""
    if inputs is None:
        inputs = [b["work"] / "rng.npy", b["work"] / "x.npy"]
    cmd = [b["host"], "--bundle", bundle_dir or b["dir"], "--fn", fn,
           "--device", "cpu", *[a for p in inputs for a in ("--input",
                                                              str(p))],
           *args]
    if ops is not False:
        cmd[1:1] = ["--ops", ops or b["lib"]]
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=120)


def _answer(b, bundle_dir=None, *args):
    out = b["work"] / f"z-{os.path.basename(bundle_dir or b['dir'])}.npy"
    proc = _serve(b, "--output", str(out), *args, bundle_dir=bundle_dir)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1]), np.load(out)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_manifest_native_section(bundle):
    nat = bundle["result"]["manifest"]["native"]
    with open(os.path.join(bundle["dir"], "manifest.json")) as f:
        assert json.load(f)["native"] == nat
    assert nat["batch"] == BATCH and nat["platforms"] == ["cpu"]
    assert nat["ops"] == {"library": "cliffordtpu_native", "abi": native.ABI}
    assert nat["param_order"] == [n for n, _ in
                                  _port_model().named_parameters()]
    fn = nat["functions"]["encode_z"]
    assert list(nat["functions"]) == ["encode_z"]
    assert fn["args"] == [
        {"name": "rng", "shape": [2], "dtype": "uint32",
         "program_dtype": "int64"},
        {"name": "x", "shape": [BATCH, *IMG], "dtype": "float32"}]
    assert fn["out"] == {"shape": [str(BATCH), str(8 * 2 * 64)],
                         "dtype": "float32"}
    assert fn["packages"] == {"cpu": "encode_z.native.cpu.pt2"}
    assert os.path.getsize(os.path.join(bundle["dir"],
                                        "encode_z.native.cpu.pt2")) > 0
    assert set(bundle["result"]["native_compile_s"]) == {
        "encode_z.native.cpu.pt2"}


def test_host_matches_jax_serving_fns(bundle):
    """The host, with no Python in its process, against JAX's jitted
    ``serving_fns`` encode_z on the same params and rng."""
    run, got = _answer(bundle)
    assert run["fn"] == "encode_z" and run["platform"] == "cpu"
    assert run["out_shape"] == [BATCH, 1024] and run["out_dtype"] == "f4"
    assert run["launches"] == {"attention_fwd": 0, "sampler_keyed": 0,
                               "sampler_rng": 0, "torus_fwd": 0}
    flat = serving.load_params_npz(os.path.join(bundle["dir"],
                                                "params.npz"))
    ref = to_jax(_port_model())  # the seeded weights the bundle holds
    assert flat.keys() == ref.keys()
    assert all(np.array_equal(flat[k], ref[k]) for k in ref)
    fns = serving_fns(graft._flagship(tiny=True), IMG)
    params = _unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    want = np.asarray(jax.jit(fns["encode_z"])(
        params, jnp.asarray(np.asarray(RNG, np.uint32)),
        jnp.asarray(bundle["x"])))
    assert _rel(got, want) <= BAR


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_host_matches_loaded_serving_on_each_storage(bundle, mode):
    """The same package beside a params.npz in each storage mode: the host
    dequantizes as ``LoadedServing`` does and answers as it does."""
    d = bundle["dir"]
    if mode != "float32":
        d = str(bundle["work"] / mode)
        shutil.copytree(bundle["dir"], d)
        flat = serving.load_params_npz(os.path.join(bundle["dir"],
                                                    "params.npz"))
        np.savez(os.path.join(d, "params.npz"),
                 **serving._quantize_flat(flat, mode))
    _, got = _answer(bundle, d)
    want = serving.load_serving(d, device="cpu").encode_z(RNG, bundle["x"])
    assert _rel(got, want.numpy()) <= BAR


def test_host_bench_line(bundle):
    run, _ = _answer(bundle, None, "--bench", "3", "--warmup", "1")
    assert set(run) == {"fn", "platform", "batch", "compile_ms", "mean_ms",
                        "p50_ms", "p90_ms", "requests_per_s",
                        "samples_per_s", "launches"}
    assert run["batch"] == BATCH and run["p50_ms"] > 0


def _no_native(b):
    d = str(b["work"] / "plain")
    if not os.path.exists(d):
        shutil.copytree(b["dir"], d)
        with open(os.path.join(d, "manifest.json")) as f:
            m = json.load(f)
        del m["native"]
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(m, f)
    return d


def _wrong_batch(b):
    path = b["work"] / "x4.npy"
    np.save(path, np.zeros((BATCH + 1, *IMG), np.float32))
    return path


@pytest.mark.parametrize("case,match", [
    ("no_ops", "--ops, --bundle and --fn are required"),
    ("wrong_ops", "not the cliffordtpu_native operator library"),
    ("missing_ops", "dlopen"),
    ("wrong_batch", "fixed at export"),
    ("wrong_dtype", "dtype"),
    ("one_input", "takes 2 array input"),
    ("no_program", "no native program of 'decode'"),
    ("cuda", "built without CUDA"),
    ("no_native_section", "no 'native' section"),
])
def test_host_errors_exit_nonzero(bundle, case, match):
    b = bundle
    kw = {}
    args = []
    if case == "no_ops":
        kw["ops"] = False
    elif case == "wrong_ops":
        kw["ops"] = os.path.join(os.path.dirname(torch.__file__), "lib",
                                 "libc10.so")
    elif case == "missing_ops":
        kw["ops"] = str(b["work"] / "missing.so")
    elif case == "wrong_batch":
        kw["inputs"] = [b["work"] / "rng.npy", _wrong_batch(b)]
    elif case == "wrong_dtype":
        np.save(b["work"] / "rng_f4.npy", np.asarray(RNG, np.float32))
        kw["inputs"] = [b["work"] / "rng_f4.npy", b["work"] / "x.npy"]
    elif case == "one_input":
        kw["inputs"] = [b["work"] / "x.npy"]
    elif case == "no_program":
        kw["fn"] = "decode"
        kw["inputs"] = [b["work"] / "x.npy"]
    elif case == "cuda":
        args = ["--device", "cuda"]
    elif case == "no_native_section":
        kw["bundle_dir"] = _no_native(b)
    proc = _serve(b, *args, **kw)
    assert proc.returncode != 0 and proc.stdout == ""
    assert match in proc.stderr, proc.stderr


def test_native_export_refuses_data_parallel():
    with pytest.raises(ValueError, match="data_parallel"):
        serving.export_serving(_port_model(), None, IMG, out_dir="unused",
                               platforms=("cpu",), data_parallel=2,
                               native=True, native_platforms=("cpu",))
    with pytest.raises(ValueError, match="out_dir"):
        serving.export_serving(_port_model(), None, IMG, platforms=("cpu",),
                               native=True, native_platforms=("cpu",))


class _CastNorm(torch.nn.Module):
    """A float32 linear layer, group norm, silu and softplus computed in
    ``dtype``, cast as the models cast (``.to`` on the input and the
    weights)."""

    def __init__(self, dtype):
        super().__init__()
        self.lin = torch.nn.Linear(8, 4)
        self.norm = torch.nn.GroupNorm(2, 4, eps=1e-6)
        self.dtype = dtype

    def forward(self, x):
        h = torch.nn.functional.linear(
            x.to(self.dtype), self.lin.weight.to(self.dtype),
            self.lin.bias.to(self.dtype))
        h = torch.nn.functional.group_norm(
            h.float()[..., None], 2, self.norm.weight, self.norm.bias, 1e-6)
        return torch.nn.functional.softplus(
            torch.nn.functional.silu(h.to(self.dtype))).float()


def test_low_precision_programs_compile_as_eager_calls():
    """native/compile.py compiles a program that computes in bfloat16 or
    float16 in Inductor's lite mode without its layout rewrite, prepared
    by ``eager_calls``: casts and group norms as the operator library's
    ``cast`` and ``group_norm``, linear layers as eager decomposes them
    (``addmm``), silu kept whole, its int Scalars as floats, no metadata asserts; the prepared
    program answers as the exported one bit for bit.  A float32 program
    compiles as Inductor's default.  It tells them apart by their values'
    dtypes, the casts of the models included."""
    from cliffordtpu_torch.native import compile as ncompile

    native.load(False)
    x = torch.randn(5, 8)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        model = _CastNorm(dtype)
        program = torch.export.export(model, (x,))
        lowp = ncompile.low_precision(program)
        assert lowp == (dtype != torch.float32)
        configs = ncompile.inductor_configs(lowp)
        if not lowp:
            assert configs == {}
            continue
        assert configs["fallback_by_default"]
        assert configs["layout_optimization"] is False
        prepared = ncompile.eager_calls(program)
        calls = [n for n in prepared.graph.nodes if n.op == "call_function"]
        ops = {str(n.target) for n in calls}
        assert {"cliffordtpu_native.cast.default",
                "cliffordtpu_native.group_norm.default",
                "aten.addmm.default", "aten.silu.default"} <= ops, ops
        assert not ops & {"aten._to_copy.default", "aten.linear.default",
                          "aten.group_norm.default",
                          "aten.native_group_norm.default",
                          "aten._assert_tensor_metadata.default"}, ops
        softplus = next(n for n in calls
                        if n.target is torch.ops.aten.softplus.default)
        assert softplus.kwargs == {"beta": 1.0, "threshold": 20.0}
        assert all(type(v) is float for v in softplus.kwargs.values())
        with torch.no_grad():
            assert torch.equal(prepared.module()(x), model(x))
