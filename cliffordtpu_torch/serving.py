"""Serving (port of ``cliffordtpu/serving.py``): the three inference entry
points of a model, in process (``Serving``) and as an exported bundle
(``export_serving`` / ``load_serving``), on the card by default.

Every model family answers the same three requests (``serving_fns``):

* ``encode_mu(x)``      images (B, H, W, C) -> means (B, T*d): the mean
                        angles of a clifford latent; T tokens per image
                        (``CliffordARVAE``, ``HybridVAE``), T = 1 for
                        ``CNNVAE`` and ``MLPVAE`` (which reads flattened
                        rows of its 784 pixels)
* ``encode_z(rng, x)``  images -> sampled latents (B, T*k), k = 2d for
                        clifford and d otherwise
* ``decode(z)``         latents -> images (B, H, W, C), or the MLP's
                        logits (B, 784)

A bundle is one directory, as the JAX package writes it, with torch
programs in place of StableHLO:

```
manifest.json          # shapes / dtypes, calling convention, versions
params.npz             # weights in JAX's flat "a/b/c" keys and layouts
<fn>.<platform>.pt2    # torch.export program, platform "cuda" or "cpu"
```

Each program takes the port-layout weights (a dict of tensors) as its
first argument, so the weights are not baked in: ``LoadedServing.params``
hot-swaps them, and a program stays small.  The manifest's
``param_layout`` says how each JAX array becomes a program input (a flip
and a transpose), so the loader needs no model code: it imports the
kernels' operator registrations (``kernels/ops.py``) and no
``cliffordtpu_torch.nn`` module.  A JAX bundle's ``params.npz`` loads
(``load_params_npz``, ``Serving(params=...)``); its ``.stablehlo``
programs do not.

A bundle exported with ``data_parallel=N`` serves a request's rows on N
replicas (JAX's batch sharded over an N-device mesh): the batch is a
multiple of N, each replica runs the same programs on its B/N rows on
its own device (``load_serving(devices=)``, default ``cuda:0..N-1``), and
a replica's ``encode_z`` draws its rows of the global draw, its program
taking the rng as four words (the key, row0, B), which ``draw_latent``
reads as the row base of the draw; the outputs are joined on the first
device.  So a request gives the z of one device, bit for bit in every
counter.

``params.npz`` keeps JAX's three storage modes (``_quantize_flat``):
float32, bfloat16 (the raw uint16 words of a round-to-nearest-even cast)
and int8 (one symmetric scale per output column, tensors of rank < 2
exact).  They are storage only: the programs take float32 weights, and a
quantized file dequantizes at load.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.device import resolve_device

SERVING_FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_PARAMS = "params.npz"
_FN_NAMES = ("encode_mu", "encode_z", "decode")
_QUANT_MODES = ("float32", "bfloat16", "int8")


# ---- params.npz: JAX's flat keys and storage modes ----


def _quantize_flat(flat: Dict[str, np.ndarray], mode: str
                   ) -> Dict[str, np.ndarray]:
    """A flat float32 dict in one of the storage modes of
    ``cliffordtpu/serving.py::_quantize_flat``, byte for byte: bfloat16 as
    uint16 words under ``<key>::bf16``; int8 under ``<key>::int8`` with a
    float32 scale per output column (last axis) under ``<key>::scale``, a
    zero scale made 1, tensors of rank < 2 kept exact."""
    if mode not in _QUANT_MODES:
        raise ValueError(f"params_dtype must be one of {_QUANT_MODES}")
    out: Dict[str, np.ndarray] = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if mode == "float32" or not np.issubdtype(v.dtype, np.floating):
            out[k] = v
        elif mode == "bfloat16":
            bf = torch.from_numpy(np.array(v, np.float32)).to(
                torch.bfloat16)
            out[k + "::bf16"] = bf.view(torch.int16).numpy().view(np.uint16)
        elif v.ndim < 2:
            out[k] = v
        else:
            scale = (np.max(np.abs(v), axis=tuple(range(v.ndim - 1)),
                            keepdims=True) / 127.0)
            scale = np.where(scale == 0.0, 1.0, scale).astype(np.float32)
            out[k + "::int8"] = np.clip(np.round(v / scale), -127,
                                        127).astype(np.int8)
            out[k + "::scale"] = scale
    return out


def _dequantize_flat(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``_quantize_flat``'s inverse up to its rounding, as
    ``cliffordtpu/serving.py::_dequantize_flat``."""
    out: Dict[str, np.ndarray] = {}
    for k, v in flat.items():
        if k.endswith("::scale"):
            continue
        if k.endswith("::bf16"):
            words = np.asarray(v, np.uint16).astype(np.uint32) << 16
            out[k[:-6]] = words.view(np.float32)
        elif k.endswith("::int8"):
            scale = flat[k[:-6] + "::scale"]
            out[k[:-6]] = (v.astype(np.float32) * scale).astype(np.float32)
        else:
            out[k] = v
    return out


def load_params_npz(path) -> Dict[str, np.ndarray]:
    """Flat ``"a/b/c"`` -> float32 array dict from a ``params.npz`` in any
    storage mode, written by either package."""
    with np.load(path) as z:
        flat = _dequantize_flat({k: z[k] for k in z.files})
    return {k: np.asarray(v, dtype=np.float32) for k, v in flat.items()}


def _apply_layout(flat: Dict[str, np.ndarray], layout, device
                  ) -> Dict[str, torch.Tensor]:
    """JAX flat arrays -> the programs' port-layout weights on ``device``,
    by the manifest's ``param_layout`` entries (port name, JAX key, flip,
    order)."""
    out = {}
    for port, key, flip, order in layout:
        a = np.asarray(flat[key], np.float32)
        if flip:
            a = np.flip(a, tuple(flip))
        if order is not None:
            a = a.transpose(order)
        out[port] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


# ---- the three entry points, every family ----


def _heads(model, x):
    """The encoder heads: ``encode`` on flattened rows for ``MLPVAE``,
    ``encode_heads`` for the others."""
    if hasattr(model, "encode_heads"):
        return model.encode_heads(x)
    return model.encode(x.reshape(x.shape[0], -1))


def _rng_tensor(rng, rows=None) -> torch.Tensor:
    """An rng (two uint32 words in any form ``random.key_words`` takes) as
    the int64 tensor on the CPU that ``draw_latent`` reads: (2,), or (4,)
    with the row range ``rows=(row0, n_rows)`` after the key."""
    words = list(random.key_words(rng))
    if rows is not None:
        words += [int(rows[0]), int(rows[1])]
    return torch.tensor(words, dtype=torch.int64)


def serving_fns(model) -> Dict[str, Callable]:
    """``encode_mu(x)``, ``encode_z(rng, x)`` and ``decode(z)`` of any
    model family, on the model's weights (port of
    ``cliffordtpu/serving.py::serving_fns``).  ``encode_z`` takes the rng
    that the JAX function hands ``model.apply`` and draws, through the
    ``draw_latent`` operator, with its sampling key
    ``random.sample_key(rng)``, so one rng gives JAX's z in both
    packages."""
    from cliffordtpu_torch import kernels  # noqa: F401  (registers the ops)
    from cliffordtpu_torch.kernels import native

    latent_dim = int(getattr(model, "latent_dim",
                             getattr(model, "z_dim", 0)))

    def encode_mu(x):
        mu, _ = _heads(model, x)
        return mu.reshape(mu.shape[0], -1)

    def encode_z(rng, x):
        mu, param2 = _heads(model, x)
        if native.active():  # a native export: the C++ operator
            return native.draw_latent(
                rng, mu, param2, model.distribution,
                bool(model.l2_normalize), model.sampler,
                float(getattr(model, "draw_scale", 1.0)))
        return torch.ops.cliffordtpu_torch.draw_latent(
            rng, mu, param2, model.distribution, latent_dim,
            bool(model.l2_normalize), model.sampler,
            float(getattr(model, "draw_scale", 1.0)))

    def decode(z):
        return model.decode(z)

    return {"encode_mu": encode_mu, "encode_z": encode_z, "decode": decode}


class Serving:
    """One model in eval mode on one device, answering the three requests
    in process.

    ``device`` defaults to CUDA and raises when there is none; pass
    ``device="cpu"`` to run the plain versions of the kernels.  ``params``,
    when given, is a flat JAX param dict (``load_params_npz``) that replaces
    the model's own initialisation."""

    def __init__(self, model, params: Optional[Dict[str, np.ndarray]] = None,
                 device=None):
        self.device = resolve_device(device)
        if params is not None:
            from cliffordtpu_torch.nn.param_import import from_jax

            model.load_state_dict(from_jax(params, model.distribution))
        self.model = model.to(self.device).eval()
        self._fns = serving_fns(self.model)

    def _input(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def encode_mu(self, x) -> torch.Tensor:
        return self._fns["encode_mu"](self._input(x))

    @torch.inference_mode()
    def encode_z(self, key, x,
                 sampler: Optional[str] = None) -> torch.Tensor:
        """Sampled latents.  ``key`` is the SAMPLING key, two uint32 words,
        used as ``CliffordPowerSphericalDistribution.sample`` uses its key:
        not the rng that ``serving_fns``' ``encode_z`` and a loaded
        bundle's take, which derive this key as ``random.sample_key(rng)``
        (flax's ``make_rng("sample")``).  So ``encode_z(sample_key(rng),
        x)`` here equals a bundle's ``encode_z(rng, x)``.  ``sampler`` names
        the route of a clifford draw
        (``distributions/clifford_torus.py::SAMPLERS``) for this request;
        the default is the model's own.  The other latents have one route,
        and a ``sampler`` for them raises ``ValueError``."""
        return self.model.get_flat_latent(self._input(x), key, sampler)

    @torch.inference_mode()
    def decode(self, z) -> torch.Tensor:
        return self._fns["decode"](self._input(z))


CliffordARServing = Serving


# ---- export ----


class _Program(torch.nn.Module):
    """One entry point as a module with no state of its own: ``forward``
    takes the weights first and calls the entry point with them in place
    of the model's (``torch.func.functional_call``), so ``torch.export``
    lifts no parameter into the program."""

    def __init__(self, model, name: str):
        super().__init__()
        self._bound = (_Entry(model, name),)  # a tuple: not a submodule

    def forward(self, params, *args):
        entry = self._bound[0]
        return torch.func.functional_call(
            entry, {f"model.{k}": v for k, v in params.items()}, args,
            strict=False)


class _Entry(torch.nn.Module):
    def __init__(self, model, name: str):
        super().__init__()
        self.model = model
        self.name = name

    def forward(self, *args):
        return serving_fns(self.model)[self.name](*args)


def _sd_json(shape, dtype: str) -> dict:
    return {"shape": [d if isinstance(d, str) else str(int(d))
                      for d in shape], "dtype": dtype}


def _out_shape(program) -> list:
    """The output's shape of an exported program, "b" for the batch."""
    node = next(n for n in program.graph.nodes if n.op == "output")
    val = node.args[0][0].meta["val"]
    return ["b" if not isinstance(d, int) else d for d in val.shape]


def export_serving(model, params: Optional[Dict[str, np.ndarray]],
                   img_shape, out_dir: Optional[str] = None,
                   platforms=("cuda", "cpu"), fallback_batch: int = 8,
                   data_parallel: Optional[int] = None,
                   params_dtype: str = "float32",
                   native: bool = False,
                   native_platforms=("cuda", "cpu"),
                   native_batch: int = 8) -> dict:
    """Export a model's serving functions as ``torch.export`` programs, one
    per function and platform, each from the model on that device.

    ``params``: a flat JAX param dict that replaces the model's weights,
    or None for the model's own.  ``img_shape``: (H, W, C) of the input
    images.  The batch is symbolic (``Dim("b")``); where an export with it
    fails, the function is exported again at ``fallback_batch``, loudly,
    and the first error is raised if that fails too.  ``params_dtype``:
    the storage mode of ``params.npz`` ("float32", "bfloat16", "int8").
    Returns {"manifest": ..., "exported": {(fn, platform): program}};
    with ``out_dir`` the bundle is written there.

    ``data_parallel`` N > 1 records N in the manifest: requests are then a
    multiple of N rows ("N*b"), served on N replicas, and ``encode_z``'s
    program takes the four-word rng (the module docstring).

    ``native=True`` also writes, for each function and each of
    ``native_platforms``, a program for the Python-free host
    (``native/serve.cc``): traced at the fixed batch ``native_batch`` with
    the C++ operators (``kernels/native.py``) and compiled by AOTInductor
    into ``<fn>.native.<platform>.pt2`` by child processes (one a
    package, up to the cores; their Inductor cache
    ``build/cliffordtpu_torch/inductor``), and records the manifest's
    ``native`` section (``_export_native``).  It needs ``out_dir`` and
    raises ``ValueError`` with ``data_parallel`` > 1, as the JAX package's
    does.  The result then also holds "native_compile_s", the seconds of
    each package's compile."""
    from torch.export import Dim

    from cliffordtpu_torch.nn.param_import import from_jax, layout, to_jax

    if params_dtype not in _QUANT_MODES:
        raise ValueError(f"params_dtype must be one of {_QUANT_MODES}")
    dp = int(data_parallel or 1)
    if dp < 1:
        raise ValueError(f"data_parallel must be >= 1, got {data_parallel}")
    if native:
        if dp > 1:
            raise ValueError("native export is single-device; it is "
                             "incompatible with data_parallel > 1")
        if out_dir is None:
            raise ValueError("native export writes packages: pass out_dir")
        for plat in native_platforms:
            if plat not in ("cuda", "cpu"):
                raise ValueError(f"native platforms are cuda and cpu, got "
                                 f"{plat!r}")
    if params is not None:
        model.load_state_dict(from_jax(params, model.distribution))
    model.eval()
    img_shape = tuple(int(d) for d in img_shape)
    param_layout = layout(model)
    b = Dim("b")
    exported, batch_mode, shapes = {}, {}, {}
    for plat in platforms:
        device = torch.device(plat)
        model.to(device)
        weights = {k: v.detach() for k, v in model.named_parameters()}
        rng = _rng_tensor((0, 0), (0, 2) if dp > 1 else None)
        z_width = None
        for name in _FN_NAMES:
            def run(batch, symbolic):
                """Export at ``batch``; forward(params, *args) takes the
                array arguments as one nested tuple."""
                x = torch.zeros((batch, *img_shape), device=device)
                if name == "encode_mu":
                    args, dyn = (x,), ({0: b},)
                elif name == "encode_z":
                    args, dyn = (rng, x), (None, {0: b})
                else:
                    args = (torch.zeros((batch, z_width), device=device),)
                    dyn = ({0: b},)
                with torch.no_grad():
                    return torch.export.export(
                        _Program(model, name), (weights, *args),
                        dynamic_shapes=({k: None for k in weights}, dyn)
                        if symbolic else None, strict=False)

            try:
                program = run(2, True)
                mode = "symbolic"
            except Exception as e:
                print(f"serving export: symbolic batch failed for {name!r} "
                      f"on {plat} ({type(e).__name__}: {e}); retrying with "
                      f"fixed batch {fallback_batch}", file=sys.stderr)
                try:
                    program = run(fallback_batch, False)
                except Exception as pinned_err:
                    raise e from pinned_err
                mode = fallback_batch
            program.example_inputs = None  # else saved: the weights
            exported[(name, plat)] = program
            if batch_mode.setdefault(name, mode) != mode:
                raise RuntimeError(f"{name}: the platforms export different "
                                   f"batches ({batch_mode[name]}, {mode})")
            shapes[name] = _out_shape(program)
            if name == "encode_z":
                z_width = shapes[name][-1]

    def batch_dim(name):
        b_ = "b" if batch_mode[name] == "symbolic" else batch_mode[name]
        return b_ if dp == 1 else f"{dp}*{b_}"

    def ins(name):
        if name == "decode":
            return [_sd_json((batch_dim(name), z_width), "float32")]
        x = _sd_json((batch_dim(name), *img_shape), "float32")
        rng_words = 2 if dp == 1 else 4
        return ([_sd_json((rng_words,), "uint32"), x] if name == "encode_z"
                else [x])

    manifest = {
        "format_version": SERVING_FORMAT_VERSION,
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "data_parallel": dp,
        "model_class": type(model).__name__,
        "distribution": getattr(model, "distribution", "normal"),
        "latent_dim": int(getattr(model, "latent_dim",
                                  getattr(model, "z_dim", 0))),
        "img_shape": list(img_shape),
        "flat_z_dim": int(z_width),
        "mu_dim": int(shapes["encode_mu"][-1]),
        "decode_output": ("sigmoid_logits"
                          if not hasattr(model, "encode_heads")
                          else "tanh_image"),
        # calling convention: the port-layout weights are always the
        # FIRST argument; "in" lists the remaining (array) arguments
        "functions": {
            name: {"batch": batch_mode[name], "in": ins(name),
                   "out": _sd_json([batch_dim(name) if d == "b" else d
                                    for d in shapes[name]], "float32")}
            for name in _FN_NAMES},
        "params_dtype": params_dtype,
        # how each program input comes from params.npz:
        # [port name, JAX key, flip axes, transpose order or null]
        "param_layout": [list(e) for e in param_layout],
    }
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, _PARAMS),
                 **_quantize_flat(to_jax(model), params_dtype))
        for (name, plat), program in exported.items():
            torch.export.save(program,
                              os.path.join(out_dir, f"{name}.{plat}.pt2"))
    result = {"manifest": manifest, "exported": exported}
    if native:
        manifest["native"], result["native_compile_s"] = _export_native(
            model, img_shape, z_width, out_dir, tuple(native_platforms),
            int(native_batch))
    if out_dir is not None:
        with open(os.path.join(out_dir, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
    return result


class _NativeProgram(torch.nn.Module):
    """One entry point for the native host: ``forward`` takes the weights
    as flat positional inputs, in ``names`` order, then the array
    arguments."""

    def __init__(self, model, name: str, names):
        super().__init__()
        self._bound = (_Entry(model, name),)  # a tuple: not a submodule
        self._names = list(names)

    def forward(self, *flat):
        n = len(self._names)
        return torch.func.functional_call(
            self._bound[0],
            {f"model.{k}": v for k, v in zip(self._names, flat[:n])},
            flat[n:], strict=False)


def _export_native(model, img_shape, z_width: int, out_dir: str, platforms,
                   batch: int, fns=_FN_NAMES):
    """Trace each (function of ``fns``, platform) at ``batch`` with the C++
    operators and compile the programs into AOTInductor packages in child
    processes (``native/compile.py``, ``_compile_packages``).  Returns
    (the manifest's ``native`` section, the compile seconds per
    package)."""
    import shutil
    import tempfile

    from cliffordtpu_torch.kernels import build as kbuild
    from cliffordtpu_torch.kernels import native as knative

    ops = knative.load(cuda="cuda" in platforms)
    names = [n for n, _ in model.named_parameters()]
    rng_spec = {"name": "rng", "shape": [2], "dtype": "uint32",
                "program_dtype": "int64"}
    x_spec = {"name": "x", "shape": [batch, *img_shape], "dtype": "float32"}
    z_spec = {"name": "z", "shape": [batch, z_width], "dtype": "float32"}
    args_of = {"encode_mu": [x_spec], "encode_z": [rng_spec, x_spec],
               "decode": [z_spec]}
    functions = {}
    work = tempfile.mkdtemp(prefix="native-export-", dir=out_dir)
    todo = []
    try:
        for plat in platforms:
            device = torch.device(plat)
            model.to(device)
            weights = [p.detach() for _, p in model.named_parameters()]
            for name in fns:
                args = [torch.zeros([2], dtype=torch.int64, device=device)
                        if a["name"] == "rng" else
                        torch.zeros(a["shape"], device=device)
                        for a in args_of[name]]
                with knative.tracing(), torch.no_grad():
                    program = torch.export.export(
                        _NativeProgram(model, name, names),
                        (*weights, *args), strict=False)
                out_val = next(n for n in program.graph.nodes
                               if n.op == "output").args[0][0].meta["val"]
                package = f"{name}.native.{plat}.pt2"
                entry = functions.setdefault(name, {
                    "args": args_of[name],
                    "out": _sd_json(list(out_val.shape),
                                    str(out_val.dtype).split(".")[-1]),
                    "packages": {}})
                entry["packages"][plat] = package
                ep_path = os.path.join(work, f"{name}.{plat}.ep.pt2")
                program.example_inputs = None
                torch.export.save(program, ep_path)
                todo.append((package, ep_path))
        compile_s = _compile_packages(todo, ops, out_dir, work,
                                      kbuild.BUILD_DIR / "inductor")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    section = {
        "batch": batch,
        "platforms": list(platforms),
        "ops": {"library": knative.LIBRARY, "abi": knative.ABI},
        # the flat calling convention: these weights (param_layout's port
        # names) in this order, then each function's "args"
        "param_order": names,
        "functions": functions,
    }
    return section, compile_s


def _compile_packages(todo, ops: str, out_dir: str, work: str,
                      cache_dir) -> Dict[str, float]:
    """Compile each (package, exported program) with ``native/compile.py``:
    one child a package, at most one a core at once (beyond that a child
    compiles its share in turn); raises with the log of any that fails."""
    import subprocess

    jobs = max(1, min(len(todo), os.cpu_count() or 1))
    env = dict(os.environ)
    env["TORCHINDUCTOR_CACHE_DIR"] = str(cache_dir)
    env.setdefault("TORCHINDUCTOR_COMPILE_THREADS",
                   str(max(1, (os.cpu_count() or 1) // jobs)))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    children = []
    for i in range(jobs):
        args = [a for package, ep_path in todo[i::jobs]
                for a in ("--program", ep_path,
                          "--out", os.path.join(out_dir, package))]
        log = open(os.path.join(work, f"compile{i}.log"), "w+")
        children.append((subprocess.Popen(
            [sys.executable, "-m", "cliffordtpu_torch.native.compile",
             "--ops", ops, *args], stdout=log, stderr=subprocess.STDOUT,
            env=env), log))
    seconds, errors = {}, []
    for proc, log in children:
        proc.wait()
        log.seek(0)
        text = log.read()
        log.close()
        if proc.returncode != 0:
            errors.append(f"package compile failed (rc {proc.returncode}):"
                          f"\n{text[-4000:]}")
        else:
            seconds.update(json.loads(text.strip().splitlines()[-1])[
                "compile_s"])
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


# ---- load + run ----


class LoadedServing:
    """A serving bundle loaded from disk: ``encode_mu`` / ``encode_z`` /
    ``decode`` run its ``torch.export`` programs for one platform, with no
    model code.  ``device`` defaults to CUDA; a bundle without programs
    for the device's platform raises.

    A ``data_parallel`` N bundle runs N replicas on ``devices`` (default
    ``cuda:0`` .. ``cuda:N-1``, which raises when fewer cards are visible;
    replicas may share a device), each on its B/N rows of a request; the
    outputs are joined on the first."""

    def __init__(self, directory: str, device=None, devices=None):
        from cliffordtpu_torch import kernels  # noqa: F401  (the ops)

        with open(os.path.join(directory, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest["format_version"] > SERVING_FORMAT_VERSION:
            raise ValueError(
                f"serving bundle format {self.manifest['format_version']} "
                f"is newer than supported {SERVING_FORMAT_VERSION}")
        self.data_parallel = dp = int(self.manifest.get("data_parallel", 1))
        if devices is None:
            if dp > 1 and device is None:
                visible = (torch.cuda.device_count()
                           if torch.cuda.is_available() else 0)
                if visible < dp:
                    raise ValueError(
                        f"bundle was exported for {dp}-way data parallelism "
                        f"but only {visible} devices are visible")
                devices = [f"cuda:{i}" for i in range(dp)]
            else:
                devices = [resolve_device(device)] * dp
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != dp:
            raise ValueError(f"a {dp}-replica bundle needs {dp} devices, "
                             f"got {len(self.devices)}")
        self.device = self.devices[0]
        plats = {d.type for d in self.devices}
        missing = plats - set(self.manifest["platforms"])
        if missing:
            raise ValueError(
                f"the bundle has programs for {self.manifest['platforms']}, "
                f"not for {', '.join(sorted(missing))}")
        self._layout = self.manifest["param_layout"]
        self._directory = directory
        self._loaded = {}
        self.params = load_params_npz(os.path.join(directory, _PARAMS))

    @property
    def params(self) -> Dict[str, np.ndarray]:
        """The weights, as JAX's flat float32 dict."""
        return self._params

    @params.setter
    def params(self, flat: Dict[str, np.ndarray]):
        """Hot-swap the weights: placed on each replica's device once,
        here."""
        self._params = flat
        self._placed = {str(d): _apply_layout(flat, self._layout, d)
                        for d in dict.fromkeys(self.devices)}

    def _program(self, name: str, device: torch.device):
        """The program of ``name`` for ``device``'s platform, its constants
        on ``device`` (loaded once per device)."""
        key = (name, str(device))
        if key not in self._loaded:
            self._loaded[key] = torch.export.load(os.path.join(
                self._directory, f"{name}.{device.type}.pt2")).module().to(
                device)
        return self._loaded[key]

    def _run(self, name: str, a, rng=None) -> torch.Tensor:
        """``name`` on each replica's rows of ``a``, joined on the first
        device."""
        a = torch.as_tensor(a, dtype=torch.float32)
        n = self.data_parallel
        if a.shape[0] % n:
            raise ValueError(f"a batch of {a.shape[0]} is not divisible by "
                             f"the bundle's {n} replicas")
        b = a.shape[0] // n
        outs = []
        for i, dev in enumerate(self.devices):
            args = [a[i * b:(i + 1) * b].to(dev)]
            if rng is not None:
                args.insert(0, _rng_tensor(rng, None if n == 1 else
                                           (i * b, a.shape[0])))
            outs.append(self._program(name, dev)(self._placed[str(dev)],
                                                 *args))
        if n == 1:
            return outs[0]
        return torch.cat([o.to(self.device) for o in outs])

    @torch.inference_mode()
    def encode_mu(self, x) -> torch.Tensor:
        return self._run("encode_mu", x)

    @torch.inference_mode()
    def encode_z(self, rng, x) -> torch.Tensor:
        """Sampled latents for the rng of JAX's ``encode_z`` (two uint32
        words), as ``serving_fns``' ``encode_z``; each replica draws its
        rows of the request's draw."""
        return self._run("encode_z", x, rng)

    @torch.inference_mode()
    def decode(self, z) -> torch.Tensor:
        return self._run("decode", z)


def load_serving(directory: str, device=None, devices=None
                 ) -> LoadedServing:
    return LoadedServing(directory, device, devices)


__all__ = ["Serving", "CliffordARServing", "serving_fns", "export_serving",
           "LoadedServing", "load_serving", "load_params_npz"]
