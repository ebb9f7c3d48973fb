"""bfloat16 native packages answer as eager bfloat16 ``Serving``: the tiny
flagship ``CliffordARVAE`` (``scripts/torch_native_bf16_parity.py``'s
model) in bfloat16 compute, its ``encode_z`` and ``decode`` exported with
``native=True``'s path (``serving._export_native``: two AOTInductor
compiles in parallel child processes, ``native/compile.py``'s mode for a
low-precision program), loaded in this process on the CPU and held against
eager bfloat16 ``Serving`` at ``EAGER_BAR`` and at least ``F32_FLOOR``
from float32 ``Serving`` on the same weights and inputs.  Inductor's fused
kernels part from eager by 3.5e-3 to 1.5e-2 here (``emulate_precision_casts``
and the default, the parity script's readings), so they fail the bar."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from cliffordtpu_torch import random as trandom
from cliffordtpu_torch import serving

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
RNG = (0, 5)
IMG = (32, 32, 1)
# the package against eager bfloat16 Serving: the same ATen calls in the
# same order (0.0 in practice); one bfloat16 step of a value is 2**-8 of it
EAGER_BAR = 1e-6
# and at least this far from float32 Serving: a package that computed in
# float32 would sit within 1e-5 of it (eager bfloat16 parts by ~1.5e-2)
F32_FLOOR = 1e-3


def _parity_script():
    spec = importlib.util.spec_from_file_location(
        "torch_native_bf16_parity",
        os.path.join(ROOT, "scripts", "torch_native_bf16_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    """(package answers, eager bfloat16 answers, eager float32 answers) by
    function, on one seeded image batch and rng."""
    tiny_model = _parity_script().tiny_model
    mbf, m32 = tiny_model(torch.bfloat16), tiny_model(torch.float32)
    x = np.random.default_rng(0).uniform(-1, 1, (BATCH, *IMG)).astype(
        np.float32)
    key = trandom.sample_key(RNG)
    sbf = serving.Serving(mbf, device="cpu")
    s32 = serving.Serving(m32, device="cpu")
    with torch.no_grad():
        z = sbf.encode_z(key, x).float()
        bf16 = {"encode_z": z.numpy(), "decode": sbf.decode(z).float().numpy()}
        f32 = {"encode_z": s32.encode_z(key, x).float().numpy(),
               "decode": s32.decode(z).float().numpy()}
    d = str(tmp_path_factory.mktemp("native_bf16"))
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        section, _ = serving._export_native(
            mbf, IMG, z.shape[1], d, ("cpu",), BATCH, ("encode_z", "decode"))
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    weights = dict(mbf.named_parameters())
    flat = [weights[n].detach() for n in section["param_order"]]
    args = {"encode_z": (torch.tensor(RNG, dtype=torch.int64),
                         torch.from_numpy(x)),
            "decode": (z,)}
    got = {}
    for fn, entry in section["functions"].items():
        package = torch._inductor.aoti_load_package(
            os.path.join(d, entry["packages"]["cpu"]))
        with torch.no_grad():
            out = package(*flat, *args[fn])
        out = out[0] if isinstance(out, (list, tuple)) else out
        got[fn] = out.float().numpy()
    return got, bf16, f32


@pytest.mark.parametrize("fn", ["encode_z", "decode"])
def test_package_answers_as_eager_bfloat16(answers, fn):
    got, bf16, _ = answers
    assert got[fn].shape == bf16[fn].shape
    assert np.isfinite(got[fn]).all()
    assert _rel(got[fn], bf16[fn]) <= EAGER_BAR


@pytest.mark.parametrize("fn", ["encode_z", "decode"])
def test_package_computes_in_bfloat16(answers, fn):
    got, _, f32 = answers
    assert _rel(got[fn], f32[fn]) >= F32_FLOOR
