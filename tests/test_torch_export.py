"""The serving bundle (cliffordtpu_torch/serving.py): every family's
exported CPU programs against the JAX package's ``serving_fns`` (jitted)
on the same params, through one program per function
at two batch sizes; the key, the files and the manifest, the hot swap, and
a loader that imports no model code.  One export per family, shared by
the cases."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from cliffordtpu import nn as jnn
from cliffordtpu.serving import _unflatten_params, serving_fns
from cliffordtpu_torch import random, serving
from cliffordtpu_torch.nn.conv_vae import CNNVAE
from cliffordtpu_torch.nn.hybrid_vae import HybridVAE
from cliffordtpu_torch.nn.mlp_vae import MLPVAE
from cliffordtpu_torch.nn.param_import import to_jax
from cliffordtpu_torch.nn.vit_vae import CliffordARVAE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the bundle against JAX, relative to the output's largest magnitude:
# XLA's and torch's float32 convolutions and matmuls sum in different
# orders (1.5e-6 at most here)
BAR = 1e-5
B = 5  # JAX's batch; the bundle answers it and its first 3 rows

FAMILIES = {
    "mlp": (lambda: jnn.MLPVAE(h_dim=32, z_dim=5, distribution="clifford"),
            lambda: MLPVAE(32, 5, "clifford"), (28, 28, 1)),
    "vit": (lambda: graft._flagship(tiny=True),
            lambda: CliffordARVAE(latent_dim=8, image_size=32, in_channels=1,
                                  cnn_chs=[16, 32, 64], z_channels=64,
                                  encoder_vit_layers=1, decoder_vit_layers=2,
                                  patch_size=4), (32, 32, 1)),
    "cnn": (lambda: jnn.CNNVAE(latent_dim=16, in_channels=1,
                               distribution="clifford", img_size=32),
            lambda: CNNVAE(16, 1), (32, 32, 1)),
    "hybrid": (lambda: jnn.HybridVAE(latent_dim=4, in_channels=1,
                                     distribution="clifford", img_size=8,
                                     encoder_chs=[8, 16]),
               lambda: HybridVAE(latent_dim=4, in_channels=1, img_size=8,
                                 encoder_chs=[8, 16]), (8, 8, 1)),
}


def _images(img, b, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (b, *img)).astype(
        np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """family -> (JAX model, flat params, bundle dir, loaded bundle).  The
    params are the port model's seeded initialisation in JAX's tree
    (``param_import.to_jax``), which the JAX model runs as they are."""
    out = {}
    for name, (make_jax, make_port, img) in FAMILIES.items():
        flat = to_jax(make_port())
        d = str(tmp_path_factory.mktemp(name))
        serving.export_serving(make_port(), flat, img, out_dir=d,
                               platforms=("cpu",))
        out[name] = (make_jax(), flat, d, serving.load_serving(d,
                                                               device="cpu"))
        if name == "mlp":
            out["child"] = _start_loader_child(d)
    yield out
    out["child"].kill()


def _start_loader_child(d):
    """A process that loads the bundle in ``d`` and prints the model
    modules it imported and the sums of its three answers."""
    np.save(os.path.join(d, "x.npy"), _images((28, 28, 1), 2, 3))
    code = (
        "import sys, numpy as np, torch\n"
        "from cliffordtpu_torch.serving import load_serving\n"
        f"ld = load_serving({d!r}, device='cpu')\n"
        f"x = np.load({os.path.join(d, 'x.npy')!r})\n"
        "z = ld.encode_z((0, 5), x)\n"
        "out = [ld.encode_mu(x), z, ld.decode(z)]\n"
        "print([m for m in sys.modules if m.startswith("
        "'cliffordtpu_torch.nn')])\n"
        "print([float(o.double().sum()) for o in out])\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _jax_outputs(jmodel, flat, img, rngs):
    """JAX's encode_mu, encode_z per rng and decode of the first z, at
    batch B."""
    fns = serving_fns(jmodel, img)

    @jax.jit  # one compile for the three functions
    def run(params, rngs, x):
        zs = [fns["encode_z"](params, r, x) for r in rngs]
        return fns["encode_mu"](params, x), zs, fns["decode"](params, zs[0])

    params = _unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    x = _images(img, B, 1)
    mu, zs, y = run(params, rngs, x)
    return x, np.asarray(mu), [np.asarray(z) for z in zs], np.asarray(y)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bundle_matches_jax_serving_fns(bundles, family):
    """encode_mu, encode_z with JAX's rng and decode, at batch 5 and 3
    through the one program of each function (a draw's first rows do not
    depend on the batch).  The rng is an input of the program, not a
    constant in it: two rngs give JAX's two latents, which differ."""
    jmodel, flat, _, loaded = bundles[family]
    rngs = [jax.random.PRNGKey(42), jax.random.PRNGKey(43)]
    x, mu, zs, y = _jax_outputs(jmodel, flat, FAMILIES[family][2], rngs)
    assert all(f["batch"] == "symbolic"
               for f in loaded.manifest["functions"].values())
    for b in (B, 3):
        assert _rel(loaded.encode_mu(x[:b]).numpy(), mu[:b]) <= BAR
        got = [loaded.encode_z(np.asarray(r), x[:b]).numpy() for r in rngs]
        for g, z in zip(got, zs):
            assert _rel(g, z[:b]) <= BAR
        assert np.abs(got[0] - got[1]).max() > 0.1
        assert _rel(loaded.decode(zs[0][:b]).numpy(), y[:b]) <= BAR


def test_bundle_files_and_manifest(bundles):
    _, flat, d, loaded = bundles["vit"]
    assert sorted(os.listdir(d)) == sorted(
        ["manifest.json", "params.npz"]
        + [f"{fn}.cpu.pt2" for fn in ("encode_mu", "encode_z", "decode")])
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    assert m == loaded.manifest
    assert m["format_version"] == 1 and m["torch_version"] == torch.__version__
    assert m["platforms"] == ["cpu"] and m["data_parallel"] == 1
    assert (m["model_class"], m["distribution"], m["latent_dim"]) == (
        "CliffordARVAE", "clifford", 8)
    assert m["img_shape"] == [32, 32, 1] and m["params_dtype"] == "float32"
    assert (m["mu_dim"], m["flat_z_dim"]) == (64 * 8, 64 * 16)
    assert m["decode_output"] == "tanh_image"
    fns = m["functions"]
    assert fns["encode_mu"]["in"] == [
        {"shape": ["b", "32", "32", "1"], "dtype": "float32"}]
    assert fns["encode_z"]["in"][0] == {"shape": ["2"], "dtype": "uint32"}
    assert fns["encode_z"]["out"] == {"shape": ["b", "1024"],
                                      "dtype": "float32"}
    assert fns["decode"]["out"]["shape"] == ["b", "32", "32", "1"]
    # params.npz holds JAX's flat keys; each program input names its key
    with np.load(os.path.join(d, "params.npz")) as z:
        assert sorted(z.files) == sorted(flat)
    assert {e[1] for e in m["param_layout"]} == set(flat)


def test_params_hot_swap(bundles):
    """Zeroed weights give zero means; the old weights come back."""
    _, flat, _, loaded = bundles["mlp"]
    x = _images((28, 28, 1), 3, 2)
    before = loaded.encode_mu(x)
    loaded.params = {k: np.zeros_like(v) for k, v in flat.items()}
    assert not loaded.encode_mu(x).any()
    loaded.params = flat
    assert torch.equal(loaded.encode_mu(x), before)


def test_loader_imports_no_model_code(bundles):
    """A child process (started beside the other exports) loads the MLP
    bundle and answers all three requests with no cliffordtpu_torch.nn
    module imported; its answers are the parent's."""
    _, _, d, loaded = bundles["mlp"]
    out, err = bundles["child"].communicate(timeout=120)
    assert bundles["child"].returncode == 0, err[-2000:]
    nn_mods, sums = out.strip().splitlines()[-2:]
    assert nn_mods == "[]"
    x = np.load(os.path.join(d, "x.npy"))
    z = loaded.encode_z((0, 5), x)
    want = [loaded.encode_mu(x), z, loaded.decode(z)]
    assert sums == str([float(o.double().sum()) for o in want])


def test_bundle_encode_z_is_the_in_process_draw(bundles):
    """The bundle's rng is the in-process ``Serving``'s sampling key
    through ``random.sample_key``, for every clifford family."""
    for family in FAMILIES:
        _, flat, _, loaded = bundles[family]
        img = FAMILIES[family][2]
        srv = serving.Serving(FAMILIES[family][1](), params=flat,
                              device="cpu")
        x = _images(img, 3, 4)
        assert torch.equal(loaded.encode_z((0, 8), x),
                           srv.encode_z(random.sample_key((0, 8)), x))
        assert torch.equal(loaded.encode_mu(x), srv.encode_mu(x))
