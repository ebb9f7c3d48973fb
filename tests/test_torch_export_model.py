"""params.npz's storage modes byte for byte against cliffordtpu/serving.py
(written by either package, read by the other), quantized bundles, the
``export_model`` entry point (its layouts, data-parallel bundles and
``--native``'s manifest section), and ``encode_z`` through a
bundle for the gaussian, powerspherical and vMF heads."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu import nn as jnn
from cliffordtpu.serving import (
    _dequantize_flat as jax_dequantize,
    _quantize_flat as jax_quantize,
    _unflatten_params,
    serving_fns,
)
from cliffordtpu_torch import random, serving
from cliffordtpu_torch.nn.conv_vae import CNNVAE
from cliffordtpu_torch.nn.mlp_vae import MLPVAE
from cliffordtpu_torch.nn.param_import import to_jax
from cliffordtpu_torch.scripts import export_model
from cliffordtpu_torch.train.checkpoint import save_checkpoint
from cliffordtpu_torch.train.state import create_train_state

torch.set_num_threads(1)

IMG = (28, 28, 1)
BAR = 1e-5  # against JAX, relative to the output's largest magnitude


def _images(img, b, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (b, *img)).astype(
        np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _odd_flat():
    """Weights with the storage modes' edge cases: bfloat16 rounding ties
    and subnormals, a zero column (scale 1), rank-1 and rank-0 arrays,
    an integer array."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    w[:, 2] = 0.0
    ties = np.array([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -1.0 - 2.0 ** -8,
                     1e-40, -3e-39, 3.0e38, 65504.0, 0.0], np.float32)
    return {"a/kernel": w, "a/bias": rng.normal(size=5).astype(np.float32),
            "b/conv": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
            "c/ties": np.tile(ties, (3, 1)), "d/scalar": np.float32(2.5),
            "e/count": np.arange(4, dtype=np.int32)}


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_quantize_flat_bytes_equal_jax(mode):
    flat = _odd_flat()
    got = serving._quantize_flat(flat, mode)
    want = jax_quantize(flat, mode)
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k
    back, jax_back = serving._dequantize_flat(got), jax_dequantize(want)
    assert back.keys() == jax_back.keys() == flat.keys()
    for k in back:
        assert np.asarray(back[k]).tobytes() == np.asarray(
            jax_back[k]).tobytes(), k


@pytest.fixture(scope="module")
def mlp_flat():
    return to_jax(MLPVAE(32, 5, "clifford"))


@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_jax_quantized_npz_serves_jax_outputs(mlp_flat, mode, tmp_path):
    """A params.npz that the JAX package quantized loads into ``Serving``,
    whose answers are JAX's on JAX's own dequantization."""
    np.savez(tmp_path / "params.npz", **jax_quantize(mlp_flat, mode))
    srv = serving.Serving(MLPVAE(32, 5, "clifford"),
                          params=serving.load_params_npz(
                              tmp_path / "params.npz"), device="cpu")
    params = _unflatten_params(jax.tree_util.tree_map(
        jnp.asarray, jax_dequantize(jax_quantize(mlp_flat, mode))))
    fns = serving_fns(jnn.MLPVAE(h_dim=32, z_dim=5, distribution="clifford"),
                      IMG)
    x = _images(IMG, 4, 0)
    assert _rel(srv.encode_mu(x).numpy(),
                jax.jit(fns["encode_mu"])(params, x)) <= BAR
    z = np.asarray(jax.jit(fns["decode"])(params, np.ones((4, 10),
                                                          np.float32)))
    assert _rel(srv.decode(np.ones((4, 10), np.float32)).numpy(), z) <= BAR


@pytest.fixture(scope="module")
def f32_bundle(mlp_flat, tmp_path_factory):
    d = tmp_path_factory.mktemp("f32")
    serving.export_serving(MLPVAE(32, 5, "clifford"), mlp_flat, IMG,
                           out_dir=str(d), platforms=("cpu",))
    return d


@pytest.mark.parametrize("mode,max_err,shrink", [
    ("bfloat16", 5e-3, 1.6), ("int8", 5e-2, 2.5)])
def test_quantized_params_storage(mlp_flat, f32_bundle, tmp_path, mode,
                                  max_err, shrink):
    """params_dtype quantizes only the stored weights: params.npz shrinks,
    the programs are the float32 bundle's, and the answers stay close to
    it (the JAX package's bars, tests/test_export.py)."""
    res = serving.export_serving(MLPVAE(32, 5, "clifford"), mlp_flat, IMG,
                                 out_dir=str(tmp_path), platforms=("cpu",),
                                 params_dtype=mode)
    assert res["manifest"]["params_dtype"] == mode
    s32 = (f32_bundle / "params.npz").stat().st_size
    sq = (tmp_path / "params.npz").stat().st_size
    assert s32 / sq > shrink
    srv32 = serving.load_serving(str(f32_bundle), device="cpu")
    srvq = serving.load_serving(str(tmp_path), device="cpu")
    x = _images(IMG, 3, 2)
    mu32, muq = srv32.encode_mu(x).numpy(), srvq.encode_mu(x).numpy()
    err = np.abs(mu32 - muq).max() / (np.abs(mu32).max() + 1e-9)
    assert err < max_err, err


def test_export_model_writes_a_bundle_of_the_checkpoint(tmp_path, capsys):
    """``export_model`` on a port checkpoint: JAX's JSON summary, and a
    bundle that answers as the checkpoint's model does."""
    st = create_train_state(MLPVAE(128, 5, "clifford", seed=3), "adam", 1e-3,
                            device="cpu")
    save_checkpoint(str(tmp_path / "ckpt"), st)
    out = str(tmp_path / "bundle")
    rc = export_model.main([
        "--ckpt", str(tmp_path / "ckpt"), "--arch", "mlp",
        "--distribution", "clifford", "--latent_dim", "5",
        "--img_size", "28", "--platforms", "cpu", "--device", "cpu",
        "--outdir", out])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary == {"outdir": out, "model_class": "MLPVAE",
                       "distribution": "clifford", "flat_z_dim": 10,
                       "platforms": ["cpu"],
                       "batch": {"encode_mu": "symbolic",
                                 "encode_z": "symbolic",
                                 "decode": "symbolic"}}
    loaded = serving.load_serving(out, device="cpu")
    srv = serving.Serving(st.model, device="cpu")
    x = _images(IMG, 3, 5)
    assert torch.equal(loaded.encode_mu(x), srv.encode_mu(x))
    assert torch.equal(loaded.encode_z((0, 3), x),
                       srv.encode_z(random.sample_key((0, 3)), x))
    defaults = vars(export_model.build_parser().parse_args(
        ["--ckpt", "c", "--arch", "mlp", "--distribution", "normal",
         "--latent_dim", "2", "--outdir", "o"]))
    assert defaults["platforms"] == "cuda,cpu" and defaults["device"] is None
    assert export_model.main([
        "--ckpt", str(tmp_path / "none"), "--arch", "mlp",
        "--distribution", "clifford", "--latent_dim", "5", "--device", "cpu",
        "--outdir", out]) == 2


def _narrow_vit(scan_layers=False, fused_proj=False, seed=0):
    from cliffordtpu_torch.nn.vit_vae import CliffordARVAE

    return CliffordARVAE(latent_dim=4, image_size=32, in_channels=1,
                         cnn_chs=[16, 32, 64], z_channels=64,
                         encoder_vit_layers=1, decoder_vit_layers=1,
                         patch_size=4, scan_layers=scan_layers,
                         fused_proj=fused_proj, seed=seed)


@pytest.mark.parametrize("flag", [
    ["--scan_layers"], ["--fused_proj", "--arch", "vit"],
    ["--data_parallel", "2"], ["--native"]])
def test_unported_export_options_raise(flag, tmp_path, monkeypatch):
    """None of the options that raised before raises now.
    ``--scan_layers`` exports a layer-stacked ViT checkpoint;
    ``--fused_proj`` a split one, converted to the fused layout on load;
    ``--data_parallel 2`` a bundle of two replicas (run here as two CPU
    replicas); ``--native`` adds the manifest's native section, its three
    programs traced with the C++ operators and handed to the package
    compile, which is recorded here instead of run (tests/
    test_torch_native_serve.py compiles and serves a package).  Each
    bundle answers as the checkpoint's model does."""
    from cliffordtpu_torch.scripts import eval_checkpoint

    vit = "--data_parallel" not in flag and "--native" not in flag
    scan = "--scan_layers" in flag
    model = (_narrow_vit(scan_layers=scan, seed=4) if vit
             else MLPVAE(32, 5, "clifford", seed=4))
    if vit:
        monkeypatch.setattr(
            eval_checkpoint, "build_model",
            lambda *a, scan_layers=False, fused_proj=False: _narrow_vit(
                scan_layers, fused_proj))
    st = create_train_state(model, "adam", 1e-3, device="cpu")
    save_checkpoint(str(tmp_path), st)
    out = tmp_path / "o"
    argv = ["--ckpt", str(tmp_path), "--arch", "vit" if vit else "mlp",
            "--distribution", "clifford", "--latent_dim",
            "4" if vit else "5", "--device", "cpu", "--platforms", "cpu",
            "--img_size", "32" if vit else "28", "--outdir", str(out),
            *[f for f in flag if f not in ("--arch", "vit")]]
    compiles = []
    if "--native" in flag:
        monkeypatch.setattr(
            serving, "_compile_packages",
            lambda todo, *a: compiles.extend(p for p, _ in todo) or {
                p: 0.0 for p, _ in todo})
    assert export_model.main(argv) == 0
    if "--native" in flag:
        with open(out / "manifest.json") as f:
            nat = json.load(f)["native"]
        assert nat["batch"] == 8 and nat["platforms"] == ["cpu"]
        assert nat["param_order"] == [n for n, _ in model.named_parameters()]
        assert sorted(compiles) == sorted(
            f"{fn}.native.cpu.pt2" for fn in ("encode_mu", "encode_z",
                                              "decode"))
        assert {fn: f["packages"] for fn, f in nat["functions"].items()} \
            == {fn: {"cpu": f"{fn}.native.cpu.pt2"}
                for fn in ("encode_mu", "encode_z", "decode")}
        assert nat["functions"]["encode_z"]["args"][1]["shape"] == [8, *IMG]
    dp = 2 if "--data_parallel" in flag else 1
    loaded = serving.load_serving(str(out), devices=["cpu"] * dp)
    assert loaded.manifest["data_parallel"] == dp
    srv = serving.Serving(model, device="cpu")
    x = _images((32, 32, 1) if vit else IMG, 4, 6)
    np.testing.assert_allclose(loaded.encode_mu(x).numpy(),
                               srv.encode_mu(x).numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        loaded.encode_z((0, 3), x).numpy(),
        srv.encode_z(random.sample_key((0, 3)), x).numpy(), rtol=1e-5,
        atol=1e-5)


def test_export_and_load_refuse_what_they_cannot_do(mlp_flat, f32_bundle,
                                                   tmp_path):
    """native with data_parallel=2 raises at export, as JAX's does;
    data_parallel=2 is recorded (requests a
    multiple of 2, ``encode_z`` taking the four-word rng), and its bundle
    without ``devices`` asks for two cards, which this host lacks; a
    bundle loaded on a device it has no programs for raises, and without
    a device it asks for the card: nothing moves to the CPU."""
    model = MLPVAE(32, 5, "clifford")
    dp_dir = str(tmp_path / "dp2")
    mani = serving.export_serving(model, mlp_flat, IMG, out_dir=dp_dir,
                                  data_parallel=2,
                                  platforms=("cpu",))["manifest"]
    assert mani["data_parallel"] == 2
    assert mani["functions"]["encode_z"]["in"][0]["shape"] == ["4"]
    assert mani["functions"]["encode_mu"]["in"][0]["shape"][0] == "2*b"
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="devices are visible"):
            serving.load_serving(dp_dir)
    with pytest.raises(ValueError, match="divisible"):
        serving.load_serving(dp_dir, devices=["cpu"] * 2).encode_mu(
            _images(IMG, 3, 1))
    with pytest.raises(ValueError, match="data_parallel"):
        serving.export_serving(model, mlp_flat, IMG, native=True,
                               data_parallel=2, platforms=("cpu",))
    with pytest.raises(ValueError, match="not for cuda"):
        serving.load_serving(str(f32_bundle), device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.load_serving(str(f32_bundle))


@pytest.mark.parametrize("family,head", [
    ("cnn", "gaussian"), ("cnn", "powerspherical"), ("mlp", "vmf")])
def test_heads_encode_z_is_the_in_process_draw(family, head, tmp_path):
    """The draw of the registered operator is the eager draw, bit for bit,
    for the heads whose draws loop on the host (powerspherical and vMF
    rejection sampling) or have no kernel (gaussian)."""
    if family == "cnn":
        make, img = (lambda: CNNVAE(16, 1, head, l2_normalize=True)), (
            32, 32, 1)
    else:
        make, img = (lambda: MLPVAE(32, 5, head)), IMG
    serving.export_serving(make(), None, img, out_dir=str(tmp_path),
                           platforms=("cpu",))
    loaded = serving.load_serving(str(tmp_path), device="cpu")
    srv = serving.Serving(make(), device="cpu")
    x = _images(img, 3, 6)
    for rng in ((0, 1), (0, 2)):
        got = loaded.encode_z(rng, x)
        assert torch.isfinite(got).all()
        assert torch.equal(got, srv.encode_z(random.sample_key(rng), x))
