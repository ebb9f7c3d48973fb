"""The port's FID (cliffordtpu_torch/eval/fid.py) against
cliffordtpu/eval/fid.py: the host Fréchet distance, the seed-42
random-conv surrogate (28 px of one channel and 32 px of three, where
"SAME" padding at stride 2 pads (0, 1)), and ``compute_fid`` on a tiny
``MLPVAE`` (z 4, clifford) and a tiny ``CNNVAE`` (latent 16, three
channels) on weights carried by ``param_import``.  The images each
extractor sees are captured on both sides.  Bars: the Fréchet distance
exactly (the same numpy code on the same features); surrogate features
1e-4 of their largest magnitude (four float32 convolutions summed in
another order); prior decodes 1e-5 on [0, 1] images; FID 1e-3
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.eval import fid as jfid
from cliffordtpu.eval.adapters import ModelHandle as JaxHandle
from cliffordtpu.nn import conv_vae as jconv
from cliffordtpu.nn.mlp_vae import MLPVAE as JaxMLPVAE
from cliffordtpu.serving import _flatten_params, _unflatten_params
from cliffordtpu_torch.eval import fid
from cliffordtpu_torch.eval.adapters import ModelHandle
from cliffordtpu_torch.nn import conv_vae, mlp_vae, param_import

torch.set_num_threads(1)

RNGS = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
KEY = jax.random.PRNGKey(3)


def _random_params(module, example, seed):
    shapes = jax.eval_shape(module.init, RNGS, example)["params"]
    rng = np.random.default_rng(seed)
    flat = _flatten_params(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    return {k: (rng.normal(size=v.shape) * (
        1 / np.sqrt(np.prod(v.shape[:-1])) if k.endswith("kernel") else 0.1)
                ).astype(np.float32) for k, v in flat.items()}


def test_frechet_is_the_jax_function():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(40, 16)) @ rng.normal(size=(16, 16))
    b = rng.normal(size=(40, 16)) * 1.3 + 0.2
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0),
            np.cov(b, rowvar=False))
    assert fid._frechet(*args) == jfid._frechet(*args)
    assert np.array_equal(fid._sqrtm_psd(args[1]), jfid._sqrtm_psd(args[1]))


@pytest.mark.parametrize("size,channels", [(28, 1), (32, 3)])
def test_random_conv_features_match_jax(size, channels):
    imgs = np.random.default_rng(size).uniform(
        0, 1, (4, size, size, channels)).astype(np.float32)
    want = jfid._get_features(imgs, "random_conv")
    got = fid._get_features(imgs, "random_conv", device="cpu")
    assert got.shape == want.shape == (4, 512)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_same_padding_is_asymmetric():
    """At 32 -> 16 "SAME" pads (0, 1); at 7 -> 4 it pads (1, 1)."""
    assert fid._same_pads(32) == fid._same_pads(28) == (0, 1)
    assert fid._same_pads(7) == (1, 1)


def _mlp():
    jmodel = JaxMLPVAE(h_dim=16, z_dim=4, distribution="clifford")
    flat = _random_params(jmodel, jnp.zeros((2, 784)), 1)
    port = mlp_vae.MLPVAE(16, 4, "clifford")
    x = np.random.default_rng(1).uniform(-1, 1, (8, 28, 28, 1))
    return jmodel, flat, port, x.astype(np.float32), 1


def _cnn():
    jmodel = jconv.CNNVAE(latent_dim=16, in_channels=3,
                          distribution="clifford")
    flat = _random_params(jmodel, jnp.zeros((2, 32, 32, 3)), 2)
    port = conv_vae.CNNVAE(16, 3)
    x = np.random.default_rng(2).uniform(-1, 1, (8, 32, 32, 3))
    return jmodel, flat, port, x.astype(np.float32), 3


def _capture(monkeypatch, module):
    """Record the images ``_get_features`` is given (real, then fake)."""
    seen, real = [], module._get_features

    def wrapped(images01, extractor, *args, **kw):
        seen.append(np.array(images01))
        return real(images01, extractor, *args, **kw)

    monkeypatch.setattr(module, "_get_features", wrapped)
    return seen


@pytest.mark.parametrize("family", [_mlp, _cnn], ids=["mlp", "cnn"])
def test_compute_fid_matches_jax(family, monkeypatch):
    jmodel, flat, port, x, channels = family()
    port.load_state_dict(param_import.from_jax(flat))
    jh = JaxHandle(jmodel, _unflatten_params(
        {k: jnp.asarray(v) for k, v in flat.items()}))
    th = ModelHandle(port.eval())
    monkeypatch.delenv("CLIFFORDTPU_INCEPTION", raising=False)
    j_seen, t_seen = _capture(monkeypatch, jfid), _capture(monkeypatch, fid)
    d = jmodel.z_dim if channels == 1 else jmodel.latent_dim
    want = jfid.compute_fid(jh, x, "clifford", d, in_channels=channels,
                            n_samples=8, batch_size=4, key=KEY)
    got = fid.compute_fid(th, x, "clifford", d, in_channels=channels,
                          n_samples=8, batch_size=4, key=np.asarray(KEY))
    assert got["fid_features"] == want["fid_features"] == "random_conv"
    assert np.array_equal(t_seen[0], j_seen[0])  # the real images
    assert t_seen[1].shape == j_seen[1].shape == x.shape
    assert np.abs(t_seen[1] - j_seen[1]).max() <= 1e-5  # prior decodes
    assert np.isfinite(got["fid"])
    assert abs(got["fid"] - want["fid"]) <= 1e-3 * abs(want["fid"])


def test_extractor_labels_and_errors(monkeypatch):
    """Unknown extractors raise; "inception" without the variable raises
    (never a silent surrogate); "auto" without it is the surrogate."""
    imgs = np.random.default_rng(4).uniform(0, 1, (2, 28, 28, 1))
    with pytest.raises(ValueError, match="unknown feature extractor"):
        fid._get_features(imgs, "not_an_extractor", device="cpu")
    monkeypatch.delenv("CLIFFORDTPU_INCEPTION", raising=False)
    with pytest.raises(RuntimeError, match="CLIFFORDTPU_INCEPTION"):
        fid._get_features(imgs, "inception", device="cpu")
    port = mlp_vae.MLPVAE(16, 4, "clifford")
    res = fid.compute_fid(ModelHandle(port.eval()), imgs * 2 - 1,
                          "clifford", 4, in_channels=1, n_samples=2,
                          batch_size=2)
    assert res["fid_features"] == "random_conv" and np.isfinite(res["fid"])
