"""The port's InceptionV3 (cliffordtpu_torch/eval/inception.py) against
cliffordtpu/eval/inception.py on one npz of seeded random weights (the
variance-keeping recipe of tests/test_inception.py, so input differences
survive all 94 layers): the parameter spec, the loader's folded
BatchNorm and its loud errors, the preprocessing (uint8 levels, the
bilinear half-pixel resize to 299) against ``jax.image.resize`` at 28
and 32 px, the features at batch 2, and ``compute_fid``'s "inception"
label.  Bars: the folded parameters 1e-6 relative; the resize 1e-6 on
[0, 1] images; the features 1e-4 of their largest magnitude (94 float32
convolutions summed in another order, the port with the BatchNorm
scale folded into the weights)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.eval import inception as jinc
from cliffordtpu_torch.eval import fid, inception
from cliffordtpu_torch.eval.adapters import ModelHandle
from cliffordtpu_torch.nn import mlp_vae

torch.set_num_threads(1)


def _random_npz(path, seed=0):
    """He-scaled convs and an identity-like BatchNorm with a ReLU gain (the
    recipe of tests/test_inception.py)."""
    rng = np.random.RandomState(seed)
    arrs = {}
    for key, shape in inception.param_spec().items():
        if key.endswith("running_var"):
            arrs[key] = np.ones(shape, np.float32)
        elif key.endswith("running_mean"):
            arrs[key] = np.zeros(shape, np.float32)
        elif key.endswith("bn.weight"):
            arrs[key] = np.full(shape, 1.4, np.float32)
        elif key.endswith("bn.bias"):
            arrs[key] = (rng.randn(*shape) * 0.02).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            arrs[key] = (rng.randn(*shape) / np.sqrt(fan_in)).astype(
                np.float32)
    np.savez(path, **arrs)
    return str(path)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return _random_npz(tmp_path_factory.mktemp("inception") / "random.npz")


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(3).rand(2, 32, 32, 1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_features(npz, images):
    """One JAX forward for the file."""
    return jinc.inception_features(images, jinc.load_inception_params(npz),
                                   batch=2)


def test_spec_is_the_jax_one():
    assert inception.CONV_DEFS == jinc.CONV_DEFS
    assert inception.param_spec() == jinc.param_spec()
    assert (inception.BN_EPS, inception.FEATURE_DIM, inception.INPUT_SIZE) \
        == (jinc.BN_EPS, jinc.FEATURE_DIM, jinc.INPUT_SIZE)


def test_loader_folds_as_jax_does(npz):
    got = inception.load_inception_params(npz)
    want = jinc.load_inception_params(npz)
    assert list(got) == list(want)
    for name, (w, scale, shift) in want.items():
        gw, gs, gt = got[name]
        assert np.array_equal(gw.transpose(2, 3, 1, 0), np.asarray(w))
        np.testing.assert_allclose(gs, scale, rtol=1e-6)
        np.testing.assert_allclose(gt, shift, rtol=1e-6, atol=1e-7)


def test_load_errors_loudly(tmp_path):
    with pytest.raises(RuntimeError, match="cannot load"):
        inception.load_inception_params(str(tmp_path / "nope.npz"))
    bad = tmp_path / "partial.npz"
    np.savez(bad, **{"Conv2d_1a_3x3.conv.weight":
                     np.zeros((32, 3, 3, 3), np.float32)})
    with pytest.raises(RuntimeError, match="missing array"):
        inception.load_inception_params(str(bad))
    wrong = {k: np.zeros(s, np.float32)
             for k, s in inception.param_spec().items()}
    wrong["Conv2d_1a_3x3.conv.weight"] = np.zeros((32, 3, 5, 5), np.float32)
    np.savez(tmp_path / "wrong.npz", **wrong)
    with pytest.raises(RuntimeError, match="expected"):
        inception.load_inception_params(str(tmp_path / "wrong.npz"))


@pytest.mark.parametrize("size,channels", [(28, 1), (32, 3)])
def test_preprocess_matches_jax_resize(size, channels):
    x = np.random.default_rng(size).uniform(
        -0.1, 1.1, (2, size, size, channels)).astype(np.float32)
    xj = jnp.asarray(x)
    if channels == 1:
        xj = jnp.repeat(xj, 3, axis=-1)
    xj = jnp.round(jnp.clip(xj, 0.0, 1.0) * 255.0) / 255.0
    want = np.asarray(jax.image.resize(xj, (2, 299, 299, 3), "bilinear"))
    got = inception.preprocess(torch.from_numpy(x)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6


def test_features_match_jax(npz, images, jax_features):
    net = inception.InceptionV3Features(
        inception.load_inception_params(npz), "cpu")
    got = inception.inception_features(images, net, batch=2)
    assert got.shape == jax_features.shape == (2, inception.FEATURE_DIM)
    assert np.isfinite(got).all()
    assert np.abs(got[0] - got[1]).mean() > 1e-4  # the input reaches pool3
    scale = np.abs(jax_features).max()
    assert np.abs(got - jax_features).max() <= 1e-4 * scale


def test_compute_fid_labels_inception(npz, monkeypatch):
    """With the variable set, "auto" is "inception" and runs the net the
    npz holds; without it, the same call is the surrogate.  The net reads
    75 px here (the least its stem takes), which the label does not
    depend on: 299 px costs 16 times the work on a loaded host."""
    monkeypatch.setenv("CLIFFORDTPU_INCEPTION", npz)
    monkeypatch.setattr(fid, "_INCEPTION_CACHE", {})
    monkeypatch.setattr(inception, "INPUT_SIZE", 75)
    handle = ModelHandle(mlp_vae.MLPVAE(16, 4, "clifford").eval())
    x = np.random.RandomState(5).rand(4, 28, 28, 1).astype(np.float32) * 2 - 1
    res = fid.compute_fid(handle, x, "clifford", 4, in_channels=1,
                          n_samples=2, batch_size=2)
    assert res["fid_features"] == "inception" and np.isfinite(res["fid"])
    assert list(fid._INCEPTION_CACHE) == [(npz, torch.device("cpu"))]
    monkeypatch.delenv("CLIFFORDTPU_INCEPTION")
    res = fid.compute_fid(handle, x, "clifford", 4, in_channels=1,
                          n_samples=2, batch_size=2)
    assert res["fid_features"] == "random_conv"
