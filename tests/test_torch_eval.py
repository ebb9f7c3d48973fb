"""The port's evaluation battery (cliffordtpu_torch/eval) against
cliffordtpu/eval on the same weights, inputs and keys: ModelHandle over
the tiny HybridVAE (clifford, 16 tokens of latent 4) and a tiny MLPVAE
(clifford, d 5), prior sampling, class means, kNN (the port's "torch"
backend against JAX's "jax" backend on the same numpy rng) and the
numbers of the four binding experiments, with their plots drawn by both
packages under the same file names, and the HRR / unitary baseline
curves of the self-binding plot.  Bars: latents, means and
decodes 5e-4 (whole stacks); prior draws 1e-5 (the normals' erfinv);
similarities after one bind 1e-5, along the depth curves 1e-4 (FFT
rounding grows with every bind), 1e-3 for the deconvolution's (it
divides by each partner's spectrum); kNN predictions, accuracies and the
nearest-mean accuracy exactly."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.eval import binding as jbinding
from cliffordtpu.eval import class_means as jmeans
from cliffordtpu.eval import knn as jknn
from cliffordtpu.eval.adapters import ModelHandle as JaxHandle
from cliffordtpu.eval.prior import sample_prior_z as jax_prior
from cliffordtpu.nn import hybrid_vae as jhybrid
from cliffordtpu.nn.mlp_vae import MLPVAE as JaxMLPVAE
from cliffordtpu.serving import _flatten_params, _unflatten_params
from cliffordtpu_torch.eval import binding as tbinding
from cliffordtpu_torch.eval import class_means as tmeans
from cliffordtpu_torch.eval import knn as tknn
from cliffordtpu_torch.eval.adapters import ModelHandle
from cliffordtpu_torch.eval.prior import sample_prior_z
from cliffordtpu_torch.nn import hybrid_vae, mlp_vae, param_import

torch.set_num_threads(1)

N, IMG, LATENT = 48, 8, 4
RNGS = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
KEY = jax.random.PRNGKey(6)


def _random_params(module, example, seed):
    shapes = jax.eval_shape(module.init, RNGS, example)["params"]
    rng = np.random.default_rng(seed)
    flat = _flatten_params(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    return {k: (rng.normal(size=v.shape) * (
        1 / np.sqrt(np.prod(v.shape[:-1])) if k.endswith("kernel") else 0.1)
                ).astype(np.float32) for k, v in flat.items()}


@pytest.fixture(scope="module", params=["hybrid", "mlp"])
def handles(request):
    """(JAX handle, port handle, images, labels) on the same weights."""
    rng = np.random.default_rng(2)
    y = rng.integers(0, 5, N)
    if request.param == "hybrid":
        jmodel = jhybrid.HybridVAE(latent_dim=LATENT, in_channels=1,
                                   encoder_chs=[8, 16], img_size=IMG)
        x = rng.uniform(-1, 1, (N, IMG, IMG, 1)).astype(np.float32)
        flat = _random_params(jmodel, jnp.zeros((2, IMG, IMG, 1)), 3)
        port = hybrid_vae.HybridVAE(LATENT, 1, encoder_chs=[8, 16],
                                    img_size=IMG)
    else:
        jmodel = JaxMLPVAE(h_dim=128, z_dim=5, distribution="clifford")
        x = rng.uniform(0, 1, (N, 784)).astype(np.float32)
        flat = _random_params(jmodel, jnp.zeros((2, 784)), 4)
        port = mlp_vae.MLPVAE(128, 5, "clifford")
    port.load_state_dict(param_import.from_jax(flat))
    params = _unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    return (request.param, JaxHandle(jmodel, params),
            ModelHandle(port.eval()), x, y)


def _close(got, want, bar):
    want = np.asarray(want)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    assert np.shape(got) == want.shape
    assert np.abs(got - want).max() <= bar


def test_handle_matches_jax(handles):
    """``flat_z`` takes the JAX handle's key (the rng of ``apply``),
    ``latent_mu``, ``decode`` of flat latents, ``collect_flat_z`` (batch s
    drawn with fold_in(key, s)) and the metadata."""
    family, jh, th, x, y = handles
    assert (th.distribution, th.latent_dim, th.num_tokens) == (
        jh.distribution, jh.latent_dim, jh.num_tokens)
    _close(th.flat_z(x[:5], np.asarray(KEY)), jh.flat_z(x[:5], KEY), 5e-4)
    _close(th.latent_mu(x[:5]), jh.latent_mu(x[:5], KEY), 5e-4)
    z = np.asarray(jh.flat_z(x[:5], KEY))
    _close(th.decode(z), jh.decode(z), 5e-4)
    got, got_y = th.collect_flat_z(x, y, np.asarray(KEY), limit=30,
                                   batch=16)
    want, want_y = jh.collect_flat_z(x, y, KEY, limit=30, batch=16)
    _close(got, want, 5e-4)
    assert np.array_equal(got_y, want_y) and len(got_y) == 30


@pytest.mark.parametrize("dist,l2,tokens", [
    ("clifford", False, None), ("clifford", False, 16),
    ("gaussian", False, None), ("gaussian", True, 4),
    ("powerspherical", False, None)])
def test_sample_prior_z_matches_jax(dist, l2, tokens):
    got = sample_prior_z(np.asarray(KEY), dist, 6, 5, l2_normalize=l2,
                         num_tokens=tokens, device="cpu")
    want = jax_prior(KEY, dist, 6, 5, l2_normalize=l2, num_tokens=tokens)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("true_mean", [False, True])
def test_class_means_match_jax(handles, true_mean):
    """The class means (the min(count, 10) divisor unless ``true_mean``)
    and the nearest-mean accuracy, overall and per class."""
    _, jh, th, x, y = handles
    got = tmeans.compute_class_means(th, x, y, batch=20,
                                     key=np.asarray(KEY), true_mean=true_mean)
    want = jmeans.compute_class_means(jh, x, y, batch=20, key=KEY,
                                      true_mean=true_mean)
    assert sorted(got) == sorted(want)
    for label in want:
        _close(got[label], want[label], 5e-4 * max(
            1.0, float(np.abs(np.asarray(want[label])).max())))
    acc, per = tmeans.evaluate_mean_vector_cosine(th, x, y, got, batch=20)
    want_acc, want_per = jmeans.evaluate_mean_vector_cosine(jh, x, y, want,
                                                            batch=20)
    assert (acc, per) == (want_acc, want_per)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_knn_predict_matches_the_jax_backend(metric):
    rng = np.random.default_rng(9)
    X_train = rng.normal(size=(40, 12)).astype(np.float32)
    y_train = rng.integers(0, 10, 40)
    X_test = rng.normal(size=(25, 12)).astype(np.float32)
    assert np.array_equal(
        tknn.knn_predict_torch(X_train, y_train, X_test, metric),
        jknn._knn_predict_jax(X_train, y_train, X_test, metric))


def test_knn_evaluation_matches_the_jax_backend(handles):
    """``perform_knn_evaluation`` with the "torch" backend against JAX's
    "jax" backend: the same subsets from the same numpy rng, the same
    accuracies and macro F1."""
    _, jh, th, x, y = handles
    got = tknn.perform_knn_evaluation(
        th, x[:32], y[:32], x[32:], y[32:], (10, 30), backend="torch",
        rng=np.random.default_rng(0), key=np.asarray(KEY))
    want = jknn.perform_knn_evaluation(
        jh, x[:32], y[:32], x[32:], y[32:], (10, 30), backend="jax",
        rng=np.random.default_rng(0), key=KEY)
    assert got == pytest.approx(want, abs=1e-12)
    with pytest.raises(ValueError, match="backend"):
        tknn.perform_knn_evaluation(th, x, y, x, y, (10,), backend="jax")


def _plots(result, root):
    """The plot paths of a battery result, relative to its output dir."""
    return {k: (None if v is None else os.path.relpath(v, root))
            for k, v in result.items() if "plot" in k}


@pytest.mark.parametrize("handles", ["hybrid"], indirect=True)
def test_binding_battery_matches_jax(handles, tmp_path):
    """The numbers of ``test_self_binding`` (both unbindings),
    ``test_vsa_operations``, ``test_pairwise_bind_bundle_decode`` and
    ``test_cross_class_bind_unbind``, and their plots: both packages draw
    into directories of their own, and the port's files bear the JAX
    package's names."""
    _, jh, th, x, y = handles
    shape = (IMG, IMG, 1)
    k = np.asarray(KEY)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for method in ("*", "†"):
        got = tbinding.test_self_binding(th, x, y, str(tdir), k_self_bind=4,
                                         unbind_method=method, img_shape=shape,
                                         n_trials=3, key=k)
        want = jbinding.test_self_binding(jh, x, y, str(jdir),
                                          k_self_bind=4,
                                          unbind_method=method,
                                          img_shape=shape, n_trials=3,
                                          key=KEY)
        assert got["k_values"] == want["k_values"] == [1, 2, 3, 4]
        assert _plots(got, tdir) == _plots(want, jdir)
        assert got["recon_after_k_binds_plot_path"] is not None
        # the deconvolution divides by every partner's spectrum: each side
        # lies about 1e-4 from the float64 curve on these latents
        bar = 1e-4 if method == "*" else 1e-3
        _close(np.array(got["k_sims"]), want["k_sims"], bar)
        assert abs(got["binding_k_self_similarity"]
                   - want["binding_k_self_similarity"]) <= bar
        if method == "†":
            # self-binding by deconvolution divides the target's spectrum
            # raised to the power m + 1 by itself: in float32 that curve is
            # rounding noise on either side (on these latents it lies up
            # to 0.8 from its float64 value at depth 4), so it is held for
            # the involution only
            continue
        # the self-binding curve, which the JAX function only plots
        all_z, _ = jh.collect_flat_z(x, y, jax.random.split(KEY, 4)[0],
                                     limit=200)
        tidx = jax.random.randint(jax.random.split(KEY, 4)[1], (3,), 0, N)
        targets = all_z[tidx]
        self_want = np.asarray(jbinding._depth_curve_jit(
            targets, jnp.repeat(targets[:, None], 4, 1), method)).mean(0)
        _close(np.array(got["self_k_sims"]), self_want, 1e-4)
    got = tbinding.test_vsa_operations(th, x, y, str(tdir), n_test_pairs=10,
                                       key=k)
    want = jbinding.test_vsa_operations(jh, x, y, str(jdir),
                                        n_test_pairs=10, key=KEY)
    assert abs(got["vsa_bind_unbind_similarity"]
               - want["vsa_bind_unbind_similarity"]) <= 1e-5
    assert _plots(got, tdir) == _plots(want, jdir)
    got = tbinding.test_pairwise_bind_bundle_decode(th, x, y, str(tdir),
                                                    img_shape=shape, key=k)
    want = jbinding.test_pairwise_bind_bundle_decode(
        jh, x, y, str(jdir), img_shape=shape, key=KEY)
    assert abs(got["avg_unbind_similarity"]
               - want["avg_unbind_similarity"]) <= 1e-5
    assert _plots(got, tdir) == _plots(want, jdir)
    got = tbinding.test_cross_class_bind_unbind(th, x, y, str(tdir),
                                                class_a=1, class_b=3,
                                                img_shape=shape, key=k)
    want = jbinding.test_cross_class_bind_unbind(
        jh, x, y, str(jdir), class_a=1, class_b=3, img_shape=shape,
        key=KEY)
    for name, value in want.items():
        if isinstance(value, float):
            assert abs(got[name] - value) <= 1e-5, name
    assert _plots(got, tdir) == _plots(want, jdir)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    # without an output directory: the numbers alone, no plot
    got = tbinding.test_vsa_operations(th, x, y, n_test_pairs=10, key=k)
    assert got["vsa_bind_unbind_plot"] is None


@pytest.mark.parametrize("method", ["*", "†"])
def test_binding_baselines_match_jax(method):
    """The HRR and random-unitary curves that the self-binding plot draws,
    against the JAX function's inline computation (split, fold_in by the
    name's hash, ``hrr_init`` / ``unitary_init``, the depth curve)."""
    from cliffordtpu.utils import stable_hash
    from cliffordtpu.vsa.ops import hrr_init, unitary_init

    k_base = jax.random.split(KEY, 4)[2]
    got = tbinding._baseline_curves(tuple(np.asarray(k_base).tolist()), 5, 32,
                                    3, method, "cpu")
    for bname, init_fn in (("HRR (Random)", hrr_init),
                           ("Random Unitary", unitary_init)):
        bkeys = jax.random.split(
            jax.random.fold_in(k_base, stable_hash(bname) % 97), 3)
        bvecs = jax.vmap(lambda kk: jbinding.normalize_vectors(
            init_fn(kk, 6, 32)))(bkeys)
        want = np.asarray(jbinding._depth_curve_jit(
            bvecs[:, 0], bvecs[:, 1:], method))
        _close(got[bname], want, 1e-4)


def test_depth_curve_degenerates_where_jax_does():
    """Flat latents of 64 unit torus points (norm 8) bound 40 deep leave
    float32's range: the involution's curve turns to 0 and then NaN at
    the same depths in both packages, and agrees within 1e-4 where it is
    finite (the protocol's depth on the card meets this; chip_smoke holds
    its curves to it)."""
    rng = np.random.default_rng(5)
    z = rng.normal(size=(44, 64, 2))
    z = (z / np.linalg.norm(z, axis=-1, keepdims=True)).reshape(44, -1)
    z = z.astype(np.float32)
    targets, partners = z[:3], z[3:43].reshape(1, 40, -1).repeat(3, 0)
    want = np.asarray(jbinding._depth_curve_jit(
        jnp.asarray(targets), jnp.asarray(partners), "*"))
    got = tbinding.depth_curve(torch.from_numpy(targets),
                               torch.from_numpy(partners), "*").numpy()
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    assert finite[:, 0].all() and not finite[:, -1].any()
    assert np.abs(got[finite] - want[finite]).max() <= 1e-4
