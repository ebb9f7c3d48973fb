"""The port's plots (cliffordtpu_torch/eval/plots.py) against
cliffordtpu/eval/plots.py on the same weights, inputs and keys: tiny
``MLPVAE``s (clifford d 5, normal d 5, powerspherical d 6; 28 px) and a
tiny per-token ``HybridVAE`` (clifford, 16 tokens of latent 4; 8 px).
Both modules draw through a recorder in place of pyplot and of
``_imshow_save``, so every canvas, every image shown and every scatter's
points are compared; one real PNG (the port's t-SNE) is written.  Each
image-grid plot runs on the families whose branches it takes (``PLOTS``:
every plot on the clifford MLP, the per-token and tanh paths on the
hybrid, lerp, slerp and the sphere grids on the other two).  The JAX
handle's ``decode`` / ``latent_mu`` / ``flat_z`` are jitted: the same
functions, compiled once per shape instead of op by op.  Bars:
canvases and images 1e-5 on [0, 1] (5e-4 where a whole stack's latents
pass through a decoder: the hybrid; see test_torch_eval.py), scatter
points and t-SNE inputs 5e-4, ``get_fixed_interp_pairs`` exactly,
``slerp`` / ``lerp`` / ``clifford_manifold_interp`` 1e-6."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.eval import plots as jplots
from cliffordtpu.eval.adapters import ModelHandle as JaxHandle
from cliffordtpu.nn import hybrid_vae as jhybrid
from cliffordtpu.nn.mlp_vae import MLPVAE as JaxMLPVAE
from cliffordtpu.serving import _flatten_params, _unflatten_params
from cliffordtpu_torch.eval import plots
from cliffordtpu_torch.eval.adapters import ModelHandle
from cliffordtpu_torch.nn import hybrid_vae, mlp_vae, param_import

torch.set_num_threads(1)

N = 40
RNGS = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
KEY = jax.random.PRNGKey(7)
MLP_SHAPE, HYB_SHAPE = (28, 28, 1), (8, 8, 1)


def _random_params(module, example, seed):
    shapes = jax.eval_shape(module.init, RNGS, example)["params"]
    rng = np.random.default_rng(seed)
    flat = _flatten_params(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    return {k: (rng.normal(size=v.shape) * (
        1 / np.sqrt(np.prod(v.shape[:-1])) if k.endswith("kernel") else 0.1)
                ).astype(np.float32) for k, v in flat.items()}


FAMILIES = ["mlp-clifford", "mlp-normal", "mlp-powerspherical", "hybrid"]


class _JitHandle(JaxHandle):
    """The JAX handle with its three model calls jitted."""

    @functools.cached_property
    def _fns(self):
        m = self.model
        return (jax.jit(lambda p, z: JaxHandle(m, p).decode(z)),
                jax.jit(lambda p, x: JaxHandle(m, p).latent_mu(x, None)),
                jax.jit(lambda p, x, k: JaxHandle(m, p).flat_z(x, k)))

    def decode(self, z):
        return self._fns[0](self.params, jnp.asarray(z))

    def latent_mu(self, x, key):
        return self._fns[1](self.params, jnp.asarray(x))

    def flat_z(self, x, key):
        return self._fns[2](self.params, jnp.asarray(x), key)


@pytest.fixture(scope="module", params=FAMILIES)
def handles(request):
    """(name, JAX handle, port handle, images, labels, image shape)."""
    rng = np.random.default_rng(FAMILIES.index(request.param))
    y = rng.integers(0, 5, N)
    if request.param == "hybrid":
        jmodel = jhybrid.HybridVAE(latent_dim=4, in_channels=1,
                                   encoder_chs=[8, 16], img_size=8)
        x = rng.uniform(-1, 1, (N, *HYB_SHAPE)).astype(np.float32)
        flat = _random_params(jmodel, jnp.zeros((2, *HYB_SHAPE)), 3)
        port = hybrid_vae.HybridVAE(4, 1, encoder_chs=[8, 16], img_size=8)
        shape = HYB_SHAPE
    else:
        dist = request.param.split("-")[1]
        z = 6 if dist == "powerspherical" else 5
        jmodel = JaxMLPVAE(h_dim=128, z_dim=z, distribution=dist)
        x = rng.uniform(0, 1, (N, *MLP_SHAPE)).astype(np.float32)
        flat = _random_params(jmodel, jnp.zeros((2, 784)), 4)
        port = mlp_vae.MLPVAE(128, z, dist)
        shape = MLP_SHAPE
    port.load_state_dict(param_import.from_jax(flat))
    params = _unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    return (request.param, _JitHandle(jmodel, params),
            ModelHandle(port.eval()), x, y, shape)


class _Recorder:
    """Stands in for pyplot, a figure and its axes: records the images
    shown and the points scattered, ignores everything else."""

    def __init__(self):
        self.log = []

    def imshow(self, img, *args, **kw):
        self.log.append(("imshow", np.array(img, np.float32)))

    def scatter(self, xs, ys, *args, c=None, **kw):
        self.log.append(("scatter", np.stack([np.asarray(xs),
                                              np.asarray(ys)], 1),
                         np.asarray(c)))

    def subplots(self, nrows=1, ncols=1, **kw):
        if nrows == ncols == 1:
            return self, self
        axes = np.empty((nrows, ncols), object)
        for idx in np.ndindex(axes.shape):
            axes[idx] = self
        return self, axes.squeeze()

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return lambda *args, **kw: None


@pytest.fixture
def record(monkeypatch):
    """Swap the recorder in for pyplot and ``_imshow_save`` in both
    modules; returns {"jax": log, "port": log}."""
    logs = {}
    for name, mod in (("jax", jplots), ("port", plots)):
        rec = _Recorder()
        logs[name] = rec.log

        def imshow_save(canvas, path, title, figsize, rec=rec):
            rec.log.append(("canvas", np.array(canvas, np.float32),
                            os.path.basename(path), title))
            return path

        monkeypatch.setattr(mod, "_plt", lambda rec=rec: rec)
        monkeypatch.setattr(mod, "_imshow_save", imshow_save)
    return logs


def _bar(family):
    return 5e-4 if family == "hybrid" else 1e-5


def _same_logs(got, want, bar):
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0]
        if g[0] == "canvas":
            assert g[2:] == w[2:]  # file name and title
        assert g[1].shape == w[1].shape
        assert np.abs(g[1] - w[1]).max() <= bar, g[0]
        if g[0] == "scatter":
            assert np.array_equal(g[2], w[2])


PLOTS = {
    "mlp-clifford": ("plot_reconstructions", "plot_interpolations",
                     "plot_prior_sample_grid",
                     "plot_latent_dimension_exploration",
                     "plot_latent_interpolations", "plot_decoded_bundles",
                     "plot_clifford_manifold_visualization",
                     "plot_clifford_torus_recon_grid"),
    "hybrid": ("plot_reconstructions", "plot_prior_sample_grid",
               "plot_latent_dimension_exploration",
               "plot_latent_interpolations",
               "plot_clifford_manifold_visualization"),
    "mlp-normal": ("plot_latent_interpolations",
                   "plot_gaussian_manifold_visualization"),
    "mlp-powerspherical": ("plot_interpolations",
                           "plot_latent_interpolations",
                           "plot_powerspherical_manifold_visualization"),
}


def test_image_grid_canvases_match_jax(handles, record, tmp_path):
    """The image-grid plots of the family (``PLOTS``): reconstructions,
    the two-image interpolation, the prior grid, the manifold grids, the
    traversal, the fixed-pair interpolations and the decoded bundles."""
    family, jh, th, x, y, shape = handles
    k, d = np.asarray(KEY), str(tmp_path)
    # every grid decodes 9 latents at a time, so the JAX side compiles its
    # decoder once per family
    calls = [
        ("plot_reconstructions", (x, os.path.join(d, "r.png")),
         dict(img_shape=shape)),
        ("plot_interpolations", (x, y, os.path.join(d, "i.png")),
         dict(steps=9, img_shape=shape)),
        ("plot_prior_sample_grid", (d,), dict(n_samples=9, img_shape=shape)),
        ("plot_latent_dimension_exploration", (x, d),
         dict(n_dims_to_explore=3, n_steps=3, img_shape=shape)),
        ("plot_latent_interpolations",
         (jplots.get_fixed_interp_pairs(x, y, n_pairs=2), d),
         dict(n_steps=9, img_shape=shape)),
        ("plot_decoded_bundles", (x, y, os.path.join(d, "b.png")),
         dict(n_samples=30, max_bundle_size=3)),
        ("plot_clifford_manifold_visualization", (d,),
         dict(n_grid=3, img_shape=shape)),
        ("plot_clifford_torus_recon_grid", (d,),
         dict(n_grid=3, img_shape=shape)),
        ("plot_gaussian_manifold_visualization", (d,),
         dict(img_shape=shape)),
        ("plot_powerspherical_manifold_visualization", (d,),
         dict(img_shape=shape)),
    ]
    calls = [c for c in calls if c[0] in PLOTS[family]]
    assert len(calls) == len(PLOTS[family])
    keyless = ("plot_clifford_manifold_visualization",
               "plot_clifford_torus_recon_grid")
    for name, args, kw in calls:
        want = getattr(jplots, name)(jh, *args, **kw,
                                     **({} if name in keyless
                                        else {"key": KEY}))
        got = getattr(plots, name)(th, *args, **kw,
                                   **({} if name in keyless
                                      else {"key": k}))
        assert got == want, name
    _same_logs(record["port"], record["jax"], _bar(family))


def test_scatter_points_and_tsne_inputs_match_jax(handles, record,
                                                  tmp_path):
    family, jh, th, x, y, _ = handles
    got = plots.latent_space_points(th, x, y, n_plot=20)
    want = np.asarray(jh.latent_mu(x[:20], KEY))
    assert np.abs(got[0] - want).max() <= 5e-4
    assert np.array_equal(got[1], y[:20])
    for mod, h, k in ((jplots, jh, KEY), (plots, th, np.asarray(KEY))):
        path = mod.plot_clifford_torus_latent_scatter(h, x, y, str(tmp_path),
                                                      key=k)
        assert (path is None) == (family not in ("mlp-clifford", "hybrid"))
    if family in ("mlp-clifford", "hybrid"):
        _same_logs(record["port"], record["jax"], 5e-4)


def test_tsne_writes_a_png(tmp_path):
    """scikit-learn's t-SNE and matplotlib, for real: one panel, and the
    multi-perplexity figure under the JAX name."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (20, *MLP_SHAPE)).astype(np.float32)
    y = rng.integers(0, 5, 20)
    th = ModelHandle(mlp_vae.MLPVAE(128, 5, "clifford").eval())
    path = str(tmp_path / "tsne.png")
    assert plots.plot_latent_space(th, x, y, path, n_plot=20) == path
    multi = plots.plot_multi_perplexity_tsne(th, x, y, str(tmp_path),
                                             perplexities=(5, 30), n_plot=20)
    assert os.path.basename(multi) == "tsne_multi_perplexity.png"
    assert os.path.getsize(multi) > 1000
    assert os.path.getsize(path) > 1000


def test_get_fixed_interp_pairs_is_exact():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(60, 4, 4, 1)).astype(np.float32)
    y = rng.integers(0, 10, 60)
    got = plots.get_fixed_interp_pairs(x, torch.from_numpy(y), n_pairs=5)
    want = jplots.get_fixed_interp_pairs(x, y, n_pairs=5)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g[2:] == w[2:]
        assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


@pytest.mark.parametrize("t", [0.0, 0.3, 1.0])
def test_interpolation_helpers_match_jax(t):
    rng = np.random.default_rng(1)
    z1, z2 = rng.normal(size=(2, 3, 12)).astype(np.float32)
    for name in ("slerp", "lerp"):
        got = getattr(plots, name)(torch.from_numpy(z1),
                                   torch.from_numpy(z2), t)
        want = getattr(jplots, name)(jnp.asarray(z1), jnp.asarray(z2), t)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6
    same = plots.slerp(torch.from_numpy(z1), torch.from_numpy(z1), t)
    assert np.abs(same.numpy() - np.asarray(jplots.slerp(
        jnp.asarray(z1), jnp.asarray(z1), t))).max() <= 1e-6
    a1, a2 = rng.uniform(-np.pi, np.pi, (2, 3, 6)).astype(np.float32)
    from cliffordtpu.ops.torus import angles_to_torus as jtorus

    p1, p2 = np.array(jtorus(jnp.asarray(a1))), np.array(
        jtorus(jnp.asarray(a2)))
    got = plots.clifford_manifold_interp(torch.from_numpy(p1),
                                         torch.from_numpy(p2), t, 6)
    want = jplots.clifford_manifold_interp(jnp.asarray(p1), jnp.asarray(p2),
                                           t, 6)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6
