"""The port's VSA operations (cliffordtpu_torch/vsa/ops.py, torch.fft) and
capacity experiments (vsa/capacity.py) against cliffordtpu/vsa, and
random.randint / random.permutation bit for bit against jax.random at the
battery's shapes.  Each op at d 64 and d 65 (odd: no Nyquist bin) within
1e-6; the capacity curves from the same key and the same numpy item
memory: every trial of these draws decides alike on both sides, so the
accuracies agree to the float32 rounding of their mean (1e-6).  With
``plot=True`` both packages draw the same files, the capacity plots'
HRR and unitary baselines from the same keys."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.vsa import capacity as jcap
from cliffordtpu.vsa import ops as jops
from cliffordtpu_torch import random
from cliffordtpu_torch.utils import stable_hash
from cliffordtpu_torch.vsa import capacity as tcap
from cliffordtpu_torch.vsa import ops as tops

torch.set_num_threads(1)


def _vectors(d, n, seed):
    return (np.random.default_rng(seed).normal(size=(n, d))
            / np.sqrt(d)).astype(np.float32)


@pytest.mark.parametrize("d", [64, 65])
def test_ops_match_jax(d):
    a, b = _vectors(d, 6, d), _vectors(d, 6, d + 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    perm = np.random.default_rng(d).permutation(d)

    def close(got, want, bar=1e-6):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= bar

    close(tops.bind(ta, tb), jops.bind(a, b))
    assert np.array_equal(tops.invert(ta).numpy(), np.asarray(
        jops.invert(a)))
    for method in ("inv", "*"):
        close(tops.unbind(ta, tb, method), jops.unbind(a, b, method))
    # the deconvolution divides by rfft(b): exact for a unitary b, and for
    # a random b held relative to its spectrum's condition number
    u = np.array(jops.unitary_init(jax.random.PRNGKey(d), 6, d))
    for method in ("deconv", "†", "dagger"):
        close(tops.unbind(ta, torch.from_numpy(u), method),
              jops.unbind(a, u, method))
        spec = np.abs(np.fft.rfft(b, axis=-1))
        close(tops.unbind(ta, tb, method), jops.unbind(a, b, method),
              1e-6 * float((spec.max(-1) / spec.min(-1)).max()))
    with pytest.raises(ValueError, match="unbind"):
        tops.unbind(ta, tb, "conv")
    for normalize in (True, False):
        close(tops.bundle(ta, normalize), jops.bundle(a, normalize))
    close(tops.normalize_vectors(ta), jops.normalize_vectors(a))
    close(tops.similarity(ta, tb), jops.similarity(a, b))
    tperm = torch.from_numpy(perm)
    assert np.array_equal(tops.permute_vector(ta, tperm).numpy(),
                          np.asarray(jops.permute_vector(a, perm)))
    assert np.array_equal(tops.unpermute_vector(ta, tperm).numpy(),
                          np.asarray(jops.unpermute_vector(a, perm)))


@pytest.mark.parametrize("d", [64, 65])
def test_initialisers_match_jax_from_the_same_key(d):
    """``unitary_init`` within 1e-6 (its uniforms are jax's bit for bit);
    ``hrr_init`` within 1e-5 relative (the normals' float32 erfinv
    differs from XLA's by a few 1e-6 relative)."""
    key = jax.random.PRNGKey(11 + d)
    u = tops.unitary_init(np.asarray(key), 5, d).numpy()
    assert np.abs(u - np.asarray(jops.unitary_init(key, 5, d))).max() <= 1e-6
    np.testing.assert_allclose(np.abs(np.fft.rfft(u, axis=-1)), 1.0,
                               atol=1e-5)
    h = tops.hrr_init(np.asarray(key), 5, d).numpy()
    want = np.asarray(jops.hrr_init(key, 5, d))
    assert np.abs(h - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n,shape,lo,hi", [
    (200, (10,), 0, 200), (400, (50,), 0, 400), (0, (16,), 0, 10),
    (0, (33,), -5, 70_000), (0, (8,), 3, 3), (0, (64,), 0, 2 ** 31 - 1)])
def test_randint_and_permutation_are_bit_exact(n, shape, lo, hi):
    """``randint`` at the battery's draws (targets among 200 latents, keys
    among 400 means), spans above 2**16 (where jax's uint32 multiplier
    wraps to 0) and an empty range; ``permutation`` of 200, 1000 and
    32768 (two sort rounds) items."""
    key = jax.random.PRNGKey(lo + hi + len(shape))
    got = random.randint(np.asarray(key), shape, lo, hi)
    assert np.array_equal(got.numpy(), np.asarray(
        jax.random.randint(key, shape, lo, hi)))
    if n:
        for m in (n, 1000, 32768):
            assert np.array_equal(
                random.permutation(np.asarray(key), m).numpy(),
                np.asarray(jax.random.permutation(key, m)))


def test_stable_hash_is_the_jax_package_one():
    from cliffordtpu.utils import stable_hash as jax_stable_hash

    for parts in (("HRR",), ("Random Unitary",), ("a", 3, 4.5)):
        assert stable_hash(*parts) == jax_stable_hash(*parts)


MEM = np.random.default_rng(0).normal(size=(60, 64)).astype(np.float32)


def _curves_equal(got, want):
    assert got["k"] == want["k"]
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-6)
    np.testing.assert_allclose(got["std"], want["std"], atol=1e-6)


def test_bundle_capacity_matches_jax(monkeypatch):
    """On the CPU when asked (the card by default: without one it raises),
    and on a tensor memory's own device."""
    key = jax.random.PRNGKey(3)
    kw = dict(d=64, n_items=60, k_range=[2, 8, 40], n_trials=4,
              item_memory=MEM)
    want = jcap.test_bundle_capacity(key=key, **kw)
    _curves_equal(tcap.test_bundle_capacity(key=np.asarray(key),
                                            device="cpu", **kw), want)
    _curves_equal(tcap.test_bundle_capacity(
        key=np.asarray(key), **{**kw, "item_memory": torch.from_numpy(MEM)}),
        want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcap.test_bundle_capacity(key=np.asarray(key), **kw)


@pytest.mark.parametrize("random_roles,braiding,method", [
    (True, False, "inv"), (False, False, "†"), (True, True, "inv")])
def test_role_filler_capacity_matches_jax(random_roles, braiding, method):
    key = jax.random.PRNGKey(4)
    kw = dict(d=64, n_items=60, k_range=[2, 6], n_trials=4, item_memory=MEM,
              bind_with_random=random_roles, use_braiding=braiding,
              unbind_method=method)
    _curves_equal(tcap.test_binding_unbinding_pairs(key=np.asarray(key),
                                                    device="cpu", **kw),
                  jcap.test_binding_unbinding_pairs(key=key, **kw))


@pytest.mark.parametrize("braid", ["none", "per_item", "per_class"])
def test_per_class_similarity_matrix_matches_jax(braid):
    """Given memory and labels, with each braiding, within 1e-6; and
    memory and labels drawn from the key (``hrr_init``, ``randint``):
    the same items chosen, the matrix within 1e-5."""
    key = jax.random.PRNGKey(5)
    labels = np.random.default_rng(1).integers(0, 5, 60)
    kw = dict(d=64, n_items=60, n_classes=5, items_per_class=2,
              item_memory=MEM, use_braiding=braid != "none",
              per_class_braid=braid == "per_class")
    got = tcap.test_per_class_bundle_capacity_k_items(
        key=np.asarray(key), labels=labels, device="cpu", **kw)
    want = jcap.test_per_class_bundle_capacity_k_items(
        key=key, labels=jnp.asarray(labels), **kw)
    assert got["n_bundles"] == want["n_bundles"] == 10
    assert np.abs(got["avg_similarity_matrix"]
                  - want["avg_similarity_matrix"]).max() <= 1e-6
    if braid == "none":
        got = tcap.test_per_class_bundle_capacity_k_items(
            d=64, n_items=60, n_classes=5, key=np.asarray(key),
            device="cpu")
        want = jcap.test_per_class_bundle_capacity_k_items(
            d=64, n_items=60, n_classes=5, key=key)
        assert got["n_bundles"] == want["n_bundles"]
        assert np.abs(got["avg_similarity_matrix"]
                      - want["avg_similarity_matrix"]).max() <= 1e-5


def test_capacity_plots_match_jax(tmp_path, monkeypatch):
    """``plot=True`` in each experiment: the curves as without it, the same
    file names in ``save_dir``, and the baselines the capacity plots
    recompute (from fold_in(key, 999 / 998), then stable_hash of the
    name) equal to the JAX ones, captured where each package's plot
    helper calls the experiment again."""
    key = jax.random.PRNGKey(6)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    labels = np.random.default_rng(2).integers(0, 3, 60)
    images = np.random.default_rng(3).uniform(-1, 1, (60, 4, 4, 1))
    runs = [("test_bundle_capacity", dict(k_range=[16], n_trials=3)),
            ("test_binding_unbinding_pairs",
             dict(k_range=[12], n_trials=3)),
            ("test_per_class_bundle_capacity_k_items",
             dict(n_classes=3, items_per_class=2, labels=labels,
                  item_images=images))]
    seen = {"jax": [], "port": []}
    for side, mod in (("jax", jcap), ("port", tcap)):
        for name in ("test_bundle_capacity", "test_binding_unbinding_pairs"):
            real = getattr(mod, name)

            def wrapped(*args, real=real, side=side, **kw):
                out = real(*args, **kw)
                if kw.get("plot") is False:  # a baseline of the plot
                    seen[side].append(out)
                return out

            monkeypatch.setattr(mod, name, wrapped)
    for name, kw in runs:
        kw = dict(d=64, n_items=60, item_memory=MEM, plot=True, **kw)
        want = getattr(jcap, name)(key=key, save_dir=jdir, **kw)
        got = getattr(tcap, name)(key=np.asarray(key), save_dir=tdir,
                                  device="cpu", **kw)
        if "k" in want:
            _curves_equal(got, want)
        else:
            assert np.abs(got["avg_similarity_matrix"]
                          - want["avg_similarity_matrix"]).max() <= 1e-6
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "bundle_capacity.png", "bundle_similarity_matrix.png",
        "role_filler_capacity.png"]
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for got, want in zip(seen["port"], seen["jax"]):
        _curves_equal(got, want)
    assert min(a for r in seen["jax"] for a in r["accuracy"]) < 1.0
