"""Binding-depth and bind / bundle decode experiments (port of
``cliffordtpu/eval/binding.py``): the numbers of each, from the keys the
JAX functions derive.

The depth curve binds a target to partners p_1 .. p_M and, for every
depth m, unbinds p_m .. p_1 again; the JAX package runs a masked loop of
M unbinds per depth, the port one batched unbind per step over the
depths still unbinding, which gives the same vectors.  The plots and the
decoded image grids are not ported (they wait for ``eval/plots.py``):
``output_dir`` must be None and the plot paths come back None.

The names start with ``test_`` as the JAX ones do; they are evaluations,
not tests, and carry ``__test__ = False``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.vsa.ops import (
    bind,
    normalize_vectors,
    similarity,
    unbind,
)


def _no_plot(output_dir: Optional[str]):
    if output_dir is not None:
        raise NotImplementedError("the battery's plots are not ported; pass "
                                  "output_dir=None")


def depth_curve(targets: torch.Tensor, partners: torch.Tensor,
                unbind_method: str) -> torch.Tensor:
    """cos(unbind^m(bind^m(target, p_1..p_m)), target) for m = 1 .. M:
    targets (T, d), partners (T, M, d) -> (T, M)."""
    M = partners.shape[1]
    bounds, bound = [], targets
    for m in range(M):
        bound = bind(bound, partners[:, m])
        bounds.append(bound)
    rec = torch.stack(bounds, 1)  # depth j + 1 at index j
    for i in range(M):
        # step i unbinds partner j - i at every depth j >= i
        rec[:, i:] = unbind(rec[:, i:], partners[:, :M - i],
                            method=unbind_method)
    return similarity(rec, targets[:, None])


def test_self_binding(handle, x, y, output_dir: Optional[str] = None,
                      k_self_bind: int = 40, unbind_method: str = "*",
                      img_shape=(28, 28, 1), n_trials: int = 10,
                      key=None) -> Dict:
    """The binding-depth test on up to 200 sampled latents: n_trials
    targets bound to themselves (``self_k_sims``) and to random other
    latents (``k_sims``), depths 1 .. min(k_self_bind, n - 1);
    ``binding_k_self_similarity`` is the random-partner curve's last
    point."""
    _no_plot(output_dir)
    key = (0, 0) if key is None else key
    k_enc, k_sel, _, _ = random.split_words(key, 4)
    all_z, _ = handle.collect_flat_z(x, y, k_enc, limit=200)
    if handle.distribution == "gaussian":
        all_z = normalize_vectors(all_z)
    n = all_z.shape[0]
    max_depth = min(k_self_bind, n - 1)
    dev = all_z.device
    targets = all_z[random.randint(k_sel, (n_trials,), 0, n, device=dev)]
    self_sims = depth_curve(
        targets, targets[:, None].expand(-1, max_depth, -1), unbind_method)
    pkeys = random.split_words(random.fold_in_words(k_sel, 1), n_trials)
    pidx = torch.stack([random.permutation(k, n, dev)[:max_depth]
                        for k in pkeys])
    rand_means = depth_curve(targets, all_z[pidx], unbind_method).mean(0)
    return {
        "binding_k_self_similarity": (float(rand_means[-1])
                                      if len(rand_means) else 0.0),
        "similarity_after_k_binds_plot_path": None,
        "recon_after_k_binds_plot_path": None,
        "k_sims": rand_means.tolist(),
        "self_k_sims": self_sims.mean(0).tolist(),
        "k_values": list(range(1, max_depth + 1)),
    }


def test_vsa_operations(handle, x, y, output_dir: Optional[str] = None,
                        n_test_pairs: int = 50, unbind_method: str = "*",
                        normalize: bool = True, key=None) -> Dict:
    """The mean cosine of unbind(bind(k, v), k) to v over posterior means:
    values the first m, keys drawn with ``randint``."""
    _no_plot(output_dir)
    key = (0, 0) if key is None else key
    k_enc, k_pick = random.split_words(key)
    z_all = handle.latent_mu(x[:n_test_pairs * 2], k_enc)
    if handle.distribution == "powerspherical" or normalize:
        z_all = normalize_vectors(z_all)
    n = z_all.shape[0]
    m = min(n_test_pairs, n // 2)
    keys_v = z_all[random.randint(k_pick, (m,), 0, n, device=z_all.device)]
    values = z_all[:m]
    sims = similarity(unbind(bind(keys_v, values), keys_v,
                             method=unbind_method), values)
    return {"vsa_bind_unbind_similarity": (float(sims.mean()) if len(sims)
                                           else 0.0),
            "vsa_bind_unbind_plot": None}


def test_pairwise_bind_bundle_decode(handle, x, y,
                                     output_dir: Optional[str] = None,
                                     img_shape=(32, 32, 1),
                                     unbind_method: str = "*",
                                     class_names=None, key=None) -> Dict:
    """For every pair of the first ten classes' first sampled latents:
    the mean cosine of each one recovered from their binding."""
    _no_plot(output_dir)
    key = (0, 0) if key is None else key
    z_all, labels = handle.collect_flat_z(x, y, key, limit=400)
    reps = {}
    for c in np.unique(labels)[:10]:
        idx = np.where(labels == c)[0]
        if len(idx):
            reps[int(c)] = int(idx[0])
    classes = sorted(reps)
    pairs = [(a, b) for i, a in enumerate(classes) for b in classes[i + 1:]]
    if not pairs:
        return {"avg_unbind_similarity": 0.0, "plot_path": None}
    za = z_all[[reps[a] for a, _ in pairs]]
    zb = z_all[[reps[b] for _, b in pairs]]
    bound = bind(za, zb)
    sims = 0.5 * (similarity(unbind(bound, zb, method=unbind_method), za)
                  + similarity(unbind(bound, za, method=unbind_method), zb))
    return {"avg_unbind_similarity": float(sims.mean()), "plot_path": None}


def test_cross_class_bind_unbind(handle, x, y,
                                 output_dir: Optional[str] = None,
                                 class_a: int = 6, class_b: int = 9,
                                 img_shape=(28, 28, 1), class_names=None,
                                 key=None) -> Dict:
    """The first sampled latents of two classes (unit vectors for a
    gaussian latent), bound and recovered by each unbinding ("*" and
    "†")."""
    _no_plot(output_dir)
    key = (0, 0) if key is None else key
    z_all, labels = handle.collect_flat_z(x, y, key, limit=400)
    ia = np.where(labels == class_a)[0]
    ib = np.where(labels == class_b)[0]
    if not len(ia) or not len(ib):
        return {"plot_path": None,
                "cross_class_bind_unbind_similarity": 0.0,
                "cross_class_bind_unbind_plot_path": None}
    za, zb = z_all[int(ia[0])], z_all[int(ib[0])]
    if handle.distribution == "gaussian":
        za = za / torch.clamp(torch.linalg.vector_norm(za), min=1e-12)
        zb = zb / torch.clamp(torch.linalg.vector_norm(zb), min=1e-12)
    bound = bind(za, zb)
    sims = {}
    for method in ("*", "†"):
        sims[f"sim_a_{method}"] = float(similarity(
            unbind(bound, zb, method=method), za))
        sims[f"sim_b_{method}"] = float(similarity(
            unbind(bound, za, method=method), zb))
    sim_star = 0.5 * (sims["sim_a_*"] + sims["sim_b_*"])
    sim_dag = 0.5 * (sims["sim_a_†"] + sims["sim_b_†"])
    return {
        "plot_path": None,
        "cross_class_bind_unbind_similarity": 0.5 * (sim_star + sim_dag),
        "cross_class_bind_unbind_similarity_star": sim_star,
        "cross_class_bind_unbind_similarity_dag": sim_dag,
        "cross_class_bind_unbind_plot_path": None,
        **sims,
    }


# evaluations named test_* as the JAX ones are, not pytest tests
test_self_binding.__test__ = False
test_vsa_operations.__test__ = False
test_pairwise_bind_bundle_decode.__test__ = False
test_cross_class_bind_unbind.__test__ = False
