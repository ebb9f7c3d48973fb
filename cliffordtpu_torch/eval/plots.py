"""Visualisations (port of ``cliffordtpu/eval/plots.py``), with the JAX
package's file names, titles, keys and canvases.

Each plot has a device half and a drawing half.  The device half
(``*_canvas``, ``*_points``, ``decoded_bundle_images``) encodes, draws and
decodes on the handle's device and returns what is drawn as numpy: an
image canvas in [0, 1], or the points of a scatter.  The drawing half
(``plot_*``) takes matplotlib lazily, inside the function, as the JAX
package does, and writes the file; the card has no matplotlib, so it runs
the device halves only.  Image grids are drawn by ``_imshow_save``, the
JAX helper's name.  Keys are pairs of uint32 words (a raw
``jax.random.PRNGKey``), (0, 0) by default, with ``fold_in`` where the
JAX code folds.
"""

from __future__ import annotations

import math
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.eval.adapters import to_numpy
from cliffordtpu_torch.eval.prior import sample_prior_z
from cliffordtpu_torch.ops.torus import (
    angles_to_torus,
    torus_to_angles,
    wrap_angle,
)
from cliffordtpu_torch.utils import pyplot as _plt


def _key(key):
    return (0, 0) if key is None else key


def to_image(handle, x_recon: torch.Tensor) -> torch.Tensor:
    """The JAX helper's name for ``ModelHandle.to_image``."""
    return handle.to_image(x_recon)


def _grid(imgs: np.ndarray, n_cols: int, pad: float = 0.5) -> np.ndarray:
    """Tile (N, H, W, C) into a padded grid image (like torchvision
    make_grid with pad_value)."""
    n, h, w, c = imgs.shape
    n_rows = (n + n_cols - 1) // n_cols
    canvas = np.full(((h + 2) * n_rows, (w + 2) * n_cols, c), pad,
                     dtype=np.float32)
    for i in range(n):
        r, cc = divmod(i, n_cols)
        canvas[r * (h + 2) + 1:r * (h + 2) + 1 + h,
               cc * (w + 2) + 1:cc * (w + 2) + 1 + w] = imgs[i]
    return canvas


def _tile(imgs: np.ndarray, n_rows: int, n_cols: int) -> np.ndarray:
    """(n_rows * n_cols, H, W, C) images edge to edge, row-major, float32."""
    _, h, w, c = imgs.shape
    return imgs.reshape(n_rows, n_cols, h, w, c) \
        .transpose(0, 2, 1, 3, 4).reshape(n_rows * h, n_cols * w, c) \
        .astype(np.float32)


def _imshow_save(canvas, path, title, figsize):
    plt = _plt()
    plt.figure(figsize=figsize)
    if canvas.shape[-1] == 1:
        plt.imshow(canvas[..., 0], cmap="gray")
    else:
        plt.imshow(canvas)
    plt.title(title)
    plt.axis("off")
    plt.savefig(path, dpi=200, bbox_inches="tight")
    plt.close()
    return path


# ---- reconstructions and the two-image interpolation ----


def reconstructions_canvas(handle, x, img_shape=(28, 28, 1), key=None
                           ) -> np.ndarray:
    """The first 8 images over their reconstructions: the model's forward
    pass with the rng of JAX's ``apply`` (its sampling key
    ``random.sample_key(key)``), as a padded 2 x 8 grid."""
    key = _key(key)
    xb = handle._input(x[:8])
    with torch.inference_mode():
        if type(handle.model).__name__ == "MLPVAE":
            recon = handle.model(xb.reshape(8, -1),
                                 random.sample_key(key))[-1]
            origs = to_numpy(xb)
        else:
            recon = handle.model(xb, random.sample_key(key))[0]
            origs = to_numpy(torch.clamp(xb * 0.5 + 0.5, 0, 1))
        recons = to_numpy(handle.to_image(recon)).reshape(8, *img_shape)
    return _grid(np.concatenate([origs.reshape(8, *img_shape), recons], 0),
                 8)


def plot_reconstructions(handle, x, filepath, img_shape=(28, 28, 1),
                         key=None):
    """Top originals / bottom reconstructions."""
    return _imshow_save(
        reconstructions_canvas(handle, x, img_shape, key), filepath,
        "Top: Original Images | Bottom: Reconstructed Images", (10, 3))


def interpolations_canvas(handle, x, y, steps: int = 10,
                          img_shape=(28, 28, 1), key=None) -> np.ndarray:
    """The posterior means of the first image and of the first of another
    class, interpolated in ``steps``: clifford in angles with wraparound,
    embedded and scaled by sqrt(2d) (the reference's norm="ortho" iFFT,
    kept as the JAX package keeps it); powerspherical / vmf on the sphere
    by normalised lerp; the others by lerp."""
    y = to_numpy(y)
    idx1 = int(np.argmax(y == y[0]))
    idx2 = int(np.argmax(y != y[0]))
    z1 = handle.latent_mu(x[idx1:idx1 + 1])
    z2 = handle.latent_mu(x[idx2:idx2 + 1])
    alphas = torch.linspace(0, 1, steps, device=z1.device)[:, None]
    dist = handle.distribution
    if dist == "clifford":
        delta = (z2 - z1 + math.pi) % (2 * math.pi) - math.pi
        interp = z1 + alphas * delta
        interp_z = angles_to_torus(interp) * math.sqrt(2 * interp.shape[-1])
    elif dist in ("powerspherical", "vmf"):
        z = (1 - alphas) * z1 + alphas * z2
        interp_z = z / torch.clamp(torch.linalg.vector_norm(
            z, dim=-1, keepdim=True), min=1e-12)
    else:
        interp_z = (1 - alphas) * z1 + alphas * z2
    return _grid(handle.decode_images(interp_z, img_shape), steps)


def plot_interpolations(handle, x, y, filepath, steps: int = 10,
                        img_shape=(28, 28, 1), key=None):
    """Two-image latent interpolation."""
    return _imshow_save(
        interpolations_canvas(handle, x, y, steps, img_shape, key), filepath,
        f"Latent Space Interpolation ({handle.distribution.upper()}-VAE)",
        (12, 2))


# ---- t-SNE and the phase-angle scatter ----


def latent_space_points(handle, x, y, n_plot: int = 1000, key=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The t-SNE input: posterior means of the first ``n_plot`` images and
    their labels, numpy."""
    return to_numpy(handle.latent_mu(x[:n_plot])), to_numpy(y[:n_plot])


def _tsne(Xz, perplexity):
    from sklearn.manifold import TSNE

    return TSNE(n_components=2, random_state=42, perplexity=perplexity,
                max_iter=1000).fit_transform(Xz)


def plot_latent_space(handle, x, y, filepath, n_plot: int = 1000, key=None):
    """t-SNE of the posterior means (scikit-learn's, random_state 42)."""
    Xz, yy = latent_space_points(handle, x, y, n_plot, key)
    print(f"running t-sne on {len(Xz)} points...")
    z2 = _tsne(Xz, min(30, max(2, len(Xz) // 4)))
    plt = _plt()
    plt.figure(figsize=(8, 6))
    plt.scatter(z2[:, 0], z2[:, 1], c=yy, cmap=plt.get_cmap("tab10", 10),
                s=10, alpha=0.8)
    plt.title(f"t-SNE Latent Space ({handle.distribution.upper()}-VAE)")
    plt.xticks([])
    plt.yticks([])
    plt.savefig(filepath, dpi=200, bbox_inches="tight")
    plt.close()
    return filepath


def plot_multi_perplexity_tsne(handle, x, y, save_dir,
                               perplexities=(5, 30, 50), n_plot=1000,
                               key=None):
    """One t-SNE panel per perplexity."""
    Xz, yy = latent_space_points(handle, x, y, n_plot, key)
    plt = _plt()
    fig, axes = plt.subplots(1, len(perplexities),
                             figsize=(5 * len(perplexities), 5))
    if len(perplexities) == 1:
        axes = [axes]
    for ax, perp in zip(axes, perplexities):
        z2 = _tsne(Xz, min(perp, max(2, len(Xz) // 4)))
        ax.scatter(z2[:, 0], z2[:, 1], c=yy, cmap=plt.get_cmap("tab10", 10),
                   s=8, alpha=0.8)
        ax.set_title(f"perplexity={perp}")
        ax.set_xticks([])
        ax.set_yticks([])
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "tsne_multi_perplexity.png")
    plt.tight_layout()
    plt.savefig(path, dpi=200, bbox_inches="tight")
    plt.close()
    return path


def _clifford_2d(handle) -> bool:
    return handle.distribution == "clifford" and handle.latent_dim >= 2


def clifford_torus_scatter_points(handle, x, y, key=None
                                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The wrapped posterior-mean angles of the first 4000 images and their
    labels, or None unless the latent is clifford of d >= 2."""
    if not _clifford_2d(handle):
        return None
    return (to_numpy(wrap_angle(handle.latent_mu(x[:4000]))),
            to_numpy(y[:4000]))


def plot_clifford_torus_latent_scatter(handle, x, y, output_dir,
                                       dims=(0, 1), dataset_name=None,
                                       key=None):
    """Phase-angle scatter of two latent dimensions."""
    points = clifford_torus_scatter_points(handle, x, y, key)
    if points is None:
        return None
    A, Y = points
    ax0, ax1 = dims
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(
        output_dir,
        f"clifford_torus_latent_scatter_{dataset_name or 'dataset'}.png")
    plt = _plt()
    plt.figure(figsize=(5, 5))
    sc = plt.scatter(A[:, ax0], A[:, ax1], c=Y, cmap="tab10", s=6, alpha=0.8)
    plt.colorbar(sc)
    plt.xlim(-math.pi, math.pi)
    plt.ylim(-math.pi, math.pi)
    plt.xlabel(f"Phase Angle $\\theta_{{{ax0}}}$")
    plt.ylabel(f"Phase Angle $\\theta_{{{ax1}}}$")
    plt.title("Clifford Torus Latent Phase Angles")
    plt.tight_layout()
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()
    return path


# ---- decoded grids of the prior and of the latent space ----


def _decode_tokens(handle, z):
    """decode(z), z repeated over the tokens of a per-token model."""
    if handle.num_tokens:
        z = z.repeat(1, handle.num_tokens)
    return handle.decode(z)


def clifford_manifold_canvas(handle, n_grid=12, dims=(0, 1),
                             img_shape=(28, 28, 1)) -> Optional[np.ndarray]:
    """An n_grid x n_grid grid of angles in [-pi, pi] on two dimensions
    (the others 0), embedded on the torus and decoded, edge to edge; None
    unless the latent is clifford of d >= 2."""
    if not _clifford_2d(handle):
        return None
    a0 = np.linspace(-math.pi, math.pi, n_grid)
    m0, m1 = np.meshgrid(a0, a0, indexing="ij")
    A = np.zeros((n_grid * n_grid, handle.latent_dim), np.float32)
    A[:, dims[0]] = m0.ravel()
    A[:, dims[1]] = m1.ravel()
    Z = angles_to_torus(torch.from_numpy(A).to(handle.device))
    imgs = to_numpy(handle.to_image(_decode_tokens(handle, Z)))
    return _tile(imgs.reshape(-1, *img_shape), n_grid, n_grid)


def plot_clifford_manifold_visualization(handle, output_dir, n_grid=12,
                                         dims=(0, 1), img_shape=(28, 28, 1)):
    """Decode a 2-D grid of torus angles."""
    canvas = clifford_manifold_canvas(handle, n_grid, dims, img_shape)
    if canvas is None:
        return None
    os.makedirs(output_dir, exist_ok=True)
    return _imshow_save(
        canvas, os.path.join(output_dir, "clifford_manifold_visualization.png"),
        f"Clifford Torus Manifold Traversal (Dimensions {dims[0]}, {dims[1]})",
        (8, 8))


def plot_clifford_torus_recon_grid(handle, output_dir, dims=(0, 1),
                                   n_grid: int = 16, img_shape=(28, 28, 1)):
    """The manifold grid, also saved under its legacy name."""
    if not _clifford_2d(handle):
        return None
    os.makedirs(output_dir, exist_ok=True)
    p = plot_clifford_manifold_visualization(
        handle, output_dir, n_grid=n_grid, dims=dims, img_shape=img_shape)
    if p is None:
        return None
    out = os.path.join(output_dir, "clifford_torus_recon_grid.png")
    try:
        shutil.copyfile(p, out)
    except OSError:
        return p
    return out


def prior_sample_canvas(handle, n_samples=64, img_shape=(28, 28, 1),
                        key=None) -> np.ndarray:
    """``n_samples`` prior draws decoded, as a padded square grid."""
    z = sample_prior_z(_key(key), handle.distribution, handle.latent_dim,
                       n_samples,
                       l2_normalize=getattr(handle.model, "l2_normalize",
                                            False),
                       num_tokens=handle.num_tokens, device=handle.device)
    return _grid(handle.decode_images(z, img_shape),
                 int(math.isqrt(n_samples)))


def plot_prior_sample_grid(handle, output_dir, n_samples=64,
                           img_shape=(28, 28, 1), key=None,
                           filename="prior_samples.png"):
    """Random prior decodes."""
    canvas = prior_sample_canvas(handle, n_samples, img_shape, key)
    os.makedirs(output_dir, exist_ok=True)
    return _imshow_save(
        canvas, os.path.join(output_dir, filename),
        f"Prior Samples ({handle.distribution.upper()})", (8, 8))


def latent_dimension_canvas(handle, x, n_dims_to_explore: int = 6,
                            n_steps: int = 9, img_shape=(28, 28, 1),
                            key=None):
    """(canvas, dimension indices, sweep) of the per-dimension traversal
    of the first image's posterior mean, or None below d 4: clifford
    sweeps angles over [-pi, pi] and embeds them (per token for a
    per-token model), the others sweep [-3, 3]; the dimensions spread
    evenly when d > 10."""
    latent_dim = handle.latent_dim
    if latent_dim is None or latent_dim < 4:
        return None
    mu = handle.latent_mu(x[:1])
    dims_to_explore = min(n_dims_to_explore, latent_dim)
    if latent_dim > 10:
        dim_indices = [int(i * latent_dim / dims_to_explore)
                       for i in range(dims_to_explore)]
    else:
        dim_indices = list(range(dims_to_explore))
    clifford = handle.distribution == "clifford"
    sweep = (np.linspace(-math.pi, math.pi, n_steps) if clifford
             else np.linspace(-3.0, 3.0, n_steps))
    rows = []
    for dim_idx in dim_indices:
        z = mu.repeat(n_steps, 1)
        z[:, dim_idx] = torch.as_tensor(sweep, dtype=z.dtype, device=z.device)
        if clifford and handle.num_tokens:
            z = angles_to_torus(z.reshape(n_steps, handle.num_tokens,
                                          latent_dim)).reshape(n_steps, -1)
        elif clifford:
            z = angles_to_torus(z)
        rows.append(z)
    imgs = handle.decode_images(torch.cat(rows, 0), img_shape)
    return _tile(imgs, len(dim_indices), n_steps), dim_indices, sweep


def plot_latent_dimension_exploration(handle, x, output_dir,
                                      n_dims_to_explore: int = 6,
                                      n_steps: int = 9,
                                      img_shape=(28, 28, 1), key=None):
    """Per-dimension latent traversal, file
    ``{dist}_style_exploration.png``."""
    out = latent_dimension_canvas(handle, x, n_dims_to_explore, n_steps,
                                  img_shape, key)
    if out is None:
        return None
    canvas, dim_indices, sweep = out
    dist, latent_dim = handle.distribution, handle.latent_dim
    h, w, c = img_shape
    n_rows = len(dim_indices)
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"{dist}_style_exploration.png")
    plt = _plt()
    plt.figure(figsize=(max(12, n_steps * 1.5), max(8, n_rows * 1.5)))
    if c == 1:
        plt.imshow(canvas[..., 0], cmap="gray")
    else:
        plt.imshow(canvas)
    plt.yticks([h * i + h // 2 for i in range(n_rows)],
               [f"Dim {dim_indices[i]}" for i in range(n_rows)])
    range_str = "[-π, π]" if dist == "clifford" else "[-3σ, 3σ]"
    plt.xticks([w * i + w // 2 for i in range(n_steps)],
               [f"{sweep[i]:.2f}" for i in range(n_steps)], rotation=45)
    plt.title(
        f"{dist.capitalize()} Latent Space Traversal ($d={latent_dim}$)\n"
        f"Each Row Shows Variations Along One Latent Dimension {range_str}")
    plt.tight_layout()
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()
    return path


# legacy name kept for callers
plot_latent_traversal = plot_latent_dimension_exploration


# ---- interpolation helpers and the fixed-pair interpolations ----


def slerp(z1, z2, t):
    z1n = z1 / torch.linalg.vector_norm(z1, dim=-1, keepdim=True)
    z2n = z2 / torch.linalg.vector_norm(z2, dim=-1, keepdim=True)
    dot = torch.clamp((z1n * z2n).sum(-1, keepdim=True), -1, 1)
    omega = torch.arccos(dot)
    sin_o = torch.sin(omega)
    lin = (1 - t) * z1n + t * z2n
    s1 = torch.sin((1 - t) * omega) / sin_o
    s2 = torch.sin(t * omega) / sin_o
    return torch.where(torch.abs(sin_o) < 1e-6, lin, s1 * z1n + s2 * z2n)


def lerp(z1, z2, t):
    return (1 - t) * z1 + t * z2


def clifford_manifold_interp(z1, z2, t, latent_dim: int):
    """Angle-space interpolation of two torus points with wraparound."""
    a1 = torus_to_angles(z1)[..., :latent_dim]
    a2 = torus_to_angles(z2)[..., :latent_dim]
    return angles_to_torus(a1 + t * wrap_angle(a2 - a1))


def get_fixed_interp_pairs(x, y, n_pairs: int = 5, seed: int = 42):
    """Fixed seeded class pairs: the first image of each of up to 10
    classes, pairs drawn by numpy ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    y = to_numpy(y)
    class_images = {}
    for i in range(len(y)):
        label = int(y[i])
        if label not in class_images:
            class_images[label] = to_numpy(x[i])
        if len(class_images) >= 10:
            break
    classes = sorted(class_images.keys())
    pairs, used = [], set()
    for _ in range(n_pairs * 10):
        c1, c2 = rng.choice(classes, 2, replace=False)
        kk = (min(c1, c2), max(c1, c2))
        if kk not in used:
            used.add(kk)
            pairs.append((class_images[c1], class_images[c2], int(c1),
                          int(c2)))
        if len(pairs) >= n_pairs:
            break
    return pairs


def latent_interpolation_canvases(handle, fixed_pairs, n_steps: int = 10,
                                  img_shape=(32, 32, 1), key=None
                                  ) -> Dict[str, np.ndarray]:
    """Per method, the rows of each pair's interpolation between its two
    sampled latents (``flat_z`` with fold_in(key, pair index)), edge to
    edge."""
    key = _key(key)
    dist = handle.distribution
    canvases = {}
    for method in (["slerp", "manifold"] if dist == "clifford"
                   else ["slerp"] if dist == "powerspherical" else ["lerp"]):
        rows = []
        for p_i, (img1, img2, _, _) in enumerate(fixed_pairs):
            xb = np.stack([to_numpy(img1), to_numpy(img2)], 0)
            z = handle.flat_z(xb, random.fold_in_words(key, p_i))
            z1, z2 = z[0:1], z[1:2]
            ts = [float(t) for t in torch.linspace(0, 1, n_steps)]
            if method == "manifold":
                T, D = handle.num_tokens, handle.latent_dim
                if T:
                    zi = torch.cat([clifford_manifold_interp(
                        z1.reshape(1, T, 2 * D), z2.reshape(1, T, 2 * D),
                        t, D).reshape(1, -1) for t in ts], 0)
                else:
                    zi = torch.cat([clifford_manifold_interp(z1, z2, t, D)
                                    for t in ts], 0)
            else:
                interp = slerp if method == "slerp" else lerp
                zi = torch.cat([interp(z1, z2, t) for t in ts], 0)
            rows.append(handle.decode_images(zi, img_shape))
        canvases[method] = _tile(np.concatenate(rows, 0), len(fixed_pairs),
                                 n_steps)
    return canvases


def plot_latent_interpolations(handle, fixed_pairs, save_dir,
                               n_steps: int = 10, img_shape=(32, 32, 1),
                               key=None):
    """slerp / lerp / clifford-manifold interpolation rows per pair, one
    file per method."""
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for method, canvas in latent_interpolation_canvases(
            handle, fixed_pairs, n_steps, img_shape, key).items():
        path = os.path.join(save_dir, f"interpolation_{method}.png")
        _imshow_save(canvas, path,
                     f"Latent Interpolation ({method}, {handle.distribution})",
                     (n_steps, len(fixed_pairs)))
        paths.append(path)
    return paths


def sphere_manifold_canvas(handle, img_shape=(28, 28, 1), key=None,
                           unit: bool = True) -> np.ndarray:
    """A 12 x 12 grid of N(0, I) draws (unit vectors with ``unit``)
    decoded, edge to edge."""
    g = 12
    z = random.normal(_key(key), (g * g, handle.latent_dim), handle.device)
    if unit:
        z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                            min=1e-12)
    imgs = to_numpy(handle.to_image(_decode_tokens(handle, z)))
    return _tile(imgs.reshape(-1, *img_shape), g, g)


def plot_powerspherical_manifold_visualization(handle, output_dir,
                                               n_samples=256, dims=(0, 1),
                                               img_shape=(28, 28, 1),
                                               key=None):
    """Random unit-sphere decodes on a 12x12 grid."""
    if handle.distribution != "powerspherical" or handle.latent_dim < 2:
        return None
    os.makedirs(output_dir, exist_ok=True)
    return _imshow_save(
        sphere_manifold_canvas(handle, img_shape, key, unit=True),
        os.path.join(output_dir, "powerspherical_manifold_visualization.png"),
        "Power Spherical Manifold Reconstructions", (8, 8))


def plot_gaussian_manifold_visualization(handle, output_dir, n_samples=144,
                                         dims=(0, 1), img_shape=(28, 28, 1),
                                         key=None):
    """Random N(0, I) decodes on a 12x12 grid."""
    if handle.distribution not in ("gaussian", "normal") or \
            handle.latent_dim < 2:
        return None
    os.makedirs(output_dir, exist_ok=True)
    return _imshow_save(
        sphere_manifold_canvas(handle, img_shape, key, unit=False),
        os.path.join(output_dir, "gaussian_manifold_visualization.png"),
        "Gaussian Manifold Random Sample Reconstructions", (8, 8))


# ---- decoded class-prototype bundles ----

N_COMBOS = 3  # class combinations per bundle size, as in the JAX plot


def decoded_bundle_images(handle, x, y, n_samples=500, max_bundle_size=5,
                          key=None):
    """Rows of bundle size k in 2 .. max, ``N_COMBOS`` class combinations
    each (numpy ``RandomState(42)``): the sum of the chosen classes' mean
    sampled latents, decoded.  Returns (images (rows, N_COMBOS, H, W, C)
    in [0, 1], the chosen classes per panel)."""
    key = _key(key)
    all_z, all_labels, n = [], [], 0
    for s in range(0, min(len(x), n_samples * 2), 200):
        z = handle.flat_z(x[s:s + 200], random.fold_in_words(key, s))
        all_z.append(z)
        all_labels.append(to_numpy(y[s:s + 200]))
        n += z.shape[0]
        if n >= n_samples:
            break
    all_z = torch.cat(all_z, 0)[:n_samples]
    all_labels = np.concatenate(all_labels, 0)[:n_samples]
    unique_classes = sorted(np.unique(all_labels).tolist())
    class_means = {c: all_z[torch.as_tensor(np.where(all_labels == c)[0],
                                            device=all_z.device)].mean(0)
                   for c in unique_classes}
    bundle_sizes = range(2, min(max_bundle_size + 1, len(unique_classes) + 1))
    rng = np.random.RandomState(42)
    chosen, vecs = [], []
    for k in bundle_sizes:
        for _ in range(N_COMBOS):
            classes = rng.choice(unique_classes, size=k,
                                 replace=False).tolist()
            chosen.append(classes)
            vecs.append(sum(class_means[c] for c in classes))
    imgs = [to_numpy(handle.to_image(handle.decode(v[None])))[0]
            for v in vecs]
    imgs = np.stack([img.reshape(int(math.isqrt(img.shape[0])),
                                 int(math.isqrt(img.shape[0])), 1)
                     if img.ndim == 1 else img for img in imgs])
    return imgs.reshape(len(bundle_sizes), N_COMBOS, *imgs.shape[1:]), chosen


def plot_decoded_bundles(handle, x, y, save_path, class_names=None,
                         n_samples=500, max_bundle_size=5, key=None):
    """Bundle class-prototype latents and decode them: rows = bundle size."""
    imgs, chosen = decoded_bundle_images(handle, x, y, n_samples,
                                         max_bundle_size, key)
    n_rows = imgs.shape[0]
    plt = _plt()
    fig, axes = plt.subplots(n_rows, N_COMBOS,
                             figsize=(3 * N_COMBOS, 3 * n_rows))
    axes = np.atleast_2d(axes)
    for i, classes in enumerate(chosen):
        row, col = divmod(i, N_COMBOS)
        img = imgs[row, col]
        if img.shape[-1] == 1:
            axes[row, col].imshow(img[..., 0], cmap="gray")
        else:
            axes[row, col].imshow(img)
        names = [class_names[c] if class_names else str(c) for c in classes]
        axes[row, col].set_title("+".join(names), fontsize=8)
        axes[row, col].axis("off")
    plt.suptitle("Decoded Class-Prototype Bundles")
    plt.tight_layout()
    plt.savefig(save_path, dpi=200, bbox_inches="tight")
    plt.close()
    return save_path
