"""Hypersphere surface-area collapse against the Clifford torus's (2π)^d
growth (port of ``scripts/surface_area_plot.py``: numpy and scipy on the
host, no device).

    python -m cliffordtpu_torch.scripts.surface_area_plot --out fig.png
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from scipy.special import gamma


def hypersphere_sa(d):
    """Unit S^(d-1) surface area: 2 pi^(d/2) / Gamma(d/2)."""
    return 2 * np.pi ** (d / 2) / gamma(d / 2)


def gaussian_typical_shell_sa(d):
    """N(0,I) typical-set shell at r = sqrt(d)."""
    return hypersphere_sa(d) * (np.sqrt(d)) ** (d - 1)


def curves():
    """The plotted series: (manifold dims, values) of each panel's lines."""
    mdims_short = np.arange(1, 40)
    mdims_comp = np.arange(1, 65)
    return {
        "sphere_short": (mdims_short, np.array(
            [hypersphere_sa(d + 1) for d in mdims_short])),
        "sphere": (mdims_comp, np.array(
            [hypersphere_sa(d + 1) for d in mdims_comp])),
        "clifford": (mdims_comp, np.array(
            [(2 * np.pi) ** d for d in mdims_comp])),
        "gaussian": (mdims_comp, np.array(
            [gaussian_typical_shell_sa(d + 1) for d in mdims_comp])),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, default="figures/surface_area.png")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update({
        "font.size": 12, "font.family": "serif",
        "axes.labelsize": 14, "axes.titlesize": 14,
        "legend.fontsize": 11, "figure.figsize": (8, 5),
    })

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 5))
    c = curves()

    mdims_short, sa_sphere_short = c["sphere_short"]
    ax1.semilogy(mdims_short, sa_sphere_short, "b-", linewidth=2,
                 label=r"Power Spherical / vMF")
    ax1.semilogy(mdims_short[::3], sa_sphere_short[::3], "x",
                 color="#9467bd", markersize=7, markeredgewidth=2,
                 label=r"$\mathcal{N}$-L2")
    ax1.axvline(x=6, color="gray", linestyle="--", alpha=0.5,
                label="$d=6$ (peak)")
    ax1.set_xlabel("manifold dimension $d$")
    ax1.set_ylabel("surface area (log scale)")
    ax1.set_title("Hypersphere Surface Area Collapse")
    ax1.legend(fontsize=9)
    ax1.set_xlim(1, 39)

    mdims_comp, sa_gauss_comp = c["gaussian"]
    ax2.semilogy(mdims_comp, sa_gauss_comp, "-", color="#2ca02c",
                 linewidth=2, label=r"Gaussian")
    ax2.semilogy(mdims_comp, c["clifford"][1], "r-", linewidth=2,
                 label=r"Clifford Torus $(2\pi)^d$")
    ax2.semilogy(mdims_comp, c["sphere"][1], "b-", linewidth=2,
                 label=r"Power Spherical / vMF")
    ax2.set_xlabel("manifold dimension $d$")
    ax2.set_ylabel("surface area / volume (log scale)")
    ax2.set_title("Latent Manifold Size vs Dimension")
    ax2.legend(fontsize=9)
    ax2.set_xlim(1, 64)

    plt.tight_layout()
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    plt.savefig(args.out, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"saved to {args.out}")


if __name__ == "__main__":
    main()
