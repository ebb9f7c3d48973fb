"""3-D projected samples of the five latent samplers (port of
``scripts/sample_viz.py``).

    python -m cliffordtpu_torch.scripts.sample_viz --kappa 5 --dim 4

draws on the card (``--device cpu`` on the CPU) and saves the figure
(``--interactive`` opens the kappa / dim sliders on a machine with a
display).  The draws take the JAX script's keys.  The clifford (PS)
column draws its N_SAMPLES points as a batch of that many rows through
``CliffordPowerSphericalDistribution.sample`` with the models' default
``"keyed"`` route, so on the card it is one launch of the fused sampler
kernel; the u and v are those the JAX script's ``sample(key, (N,))``
draws, so the points agree with its.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.device import resolve_device
from cliffordtpu_torch.distributions.clifford_torus import (
    CliffordPowerSphericalDistribution,
    CliffordTorusDistribution,
)
from cliffordtpu_torch.distributions.power_spherical import PowerSpherical

N_SAMPLES = 4000
COLORS = {
    "gaussian (raw)": "#4CAF50",
    "gaussian (L2)": "#9C27B0",
    "powerspherical": "#FF9800",
    "clifford (vM)": "#00BCD4",
    "clifford (PS)": "#2196F3",
}
PROJECTION_KEY = (0, 7)  # jax.random.PRNGKey(7)


def sample_gaussian(key, kappa, dim, device):
    return random.normal(key, (N_SAMPLES, dim), device)


def sample_powerspherical(key, kappa, dim, device):
    loc = torch.zeros(dim, device=device)
    loc[0] = 1.0
    return PowerSpherical(loc, torch.tensor(float(kappa), device=device)
                          ).sample(key, (N_SAMPLES,))


def sample_clifford_vm(key, kappa, dim, device):
    q = CliffordTorusDistribution(torch.zeros(dim, device=device),
                                  torch.full((dim,), float(kappa),
                                             device=device))
    return q.sample(key, (N_SAMPLES,))


def sample_clifford_ps(key, kappa, dim, device):
    q = CliffordPowerSphericalDistribution(
        torch.zeros((N_SAMPLES, dim), device=device),
        torch.full((N_SAMPLES, dim), float(kappa), device=device))
    return q.sample(key)


def normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-8)


def to_3d(x, key=PROJECTION_KEY):
    """Random (fixed-seed) orthonormal projection to 3-D, on the host."""
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    if x.shape[-1] == 3:
        return x
    if x.shape[-1] < 3:
        pad = np.zeros((x.shape[0], 3 - x.shape[-1]))
        return np.concatenate([x, pad], -1)
    proj = random.normal(key, (x.shape[-1], 3)).numpy()
    proj, _ = np.linalg.qr(proj)
    return x @ proj


COLUMNS = [
    ("gaussian (raw)", sample_gaussian, False),
    ("gaussian (L2)", sample_gaussian, True),
    ("powerspherical", sample_powerspherical, False),
    ("clifford (vM)", sample_clifford_vm, False),
    ("clifford (PS)", sample_clifford_ps, False),
]


def column_points(key, kappa, dim, device=None):
    """{column name: (N_SAMPLES, 3) projected points}: the device half."""
    device = resolve_device(device)
    out = {}
    for i, (name, func, do_norm) in enumerate(COLUMNS):
        samples = func(random.fold_in_words(key, i), kappa, dim, device)
        out[name] = to_3d(normalize(samples) if do_norm else samples)
    return out


def draw(fig, axes, key, kappa, dim, device=None):
    for ax, (name, pts) in zip(axes, column_points(key, kappa, dim,
                                                   device).items()):
        ax.cla()
        if name != "gaussian (raw)":
            u = np.linspace(0, 2 * np.pi, 20)
            v = np.linspace(0, np.pi, 20)
            xs = np.outer(np.cos(u), np.sin(v))
            ys = np.outer(np.sin(u), np.sin(v))
            zs = np.outer(np.ones_like(u), np.cos(v))
            ax.plot_wireframe(xs, ys, zs, color="lightgray", alpha=0.3,
                              linewidth=0.3)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5, alpha=0.3,
                   c=COLORS[name], depthshade=True)
        ax.set_title(name, fontsize=11, pad=4)
        lim = (max(np.abs(pts).max() + 0.2, 1.2)
               if name == "gaussian (raw)" else 1.2)
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_zlim(-lim, lim)
        ax.set_xticklabels([])
        ax.set_yticklabels([])
        ax.set_zticklabels([])
    fig.suptitle(f"samples projected to 3D  (dim={dim}, κ={kappa:.1f})",
                 fontsize=14)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--kappa", type=float, default=5.0)
    p.add_argument("--dim", type=int, default=4)
    p.add_argument("--out", type=str, default="figures/sample_viz.png")
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the draws; default the GPU "
                        "(raises without one)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import matplotlib

    if not args.interactive:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(22, 5))
    fig.subplots_adjust(wspace=0.02, top=0.88, left=0.02, right=0.98,
                        bottom=0.22 if args.interactive else 0.08)
    axes = [fig.add_subplot(1, 5, i + 1, projection="3d") for i in range(5)]
    key = (0, 0)  # jax.random.PRNGKey(0)

    if args.interactive:
        from matplotlib.widgets import Slider

        ax_kappa = fig.add_axes([0.15, 0.09, 0.7, 0.03])
        slider_kappa = Slider(ax_kappa, "κ", 0.1, 100.0, valinit=args.kappa,
                              valstep=0.5)
        ax_dim = fig.add_axes([0.15, 0.03, 0.7, 0.03])
        slider_dim = Slider(ax_dim, "dim", 2, 32, valinit=args.dim,
                            valstep=1)

        def _redraw(_):
            draw(fig, axes, key, slider_kappa.val, int(slider_dim.val),
                 args.device)
            fig.canvas.draw_idle()

        slider_kappa.on_changed(_redraw)
        slider_dim.on_changed(_redraw)
        draw(fig, axes, key, args.kappa, args.dim, args.device)
        plt.show()
    else:
        draw(fig, axes, key, args.kappa, args.dim, args.device)
        out_dir = os.path.dirname(args.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        plt.savefig(args.out, dpi=300, bbox_inches="tight")
        plt.close()
        print(f"saved to {args.out}")


if __name__ == "__main__":
    main()
