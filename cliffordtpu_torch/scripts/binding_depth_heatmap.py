"""Binding-depth heatmap: Schlegel et al. fig-6 style (port of
``scripts/binding_depth_heatmap.py``).

    python -m cliffordtpu_torch.scripts.binding_depth_heatmap --dims 64 256

runs on the card; ``--device cpu`` runs on the CPU."""

from __future__ import annotations

import argparse

from cliffordtpu_torch.scripts.figures_common import (
    INIT_FNS,
    plot_heatmaps,
    run_depth_heatmap,
)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--n_trials", type=int, default=10)
    p.add_argument("--max_depth", type=int, default=40)
    p.add_argument("--dims", type=int, nargs="+",
                   default=[4, 16, 64, 144, 256, 484, 512, 1024])
    p.add_argument("--out", type=str,
                   default="figures/binding_depth_heatmap.png")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the GPU (raises without "
                        "one)")
    return p


def compute(args):
    """({init name: cosine matrix (len(dims), max_depth)}, depths)."""
    results, depths = {}, None
    for name, fn in INIT_FNS.items():
        print(f"running {name}...")
        results[name], depths = run_depth_heatmap(
            fn, name, args.dims, max_depth=args.max_depth,
            n_trials=args.n_trials, device=args.device)
    return results, depths


def main(argv=None):
    args = build_parser().parse_args(argv)
    results, depths = compute(args)
    plot_heatmaps(results, args.dims, depths, "binding depth $m$",
                  "Approximate Inverse Binding Depth", "cosine similarity",
                  args.out)


if __name__ == "__main__":
    main()
