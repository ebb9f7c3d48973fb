"""Role-filler unbinding heatmap: Schlegel et al. fig-7/8 style (port of
``scripts/rolefiller_heatmap.py``).

    python -m cliffordtpu_torch.scripts.rolefiller_heatmap --dims 64 256

runs on the card; ``--device cpu`` runs on the CPU."""

from __future__ import annotations

import argparse

from cliffordtpu_torch.scripts.figures_common import (
    INIT_FNS,
    plot_heatmaps,
    run_rolefiller_heatmap,
)

K_RANGE = list(range(2, 31, 2))


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--n_trials", type=int, default=10)
    p.add_argument("--n_items", type=int, default=1000)
    p.add_argument("--dims", type=int, nargs="+",
                   default=[4, 16, 64, 144, 256, 484, 512, 1024])
    p.add_argument("--out", type=str,
                   default="figures/rolefiller_heatmap.png")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the GPU (raises without "
                        "one)")
    return p


def compute(args):
    """{init name: accuracy matrix (len(dims), len(K_RANGE))}."""
    results = {}
    for name, fn in INIT_FNS.items():
        print(f"running {name}...")
        results[name] = run_rolefiller_heatmap(
            fn, name, args.dims, K_RANGE, n_items=args.n_items,
            n_trials=args.n_trials, device=args.device)
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    plot_heatmaps(compute(args), args.dims, K_RANGE, "# pairs",
                  "Role-Filler Unbinding Capacity", "accuracy", args.out)


if __name__ == "__main__":
    main()
