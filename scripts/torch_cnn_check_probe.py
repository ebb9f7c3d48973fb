#!/usr/bin/env python3
"""Rerun one cell of the CNN runners' check (``scripts/torch_sweep_cnn.sh``)
with the trials' float32 matmuls at another precision, to ask whether a
cell's gap to the JAX run follows the matmul precision of its training:
the JAX runs trained on a TPU, whose default precision for float32 dots
takes bfloat16 passes, while the port's float32 matmuls run at PyTorch's
default, full float32 ("highest").

    python3 scripts/torch_cnn_check_probe.py --precision medium \\
        --arch vit --dist gaussian_nol2 --trials 1 8 --outdir OUT

Each trial runs in this process through ``fashion_train.main`` with the
check's flags (the shard, d 128, 60 epochs, ``--eval_subprocess``; the
battery's child at the default precision), after
``torch.set_float32_matmul_precision``.  A trial whose ``metrics.json``
exists is skipped.  Prints one JSON line per trial and, with
``--reference``, the JAX run's value of each primary metric against
these trials (the check's prediction-interval test).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--precision", required=True,
                   choices=["highest", "high", "medium"])
    p.add_argument("--arch", required=True, choices=["cnn", "hybrid", "vit"])
    p.add_argument("--dist", required=True)
    p.add_argument("--trials", type=int, nargs=2, metavar=("FIRST", "LAST"),
                   required=True)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--outdir", required=True)
    p.add_argument("--device", default=None,
                   help="the runner's --device (default the card)")
    p.add_argument("--reference", default=None,
                   help="the JAX tree's root (artifacts): print the test")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch

    from cliffordtpu_torch.scripts import fashion_train
    from torch_compare_sweep import (
        CNN_D,
        CNN_PRIMARY,
        cnn_port_trials,
        prediction_test,
    )

    torch.set_float32_matmul_precision(args.precision)
    os.environ.setdefault("CLIFFORDTPU_DATA_DIR",
                          os.path.join(ROOT, "tests", "data"))
    outdir = os.path.abspath(os.path.join(args.outdir,
                                          f"real_digits_{args.arch}"))
    cwd = os.getcwd()
    for t in range(args.trials[0], args.trials[1] + 1):
        exp = f"mnist32-{args.dist}-d{CNN_D}-l1-trial{t}"
        metrics = os.path.join(outdir, "results", exp, "metrics.json")
        if not os.path.exists(metrics):
            try:
                fashion_train.main([
                    "--dataset", "mnist32", "--arch", args.arch,
                    "--latent_dims", str(CNN_D), "--distributions",
                    args.dist, "--n_trials", "1", "--start_trial", str(t),
                    "--force_trial_suffix", "--epochs", str(args.epochs),
                    "--require_real", "--eval_subprocess", "--no_wandb",
                    "--outdir", outdir] + (
                        ["--device", args.device] if args.device else []))
            finally:
                os.chdir(cwd)
        with open(metrics) as f:
            m = json.load(f)
        print(json.dumps({"trial": t, "precision": args.precision,
                          "best_loss": m["final_best_total_loss"],
                          "knn_acc_1000": m.get("knn_acc_1000"),
                          "mvc": m["mean_vector_cosine_acc"]}), flush=True)
    if args.reference:
        trials = cnn_port_trials(args.outdir, args.arch, args.dist)
        with open(os.path.join(args.reference,
                               f"real_digits_{args.arch}_tpu",
                               "mnist32_trial_metrics.json")) as f:
            ref = json.load(f)[f"{CNN_D}|{args.dist}"][0]
        for metric in CNN_PRIMARY:
            vals = [t[metric] for t in trials]
            t_stat, p_val = prediction_test(vals, ref[metric])
            print(json.dumps({"metric": metric, "n": len(vals),
                              "mean": sum(vals) / len(vals),
                              "jax": ref[metric], "t": t_stat, "p": p_val}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
