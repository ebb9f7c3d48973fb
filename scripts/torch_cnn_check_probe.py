#!/usr/bin/env python3
"""Rerun one cell of the CNN runners' check (``scripts/torch_sweep_cnn.sh``)
as an arm of an experiment on what decides a trial: the float32 precision
of its training, or the initial weights it starts from.

    python3 scripts/torch_cnn_check_probe.py --arch hybrid --dist clifford \\
        --trials 1 8 --outdir OUT/a                          # (a) as the check
    python3 scripts/torch_cnn_check_probe.py --arch hybrid --dist clifford \\
        --trials 1 8 --init_dir INITS --outdir OUT/b        # (b) JAX's weights
    python3 scripts/torch_cnn_check_probe.py --arch hybrid --dist clifford \\
        --trials 1 8 --precision medium --conv_tf32 on \\
        --outdir OUT/c                                      # (c) TPU surrogate

Each trial runs in this process through ``fashion_train.main`` with the
check's flags (the shard, d 128, 60 epochs, ``--eval_subprocess
--scan_epochs --require_real``; the battery's child at the default
precision), after ``torch.set_float32_matmul_precision(--precision)`` and,
with ``--conv_tf32``, ``torch.backends.cudnn.allow_tf32`` (PyTorch's own
default lets cuDNN take TF32 for float32 convolutions; "medium" matmuls
and TF32 keep 10 mantissa bits where the TPU's default single bfloat16
pass keeps 7).  ``--init_dir`` starts trial t from JAX's initial weights
of the trial, redrawn from ``INITS/<arch>_<dist>_trial<t>.json``
(``flat_from_recipe``; written and held bit for bit against JAX's init
by ``tests/torch_trajectory_witness.py --inits``) in place of the port's
own draw.

Every epoch's logged metrics go to the trial's ``curve.json`` beside its
``metrics.json``; a trial with both is skipped.  Prints one JSON line per
trial (best loss; escaped: best below 200, the background plateau being
about 312; the first epoch whose test loss fell below 200; knn@1000, mvc,
FID; the precision flags in force), one line with the escapes, and with
``--reference`` the JAX run's value of each primary metric against these
trials (the check's prediction-interval test).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ESCAPED = 200.0


class CurveLogger:
    """Keeps every epoch's metrics and hands them on to the runner's
    logger."""

    use = True

    def __init__(self, inner):
        self.inner, self.rows = inner, []

    def log_metrics(self, m):
        self.rows.append({k: float(v) for k, v in m.items()})
        if self.inner is not None and self.inner.use:
            self.inner.log_metrics(m)


def flat_from_recipe(recipe, device="cpu", check=True):
    """The JAX initial weights of ``recipe`` (written by
    ``tests/torch_trajectory_witness.py --inits``) in flax's flat names,
    as numpy arrays, redrawn on ``device`` with the port's threefry: each
    parameter its ``uniform`` or ``normal`` draw on its key times its
    float32 factor, its constant, or its stored values; with ``check``,
    each held at the recipe's sample entries bit for bit."""
    import base64

    import numpy as np
    import torch

    from cliffordtpu_torch import random

    flat = {}
    for name, r in recipe["params"].items():
        shape = tuple(r["shape"])
        if r["kind"] == "const":
            flat[name] = np.full(shape, r["value"], np.float32)
        elif r["kind"] == "values":
            flat[name] = np.frombuffer(base64.b64decode(r["b64"]),
                                       np.float32).reshape(shape).copy()
        else:
            key = tuple(r["key"])
            raw = (random.uniform(key, shape, r["minval"], r["maxval"],
                                  device=device)
                   if r["kind"] == "uniform"
                   else random.normal(key, shape, device=device))
            flat[name] = (raw * torch.tensor(r["scale"], dtype=torch.float32,
                                             device=device)).cpu().numpy()
        if check:
            got = flat[name].reshape(-1)
            bad = [(i, v, float(got[i])) for i, v in r["check"]
                   if float(got[i]) != v]
            if bad:
                raise ValueError(f"{name}: the redraw is not JAX's init at "
                                 f"(index, JAX, port) {bad}")
    return flat


def init_from_recipe(path, device="cpu"):
    """The port's state dict of the JAX initial weights in ``path``."""
    from cliffordtpu_torch.nn import param_import

    with open(path) as f:
        recipe = json.load(f)
    return param_import.from_jax(flat_from_recipe(recipe, device),
                                 recipe["distribution"])


def escape_epoch(curve):
    """The first epoch (from 1) whose test loss (recon + kld) fell below
    ``ESCAPED``, or None."""
    for row in curve:
        if row["test/recon_loss"] + row["test/kld_loss"] < ESCAPED:
            return int(row["epoch"]) + 1
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--precision", default="highest",
                   choices=["highest", "high", "medium"])
    p.add_argument("--conv_tf32", default=None, choices=["on", "off"],
                   help="cuDNN's TF32 for float32 convolutions (default: "
                        "PyTorch's own)")
    p.add_argument("--init_dir", default=None,
                   help="start each trial from JAX's initial weights here")
    p.add_argument("--arch", required=True, choices=["cnn", "hybrid", "vit"])
    p.add_argument("--dist", required=True)
    p.add_argument("--trials", type=int, nargs=2, metavar=("FIRST", "LAST"),
                   required=True)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--outdir", required=True)
    p.add_argument("--device", default=None,
                   help="the runner's --device (default the card)")
    p.add_argument("--runner_flags", default="",
                   help="extra runner flags (a CPU rehearsal's limits)")
    p.add_argument("--reference", default=None,
                   help="the JAX tree's root (artifacts): print the test")
    args = p.parse_args(argv)
    if args.init_dir:  # the runner changes directory into its outdir
        args.init_dir = os.path.abspath(args.init_dir)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch

    from cliffordtpu_torch.runners import cnn_runner
    from cliffordtpu_torch.scripts import fashion_train
    from torch_compare_sweep import (
        CNN_D,
        CNN_PRIMARY,
        cnn_port_trials,
        prediction_test,
    )

    torch.set_float32_matmul_precision(args.precision)
    if args.conv_tf32:
        torch.backends.cudnn.allow_tf32 = args.conv_tf32 == "on"
    flags = {"matmul_precision": torch.get_float32_matmul_precision(),
             "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
             "init": "jax" if args.init_dir else "port"}
    os.environ.setdefault("CLIFFORDTPU_DATA_DIR",
                          os.path.join(ROOT, "tests", "data"))
    outdir = os.path.abspath(os.path.join(args.outdir,
                                          f"real_digits_{args.arch}"))
    cwd = os.getcwd()
    build_model, train_model = cnn_runner.build_model, cnn_runner.train_model
    curves = []

    def jax_init_model(a, dist, latent_dim, in_channels, *rest, **kw):
        model = build_model(a, dist, latent_dim, in_channels, *rest, **kw)
        model.load_state_dict(init_from_recipe(os.path.join(
            args.init_dir, f"{args.arch}_{dist}_trial{a.start_trial}.json"),
            "cpu" if a.device == "cpu" else "cuda"))
        return model

    def curve_train_model(a, model, x_train, x_test, run_key, logger=None):
        rec = CurveLogger(logger)
        out = train_model(a, model, x_train, x_test, run_key, rec)
        curves.append(rec.rows)
        return out

    cnn_runner.train_model = curve_train_model
    if args.init_dir:
        cnn_runner.build_model = jax_init_model
    escapes, trial_flags = [], []
    try:
        for t in range(args.trials[0], args.trials[1] + 1):
            exp = f"mnist32-{args.dist}-d{CNN_D}-l1-trial{t}"
            metrics = os.path.join(outdir, "results", exp, "metrics.json")
            curve = os.path.join(outdir, "results", exp, "curve.json")
            if not (os.path.exists(metrics) and os.path.exists(curve)):
                curves.clear()
                try:
                    fashion_train.main([
                        "--dataset", "mnist32", "--arch", args.arch,
                        "--latent_dims", str(CNN_D), "--distributions",
                        args.dist, "--n_trials", "1", "--start_trial",
                        str(t), "--force_trial_suffix", "--epochs",
                        str(args.epochs), "--require_real",
                        "--eval_subprocess", "--scan_epochs", "--no_wandb",
                        "--outdir", outdir] + (
                            ["--device", args.device] if args.device
                            else []) + args.runner_flags.split())
                finally:
                    os.chdir(cwd)
                with open(curve, "w") as f:
                    json.dump({"flags": flags, "epochs": curves[-1]}, f)
            with open(metrics) as f:
                m = json.load(f)
            with open(curve) as f:
                c = json.load(f)
            best = m["final_best_total_loss"]
            escapes.append(best < ESCAPED)
            trial_flags.append(c["flags"])
            print(json.dumps({
                "trial": t, **c["flags"], "best_loss": best,
                "escaped": best < ESCAPED,
                "escape_epoch": escape_epoch(c["epochs"]),
                "knn_acc_1000": m.get("knn_acc_1000"),
                "mvc": m["mean_vector_cosine_acc"],
                "fid": m.get("generation_fid")}), flush=True)
    finally:
        cnn_runner.build_model, cnn_runner.train_model = build_model, \
            train_model
    # the flags the trials ran with (a rerun that skips them may differ)
    ran = [f for i, f in enumerate(trial_flags) if f not in trial_flags[:i]]
    print(json.dumps({"arch": args.arch, "dist": args.dist,
                      **(ran[0] if len(ran) == 1 else {"flags": ran}),
                      "escaped": sum(escapes), "trials": len(escapes)}))
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
