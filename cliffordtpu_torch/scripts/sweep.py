"""Process-isolated sweep driver: one trial per runner process (port of
``scripts/sweep.py``: the same flags, order, names, resume rule and
summary, plus ``--device``).

Each (latent_dim, distribution, trial) cell runs as one fresh process of
the port's runner (``python -m cliffordtpu_torch.scripts.<runner>
--n_trials 1 --start_trial T``), so a crashed, killed or hung trial costs
that trial only.  Afterwards the driver aggregates every
``results/{exp}/metrics.json`` it finds into the unified CSV, the
across-dims LaTeX / CSV and the per-dim cross-dist comparison plots that
the in-process sweep writes, and a ``sweep_summary.json`` with each
trial's status.

The run keys (``fold_in(PRNGKey(seed), stable_hash(d, dist, trial))``),
the artifact names and the datasets are the same in every process, so a
shelled trial gives what the in-process runner gives for it.

    python -m cliffordtpu_torch.scripts.sweep --runner fashion_train \\
        --outdir /tmp/sweep --distributions clifford gaussian \\
        --latent_dims 128 --n_trials 2 -- --epochs 3 --eval_subprocess

Everything after ``--`` goes to the runner unchanged.  The children run
on the card unless ``--device`` names another device (``--device cpu``).
Re-running the same command resumes: trials whose ``metrics.json``
exists are skipped (``--no_resume`` runs them again).  A trial that
outlives ``--trial_timeout`` is killed with its whole process group (its
``--eval_subprocess`` child too) and marked failed.  Sweeps sliced by
trial range or family may share an outdir: the timing JSON is merged on
write (its total is the last invocation's that ran a trial), and a last
invocation of the whole sweep (every trial skipped) aggregates all
slices.  The CSV is written
with the runner's own ``results_rows`` / ``write_results_csv`` (the text
pandas writes; the card has no pandas).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

from cliffordtpu_torch.eval.tables import plot_across_dims_comparison
from cliffordtpu_torch.runners.cnn_runner import (
    ACROSS_KEYS,
    format_table,
    results_rows,
    trial_entry,
    write_results_csv,
)
from cliffordtpu_torch.scripts import replot_comparisons
from cliffordtpu_torch.utils.artifacts import merge_json_write

RUNNERS = {
    "fashion_train": "fashionmnist",
    "cifar10_train": "cifar10",
}
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_parser():
    p = argparse.ArgumentParser(
        description="one-trial-per-process sweep driver (resume-safe)")
    p.add_argument("--runner", required=True, choices=sorted(RUNNERS))
    p.add_argument("--dataset", default=None,
                   help="override the runner's default dataset (e.g. "
                        "mnist32 on fashion_train for the real digit "
                        "shard); keeps artifact naming consistent")
    p.add_argument("--outdir", required=True)
    p.add_argument("--distributions", type=str, nargs="+", required=True)
    p.add_argument("--latent_dims", type=int, nargs="+", required=True)
    p.add_argument("--n_trials", type=int, default=1)
    p.add_argument("--start_trial", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--recon_loss", type=str, default="l1",
                   help="must match the runner's recon loss (artifact names "
                        "embed it)")
    p.add_argument("--trial_timeout", type=int, default=0,
                   help="per-trial wall-clock limit in seconds (0 = none); "
                        "a timed-out trial is killed and marked failed")
    p.add_argument("--retries", type=int, default=0,
                   help="re-run a failed trial up to N times")
    p.add_argument("--no_resume", action="store_true",
                   help="re-run trials even when their metrics.json exists")
    p.add_argument("--dry_run", action="store_true",
                   help="print the per-trial commands without running")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of every trial, passed to the runner; "
                        "default the GPU (the runner raises without one), "
                        "'cpu' runs the plain versions of the kernels")
    return p


def trial_cells(args):
    """Sweep order identical to run_cnn_experiments: dim -> dist -> trial."""
    for latent_dim in args.latent_dims:
        for dist_name in args.distributions:
            for trial in range(args.n_trials):
                yield latent_dim, dist_name, trial + args.start_trial


def exp_name_for(args, dataset, latent_dim, dist_name, trial_num):
    """The runner's experiment name (no suffix for a single-trial sweep)."""
    total_multi = args.n_trials > 1 or args.start_trial > 1
    suffix = f"-trial{trial_num}" if total_multi else ""
    return f"{dataset}-{dist_name}-d{latent_dim}-{args.recon_loss}{suffix}"


def build_cmd(args, passthrough, latent_dim, dist_name, trial_num):
    cmd = [
        sys.executable, "-m", f"cliffordtpu_torch.scripts.{args.runner}",
        "--outdir", args.outdir,
        "--distributions", dist_name,
        "--latent_dims", str(latent_dim),
        "--n_trials", "1",
        "--start_trial", str(trial_num),
        "--seed", str(args.seed),
        "--recon_loss", args.recon_loss,
        "--no_wandb",
    ]
    if args.dataset:
        cmd += ["--dataset", args.dataset]
    if args.n_trials > 1 or args.start_trial > 1:
        # single-trial child must still name artifacts -trial{n}
        cmd.append("--force_trial_suffix")
    if args.device:
        cmd += ["--device", args.device]
    return cmd + list(passthrough)


def _child_env():
    """The environment of a trial: this checkout first on ``PYTHONPATH``,
    so ``-m cliffordtpu_torch...`` resolves from any working directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    return env


def run_trial(cmd, timeout, log_path):
    """Run one trial process in a session of its own, output to a log file.
    Returns (rc, seconds): the child's code (negative for a signal), 124
    where it outlived ``timeout``; then its whole process group is killed,
    so an ``--eval_subprocess`` grandchild does not outlive it."""
    t0 = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=_child_env(), start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout or None)
        except subprocess.TimeoutExpired:
            rc = 124
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    return rc, time.time() - t0


def merge_timing(outdir, runner, cumulative):
    """Fold the per-experiment keys of the runner's {runner}_timing.json
    into the sweep-wide dict after every trial."""
    path = os.path.join(outdir, f"{runner}_timing.json")
    try:
        with open(path) as fh:
            t = json.load(fh)
        for k, v in t.items():
            if k != "total_script_time_s":
                cumulative[k] = v
    except (OSError, json.JSONDecodeError):
        pass


def aggregate(args, dataset, statuses):
    """Rebuild the unified CSV + across-dims table + cross-dist plots from
    the per-trial metrics.json files (the formats of run_cnn_experiments
    and replot_comparisons)."""
    trial_metrics = {}
    across = {d: {"knn_100": [], "knn_600": [], "knn_1000": [],
                  "f1_100": [], "f1_600": [], "f1_1000": [],
                  "mean_cosine": [], "dims": []}
              for d in args.distributions}
    for latent_dim, dist_name, trial_num in trial_cells(args):
        exp = exp_name_for(args, dataset, latent_dim, dist_name, trial_num)
        mpath = os.path.join(args.outdir, "results", exp, "metrics.json")
        if not os.path.exists(mpath):
            continue
        with open(mpath) as fh:
            m = json.load(fh)
        trial_metrics.setdefault((latent_dim, dist_name), []).append(
            trial_entry(m))
        for kk, mk in ACROSS_KEYS:
            across[dist_name][kk].append(m.get(mk, 0.0))
        across[dist_name]["mean_cosine"].append(
            m.get("mean_vector_cosine_acc", 0.0))
        across[dist_name]["dims"].append(latent_dim)

    rows = results_rows(trial_metrics)
    csv_path = os.path.join(args.outdir, f"{dataset}_results.csv")
    if rows:
        write_results_csv(rows, csv_path)
        print(f"\n{'=' * 25} {dataset} results {'=' * 25}")
        print(format_table(rows))
        print(f"saved to {csv_path}")

    comp_dir = os.path.join(args.outdir, "results", "comparisons", dataset)
    if any(len(v["dims"]) for v in across.values()):
        try:
            path = plot_across_dims_comparison(
                across, sorted(set(args.latent_dims)), dataset, comp_dir)
            print(f"saved across-dims comparison to {path}")
        except Exception as e:  # aggregation must never kill the sweep
            print(f"warning: across-dims comparison failed: {e!r}")

    # per-dim cross-dist plots from saved vsa_raw.json (averaged over trials)
    try:
        rc = replot_comparisons.main(
            ["--results_dir", os.path.join(args.outdir, "results"),
             "--dataset", dataset, "--out", comp_dir])
        print(f"replot rc={rc}")
    except Exception as e:  # aggregation must never kill the sweep
        print(f"warning: replot failed: {e!r}")

    summary = {
        "runner": args.runner,
        "dataset": dataset,
        "seed": args.seed,
        "trials": statuses,
        "n_ok": sum(1 for s in statuses if s["status"] == "ok"),
        "n_failed": sum(1 for s in statuses if s["status"] == "failed"),
        "n_skipped": sum(1 for s in statuses if s["status"] == "skipped"),
        "csv": csv_path if rows else None,
    }
    spath = os.path.join(args.outdir, "sweep_summary.json")
    with open(spath, "w") as fh:
        json.dump(summary, fh, indent=2)
    print(f"sweep summary: {summary['n_ok']} ok, {summary['n_failed']} "
          f"failed, {summary['n_skipped']} skipped -> {spath}")
    return summary


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, passthrough = argv[:split], argv[split + 1:]
    else:
        passthrough = []
    args = build_parser().parse_args(argv)
    if args.dataset and args.runner != "fashion_train":
        # cifar10_train defines no --dataset flag; every child would die
        # at argparse with rc=2 after burning the retry budget
        print(f"error: --dataset is only supported by the fashion_train "
              f"runner (got --runner {args.runner})", file=sys.stderr)
        return 2
    dataset = args.dataset or RUNNERS[args.runner]
    # a SIGTERM (e.g. from ``timeout``) unwinds through run_trial, which
    # then kills the running trial's process group
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    os.makedirs(os.path.join(args.outdir, "logs"), exist_ok=True)

    cumulative_timing = {}
    statuses = []
    t_start = time.time()
    for latent_dim, dist_name, trial_num in trial_cells(args):
        exp = exp_name_for(args, dataset, latent_dim, dist_name, trial_num)
        mpath = os.path.join(args.outdir, "results", exp, "metrics.json")
        entry = {"exp": exp, "latent_dim": latent_dim, "dist": dist_name,
                 "trial": trial_num}
        if not args.no_resume and os.path.exists(mpath):
            print(f"[skip] {exp} (metrics.json exists)")
            statuses.append({**entry, "status": "skipped"})
            continue
        cmd = build_cmd(args, passthrough, latent_dim, dist_name, trial_num)
        if args.dry_run:
            print("[dry]", " ".join(cmd))
            statuses.append({**entry, "status": "dry"})
            continue
        log_path = os.path.join(args.outdir, "logs", f"{exp}.log")
        for attempt in range(args.retries + 1):
            print(f"[run ] {exp} (attempt {attempt + 1})", flush=True)
            rc, secs = run_trial(cmd, args.trial_timeout, log_path)
            ok = rc == 0 and os.path.exists(mpath)
            merge_timing(args.outdir, args.runner, cumulative_timing)
            if ok:
                break
            print(f"[fail] {exp}: rc={rc} after {secs:.1f}s "
                  f"(log: {log_path})")
        statuses.append({**entry,
                         "status": "ok" if ok else "failed",
                         "rc": rc, "seconds": round(secs, 1),
                         "log": log_path})
        state = "ok" if ok else "FAILED"
        print(f"[{state:>4}] {exp} in {secs:.1f}s", flush=True)

    if not args.dry_run:
        if any(s["status"] != "skipped" for s in statuses):
            # merged, not overwritten: sweeps sliced by trial or family
            # into one outdir keep each other's per-trial seconds; an
            # invocation that ran no trial leaves the file as it is
            cumulative_timing["total_script_time_s"] = time.time() - t_start
            merge_json_write(os.path.join(args.outdir,
                                          f"{args.runner}_timing.json"),
                             cumulative_timing)
        aggregate(args, dataset, statuses)
    # exit code: 0 all ok, 1 every trial failed, 2 partial failures — so a
    # driver/CI can detect incomplete sweeps without parsing the logs
    n_failed = sum(1 for s in statuses if s["status"] == "failed")
    if not n_failed:
        return 0
    return 1 if n_failed == len(statuses) else 2


if __name__ == "__main__":
    sys.exit(main())
