"""The port's process-isolated sweep driver
(cliffordtpu_torch/scripts/sweep.py) against the JAX package's
``scripts/sweep.py``, imported in process (no JAX runner is shelled):

* ``trial_cells``, ``exp_name_for`` and the trial arguments of
  ``build_cmd`` equal JAX's (the port runs ``-m`` its own runner and adds
  ``--device``);
* ``run_trial`` kills a child that sleeps, with its process group, and
  the sweep records it as failed; no timeout races a runner's start-up;
* a failed trial is recorded, ``--retries`` runs it again, a re-run
  resumes it, and a last run skips every trial;
* ``aggregate``'s CSV and across-dims table are byte-equal to what JAX's
  ``aggregate`` (pandas) writes from the same ``metrics.json`` files;
* one shelled tiny trial (``--latent_dims 8`` with JAX's ``TINY``
  passthrough, ``--device cpu``: the driver's ``build_cmd`` and
  ``run_trial``, then ``aggregate``) writes the metrics that
  ``run_cnn_experiments`` in process writes with the same arguments, at
  the bars of ``tests/test_sweep.py``.
Runner children and the in-process run draw through chip_smoke's pyplot
recorder, and the child lacks scikit-learn (its t-SNE plot fails), as on
the card: plots do not enter the metrics compared."""

import importlib.util
import json
import math
import os
import sys
import threading
import time
import types
from pathlib import Path

import pytest
import torch

import chip_smoke
from cliffordtpu_torch.runners import cnn_runner
from cliffordtpu_torch.scripts import fashion_train, replot_comparisons, \
    sweep

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--epochs", "1", "--warmup_epochs", "1", "--batch_size", "16",
        "--limit_train", "48", "--limit_test", "48",
        "--vsa_trials", "1", "--fid_samples", "32",
        "--cycle_epochs", "2", "--patience", "0"]
SLEEPER = [sys.executable, "-c", "import time; time.sleep(60)"]


def _jax_sweep():
    spec = importlib.util.spec_from_file_location(
        "jax_sweep", ROOT / "scripts" / "sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [
    ["--n_trials", "1"],
    ["--n_trials", "3", "--dataset", "mnist32"],
    ["--n_trials", "2", "--start_trial", "4", "--recon_loss", "mse"],
], ids=["single", "multi", "resumed"])
def test_cells_names_and_commands_match_jax(extra):
    jsweep = _jax_sweep()
    argv = ["--runner", "fashion_train", "--outdir", "o", "--distributions",
            "clifford", "gaussian", "--latent_dims", "8", "16", "--seed",
            "3"] + extra
    ja = jsweep.build_parser().parse_args(argv)
    ta = sweep.build_parser().parse_args(argv)
    tb = sweep.build_parser().parse_args(argv + ["--device", "cpu"])
    cells = list(sweep.trial_cells(ta))
    assert cells == list(jsweep.trial_cells(ja))
    dataset = ta.dataset or sweep.RUNNERS[ta.runner]
    assert dataset == (ja.dataset or jsweep.RUNNERS[ja.runner])
    passthrough = ["--epochs", "2"]
    for cell in cells:
        assert sweep.exp_name_for(ta, dataset, *cell) == \
            jsweep.exp_name_for(ja, dataset, *cell)
        jcmd = jsweep.build_cmd(ja, passthrough, *cell)
        tcmd = sweep.build_cmd(ta, passthrough, *cell)
        assert jcmd[1].endswith(os.path.join("scripts", "fashion_train.py"))
        assert tcmd[1:3] == ["-m", "cliffordtpu_torch.scripts.fashion_train"]
        assert tcmd[3:] == jcmd[2:]
        assert sweep.build_cmd(tb, passthrough, *cell)[3:] == \
            jcmd[2:-2] + ["--device", "cpu"] + passthrough


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_run_trial_kills_a_sleeping_child_and_its_group(tmp_path):
    rc, secs = sweep.run_trial(SLEEPER, 1, tmp_path / "a.log")
    assert rc == 124 and secs < 30
    # a child that started a grandchild (as --eval_subprocess does): the
    # grandchild dies with it; 2 s leave the child time to write its pid
    pid_file = tmp_path / "grandchild.pid"
    parent = [sys.executable, "-c",
              "import subprocess, sys, time; "
              f"p = subprocess.Popen({SLEEPER!r}); "
              f"open({str(pid_file)!r}, 'w').write(str(p.pid)); "
              "time.sleep(60)"]
    rc, _ = sweep.run_trial(parent, 2, tmp_path / "b.log")
    assert rc == 124
    pid = int(pid_file.read_text())
    deadline = time.time() + 10
    while _alive(pid) and time.time() < deadline:
        time.sleep(0.05)
    assert not _alive(pid)
    rc, _ = sweep.run_trial([sys.executable, "-c", "raise SystemExit(3)"],
                            0, tmp_path / "c.log")
    assert rc == 3


def _fake_trial(marker_dir):
    """A build_cmd stand-in: a child that fails the first time it runs a
    trial the passthrough lists, and otherwise writes its metrics."""
    def build_cmd(args, passthrough, latent_dim, dist, trial):
        exp = sweep.exp_name_for(args, sweep.RUNNERS[args.runner],
                                 latent_dim, dist, trial)
        exp_dir = Path(args.outdir) / "results" / exp
        code = (
            "import json, os, sys\n"
            f"marker = {str(marker_dir / exp)!r}\n"
            f"if {str(trial)!r} in {passthrough!r} "
            "and not os.path.exists(marker):\n"
            "    open(marker, 'w').close()\n"
            "    sys.exit(3)\n"
            f"os.makedirs({str(exp_dir)!r}, exist_ok=True)\n"
            f"json.dump({{'final_best_total_loss': {100.0 + trial},"
            f" 'knn_acc_1000': 0.5, 'mean_vector_cosine_acc': 0.25}},"
            f" open(os.path.join({str(exp_dir)!r}, 'metrics.json'), 'w'))\n")
        return [sys.executable, "-c", code]
    return build_cmd


def test_failed_trial_is_recorded_retried_and_resumed(tmp_path,
                                                      monkeypatch):
    (tmp_path / "m").mkdir()
    monkeypatch.setattr(sweep, "build_cmd", _fake_trial(tmp_path / "m"))
    out = tmp_path / "sweep"
    base = ["--runner", "fashion_train", "--outdir", str(out),
            "--distributions", "clifford", "--latent_dims", "8",
            "--n_trials", "2"]

    def summary():
        return json.loads((out / "sweep_summary.json").read_text())

    # trial 2 fails once: recorded, partial exit code, no metrics
    assert sweep.main(base + ["--", "2"]) == 2
    s = summary()
    assert (s["n_ok"], s["n_failed"], s["n_skipped"]) == (1, 1, 0)
    assert s["trials"][1]["rc"] == 3 and s["trials"][1]["status"] == \
        "failed"
    assert Path(s["trials"][1]["log"]) == \
        out / "logs" / "fashionmnist-clifford-d8-l1-trial2.log"
    csv = (out / "fashionmnist_results.csv").read_text()
    assert csv.splitlines()[1].endswith(",101.0000")  # trial 1 alone
    # the re-run resumes: trial 1 skipped, trial 2 runs and succeeds
    assert sweep.main(base + ["--", "2"]) == 0
    s = summary()
    assert [t["status"] for t in s["trials"]] == ["skipped", "ok"]
    assert "101.5000±0.5000" in (out / "fashionmnist_results.csv").read_text()
    # nothing left: every trial skipped, the timing file kept as it was
    timing = (out / "fashion_train_timing.json").read_text()
    assert sweep.main(base + ["--", "2"]) == 0
    assert summary()["n_skipped"] == 2
    assert (out / "fashion_train_timing.json").read_text() == timing
    # --retries runs a failing trial again in the same invocation
    out2 = tmp_path / "retry"
    base[base.index(str(out))] = str(out2)
    (tmp_path / "m" / "fashionmnist-clifford-d8-l1").unlink(missing_ok=True)
    assert sweep.main(base[:-2] + ["--n_trials", "1", "--retries", "1",
                                   "--", "1"]) == 0
    s = json.loads((out2 / "sweep_summary.json").read_text())
    assert s["n_ok"] == 1 and s["trials"][0]["rc"] == 0
    # a timeout is a failure: every trial failed -> exit code 1
    monkeypatch.setattr(sweep, "build_cmd", lambda *a: SLEEPER)
    out3 = tmp_path / "timeout"
    base[base.index(str(out2))] = str(out3)
    assert sweep.main(base[:-2] + ["--n_trials", "1", "--trial_timeout",
                                   "1"]) == 1
    s = json.loads((out3 / "sweep_summary.json").read_text())
    assert s["n_failed"] == 1 and s["trials"][0]["rc"] == 124
    assert sweep.main(base[:-2] + ["--n_trials", "1", "--dry_run"]) == 0


def _write_trial(root, dataset, dist, d, trial, knn, loss, fid=True):
    exp = root / "results" / f"{dataset}-{dist}-d{d}-l1-trial{trial}"
    exp.mkdir(parents=True)
    m = {"final_best_total_loss": loss, "mean_vector_cosine_acc": knn / 2,
         "fid_features": "random_conv"}
    for n in (100, 600, 1000):
        m[f"knn_acc_{n}"] = knn + n / 1e5
        m[f"knn_f1_{n}"] = knn - n / 1e5
    if fid:
        m["generation_fid"] = 10.0 * knn + trial
    (exp / "metrics.json").write_text(json.dumps(m))
    curve = {"k": [5, 10], "accuracy": [knn, knn / 2], "std": [0.0, 0.0]}
    (exp / "vsa_raw.json").write_text(json.dumps({
        "bundle_cap": curve, "role_filler": curve,
        "self_binding_star": {"k_values": [1, 2], "k_sims": [0.9, 0.8]},
        "self_binding_dagger": {"k_values": [1, 2], "k_sims": [0.9, 0.8]}}))


def test_aggregate_writes_what_jax_aggregate_writes(tmp_path, monkeypatch):
    jsweep = _jax_sweep()
    # JAX's aggregate shells its replot; the port replots in process (its
    # drawing, a 300 dpi PNG per dim, stubbed: test_torch_figures.py holds
    # the replot's curves)
    monkeypatch.setattr(jsweep, "subprocess", types.SimpleNamespace(
        run=lambda *a, **k: types.SimpleNamespace(stdout="", returncode=0)))
    replotted = []
    monkeypatch.setattr(replot_comparisons, "plot_cross_dist_comparison_dim",
                        lambda res, d, ds, out: replotted.append((d, ds)))
    argv = ["--runner", "fashion_train", "--dataset", "mnist32",
            "--distributions", "clifford", "gaussian", "powerspherical",
            "--latent_dims", "8", "16", "--n_trials", "3"]
    outs = {}
    for name, mod in (("jax", jsweep), ("port", sweep)):
        out = tmp_path / name
        for i, (d, dist, trial) in enumerate(
                sweep.trial_cells(sweep.build_parser().parse_args(
                    argv + ["--outdir", "x"]))):
            if (dist, trial) == ("powerspherical", 3):
                continue  # a trial that left no metrics
            _write_trial(out, "mnist32", dist, d, trial, 0.5 + i / 97,
                         150.0 + i * 1.37, fid=dist != "gaussian" or d != 8)
        args = mod.build_parser().parse_args(argv + ["--outdir", str(out)])
        summary = mod.aggregate(args, "mnist32", [{"status": "ok"}])
        assert summary["n_ok"] == 1
        outs[name] = out
    j, t = outs["jax"], outs["port"]
    assert (t / "mnist32_results.csv").read_bytes() == \
        (j / "mnist32_results.csv").read_bytes()
    comp = Path("results") / "comparisons" / "mnist32"
    for f in ("mnist32_results.tex", "mnist32_results.csv"):
        assert (t / comp / f).read_bytes() == (j / comp / f).read_bytes()
    assert replotted == [(8, "mnist32"), (16, "mnist32")]
    assert "N/A" in (t / "mnist32_results.csv").read_text()  # no FID


def test_shelled_trial_matches_inprocess(tmp_path, monkeypatch):
    """A sweep-shelled trial reproduces the in-process runner trial: the
    same run key, data and names.  The driver's trial (``build_cmd``,
    ``run_trial``) runs in a thread while the in-process run trains, then
    ``aggregate`` reads it; the child keeps to one thread, as this
    process does."""
    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    sub_dir = tmp_path / "shelled"
    (sub_dir / "logs").mkdir(parents=True)
    sargs = sweep.build_parser().parse_args(
        ["--runner", "fashion_train", "--outdir", str(sub_dir),
         "--distributions", "clifford", "--latent_dims", "8", "--seed", "3",
         "--n_trials", "1", "--device", "cpu"])
    exp = "fashionmnist-clifford-d8-l1"
    log = sub_dir / "logs" / f"{exp}.log"
    shelled = {}
    with chip_smoke.plot_recorder(str(tmp_path)):
        # the child without scikit-learn, as on the card: its t-SNE stage
        # (a plot, not a metric) fails and is logged
        fake = tmp_path / "plot_recorder" / "sklearn"
        fake.mkdir()
        (fake / "__init__.py").write_text(
            "raise ModuleNotFoundError(\"No module named 'sklearn'\", "
            "name='sklearn')\n")
        trial = threading.Thread(target=lambda: shelled.update(
            rc=sweep.run_trial(sweep.build_cmd(sargs, TINY, 8, "clifford", 1),
                               600, log)[0]))
        trial.start()
        try:
            args = fashion_train.build_parser().parse_args(
                ["--n_trials", "1", "--latent_dims", "8",
                 "--distributions", "clifford", "--seed", "3", "--no_wandb",
                 "--device", "cpu", "--outdir", str(tmp_path / "inproc")]
                + TINY)
            cwd = os.getcwd()
            try:
                cnn_runner.run_cnn_experiments(args, "fashionmnist",
                                               "fashion_train",
                                               full_eval=True)
            finally:
                os.chdir(cwd)
        finally:
            trial.join(600)
        assert shelled.get("rc") == 0, log.read_text()[-3000:]
        summary = sweep.aggregate(sargs, "fashionmnist",
                                  [{"status": "ok"}])
    assert summary["csv"] and (sub_dir / "fashionmnist_results.csv").exists()
    m_sub = json.loads(
        (sub_dir / "results" / exp / "metrics.json").read_text())
    m_in = json.loads(
        (tmp_path / "inproc" / "results" / exp / "metrics.json").read_text())
    assert m_sub.keys() == m_in.keys()
    assert abs(m_sub["final_best_total_loss"]
               - m_in["final_best_total_loss"]) < 1e-4
    for k, v in m_in.items():
        if isinstance(v, float) and math.isfinite(v):
            assert abs(m_sub[k] - v) < 1e-6 * max(1.0, abs(v)), k
    v_sub = json.loads(
        (sub_dir / "results" / exp / "vsa_raw.json").read_text())
    v_in = json.loads(
        (tmp_path / "inproc" / "results" / exp / "vsa_raw.json").read_text())
    assert v_sub["bundle_cap"]["k"] == v_in["bundle_cap"]["k"]
    for a, b in zip(v_sub["bundle_cap"]["accuracy"],
                    v_in["bundle_cap"]["accuracy"]):
        assert abs(a - b) < 1e-6
    assert log.read_text().splitlines()[-1].startswith("kernel launches: ")
