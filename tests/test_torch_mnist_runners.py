"""The port's MNIST runners (cliffordtpu_torch/scripts/mnist_clifpws.py,
mnist_vmf.py and cliffordtpu_torch/runners/mnist_runner.py) against the
JAX scripts, without running the JAX runners whole:

* the tables: from the committed sidecar of the JAX across-dims sweep
  (``artifacts/across_dims_mnist``), the port's
  ``_regenerate_summary_tables`` writes ``mnist_vae_results.csv`` and the
  three ``results/comparisons/mnist/`` files byte for byte as committed;
  the vMF CSV built from the committed trial's ``metrics.json`` is the
  committed ``mnist_vmf_results.csv``;
* the run, fit and eval keys of both runners equal ``jax.random.fold_in``'s
  words, and the fit keys ``fit_trials`` receives are JAX's;
* both parsers' defaults are the JAX parsers' (the port adds ``--device``);
* the ``eval_checkpoint`` child's argv is JAX's apart from the module
  path and ``--device``;
* in-process smokes on the CPU at tests/test_runners.py's tiny configs
  (``--vmap_trials --train_only``; ``--vmap_trials --full_eval_runs 1``)
  with the same assertions, and one ``mnist_vmf --simple``."""

import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import pytest
import torch

from cliffordtpu.utils import stable_hash as jax_stable_hash
from cliffordtpu_torch import random
from cliffordtpu_torch.runners import cnn_runner, mnist_runner
from cliffordtpu_torch.scripts import mnist_clifpws, mnist_vmf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ACROSS = ROOT / "artifacts" / "across_dims_mnist"
VMF = ROOT / "artifacts" / "real_digits_vmf"
TINY = ["--d_dims", "2", "--n_runs", "2", "--epochs", "2",
        "--warmup_epochs", "1", "--patience", "5", "--batch_size", "32",
        "--limit_train", "128", "--no_wandb", "--vmap_trials",
        "--device", "cpu"]
TABLE_FILES = ("mnist_vae_results.csv",
               "results/comparisons/mnist/mnist_results.csv",
               "results/comparisons/mnist/mnist_results.tex",
               "results/comparisons/mnist/mnist_results_stats.csv")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    return {name: _jax_script(name) for name in ("mnist_clifpws",
                                                 "mnist_vmf")}


@pytest.fixture
def data_dir(monkeypatch):
    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", str(ROOT / "tests" / "data"))
    cwd = os.getcwd()
    yield
    os.chdir(cwd)  # the runners chdir into --outdir


@pytest.mark.parametrize("name", TABLE_FILES)
def test_summary_tables_are_byte_equal_to_the_committed_ones(
        tmp_path, monkeypatch, name):
    shutil.copy(ACROSS / mnist_clifpws.SIDECAR, tmp_path)
    monkeypatch.chdir(tmp_path)
    mnist_clifpws._regenerate_summary_tables(quiet=True)
    assert (tmp_path / name).read_bytes() == (ACROSS / name).read_bytes()


def test_vmf_csv_is_byte_equal_to_the_committed_one(tmp_path, monkeypatch):
    m = json.loads((VMF / "results" / "mnist-vmf-d5-l1-trial1"
                    / "metrics.json").read_text())
    row = mnist_vmf.results_row(
        5, {n: [m[f"knn_acc_{n}"]] for n in mnist_runner.KNN_SAMPLES},
        {n: [m[f"knn_f1_{n}"]] for n in mnist_runner.KNN_SAMPLES},
        [m["mean_vector_cosine_acc"]],
        {k: [m[f"test/{k}"]] for k in ("ll", "entropy", "recon", "kl")})
    monkeypatch.chdir(tmp_path)
    mnist_runner.print_results([row], "mnist_vmf_results.csv")
    assert (tmp_path / "mnist_vmf_results.csv").read_bytes() == (
        VMF / "mnist_vmf_results.csv").read_bytes()


def _words(key):
    return tuple(int(w) for w in key)


@pytest.mark.parametrize("seed,d,dist,r", [
    (0, 2, "normal", 0), (0, 5, "normal_nol2", 3), (0, 10, "powerspherical",
                                                    7),
    (0, 40, "clifford", 1), (3, 256, "clifford", 19)])
def test_run_and_fit_keys_are_jax_fold_in(seed, d, dist, r):
    assert mnist_runner.random is random
    assert jax_stable_hash(dist) == mnist_clifpws.stable_hash(dist)
    want = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 d * 1000 + r),
                              jax_stable_hash(dist) % 100_000)
    got = mnist_clifpws.run_key(seed, d, r, dist)
    assert got == _words(want)
    for data in (1, 2):  # fit, eval
        assert random.fold_in_words(got, data) == _words(
            jax.random.fold_in(want, data))
    want_vmf = jax.random.fold_in(jax.random.PRNGKey(seed), d * 1000 + r)
    assert mnist_vmf.run_key(seed, d, r) == _words(want_vmf)


@pytest.mark.parametrize("name", ["mnist_clifpws", "mnist_vmf"])
def test_parser_defaults_are_jax(jax_scripts, name):
    port = {"mnist_clifpws": mnist_clifpws, "mnist_vmf": mnist_vmf}[name]
    want = vars(jax_scripts[name].build_parser().parse_args([]))
    got = vars(port.build_parser().parse_args([]))
    assert got.pop("device") is None
    assert got == want


def _jax_child_cmd(jax_scripts, monkeypatch, name, args, **kw):
    from cliffordtpu.train import checkpoint

    seen = {}

    def fake_run(cmd, **run_kw):
        seen["cmd"], seen["env"] = cmd, run_kw["env"]
        return types.SimpleNamespace(returncode=1, stderr="")

    with monkeypatch.context() as m:
        m.setattr(checkpoint, "save_checkpoint", lambda *a, **k: None)
        m.setattr(subprocess, "run", fake_run)
        ok, _, _ = jax_scripts[name]._run_subprocess_eval(
            args, None, "/x/vis", arch="mlp", **kw)
    assert not ok and seen["env"]["JAX_PLATFORMS"] == "cpu"
    return seen["cmd"]


def _port_child_cmd(monkeypatch, args, **kw):
    seen = {}

    def fake_run(cmd, **run_kw):
        seen["cmd"] = cmd
        return types.SimpleNamespace(returncode=1, stderr="")

    with monkeypatch.context() as m:
        m.setattr(cnn_runner, "save_checkpoint", lambda *a, **k: None)
        m.setattr(cnn_runner, "subprocess",
                  types.SimpleNamespace(run=fake_run))
        ok, _, _ = cnn_runner.run_eval_child(
            None, "/x/vis", mnist_runner.child_argv(args, "/x/vis", **kw))
    assert not ok
    return seen["cmd"]


@pytest.mark.parametrize("name,flags,kw", [
    ("mnist_clifpws", [], dict(distribution="normal", latent_dim=5,
                               l2_normalize=True, table_only=False)),
    ("mnist_clifpws", ["--limit_train", "128", "--limit_test", "48",
                       "--vsa_trials", "3"],
     dict(distribution="powerspherical", latent_dim=6, l2_normalize=False,
          table_only=True)),
    ("mnist_vmf", ["--limit_test", "64"],
     dict(distribution="vmf", latent_dim=6, l2_normalize=False))])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_child_argv_is_jax(jax_scripts, monkeypatch, name, flags, kw,
                           device):
    port = {"mnist_clifpws": mnist_clifpws, "mnist_vmf": mnist_vmf}[name]
    jargs = jax_scripts[name].build_parser().parse_args(flags)
    args = port.build_parser().parse_args(
        flags + ([] if device is None else ["--device", device]))
    want = _jax_child_cmd(jax_scripts, monkeypatch, name, jargs, **kw)
    got = _port_child_cmd(monkeypatch, args, **kw)
    assert got[:3] == [sys.executable, "-m", cnn_runner.EVAL_MODULE]
    assert want[0] == sys.executable
    assert want[1].endswith(os.path.join("scripts", "eval_checkpoint.py"))
    tail = [] if device is None else ["--device", device]
    assert got[3:] == want[2:] + tail


def test_cnn_child_argv_is_unchanged(monkeypatch):
    """The CNN runner's child goes through the same launcher with its own
    arguments."""
    seen = {}
    monkeypatch.setattr(cnn_runner, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.setattr(cnn_runner, "subprocess", types.SimpleNamespace(
        run=lambda cmd, **kw: seen.update(cmd=cmd)
        or types.SimpleNamespace(returncode=1, stderr="")))
    args = types.SimpleNamespace(
        arch="hybrid", _actual_dist="clifford", vsa_trials=2,
        fid_samples=64, device="cpu", _actual_l2=False, limit_train=None,
        limit_test=32, keep_ckpts=False)
    assert not cnn_runner._run_subprocess_eval(args, None, "/o", "mnist32",
                                               8)[0]
    assert seen["cmd"] == [
        sys.executable, "-m", "cliffordtpu_torch.scripts.eval_checkpoint",
        "--ckpt", "/o", "--arch", "hybrid", "--distribution", "clifford",
        "--latent_dim", "8", "--dataset", "mnist32", "--outdir", "/o",
        "--vsa_trials", "2", "--fid_samples", "64", "--device", "cpu",
        "--limit_test", "32"]


def test_mlp_runner_vmap_trials_train_only(tmp_path, monkeypatch, data_dir):
    """--vmap_trials + --train_only: both lanes train at once from JAX's
    fit keys, eval stages take their defaults, the artifact contract
    holds and the NaN metrics give numpy's "nan±nan" cells."""
    fit_keys = []
    real_fit_trials = mnist_runner.fit_trials

    def recording_fit_trials(states, keys, *a, **kw):
        fit_keys.append([tuple(k) for k in keys])
        return real_fit_trials(states, keys, *a, **kw)

    monkeypatch.setattr(mnist_runner, "fit_trials", recording_fit_trials)
    args = mnist_clifpws.build_parser().parse_args(TINY + [
        "--limit_test", "32", "--distributions", "clifford",
        "--train_only", "--outdir", str(tmp_path)])
    mnist_clifpws.run(args)

    root = jax.random.PRNGKey(0)
    assert fit_keys == [[_words(jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(root, 2000 + r),
        jax_stable_hash("clifford") % 100_000), 1)) for r in (0, 1)]]
    for t in (1, 2):
        m = json.loads(
            (tmp_path / "results" / f"mnist-clifford-d2-l1-trial{t}"
             / "metrics.json").read_text())
        assert math.isfinite(m["final_val_loss"])  # training really ran
        assert math.isnan(m["test/ll"])            # eval really skipped
    csv = (tmp_path / "mnist_vae_results.csv").read_text().splitlines()
    cells = dict(zip(csv[0].split(","), csv[1].split(",")))
    assert cells["d"] == "2" and cells["CLIFFORD_ll"] == "nan±nan"
    assert cells["CLIFFORD_acc_100"] == "N/A"
    timing = json.loads((tmp_path / "mnist_clifpws_timing.json").read_text())
    assert timing["data_source"] == "real"
    assert set(timing) == {"data_source", "total_script_time_s",
                           "clifford_d2_run1", "clifford_d2_run2"}


def test_mlp_runner_full_eval_runs_gates_battery(tmp_path, data_dir):
    """--full_eval_runs 1 with n_runs 2: run 1 gets the heavy VSA battery
    (non-empty capacity curves), run 2 keeps only the table-feeding eval
    (knn / mvc / test metrics present, curves empty)."""
    args = mnist_clifpws.build_parser().parse_args(TINY + [
        "--limit_test", "48", "--distributions", "clifford",
        "--vsa_trials", "2", "--full_eval_runs", "1",
        "--outdir", str(tmp_path)])
    mnist_clifpws.run(args)

    trial = tmp_path / "results"
    vsa1 = json.loads((trial / "mnist-clifford-d2-l1-trial1"
                       / "vsa_raw.json").read_text())
    vsa2 = json.loads((trial / "mnist-clifford-d2-l1-trial2"
                       / "vsa_raw.json").read_text())
    assert vsa1["bundle_cap"]["k"], "run 1 must carry the real battery"
    assert vsa1["role_filler"]["k"] and vsa1["self_binding_star"]["k_sims"]
    assert not vsa2["bundle_cap"]["k"], "run 2 must skip the battery"
    for t in (1, 2):
        m = json.loads((trial / f"mnist-clifford-d2-l1-trial{t}"
                        / "metrics.json").read_text())
        assert math.isfinite(m["final_val_loss"])
        assert math.isfinite(m["test/ll"])
        assert any(k.startswith("knn_acc") for k in m)
        assert "mean_vector_cosine_acc" in m
    vis = tmp_path / "visualizations" / "d_2" / "clifford"
    assert (vis / "role_filler_no_random_keys.png").exists()
    assert (vis / "deconv" / "role_filler_no_random_keys_deconv.png").exists()
    assert not (vis / "role_filler_capacity.png").exists()
    for name in TABLE_FILES[1:]:
        assert (tmp_path / name).exists(), name


def test_vmf_runner_simple(tmp_path, data_dir):
    """--simple: the test metrics and kNN only; no battery, no per-trial
    dumps; one CSV row per d and the timing JSON."""
    args = mnist_vmf.build_parser().parse_args(TINY + [
        "--limit_test", "48", "--simple", "--outdir", str(tmp_path)])
    mnist_vmf.run(args)
    assert not (tmp_path / "results").exists()
    csv = (tmp_path / "mnist_vmf_results.csv").read_text().splitlines()
    assert len(csv) == 2
    cells = dict(zip(csv[0].split(","), csv[1].split(",")))
    assert cells["d"] == "2" and cells["vMF_mvc"] == "N/A"
    assert cells["vMF_acc_100"] != "N/A" and "nan" not in cells["vMF_ll"]
    timing = json.loads((tmp_path / "mnist_vmf_timing.json").read_text())
    assert set(timing) == {"vmf_d2_run1", "vmf_d2_run2",
                           "total_script_time_s"}


def test_mlp_child_draws_the_per_class_panel(tmp_path, monkeypatch, capsys):
    """The MNIST runners' child (``eval_checkpoint --arch mlp --item_memory
    means``) hands the per-class test images, not flat rows, so its
    similarity figure is drawn and no stage fails."""
    from cliffordtpu_torch.nn.mlp_vae import MLPVAE
    from cliffordtpu_torch.scripts import eval_checkpoint
    from cliffordtpu_torch.train.checkpoint import save_checkpoint
    from cliffordtpu_torch.train.state import create_train_state

    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", str(ROOT / "tests" / "data"))
    out = tmp_path / "vis"
    save_checkpoint(str(out), create_train_state(
        MLPVAE(128, 5, "normal", True), "adam", 1e-3, device="cpu"))
    args = mnist_clifpws.build_parser().parse_args(
        ["--limit_train", "64", "--limit_test", "40", "--vsa_trials", "1",
         "--device", "cpu"])
    assert eval_checkpoint.main(mnist_runner.child_argv(
        args, str(out), distribution="normal", latent_dim=5,
        l2_normalize=True) + ["--fid_samples", "16"]) == 0
    assert "warning:" not in capsys.readouterr().out
    assert (out / "bundle_similarity_matrix.png").exists()
