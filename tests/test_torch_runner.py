"""The port's CNN runner (cliffordtpu_torch/runners/cnn_runner.py), its
scripts and its artifact helpers, against the JAX package where one runs:

* ``train_model``: one epoch of a ``CNNVAE`` (latent 16, 64 synthetic
  CIFAR images, batch 16, the cifar10 runner's defaults) from JAX's
  initial weights (carried by ``param_import``) with the same run key, in
  both packages: the best loss within 1e-4 relative, every parameter
  within 5e-4; at the fashion runner's lr 1e-3, one step within the same
  bars (1e-6 wherever the gradient is not within Adam's eps of zero), and
  four steps parting from JAX no further than JAX parts from itself when
  its images move by 1e-6;
* ``build_model``: each arch's model built with the JAX runner's
  constructor arguments (no forward pass);
* the CSV, byte-equal to ``pandas.DataFrame(rows).to_csv(index=False)``;
* the merge-on-write sidecars (as tests/test_runners.py holds the JAX
  ones) and their files against the JAX module's;
* one in-process ``run_cnn_experiments`` on the CPU at the JAX runner
  smoke's tiny config, with its artifact contract, and a second
  per-family run into the same directory that must aggregate;
* the flags that raised before (``--mesh``, ``--mesh_mode``,
  ``--scan_layers``, ``--fused_proj``) run; the port's ``eval_checkpoint``
  on a saved tiny ``MLPVAE``.
The whole JAX runner is not run here (tests/test_runners.py runs it)."""

import json
import math
import os
import sys

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from cliffordtpu.runners import cnn_runner as jrunner
from cliffordtpu.serving import _flatten_params
from cliffordtpu.utils import artifacts as jartifacts
from cliffordtpu_torch.data import load_dataset
from cliffordtpu_torch.nn import param_import
from cliffordtpu_torch.nn.mlp_vae import MLPVAE
from cliffordtpu_torch.runners import cnn_runner
from cliffordtpu_torch.scripts import cifar10_train, eval_checkpoint, \
    fashion_train
from cliffordtpu_torch.train.checkpoint import save_checkpoint
from cliffordtpu_torch.train.state import ClippedOptimizer, \
    create_train_state
from cliffordtpu_torch.utils import artifacts

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_jax_once  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--epochs", "1", "--warmup_epochs", "1", "--batch_size", "16",
        "--n_trials", "1", "--latent_dims", "8", "--limit_train", "64",
        "--limit_test", "64", "--vsa_trials", "1", "--fid_samples", "64",
        "--no_wandb", "--cycle_epochs", "2", "--patience", "0",
        "--device", "cpu"]
LOSS_BAR, PARAM_BAR = 1e-4, 5e-4


def _train_pair(monkeypatch, runner, dataset, n_train):
    """Both packages' ``train_model`` from JAX's initial weights on the
    runner's defaults (one epoch of batch 16, beta from the cyclical
    schedule) and one run key.  Returns the init, the port's and JAX's
    (parameters, best loss), the port's pre-clip gradient of each step by
    name, and a function that reruns JAX on other training images."""
    ds = load_dataset(dataset, n_train=64, n_test=32)
    x_train, x_test = ds["x_train"][:n_train], ds["x_test"]
    in_ch = x_train.shape[-1]
    argv = ["--epochs", "1", "--batch_size", "16", "--warmup_epochs", "1",
            "--cycle_epochs", "2", "--patience", "0"]
    jargs = torch_jax_once.jax_script(runner.__name__.rsplit(".", 1)[-1]) \
        .build_parser().parse_args(argv)
    args = runner.build_parser().parse_args(argv + ["--device", "cpu"])
    for a in (jargs, args):
        a.cur_lr, a.arch = a.lr, "cnn"
    run_key = jax.random.fold_in(jax.random.PRNGKey(0), 12345)
    jmodel = jrunner.build_model(jargs, "clifford", 16, in_ch)
    torch_jax_once.patch(monkeypatch)  # the JAX runs share one compile
    init = param_import.from_jax(_flatten_params(jax.device_get(
        torch_jax_once.created_once(
            run_key, jmodel, x_train[:2], optimizer="adamw",
            lr=jargs.cur_lr, clip_norm=1.0).params)), "clifford")

    def run_jax(images):
        jstate, jbest, _ = jrunner.train_model(jargs, jmodel, images, x_test,
                                               run_key)
        return param_import.from_jax(
            _flatten_params(jax.device_get(jstate.params)), "clifford"), jbest

    model = cnn_runner.build_model(args, "clifford", 16, in_ch)
    model.load_state_dict(init)
    names = [n for n, _ in model.named_parameters()]
    grads = []
    scale = ClippedOptimizer._scale

    def recording_scale(self, g, factor):  # before the clip scales them
        grads.append({n: t.detach().clone() for n, t in zip(names, g)})
        scale(self, g, factor)

    monkeypatch.setattr(ClippedOptimizer, "_scale", recording_scale)
    state, best = cnn_runner.train_model(args, model, x_train, x_test,
                                         np.asarray(run_key))[:2]
    assert math.isfinite(best)
    return (init, (state.model.state_dict(), best), run_jax(x_train), grads,
            x_train, run_jax)


def _max_diff(a, b):
    assert set(a) == set(b)
    return max((a[n] - b[n]).abs().max().item() for n in a)


def test_train_model_one_epoch_matches_jax(tmp_path, monkeypatch):
    """The cifar10 runner's defaults (AdamW at lr 3e-4), one epoch of 4
    steps and the test epoch: the best loss within 1e-4 relative, every
    parameter within 5e-4 (measured 2.3e-4).  At the fashion runner's lr
    1e-3 the two trajectories part further; the two tests below show why."""
    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", str(tmp_path))
    init, (got, best), (want, jbest), grads, _, _ = _train_pair(
        monkeypatch, cifar10_train, "cifar10", 64)
    assert len(grads) == 4
    assert abs(best - jbest) <= LOSS_BAR * abs(jbest), (best, jbest)
    for name, w in want.items():
        assert (got[name] - w).abs().max().item() <= PARAM_BAR, name
    # the epoch moved the weights well beyond the bar
    assert (got["decoder.fc.weight"] - init["decoder.fc.weight"]).abs() \
        .max().item() > 2 * PARAM_BAR


def test_train_model_first_step_at_the_fashion_lr_matches_jax(
        tmp_path, monkeypatch):
    """The fashion runner's lr 1e-3, one step of 16 images: the loss within
    1e-4 relative, every parameter within 5e-4 (the repo's bars; measured
    1.9e-7 and 7.1e-6), and within 1e-6 wherever the gradient exceeds
    1e-7 of its global norm.  After the clip at 1 that is 1e-7 in size,
    ten times Adam's eps (1e-8): only below it is Adam's step
    proportional to the gradient rather than +-lr, so float32 rounding of
    a gradient near 0 moves its parameter (measured: every parameter
    beyond 1e-6 has a gradient within 3.3e-8 of the norm)."""
    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", str(tmp_path))
    _, (got, best), (want, jbest), grads, _, _ = _train_pair(
        monkeypatch, fashion_train, "fashionmnist", 16)
    assert len(grads) == 1
    assert abs(best - jbest) <= LOSS_BAR * abs(jbest), (best, jbest)
    assert _max_diff(got, want) <= PARAM_BAR
    g = grads[0]
    norm = torch.sqrt(sum((t ** 2).sum() for t in g.values())).item()
    n_sure = 0
    for name, w in want.items():
        sure = g[name].abs() > 1e-7 * norm
        n_sure += int(sure.sum())
        if sure.any():
            assert (got[name] - w).abs()[sure].max().item() <= 1e-6, name
    # the rule leaves out few parameters (measured 1.0%)
    assert n_sure >= 0.98 * sum(t.numel() for t in g.values())


def test_train_model_at_the_fashion_lr_parts_as_jax_from_itself(
        tmp_path, monkeypatch):
    """The fashion runner's lr 1e-3, one epoch of 4 steps.  The step
    above parts only in parameters whose gradient is within Adam's eps of
    0, and the later steps amplify it: JAX trained on its images moved by
    1e-6 (normal, seed 0) parts from JAX by 2.0e-3 in the parameters and
    8.8e-5 in the best loss, the port by 2.0e-3 and 1.2e-4 (measured).  So
    the port must stay within twice JAX's own parting (the loss within
    twice it or twice the 1e-4 bar), with JAX's above the parameter bar: a
    fault of the port would show as more."""
    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", str(tmp_path))
    _, (got, best), (want, jbest), _, x_train, run_jax = _train_pair(
        monkeypatch, fashion_train, "fashionmnist", 64)
    noise = np.random.default_rng(0).standard_normal(x_train.shape)
    moved, mbest = run_jax((x_train + 1e-6 * noise).astype(np.float32))
    jax_own = _max_diff(moved, want)
    assert jax_own > PARAM_BAR
    assert _max_diff(got, want) <= 2 * jax_own
    assert abs(best - jbest) <= 2 * max(abs(mbest - jbest),
                                        LOSS_BAR * abs(jbest)), (best, jbest)


@pytest.mark.parametrize("arch,dist", [
    ("cnn", "clifford"), ("cnn", "gaussian"), ("cnn", "gaussian_nol2"),
    ("hybrid", "powerspherical"), ("vit", "clifford")])
def test_build_model_takes_the_jax_arguments(arch, dist):
    argv = ["--arch", arch, "--recon_loss", "mse", "--l1_weight", "0.5"]
    jargs = torch_jax_once.jax_script("fashion_train").build_parser() \
        .parse_args(argv)
    args = fashion_train.build_parser().parse_args(argv)
    in_ch = 3 if arch == "cnn" else 1
    want = jrunner.build_model(jargs, dist, 64, in_ch)
    got = cnn_runner.build_model(args, dist, 64, in_ch)
    assert type(got).__name__ == type(want).__name__
    for field in ("latent_dim", "in_channels", "distribution",
                  "recon_loss_type", "l1_weight", "l2_normalize",
                  "use_learnable_beta"):
        assert getattr(got, field) == getattr(want, field), field
    size = "image_size" if arch == "vit" else "img_size"
    assert getattr(got, size) == getattr(want, size) == 32


def test_results_csv_is_what_pandas_writes(tmp_path):
    nan = float("nan")

    def trial(a, f, loss):
        return {"knn_acc_100": a, "knn_acc_600": a + 0.1,
                "knn_acc_1000": a + 0.2, "knn_f1_100": a / 2,
                "knn_f1_600": a / 3, "knn_f1_1000": a / 4, "mvc": 1 - a,
                "fid": f, "best_loss": loss}

    all_trials = {
        (4096, "clifford"): [trial(0.5, 12.25, 30.5)],
        (128, "gaussian"): [trial(0.25, nan, 41.0), trial(0.3, 8.0, 40.0)],
        (128, "a,b \"q\""): [trial(0.125, nan, 50.125)],
        (4096, "powerspherical"): [trial(0.7, 3.0, 20.0),
                                   trial(0.75, 5.0, 21.0),
                                   trial(0.8, nan, 22.5)],
    }
    rows = cnn_runner.results_rows(all_trials)
    assert [(r["d"], r["dist"]) for r in rows] == sorted(all_trials)
    assert rows[1]["fid"] == "8.0" and rows[0]["fid"] == "N/A"
    got, want = tmp_path / "port.csv", tmp_path / "pandas.csv"
    cnn_runner.write_results_csv(rows, str(got))
    pd.DataFrame(rows).to_csv(str(want), index=False)
    assert got.read_bytes() == want.read_bytes()
    table = cnn_runner.format_table(rows).splitlines()
    assert len(table) == len(rows) + 1 and "best_loss" in table[0]


def test_merge_across_dims_as_in_jax(tmp_path):
    """Dim groups replace, siblings survive, trial multiplicity per dim is
    kept; the file equals the JAX module's."""
    first = {"clifford": {"dims": [8, 8, 16], "knn_100": [0.1, 0.2, 0.3],
                          "mean_cosine": [0.5, 0.6, 0.7]}}
    second = {
        "gaussian": {"dims": [8], "knn_100": [0.9], "mean_cosine": [0.4]},
        "clifford": {"dims": [8], "knn_100": [0.15], "mean_cosine": [0.55]},
    }
    files = {}
    for name, mod in (("port", artifacts), ("jax", jartifacts)):
        path = str(tmp_path / f"{name}.json")
        mod.merge_across_dims(path, first)
        merged = mod.merge_across_dims(path, second)
        assert set(merged) == {"clifford", "gaussian"}
        assert merged["clifford"]["dims"] == [8, 16]
        assert merged["clifford"]["knn_100"] == [0.15, 0.3]
        assert merged["gaussian"]["dims"] == [8]
        with open(path, "rb") as f:
            files[name] = f.read()
        assert json.loads(files[name]) == merged
    assert files["port"] == files["jax"]


def test_corrupt_sidecar_is_kept_and_writes_are_atomic(tmp_path):
    path = str(tmp_path / "side.json")
    with open(path, "w") as f:
        f.write('{"clifford": {"dims": [8], "knn_100"')  # truncated
    assert artifacts.load_json(path) == {}
    corrupt = tmp_path / "side.json.corrupt"
    assert corrupt.read_text().startswith('{"clifford"')
    assert artifacts.merge_json_write(path, {"gaussian": 1}) == {
        "gaussian": 1}
    artifacts.merge_across_dims(str(tmp_path / "across.json"),
                                {"clifford": {"dims": [8],
                                              "knn_100": [0.5]}})
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []
    assert artifacts.jsonable({"a": torch.tensor([1.5, 2.0]),
                               "b": (np.float32(0.25), torch.tensor(3.0))}) \
        == {"a": [1.5, 2.0], "b": [0.25, 3.0]}


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The TINY clifford run with no flag, in process on the CPU: its
    output directory.  The smoke below adds a gaussian run to it."""
    out = tmp_path_factory.mktemp("tiny")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIFFORDTPU_DATA_DIR", str(out / "none"))
        _flag_run(fashion_train, [], out, "smoke")
    return out


def test_cnn_runner_inprocess_smoke(tiny_run, monkeypatch):
    """Train + the in-process battery at a tiny config on the CPU; the
    artifact contract; a second per-family run aggregates."""
    tmp_path = tiny_run
    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", str(tmp_path / "none"))
    exp = tmp_path / "results" / "fashionmnist-clifford-d8-l1"
    metrics = json.loads((exp / "metrics.json").read_text())
    assert math.isfinite(metrics["final_best_total_loss"])
    assert metrics["fid_features"] == "random_conv"
    vsa = json.loads((exp / "vsa_raw.json").read_text())
    assert set(vsa) == {"bundle_cap", "role_filler", "self_binding_star",
                        "self_binding_dagger"}
    assert vsa["bundle_cap"].get("k")
    assert vsa["self_binding_star"]["k_sims"]
    assert (tmp_path / "fashionmnist_results.csv").exists()
    assert (tmp_path / "smoke_timing.json").exists()
    cwd = os.getcwd()
    try:
        args = fashion_train.build_parser().parse_args(
            TINY + ["--distributions", "gaussian", "--outdir",
                    str(tmp_path)])
        cnn_runner.run_cnn_experiments(args, "fashionmnist", "smoke",
                                       full_eval=False)
    finally:
        os.chdir(cwd)
    csv_text = (tmp_path / "fashionmnist_results.csv").read_text()
    assert "8,clifford" in csv_text and "8,gaussian" in csv_text
    timing = json.loads((tmp_path / "smoke_timing.json").read_text())
    assert timing["data_source"] == "synthetic"
    assert any("clifford" in k for k in timing) and any(
        "gaussian" in k for k in timing)
    comp = tmp_path / "results" / "comparisons" / "fashionmnist"
    dim_data = json.loads((comp / "dim8_data.json").read_text())
    assert {"clifford", "gaussian", "random_hrr", "unitary"} <= set(dim_data)
    across = json.loads((comp / "across_dims_data.json").read_text())
    assert across["clifford"]["dims"] == across["gaussian"]["dims"] == [8]


@pytest.fixture(scope="module")
def plain_run(tiny_run):
    """The TINY clifford run with no flag: its best loss."""
    return json.loads((tiny_run / "results" / "fashionmnist-clifford-d8-l1"
                       / "metrics.json").read_text())["final_best_total_loss"]


def _flag_run(script, flags, out, timing_name="x"):
    cwd = os.getcwd()
    try:
        args = script.build_parser().parse_args(
            TINY + flags + ["--distributions", "clifford", "--outdir",
                            str(out)])
        cnn_runner.run_cnn_experiments(args, "fashionmnist", timing_name,
                                       full_eval=False)
    finally:
        os.chdir(cwd)
    exp = out / "results" / "fashionmnist-clifford-d8-l1"
    return json.loads((exp / "metrics.json").read_text())[
        "final_best_total_loss"]


@pytest.mark.parametrize("flags", [["--mesh", "dp"],
                                   ["--mesh", "dp", "--mesh_mode", "fsdp"],
                                   ["--scan_layers"], ["--fused_proj"]],
                         ids=["mesh", "mesh_mode", "scan_layers",
                              "fused_proj"])
def test_unported_flags_raise(flags, tmp_path, monkeypatch, plain_run):
    """The flags that raised before parallel/ and the ViT layouts were
    ported now run the runner at the TINY config on the CPU: ``--mesh dp``
    (a world of 1, no launcher) with DDP or FSDP2 gives the best loss of
    the run without it within 1e-6 relative; ``--scan_layers`` (the
    cifar10 parser) and ``--fused_proj`` train a narrow ``--arch vit`` of
    that layout, whose battery child would get the same flags."""
    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", str(tmp_path / "none"))
    if flags[0] == "--mesh":
        best = _flag_run(fashion_train, flags, tmp_path)
        assert abs(best - plain_run) <= 1e-6 * abs(plain_run), (
            best, plain_run)
        return
    built, vit = [], cnn_runner.CliffordARVAE

    def narrow(**kw):
        kw.update(cnn_chs=[8, 16, 32], z_channels=32, encoder_vit_layers=1,
                  decoder_vit_layers=1)
        built.append(vit(**kw))
        return built[-1]

    monkeypatch.setattr(cnn_runner, "CliffordARVAE", narrow)
    if flags == ["--scan_layers"]:  # the cifar10 parser takes it too
        assert cifar10_train.build_parser().parse_args(
            TINY + flags).scan_layers_model
    best = _flag_run(fashion_train, flags + ["--arch", "vit"], tmp_path)
    assert math.isfinite(best)
    assert built and all(
        m.fused_proj == ("--fused_proj" in flags)
        and m.scan_layers == ("--scan_layers" in flags) for m in built)


def test_eval_checkpoint_scores_a_saved_model(tmp_path, monkeypatch):
    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", str(tmp_path / "none"))
    st = create_train_state(MLPVAE(128, 5, "clifford"), "adam", 1e-3,
                            device="cpu")
    save_checkpoint(str(tmp_path), st)
    rc = eval_checkpoint.main([
        "--ckpt", str(tmp_path), "--arch", "mlp", "--distribution",
        "clifford", "--latent_dim", "5", "--dataset", "mnist",
        "--img_size", "28", "--outdir", str(tmp_path / "out"),
        "--limit_train", "128", "--limit_test", "64", "--vsa_trials", "2",
        "--fid_samples", "32", "--skip_plots", "--device", "cpu"])
    assert rc == 0
    metrics = json.loads((tmp_path / "out" / "metrics.json").read_text())
    assert 0 <= metrics["knn_acc_100"] <= 1
    assert math.isfinite(metrics["generation_fid"])
    vsa = json.loads((tmp_path / "out" / "vsa_raw.json").read_text())
    assert vsa["bundle_cap"]["k"] and vsa["self_binding_star"]["k_sims"]
    assert eval_checkpoint.main([
        "--ckpt", str(tmp_path / "empty"), "--arch", "mlp",
        "--distribution", "clifford", "--latent_dim", "5",
        "--outdir", str(tmp_path / "o2"), "--device", "cpu"]) == 2


def test_utils_seed_timer_and_logger(tmp_path):
    """``set_global_seeds`` gives the words of ``jax.random.PRNGKey``;
    ``Timer`` dumps its sections; ``WandbLogger`` with ``--no_wandb``
    stays off and ignores every call."""
    from cliffordtpu_torch import utils

    for seed in (0, 7, 2 ** 31 - 1):
        assert utils.set_global_seeds(seed) == tuple(
            int(w) for w in np.asarray(jax.random.PRNGKey(seed)))
    timer = utils.Timer()
    timer.start("train")
    timer.stop("train")
    timer.stop("never started")
    out = timer.dump(str(tmp_path / "t.json"))
    assert set(out) == {"train", "total_seconds"}
    assert json.loads((tmp_path / "t.json").read_text()) == out
    args = fashion_train.build_parser().parse_args(["--no_wandb"])
    logger = utils.WandbLogger(args)
    assert not logger.use
    logger.start_run("x", args)
    logger.log_metrics({"a": 1.0})
    logger.finish_run()
    assert utils.get_default_device("cpu") == "cpu"
    assert utils.CLASS_NAMES["mnist32"] == [str(i) for i in range(10)]
