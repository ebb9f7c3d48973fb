"""The port's figure and artifact scripts (cliffordtpu_torch/scripts:
figures_common and the three heatmaps, sample_viz, surface_area_plot,
rebuild_artifacts, replot_comparisons, eval_battery_timing,
paper_bind_bundle_figure) against the JAX scripts of the same names,
imported in process, on the CPU at small sizes:

* ``clifford_init``, ``hrr_init`` and ``unitary_init`` from the same key
  within 1e-6 (the normals of ``hrr_init`` part by XLA's float32
  ``erf_inv``, a few 1e-7 here);
* each heatmap's matrix at dims [4, 16], 64 items, 2 trials within 1e-6,
  the bar of tests/test_torch_vsa.py's capacity curves;
* ``sample_viz``'s five sampler columns and its projection at 64 points
  within 1e-5 (the bar of tests/test_torch_vmf.py's samples);
* ``surface_area_plot``'s series equal;
* ``rebuild_artifacts`` on a copy of the committed
  ``artifacts/real_digits_cnn_tpu`` (``--vsa_trials 1``): the CSV and the
  across-dims ``.tex`` / ``.csv`` byte-equal to JAX's rebuild of another
  copy (and the CSV to the committed one), the recomputed self-binding
  baselines within 1e-5;
* ``replot_comparisons`` on such a copy hands the plotter JAX's curves;
* ``eval_battery_timing`` prints JAX's JSON keys;
* ``paper_bind_bundle_figure`` on two saved tiny ``CNNVAE`` models;
* the entry points not told ``--device cpu`` raise without a GPU."""

import importlib.util
import json
import math
import os
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from cliffordtpu.eval import tables as jtables
from cliffordtpu.vsa import capacity as jcapacity
from cliffordtpu.vsa import ops as jops

from cliffordtpu_torch import random
from cliffordtpu_torch.nn.conv_vae import CNNVAE
from cliffordtpu_torch.scripts import (
    binding_depth_heatmap,
    bundle_heatmap,
    eval_battery_timing,
    figures_common,
    paper_bind_bundle_figure,
    rebuild_artifacts,
    replot_comparisons,
    rolefiller_heatmap,
    sample_viz,
    surface_area_plot,
)
from cliffordtpu_torch.train.checkpoint import save_checkpoint
from cliffordtpu_torch.train.state import create_train_state

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_TREE = ROOT / "artifacts" / "real_digits_cnn_tpu"


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jfc():
    return _jax_script("figures_common")


@pytest.mark.parametrize("d", [16])
def test_inits_match_jax(jfc, d):
    for name, fn in figures_common.INIT_FNS.items():
        want = np.asarray(jfc.INIT_FNS[name](jax.random.PRNGKey(5), 8, d))
        got = fn((0, 5), 8, d, device="cpu").numpy()
        assert got.shape == want.shape == (8, 2 * d if name == "Clifford"
                                           else d)
        assert np.abs(got - want).max() <= 1e-6, name


@pytest.mark.parametrize("kind,init", [
    ("bundle", "Clifford"), ("rolefiller", "HRR"), ("depth", "Unitary")])
def test_heatmaps_match_jax(jfc, kind, init):
    """One init per heatmap keeps JAX's per-shape compiles few; the inits
    themselves are held above."""
    dims = [4, 16]
    if kind == "depth":
        want, wd = jfc.run_depth_heatmap(jfc.INIT_FNS[init], init, dims,
                                         max_depth=8, n_trials=2)
        got, gd = figures_common.run_depth_heatmap(
            figures_common.INIT_FNS[init], init, dims, max_depth=8,
            n_trials=2, device="cpu")
        assert gd == wd
    else:
        k_range = [7, 40] if kind == "bundle" else [6, 40]
        jrun = getattr(jfc, f"run_{kind}_heatmap")
        trun = getattr(figures_common, f"run_{kind}_heatmap")
        want = jrun(jfc.INIT_FNS[init], init, dims, k_range, n_items=64,
                    n_trials=2)
        got = trun(figures_common.INIT_FNS[init], init, dims, k_range,
                   n_items=64, n_trials=2, device="cpu")
        assert np.isnan(got[:, -1]).all()  # 2k > n_items: no point
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.nanmax(np.abs(got - want)) <= 1e-6


def test_sample_viz_columns_match_jax(monkeypatch):
    jviz = _jax_script("sample_viz")
    monkeypatch.setattr(jviz, "N_SAMPLES", 64)
    monkeypatch.setattr(sample_viz, "N_SAMPLES", 64)
    key = jax.random.PRNGKey(0)
    assert [c[0] for c in sample_viz.COLUMNS] == \
        [c[0] for c in jviz.COLUMNS]
    pts = sample_viz.column_points((0, 0), 5.0, 4, "cpu")
    for i, ((name, tfn, _), (_, jfn, norm)) in enumerate(
            zip(sample_viz.COLUMNS, jviz.COLUMNS)):
        # jitted: one compile of the column instead of one per primitive
        want = jax.jit(jfn, static_argnums=(1, 2))(
            jax.random.fold_in(key, i), 5.0, 4)
        got = tfn(random.fold_in_words((0, 0), i), 5.0, 4,
                  torch.device("cpu"))
        assert tuple(got.shape) == want.shape, name
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5, name
        want_pts = jviz.to_3d(jviz.normalize(want) if norm else want)
        assert pts[name].shape == (64, 3)
        assert np.abs(pts[name] - want_pts).max() <= 1e-5, name


def test_surface_area_series_match_jax():
    jsa = _jax_script("surface_area_plot")
    c = surface_area_plot.curves()
    for name, (dims, vals) in c.items():
        if name == "clifford":
            want = np.array([(2 * np.pi) ** d for d in dims])
        elif name == "gaussian":
            want = np.array([jsa.gaussian_typical_shell_sa(d + 1)
                             for d in dims])
        else:
            want = np.array([jsa.hypersphere_sa(d + 1) for d in dims])
        assert np.array_equal(vals, want), name
    assert surface_area_plot.hypersphere_sa(3) == pytest.approx(4 * np.pi)


def _copy_tree(dst):
    """The committed JAX tree's JSON files (metrics, curves, sidecars)."""
    shutil.copytree(JAX_TREE, dst, ignore=lambda d, names: [
        n for n in names if n.endswith(".png")])
    return dst


def _stub_jax_baselines(monkeypatch):
    """Both rebuilds' per-dim comparison figure (a 300 dpi PNG, host
    matplotlib) stubbed, and JAX's two capacity sweeps (30 s of per-k
    compiles at 1000 items) replaced by a canned curve: neither enters the
    CSV or the tables.  The port's sweeps are JAX's at the same keys
    (tests/test_torch_vsa.py); the self-binding curves are held here."""
    def plot(dim_results, d, dataset, out_dir):
        return f"{out_dir}/vsa_comparison_d{d}.png"

    def curve(**kw):
        return {"k": list(kw["k_range"]), "accuracy": [0.5] *
                len(kw["k_range"]), "std": [0.0] * len(kw["k_range"])}

    monkeypatch.setattr(jtables, "plot_cross_dist_comparison_dim", plot)
    monkeypatch.setattr(rebuild_artifacts, "plot_cross_dist_comparison_dim",
                        plot)
    monkeypatch.setattr(jcapacity, "test_bundle_capacity", curve)
    monkeypatch.setattr(jcapacity, "test_binding_unbinding_pairs", curve)
    # the self-binding curves' 2,600 binds and unbinds jitted, as one
    # compile each instead of one per primitive
    monkeypatch.setattr(jops, "bind", jax.jit(jops.bind))
    monkeypatch.setattr(jops, "unbind",
                        jax.jit(jops.unbind, static_argnames="method"))
    monkeypatch.setattr(jops, "similarity", jax.jit(jops.similarity))


def test_rebuild_artifacts_writes_what_jax_rebuild_writes(tmp_path,
                                                          monkeypatch):
    jrb = _jax_script("rebuild_artifacts")
    j, t = _copy_tree(tmp_path / "jax"), _copy_tree(tmp_path / "port")
    _stub_jax_baselines(monkeypatch)
    monkeypatch.chdir(tmp_path)
    assert jrb.main(["--outdir", str(j), "--vsa_trials", "1"]) == 0
    monkeypatch.chdir(tmp_path)
    assert rebuild_artifacts.main(["--outdir", str(t), "--vsa_trials", "1",
                                   "--device", "cpu"]) == 0
    monkeypatch.chdir(tmp_path)
    assert (t / "mnist32_results.csv").read_bytes() == \
        (j / "mnist32_results.csv").read_bytes()
    assert (t / "mnist32_results.csv").read_bytes() == \
        (JAX_TREE / "mnist32_results.csv").read_bytes()
    comp = Path("results") / "comparisons" / "mnist32"
    for f in ("mnist32_results.tex", "mnist32_results.csv"):
        assert (t / comp / f).read_bytes() == (j / comp / f).read_bytes()
    got = json.loads((t / comp / "dim128_data.json").read_text())
    want = json.loads((j / comp / "dim128_data.json").read_text())
    assert got.keys() == want.keys()
    for ref in ("random_hrr", "unitary"):
        for curve in ("bundle_cap", "role_filler"):
            assert got[ref][curve]["k"] == want[ref][curve]["k"]
            assert len(got[ref][curve]["accuracy"]) == len(
                got[ref][curve]["k"])
        assert got[ref]["self_binding_k_values"] == list(range(1, 51))
        assert np.abs(np.subtract(got[ref]["self_binding_k_sims"],
                                  want[ref]["self_binding_k_sims"])
                      ).max() <= 1e-5


def test_replot_hands_the_plotter_jax_curves(tmp_path, monkeypatch):
    jrp = _jax_script("replot_comparisons")
    tree = _copy_tree(tmp_path / "tree")
    seen = {}

    def recorder(label):
        def plot(dim_results, d, dataset, out_dir):
            seen[label] = (dim_results, d, dataset, out_dir)
            return f"{out_dir}/vsa_comparison_d{d}.png"
        return plot

    monkeypatch.setattr(jrp, "plot_cross_dist_comparison_dim",
                        recorder("jax"))
    monkeypatch.setattr(replot_comparisons, "plot_cross_dist_comparison_dim",
                        recorder("port"))
    argv = ["--results_dir", str(tree / "results"), "--dataset", "mnist32",
            "--out", str(tmp_path / "out")]
    monkeypatch.setattr(sys, "argv", ["replot_comparisons.py"] + argv)
    assert jrp.main() == 0
    assert replot_comparisons.main(argv) == 0
    assert seen["port"] == seen["jax"]
    assert set(seen["port"][0]) == {"clifford", "gaussian", "gaussian_nol2",
                                    "powerspherical"}
    assert replot_comparisons.main(
        ["--results_dir", str(tree / "results"), "--dataset", "other"]) == 1


def test_eval_battery_timing_prints_jax_keys(monkeypatch, capsys):
    jt = _jax_script("eval_battery_timing")
    tiny = ["--d", "16", "--n_items", "8", "--n_trials", "2", "--repeat",
            "1"]
    monkeypatch.setattr(sys, "argv", ["eval_battery_timing.py", "--backend",
                                      "cpu"] + tiny)
    jt.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    eval_battery_timing.main(["--device", "cpu"] + tiny)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    assert got["backend"] == "cpu" and got["d"] == 16
    assert all(got[k] >= 0 for k in got if k.endswith("_s"))


def test_paper_figure_from_two_saved_models(tmp_path, monkeypatch):
    """Through chip_smoke's pyplot recorder, as on the card: the grids are
    computed and decoded, and no PNG is drawn."""
    monkeypatch.setenv("CLIFFORDTPU_DATA_DIR", str(tmp_path / "none"))
    dirs = {}
    for seed, dist in enumerate(("clifford", "gaussian")):
        model = CNNVAE(latent_dim=8, in_channels=1, distribution=dist,
                       img_size=32)
        torch.manual_seed(seed)
        state = create_train_state(model, "adamw", 1e-3, device="cpu")
        dirs[dist] = tmp_path / dist
        dirs[dist].mkdir()
        save_checkpoint(str(dirs[dist]), state, step=0)
    load = paper_bind_bundle_figure.load_dataset  # 64 training images
    monkeypatch.setattr(paper_bind_bundle_figure, "load_dataset",
                        lambda name, n_test: load(name, 64, n_test))
    with chip_smoke.plot_recorder(str(tmp_path)):
        result = paper_bind_bundle_figure.main([
            "--clifford_ckpt", str(dirs["clifford"]), "--gaussian_ckpt",
            str(dirs["gaussian"]), "--latent_dim", "8", "--output",
            str(tmp_path / "fig.png"), "--device", "cpu"])
    assert [label for label, _, _ in result] == ["Clifford", "Gaussian"]
    for _, img, sim in result:
        assert img is None  # the recorder draws no file
        assert math.isfinite(sim) and -1.0 <= sim <= 1.0
    with pytest.raises(FileNotFoundError):
        paper_bind_bundle_figure.load_model(str(tmp_path), "clifford", 8,
                                            "cnn", "fashionmnist", "cpu")


def _heatmap(mod):
    return lambda tmp: mod.compute(mod.build_parser().parse_args(
        ["--dims", "4"]))


@pytest.mark.parametrize("call", [
    _heatmap(bundle_heatmap), _heatmap(rolefiller_heatmap),
    _heatmap(binding_depth_heatmap),
    lambda tmp: sample_viz.column_points((0, 0), 5.0, 4),
    lambda tmp: eval_battery_timing.timing(
        eval_battery_timing.build_parser().parse_args([])),
    lambda tmp: rebuild_artifacts.main(["--outdir", str(tmp)]),
], ids=["bundle_heatmap", "rolefiller_heatmap", "binding_depth_heatmap",
        "sample_viz", "eval_battery_timing", "rebuild_artifacts"])
def test_entry_points_without_a_device_need_cuda(monkeypatch, tmp_path,
                                                 call):
    """With no GPU and no ``--device``, the figure scripts raise instead
    of moving to the CPU (``rebuild_artifacts`` before it changes
    directory)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cwd = os.getcwd()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(tmp_path)
    assert os.getcwd() == cwd
