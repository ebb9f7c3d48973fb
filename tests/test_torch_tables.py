"""The port's tables (cliffordtpu_torch/eval/tables.py) against
cliffordtpu/eval/tables.py on the committed MNIST comparison sidecars
(``artifacts/real_digits_cnn_tpu/results/comparisons/mnist32``, read in
place): the ``.tex``, ``.csv`` and trial-stats files byte for byte, and
the comparison figure written under the JAX name."""

import json
import os
from pathlib import Path

import pytest

from cliffordtpu.eval import tables as jtables
from cliffordtpu_torch.eval import tables

COMPARISONS = (Path(__file__).resolve().parents[1] / "artifacts"
               / "real_digits_cnn_tpu" / "results" / "comparisons"
               / "mnist32")


def _files(d):
    return {p.name: p.read_bytes() for p in Path(d).iterdir()}


def _across_dims():
    return json.loads((COMPARISONS / "across_dims_data.json").read_text())


def _trials(across):
    """Every entry repeated as a second trial with shifted values, so the
    mean +- std cells and the stats file are written too."""
    out = {}
    for dist, data in across.items():
        rep = {"dims": list(data["dims"]) * 2}
        for key, vals in data.items():
            if key != "dims":
                rep[key] = list(vals) + [v * 0.97 for v in vals]
        out[dist] = rep
    return out


@pytest.mark.parametrize("trials", [False, True], ids=["sidecar", "trials"])
def test_across_dims_files_are_byte_equal(tmp_path, trials):
    across = _across_dims()
    if trials:
        across = _trials(across)
    dims = sorted({d for v in across.values() for d in v["dims"]})
    want = jtables.plot_across_dims_comparison(
        across, dims, "mnist32", str(tmp_path / "jax"))
    got = tables.plot_across_dims_comparison(
        across, dims, "mnist32", str(tmp_path / "port"))
    assert os.path.basename(got) == os.path.basename(want) \
        == "mnist32_results.tex"
    want_files, got_files = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert got_files == want_files
    assert ("mnist32_results_stats.csv" in got_files) == trials
    assert tables.plot_across_dims_comparison({}, dims, "x",
                                              str(tmp_path)) is None


def test_cross_dist_comparison_writes_the_jax_figure(tmp_path):
    dim = json.loads((COMPARISONS / "dim128_data.json").read_text())
    path = tables.plot_cross_dist_comparison_dim(dim, 128, "mnist32",
                                                 str(tmp_path))
    assert os.path.basename(path) == "vsa_comparison_d128.png"
    assert os.path.getsize(path) > 10_000
    assert tables.ORDER == jtables.ORDER
    assert (tables.COLORS, tables.LABELS, tables.LABELS_TEX) == (
        jtables.COLORS, jtables.LABELS, jtables.LABELS_TEX)
