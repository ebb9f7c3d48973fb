"""What the two MNIST runners share (``scripts/mnist_clifpws.py`` and
``scripts/mnist_vmf.py`` of the JAX package each carry their own copy):
the kNN sizes, the test batches, the 90/10 split of the digits, the
trials' training (one by one with ``fit``, or all at once with
``fit_trials`` under ``--vmap_trials``), the battery in the port's
``eval_checkpoint`` child under ``--eval_subprocess``, the per-trial
dumps, and the CSV and table of the results.

Keys follow the JAX runners word for word (the caller folds the run
key); the initial weights are the port's initialiser seeded from the run
key's words (``model_seed``), as the CNN runner seeds its models: the
same distributions as flax's, other values.  Everything runs on the
device of ``args.device`` (``None``: the card, ``resolve_device``),
the ``eval_checkpoint`` child too.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from cliffordtpu_torch import random
from cliffordtpu_torch.data import load_dataset
from cliffordtpu_torch.runners.cnn_runner import (
    format_table,
    write_results_csv,
)
from cliffordtpu_torch.runners.safety import EMPTY_BINDING, EMPTY_CURVE
from cliffordtpu_torch.train.loop import (
    fit,
    fit_trials,
    index_trial_state,
    make_mlp_eval_step,
    make_mlp_train_step,
    stack_trial_states,
)
from cliffordtpu_torch.train.schedules import linear_kl_warmup
from cliffordtpu_torch.train.state import create_train_state
from cliffordtpu_torch.utils import ensure_dir
from cliffordtpu_torch.utils.artifacts import jsonable

KNN_SAMPLES = [100, 600, 1000]
TEST_METRICS = ("ll", "entropy", "recon", "kl")
NAN_METRICS = {m: float("nan") for m in TEST_METRICS}


def batches(x, y, bs: int):
    for s in range(0, len(x), bs):
        yield x[s:s + bs], y[s:s + bs]


def load_mnist(args, require_real: bool = False) -> Dict:
    """The digits as the runners use them: rows of 784 pixels in [0, 1],
    the first 90% of the training set to train on and the rest to
    validate (``x_all`` / ``y_all`` keep the whole set), and ``source``.
    ``require_real`` refuses the synthetic fallback."""
    ds = load_dataset("mnist", n_train=args.limit_train,
                      n_test=args.limit_test)
    if ds["source"] == "synthetic" and require_real:
        raise SystemExit(
            "--require_real: no real MNIST found (searched "
            "$CLIFFORDTPU_DATA_DIR, ./data and the loader's fixed data "
            "directory — note the runner chdirs into --outdir, so pass "
            "an ABSOLUTE path)")
    x_all = ds["x_train"].reshape(len(ds["x_train"]), -1)
    y_all = ds["y_train"]
    n_train = int(0.9 * len(x_all))
    return {"x_all": x_all, "y_all": y_all,
            "x_train": x_all[:n_train], "y_train": y_all[:n_train],
            "x_val": x_all[n_train:],
            "x_test": ds["x_test"].reshape(len(ds["x_test"]), -1),
            "y_test": ds["y_test"], "images_test": ds["x_test"],
            "source": ds["source"]}


def model_seed(run_key) -> int:
    """The initial weights' seed: the run key's two words as one int."""
    return (int(run_key[0]) << 32) | int(run_key[1])


def _fit_kwargs(args, logger) -> Dict:
    return dict(
        epochs=args.epochs, batch_size=args.batch_size,
        beta_fn=lambda e: linear_kl_warmup(e, args.warmup_epochs),
        patience=args.patience if args.patience > 0 else 10**9,
        log_fn=((lambda e, m: logger.log_metrics({"epoch": e, **m}))
                if logger.use else None))


def train_lanes(args, make_model: Callable, run_keys: List, data: Dict,
                logger, device):
    """``--vmap_trials``: every trial of a cell trained at once by
    ``fit_trials`` (Adam at ``args.lr`` behind a clip at 1, fit key
    ``fold_in(run_key, 1)``).  ``make_model(seed)`` builds one trial's
    model.  Returns (stacked states, histories, seconds)."""
    states = stack_trial_states([
        create_train_state(make_model(model_seed(k)), "adam", lr=args.lr,
                           clip_norm=1.0, device=device) for k in run_keys])
    t0 = time.time()
    states, hists = fit_trials(
        states, [random.fold_in_words(k, 1) for k in run_keys],
        data["x_train"], data["x_val"], **_fit_kwargs(args, logger))
    vtime = time.time() - t0
    print(f"vmapped training: {len(run_keys)} trials in {vtime:.2f}s "
          f"({vtime / len(run_keys):.2f}s/trial amortized)")
    return states, hists, vtime


def train_trial(args, make_model: Callable, run_key, data: Dict, logger,
                device, lanes=None, index: int = 0):
    """One trial's trained state, history and training seconds: lane
    ``index`` of ``lanes`` (``train_lanes``; the seconds amortised over
    the lanes), else ``fit`` from the run key.  ``--scan_epochs`` takes
    the same loop (the JAX one-program epoch has no counterpart here)."""
    if lanes is not None:
        states, hists, vtime = lanes
        return (index_trial_state(states, index), hists[index],
                vtime / len(hists))
    t0 = time.time()
    state = create_train_state(make_model(model_seed(run_key)), "adam",
                               lr=args.lr, clip_norm=1.0, device=device)
    state, history = fit(
        state, make_mlp_train_step(state.model, state.optimizer),
        make_mlp_eval_step(state.model), random.fold_in_words(run_key, 1),
        data["x_train"], data["x_val"], **_fit_kwargs(args, logger))
    return state, history, time.time() - t0


def child_argv(args, outdir: str, *, distribution: str, latent_dim: int,
               l2_normalize: bool, rf_no_random_keys: bool = True,
               table_only: bool = False) -> List[str]:
    """The ``eval_checkpoint`` arguments of the JAX MNIST runners (the
    posterior-means item memory of n = 500, the role-filler variant with
    roles from the item memory), then ``--device`` when the run names
    one: ``cnn_runner.run_eval_child``'s ``argv`` for one trial."""
    argv = ["--ckpt", outdir, "--arch", "mlp",
            "--distribution", distribution,
            "--latent_dim", str(latent_dim),
            "--dataset", "mnist", "--img_size", "28",
            "--outdir", outdir,
            "--vsa_trials", str(args.vsa_trials),
            "--item_memory", "means"]
    if l2_normalize:
        argv += ["--l2_normalize"]
    if rf_no_random_keys:
        argv += ["--rf_no_random_keys"]
    if table_only:
        # beyond --full_eval_runs: only the table feed (kNN + mean-vector
        # cosine)
        argv += ["--table_only"]
    if args.limit_train:
        argv += ["--limit_train", str(args.limit_train)]
    if args.limit_test:
        argv += ["--limit_test", str(args.limit_test)]
    if getattr(args, "device", None) is not None:
        argv += ["--device", str(args.device)]
    return argv


def merge_child_battery(sub_vsa: Dict):
    """The child's curves as the runner's: (bundle capacity, role-filler,
    self-binding by "*", by "†"), the bindings' last similarity as their
    ``binding_k_self_similarity``."""
    star = {**EMPTY_BINDING, **sub_vsa.get("self_binding_star", {})}
    dagger = {**EMPTY_BINDING, **sub_vsa.get("self_binding_dagger", {})}
    for fr in (star, dagger):
        if fr.get("k_sims"):
            fr["binding_k_self_similarity"] = float(fr["k_sims"][-1])
    return (sub_vsa.get("bundle_cap", dict(EMPTY_CURVE)),
            sub_vsa.get("role_filler", dict(EMPTY_CURVE)), star, dagger)


def write_trial(trial_dir: str, *, bundle_cap, role_filler, star: Dict,
                dagger: Dict, knn_results: Dict, mean_vector_acc,
                test_metrics: Dict, best_val_loss) -> None:
    """A trial's ``vsa_raw.json`` and ``metrics.json``."""
    ensure_dir(trial_dir)
    raw_vsa = {
        "bundle_cap": bundle_cap,
        "role_filler": role_filler,
        "self_binding_star": {"k_values": star.get("k_values", []),
                              "k_sims": star.get("k_sims", [])},
        "self_binding_dagger": {"k_values": dagger.get("k_values", []),
                                "k_sims": dagger.get("k_sims", [])},
    }
    with open(os.path.join(trial_dir, "vsa_raw.json"), "w") as f:
        json.dump(jsonable(raw_vsa), f)
    metrics = {
        **{k: v for k, v in knn_results.items() if k.startswith("knn_")},
        "mean_vector_cosine_acc": float(mean_vector_acc),
        **{f"test/{m}": test_metrics[m] for m in TEST_METRICS},
        "final_val_loss": best_val_loss,
    }
    with open(os.path.join(trial_dir, "metrics.json"), "w") as f:
        json.dump(jsonable(metrics), f, indent=2)


def print_results(rows: List[Dict], path: str,
                  title: Optional[str] = "all metrics") -> None:
    """``rows`` (``d`` first) to the CSV at ``path``, the text
    ``pandas.DataFrame(rows).set_index("d").to_csv(path)`` writes, and,
    with a ``title``, to stdout as a table."""
    if title:
        print("\n" + "=" * 25 + f" {title} " + "=" * 25)
        print(format_table(rows))
    write_results_csv(rows, path)


def mean_std(vals, scale: float, prec: int) -> str:
    """``f"{mean * scale:.{prec}f}±{std * scale:.{prec}f}"`` with numpy's
    mean and population std (NaN entries give "nan")."""
    return (f"{np.mean(vals) * scale:.{prec}f}±"
            f"{np.std(vals) * scale:.{prec}f}")
