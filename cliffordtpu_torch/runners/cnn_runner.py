"""Shared CNN / ViT / Hybrid experiment engine for FashionMNIST and
CIFAR-10 (port of ``cliffordtpu/runners/cnn_runner.py``).

One engine for the fashion and cifar10 runners: train with the cyclical
beta and best-on-(recon + kld) selection, then the evaluation battery in
process (or in the port's ``eval_checkpoint`` child with
``--eval_subprocess``), the per-dim reference curves, the across-dims
table, the CSV and the timing JSON.  Artifact contract as the JAX
runner's: ``results/{exp_name}/{vsa_raw,metrics}.json``, comparison plots
and sidecars under ``results/comparisons/{dataset}``,
``{dataset}_results.csv``, ``{runner}_timing.json``.

Keys follow the JAX runner word for word: the run key ``fold_in(PRNGKey(
seed), stable_hash(d, dist, trial) % 2**31)``, the epoch key
``fold_in(run_key, epoch + 1)`` and its permutation, step s sampled with
the key flax derives from ``fold_in(ekey, s + 1)``, test batch s from
``fold_in(ekey, 10_000 + s)``, the battery from ``fold_in(run_key,
777)``.  The initial weights are the port's initialiser seeded from the
run key (the JAX runner's are flax's from the same key: the same
distributions, other values).

Everything runs on the device of ``args.device`` (``None``: the card,
``resolve_device``): training, the battery, FID.  Left out, as TPU
runtime only: the persistent compile cache, the TPU lock, the battery's
move to the CPU and the ``device_put`` calls.  ``--scan_layers`` and
``--fused_proj`` build the ViT in those layouts (``nn/vit_vae.py``).
``--mesh dp|N|NxM`` / ``--mesh_mode replicated|fsdp`` train on a
("data", "model") mesh (``parallel/``): one process per rank under
``torchrun --nproc_per_node N``, or at a world of 1 with no launcher; a
rank trains on its rows of every global batch, only rank 0 writes
artifacts, runs the battery and starts the eval child, and every rank
takes the same best-on-(recon + kld) decision from the test losses
all-reduced over the group.  The host libraries the card
lacks: the CSV is written with the ``csv`` module (the text pandas'
``to_csv(index=False)`` gives), kNN runs the "torch" backend, and the
drawing halves of the plots import matplotlib (t-SNE scikit-learn) when
called, inside ``safe_eval``.
"""

from __future__ import annotations

import copy
import csv
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import replace
from typing import Dict, List

import numpy as np
import torch

from cliffordtpu_torch import parallel, random
from cliffordtpu_torch.data import load_dataset
from cliffordtpu_torch.device import resolve_device
from cliffordtpu_torch.eval import ModelHandle
from cliffordtpu_torch.eval.binding import (
    test_cross_class_bind_unbind,
    test_self_binding,
)
from cliffordtpu_torch.eval.class_means import (
    compute_class_means,
    evaluate_mean_vector_cosine,
)
from cliffordtpu_torch.eval.fid import compute_fid
from cliffordtpu_torch.eval.knn import perform_knn_evaluation
from cliffordtpu_torch.eval.plots import (
    get_fixed_interp_pairs,
    plot_decoded_bundles,
    plot_latent_interpolations,
    plot_latent_space,
    plot_reconstructions,
)
from cliffordtpu_torch.eval.tables import (
    plot_across_dims_comparison,
    plot_cross_dist_comparison_dim,
)
from cliffordtpu_torch.kernels import launch_counts
from cliffordtpu_torch.nn.conv_vae import CNNVAE
from cliffordtpu_torch.nn.hybrid_vae import HybridVAE
from cliffordtpu_torch.nn.vit_vae import CliffordARVAE
from cliffordtpu_torch.runners.safety import (
    EMPTY_BINDING,
    EMPTY_CURVE,
    safe_eval,
)
from cliffordtpu_torch.train.checkpoint import (
    delete_checkpoint,
    save_checkpoint,
)
from cliffordtpu_torch.train.loop import (
    _snapshot,
    make_cnn_eval_step,
    make_cnn_train_step,
)
from cliffordtpu_torch.train.schedules import cyclical_kl_beta
from cliffordtpu_torch.train.state import create_train_state
from cliffordtpu_torch.utils import (
    CLASS_NAMES,
    WandbLogger,
    ensure_dir,
    get_default_device,
    stable_hash,
)
from cliffordtpu_torch.utils.artifacts import (
    jsonable as _jsonable,
    load_json as _load_json,
    merge_across_dims as _merge_across_dims,
    merge_json_write as _merge_json_write,
)
from cliffordtpu_torch.vsa.capacity import (
    test_binding_unbinding_pairs as vsa_binding_unbinding,
    test_bundle_capacity as vsa_bundle_capacity,
    test_per_class_bundle_capacity_k_items,
)
from cliffordtpu_torch.vsa.ops import (
    bind as vsa_bind,
    normalize_vectors,
    similarity,
    unbind as vsa_unbind,
    unitary_init as vsa_unitary_init,
)

BC_K_RANGE = list(range(5, 51, 5))
RF_K_RANGE = list(range(2, 21, 2))
LOSS_KEYS = ("total_loss", "recon_loss", "kld_loss", "grad_norm")
# the across-dims table's keys and the metrics.json keys they read
ACROSS_KEYS = (("knn_100", "knn_acc_100"), ("knn_600", "knn_acc_600"),
               ("knn_1000", "knn_acc_1000"), ("f1_100", "knn_f1_100"),
               ("f1_600", "knn_f1_600"), ("f1_1000", "knn_f1_1000"))
CSV_METRICS = ("knn_acc_100", "knn_acc_600", "knn_acc_1000", "knn_f1_100",
               "knn_f1_600", "knn_f1_1000", "mvc")


def is_rank0() -> bool:
    """Whether this process writes the run's artifacts: rank 0 of a
    ``--mesh`` group, or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


EVAL_MODULE = "cliffordtpu_torch.scripts.eval_checkpoint"


def run_eval_child(state, output_dir, argv, keep_ckpt: bool = False):
    """Save the checkpoint into ``output_dir``, run the port's
    ``eval_checkpoint`` with ``argv`` in a child process (on the device
    ``argv`` names: the card unless it passes ``--device``), read its
    metrics / vsa_raw back.  Shared by the CNN and the MNIST runners.
    Returns (ok, metrics, vsa)."""
    try:
        save_checkpoint(output_dir, state, step=0)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        r = subprocess.run([sys.executable, "-m", EVAL_MODULE, *argv],
                           env=env, capture_output=True, text=True,
                           timeout=7200)
        if r.returncode != 0:
            print(f"warning: subprocess eval failed rc={r.returncode}:\n"
                  f"{r.stderr[-2000:]}")
            return False, {}, {}
        with open(os.path.join(output_dir, "metrics.json")) as fh:
            metrics = json.load(fh)
        with open(os.path.join(output_dir, "vsa_raw.json")) as fh:
            vsa = json.load(fh)
        if not keep_ckpt:
            delete_checkpoint(output_dir)
        return True, metrics, vsa
    except Exception as e:
        print(f"warning: subprocess eval errored: {e!r}")
        return False, {}, {}


def _run_subprocess_eval(args, state, output_dir, dataset_name,
                         handle_latent_dim):
    """The battery in the port's ``eval_checkpoint`` (``run_eval_child``)
    with the CNN runner's arguments."""
    argv = [
        "--ckpt", output_dir,
        "--arch", getattr(args, "arch", "cnn"),
        "--distribution", args._actual_dist,
        "--latent_dim", str(handle_latent_dim),
        "--dataset", dataset_name,
        "--outdir", output_dir,
        "--vsa_trials", str(args.vsa_trials),
        "--fid_samples", str(args.fid_samples),
    ]
    if getattr(args, "device", None) is not None:
        argv += ["--device", str(args.device)]
    if getattr(args, "_actual_l2", False):
        argv += ["--l2_normalize"]
    if getattr(args, "scan_layers_model", False):
        argv += ["--scan_layers"]  # the param tree is layer-stacked
    if getattr(args, "fused_proj", False):
        argv += ["--fused_proj"]  # fused wqkv / w13 param tree
    if args.limit_train:
        argv += ["--limit_train", str(args.limit_train)]
    if args.limit_test:
        argv += ["--limit_test", str(args.limit_test)]
    return run_eval_child(state, output_dir, argv, keep_ckpt=args.keep_ckpts)


def build_model(args, dist_name: str, latent_dim: int, in_channels: int,
                seed: int = 0):
    """Model construction per arch, with the JAX runner's arguments
    (``gaussian_nol2`` is a gaussian without l2; the hybrid's per-token
    latent is ``latent_dim // 16``, at least 4; the ViT takes
    ``--scan_layers`` and ``--fused_proj``); ``seed`` seeds the initial
    weights."""
    if dist_name == "gaussian_nol2":
        actual_dist, l2_norm = "gaussian", False
    elif dist_name == "gaussian":
        actual_dist, l2_norm = "gaussian", args.l2_norm
    else:
        actual_dist, l2_norm = dist_name, False
    common = dict(in_channels=in_channels, distribution=actual_dist,
                  recon_loss_type=args.recon_loss, l1_weight=args.l1_weight,
                  l2_normalize=l2_norm,
                  use_learnable_beta=args.use_learnable_beta, seed=seed)
    arch = getattr(args, "arch", "cnn")
    if arch == "cnn":
        return CNNVAE(latent_dim=latent_dim, img_size=32, **common)
    if arch == "hybrid":
        return HybridVAE(latent_dim=max(4, latent_dim // 16), img_size=32,
                         **common)
    return CliffordARVAE(
        latent_dim=latent_dim, image_size=32,
        scan_layers=bool(getattr(args, "scan_layers_model", False)),
        fused_proj=bool(getattr(args, "fused_proj", False)), **common)


def train_model(args, model, x_train, x_test, run_key, logger=None):
    """Train ``model`` (its current weights) with the cyclical beta and
    best-on-(recon + kld) selection on ``args.device``: AdamW at
    ``args.cur_lr`` behind a clip at 1 (the learnable-beta sigmas at a
    tenth of the rate), ``--grad_accum`` as ``optax.MultiSteps``;
    ``--scan_epochs`` takes this same loop (JAX's one XLA program per
    epoch has no counterpart here).  The losses are summed on
    the device and copied once an epoch; the test losses once a batch, as
    in JAX.

    ``--mesh dp|N|NxM`` trains on a ("data", "model") mesh
    (``parallel/``): this rank's rows of every global batch, drawn as
    those rows of the global draw, the parameters placed by the rules
    (``--mesh_mode replicated|fsdp``); the math of the single-device
    step.  Returns (state with the best parameters, whole on every rank,
    best recon + kld, eval_step)."""
    device = resolve_device(getattr(args, "device", None))
    mesh = None
    mesh_spec = getattr(args, "mesh", None)
    mode = getattr(args, "mesh_mode", "replicated")
    if mesh_spec:
        if getattr(args, "scan_epochs", False):
            raise ValueError("--mesh is not supported with --scan_epochs")
        device = parallel.init_distributed(device)
        mesh = parallel.create_mesh(parallel.parse_mesh_spec(mesh_spec),
                                    device.type)
        ndata = parallel.mesh_sizes(mesh)["data"]
        if args.batch_size % ndata != 0:
            raise ValueError(
                f"--batch_size {args.batch_size} must be divisible by the "
                f"data axis ({ndata}) of mesh {mesh_spec}")
        print(f"mesh: {parallel.mesh_sizes(mesh)}, mode {mode}")
        plain = copy.deepcopy(model).to(device)
    state = create_train_state(
        model, "adamw", lr=args.cur_lr, clip_norm=1.0,
        sigma_lr_scale=0.1 if args.use_learnable_beta else None,
        accum_steps=int(getattr(args, "grad_accum", 1) or 1), device=device)
    r0, r1 = 0, args.batch_size
    if mesh is not None:
        state = parallel.shard_state(state, mesh, mode)
        train_step = parallel.make_sharded_cnn_train_step(
            state.sharded, state.optimizer, mesh)
        r0, r1 = parallel.global_batch_rows(mesh, args.batch_size)
    else:
        train_step = make_cnn_train_step(state.model, state.optimizer)
    eval_step = make_cnn_eval_step(state.model)
    xs = torch.as_tensor(x_train, dtype=torch.float32, device=device)
    xt = torch.as_tensor(x_test, dtype=torch.float32, device=device)
    one = torch.ones((), dtype=torch.float32, device=device)

    n = len(x_train)
    bs = args.batch_size
    steps = max(1, n // bs)
    best = float("inf")
    best_params = _snapshot(state.model)
    patience_counter = 0
    epoch_t0 = time.time()
    for epoch in range(args.epochs):
        beta = (1.0 if args.use_learnable_beta else cyclical_kl_beta(
            epoch, args.warmup_epochs, args.cycle_epochs, args.min_beta,
            args.max_beta))
        beta_t = torch.full((), beta, dtype=torch.float32, device=device)
        ekey = random.fold_in_words(run_key, epoch + 1)
        perm = random.permutation(ekey, n, device)
        tr_dev = None
        for s in range(steps):
            losses = train_step(
                xs[perm[s * bs + r0:s * bs + r1]],
                random.sample_key(random.fold_in_words(ekey, s + 1)),
                beta_t)
            cur = torch.stack([losses[k] for k in LOSS_KEYS])
            # device-side accumulation: one transfer per epoch
            tr_dev = cur if tr_dev is None else tr_dev + cur
        tr = dict(zip(("total", "recon", "kld", "grad_norm"),
                      tr_dev.tolist()))

        # test epoch (beta = 1 like the reference's test_epoch)
        te = {"total": 0.0, "recon": 0.0, "kld": 0.0}
        n_te = 0
        for s in range(0, len(xt), bs):
            xb = xt[s:s + bs]
            v = eval_step(xb, random.sample_key(
                random.fold_in_words(ekey, 10_000 + s)), one)
            te["total"] += float(v["total_loss"]) * xb.shape[0]
            te["recon"] += float(v["recon_loss"]) * xb.shape[0]
            te["kld"] += float(v["kld_loss"]) * xb.shape[0]
            n_te += xb.shape[0]
        for k in te:
            te[k] /= max(1, n_te)
        if mesh is not None:  # one decision on every rank
            te = _all_ranks_mean(te, device)

        val = te["recon"] + te["kld"]
        if np.isfinite(val) and val < best:
            best = val
            # a copy: the fused AdamW step updates the parameters in place
            best_params = _snapshot(state.model)
            patience_counter = 0
        else:
            patience_counter += 1

        print(f"epoch {epoch + 1}/{args.epochs}: "
              f"train {tr['total'] / steps:.2f} test {val:.2f} "
              f"({time.time() - epoch_t0:.1f}s)", flush=True)
        epoch_t0 = time.time()

        if logger and logger.use:
            logger.log_metrics({
                "epoch": epoch,
                "train/total_loss": tr["total"] / steps,
                "train/recon_loss": tr["recon"] / steps,
                "train/kld_loss": tr["kld"] / steps,
                "train/grad_norm": tr["grad_norm"] / steps,
                "test/total_loss": te["total"],
                "test/recon_loss": te["recon"],
                "test/kld_loss": te["kld"],
                "best_test_total_loss": best,
                **({} if args.use_learnable_beta else {"beta": beta}),
            })
        if args.patience > 0 and patience_counter >= args.patience:
            print(f"Early stopping at epoch {epoch + 1}")
            break

    state.model.load_state_dict(best_params)
    if mesh is not None:
        if any(hasattr(p, "device_mesh") for p in state.model.parameters()):
            state = parallel.unshard_state(state, plain)
        state = replace(state, sharded=None)
        eval_step = make_cnn_eval_step(state.model)
    return state, best, eval_step


def _all_ranks_mean(values: Dict[str, float], device) -> Dict[str, float]:
    """``values`` averaged over the ranks of the process group."""
    import torch.distributed as dist

    t = torch.tensor(list(values.values()), dtype=torch.float64,
                     device=device)
    dist.all_reduce(t)
    t /= dist.get_world_size()
    return dict(zip(values, t.tolist()))


def trial_entry(m: Dict) -> Dict:
    """One trial's ``metrics.json`` as its record in the trial sidecar
    (what ``results_rows`` reads): a missing metric 0, a missing FID or
    best loss NaN."""
    fid = m.get("generation_fid", float("nan"))
    return {
        **{mk: m.get(mk, 0.0) for _, mk in ACROSS_KEYS},
        "mvc": m.get("mean_vector_cosine_acc", 0.0),
        "fid": float("nan") if fid is None else fid,
        "best_loss": m.get("final_best_total_loss", float("nan")),
    }


K_SELF_BIND = 50


def _self_bind_curve(z: torch.Tensor) -> List[float]:
    sims = []
    cur = z
    for m in range(1, K_SELF_BIND + 1):
        cur = vsa_bind(cur, z)
        rec = cur
        for _ in range(m):
            rec = vsa_unbind(rec, z, method="*")
        sims.append(float(similarity(rec, z)))
    return sims


def reference_curves(root_key, dim: int, vsa_trials: int, device) -> Dict:
    """The random-HRR and unitary entries of one dim's cross-dist
    comparison (``fashion_train.py:1288-1371``): 1000 items and a
    self-binding vector of each, from ``fold_in(root_key, dim)``."""
    ckey = random.fold_in_words(root_key, dim)
    out = {}
    for name, items, z in [
        ("random_hrr",
         random.normal(ckey, (1000, dim), device),
         random.normal(random.fold_in_words(ckey, 1), (dim,), device)),
        ("unitary",
         vsa_unitary_init(random.fold_in_words(ckey, 2), 1000, dim,
                          device=device),
         vsa_unitary_init(random.fold_in_words(ckey, 3), 1, dim,
                          device=device)[0]),
    ]:
        items = normalize_vectors(items)
        out[name] = {
            "bundle_cap": vsa_bundle_capacity(
                d=dim, n_items=1000, k_range=BC_K_RANGE,
                n_trials=vsa_trials, item_memory=items, key=ckey),
            "role_filler": vsa_binding_unbinding(
                d=dim, n_items=1000, k_range=RF_K_RANGE,
                n_trials=vsa_trials, unbind_method="*",
                item_memory=items, bind_with_random=True, key=ckey),
            "self_binding_k_sims": _self_bind_curve(normalize_vectors(z)),
            "self_binding_k_values": list(range(1, K_SELF_BIND + 1)),
        }
    return out


def results_rows(all_trials: Dict) -> List[Dict]:
    """The rows of ``{dataset}_results.csv``: per (d, dist) the mean ± std
    over trials of each metric in percent, the FID and the best loss."""
    rows = []
    for (ldim, dist), trials in sorted(all_trials.items()):
        row = {"d": ldim, "dist": dist}
        for metric in CSV_METRICS:
            vals = [t[metric] * 100 for t in trials]
            row[metric] = (f"{np.mean(vals):.1f}±{np.std(vals):.1f}"
                           if len(vals) > 1 else f"{vals[0]:.1f}")
        fid_vals = [t["fid"] for t in trials if not math.isnan(t["fid"])]
        row["fid"] = (f"{np.mean(fid_vals):.1f}±{np.std(fid_vals):.1f}"
                      if len(fid_vals) > 1
                      else (f"{fid_vals[0]:.1f}" if fid_vals else "N/A"))
        loss_vals = [t["best_loss"] for t in trials]
        row["best_loss"] = (
            f"{np.mean(loss_vals):.4f}±{np.std(loss_vals):.4f}"
            if len(loss_vals) > 1 else f"{loss_vals[0]:.4f}")
        rows.append(row)
    return rows


def _columns(rows: List[Dict]) -> List[str]:
    return list(dict.fromkeys(k for row in rows for k in row))


def write_results_csv(rows: List[Dict], path: str) -> None:
    """``rows`` as CSV, the text ``pandas.DataFrame(rows).to_csv(path,
    index=False)`` writes for these int and string columns: a header of
    the keys in first-seen order, minimal quoting, "\\n" line ends."""
    cols = _columns(rows)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        for row in rows:
            w.writerow([row.get(c, "") for c in cols])


def format_table(rows: List[Dict]) -> str:
    """``rows`` as a text table, columns right-aligned."""
    cols = _columns(rows)
    cells = [cols] + [[str(row.get(c, "")) for c in cols] for row in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(cols))]
    return "\n".join(" ".join(v.rjust(w) for v, w in zip(r, widths))
                     for r in cells)


def run_cnn_experiments(args, dataset_name: str, timing_name: str,
                        full_eval: bool = True):
    """Main sweep loop shared by the fashion and cifar10 runners, under
    cuDNN's deterministic algorithms (the caller's setting restored
    after): a trial then gives the same numbers in every process, so a
    trial the sweep driver shells equals the same trial in process, as
    on XLA; without them two runs on the card part (1.8e-3 in best loss
    after two epochs at lr 1e-3 on an H100)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _run_experiments(args, dataset_name, timing_name, full_eval)
    finally:
        torch.backends.cudnn.deterministic = saved


def _run_experiments(args, dataset_name: str, timing_name: str,
                     full_eval: bool):
    script_start_time = time.time()
    timing_results: Dict = {}
    device = resolve_device(getattr(args, "device", None))
    os.chdir(ensure_dir(args.outdir))
    print(f"Device: {get_default_device(device)}")
    logger = WandbLogger(args)

    in_channels = 3 if dataset_name == "cifar10" else 1
    IMG_SHAPE = (32, 32, in_channels)
    class_names = (
        ["tshirt", "trouser", "pullover", "dress", "coat", "sandal",
         "shirt", "sneaker", "bag", "boot"]
        if dataset_name == "fashionmnist"
        else CLASS_NAMES["mnist"] if dataset_name == "mnist32"
        else CLASS_NAMES["cifar10"])

    ds = load_dataset(dataset_name, n_train=args.limit_train,
                      n_test=args.limit_test)
    if ds["source"] == "synthetic":
        if getattr(args, "require_real", False):
            raise SystemExit(
                f"--require_real: no real {dataset_name} found (searched "
                f"$CLIFFORDTPU_DATA_DIR, ./data, /root/data — note the "
                f"runner chdirs into --outdir, so pass an ABSOLUTE path)")
        print(f"WARNING: synthetic {dataset_name} fallback in use")
    timing_results["data_source"] = ds["source"]
    x_train_full, y_train_full = ds["x_train"], ds["y_train"]
    x_test_full, y_test_full = ds["x_test"], ds["y_test"]

    # class exclusion (``fashion_train.py:521-536``)
    if args.exclude_class >= 0:
        tr_mask = y_train_full != args.exclude_class
        te_mask = y_test_full != args.exclude_class
        x_excl = x_test_full[~te_mask]
        x_train, y_train = x_train_full[tr_mask], y_train_full[tr_mask]
        x_test, y_test = x_test_full[te_mask], y_test_full[te_mask]
        print(f"excluding class {args.exclude_class}; "
              f"excluded test set size: {len(x_excl)}")
    else:
        x_train, y_train = x_train_full, y_train_full
        x_test, y_test = x_test_full, y_test_full
        x_excl = None

    fixed_interp_pairs = get_fixed_interp_pairs(x_test, y_test, n_pairs=5,
                                                seed=42)
    latent_dims = args.latent_dims
    distributions = args.distributions
    dist_lr = {d: args.lr for d in distributions}
    dist_lr["powerspherical"] = 1e-4  # fashion_train.py:687-692

    across_dim_results = {
        d: {"knn_100": [], "knn_600": [], "knn_1000": [], "f1_100": [],
            "f1_600": [], "f1_1000": [], "mean_cosine": [], "dims": []}
        for d in distributions}
    trial_metrics: Dict = {}
    root_key = (0, args.seed)  # jax.random.PRNGKey(seed)

    for latent_dim in latent_dims:
        dim_results: Dict = {}
        for dist_name in distributions:
            for trial in range(args.n_trials):
                trial_num = trial + args.start_trial
                trial_suffix = (f"-trial{trial_num}"
                                if (args.n_trials > 1 or args.start_trial > 1
                                    or getattr(args, "force_trial_suffix",
                                               False))
                                else "")
                exp_name = (f"{dataset_name}-{dist_name}-d{latent_dim}-"
                            f"{args.recon_loss}{trial_suffix}")
                output_dir = ensure_dir(f"results/{exp_name}")
                print(f"\n== {exp_name} ==")
                exp_start_time = time.time()
                if logger.use:
                    logger.start_run(exp_name, args)

                run_key = random.fold_in_words(
                    root_key,
                    stable_hash(latent_dim, dist_name, trial_num) % (2**31))
                args.cur_lr = dist_lr.get(dist_name, args.lr)
                model = build_model(args, dist_name, latent_dim, in_channels,
                                    seed=(run_key[0] << 32) | run_key[1])
                args._actual_dist = model.distribution
                args._actual_l2 = bool(model.l2_normalize)

                train_start_time = time.time()
                state, best, eval_step = train_model(
                    args, model, x_train, x_test, run_key, logger)
                model = state.model
                train_time = time.time() - train_start_time
                if not is_rank0():
                    continue  # rank 0 scores the trial and writes it
                print(f"best total loss (recon+kld): {best:.4f}, "
                      f"training time: {train_time:.2f}s")
                if args.keep_ckpts:
                    save_checkpoint(output_dir, state, step=0,
                                    best_metric=best)

                eval_start_time = time.time()

                # --eval_subprocess: the battery in the port's
                # eval_checkpoint, in a fresh process
                did_sub, sub_metrics, sub_vsa = False, {}, {}
                if getattr(args, "eval_subprocess", False):
                    did_sub, sub_metrics, sub_vsa = _run_subprocess_eval(
                        args, state, output_dir, dataset_name,
                        handle_latent_dim=latent_dim)

                def stage(label, fn, default=None):
                    if did_sub:
                        return default
                    return safe_eval(label, fn, default)

                handle = ModelHandle(model)
                ekey = random.fold_in_words(run_key, 777)

                # optional IWAE log-likelihood bound (an extension beyond
                # the reference, which has IWAE only for the MLP runners)
                iwae_ll = None
                if getattr(args, "iwae_samples", 0):
                    def _iwae():
                        from cliffordtpu_torch.nn.losses import (
                            iwae_log_likelihood_cnn,
                        )

                        n_eval = min(256, len(x_test))
                        tot, bs = 0.0, 64
                        for s in range(0, n_eval, bs):
                            xb = torch.as_tensor(x_test[s:s + bs],
                                                 device=device)
                            with torch.no_grad():
                                tot += float(iwae_log_likelihood_cnn(
                                    random.fold_in_words(run_key, 7700 + s),
                                    model, xb,
                                    n_samples=args.iwae_samples,
                                    recon_loss_type=args.recon_loss,
                                )) * len(xb)
                        ll = tot / n_eval
                        print(f"IWAE-{args.iwae_samples} test ll/image: "
                              f"{ll:.2f}")
                        return ll

                    iwae_ll = safe_eval("iwae_ll", _iwae, None)

                # item memory of flat sampled latents (:909-925)
                n_mem = min(1000, len(x_test))
                item_memory, item_labels = stage(
                    "item_memory",
                    lambda: handle.collect_flat_z(
                        x_test, y_test, ekey, limit=n_mem,
                        batch=args.batch_size),
                    default=(None, None))

                print(f"running 1-item-per-class test ({dist_name})...")
                stage(
                    "per_class_bundle",
                    lambda: test_per_class_bundle_capacity_k_items(
                        d=latent_dim, n_items=n_mem, n_classes=10,
                        items_per_class=1, n_trials=1, plot=False,
                        save_dir=output_dir, item_memory=item_memory,
                        labels=item_labels,
                        item_images=x_test[:n_mem], class_names=class_names,
                        key=ekey))

                print(f"running bundle capacity test ({dist_name})...")
                bundle_cap_raw = stage(
                    "bundle_capacity",
                    lambda: vsa_bundle_capacity(
                        d=item_memory.shape[-1], n_items=n_mem,
                        k_range=BC_K_RANGE, n_trials=args.vsa_trials,
                        plot=False, save_dir=output_dir,
                        item_memory=item_memory, baseline_d=latent_dim,
                        key=ekey),
                    default=dict(EMPTY_CURVE))

                print(f"running role-filler unbinding test ({dist_name})...")
                role_filler_raw = stage(
                    "role_filler",
                    lambda: vsa_binding_unbinding(
                        d=item_memory.shape[-1], n_items=n_mem,
                        k_range=RF_K_RANGE, n_trials=args.vsa_trials,
                        plot=False, unbind_method="*", save_dir=output_dir,
                        item_memory=item_memory, bind_with_random=True,
                        baseline_d=latent_dim, key=ekey),
                    default=dict(EMPTY_CURVE))
                rf_results = {"role_filler_capacity": role_filler_raw}

                print(f"running self-binding test ({dist_name})...")
                fourier_star = stage(
                    "self_binding(*)",
                    lambda: test_self_binding(
                        handle, x_test[:500], y_test[:500], output_dir,
                        unbind_method="*", img_shape=IMG_SHAPE, key=ekey),
                    default=dict(EMPTY_BINDING))
                deconv_dir = ensure_dir(f"{output_dir}/deconv")
                fourier_perp = stage(
                    "self_binding(†)",
                    lambda: test_self_binding(
                        handle, x_test[:500], y_test[:500], deconv_dir,
                        unbind_method="†", img_shape=IMG_SHAPE, key=ekey),
                    default=dict(EMPTY_BINDING))

                stage("reconstructions", lambda: plot_reconstructions(
                    handle, x_test, f"{output_dir}/reconstructions.png",
                    img_shape=IMG_SHAPE, key=ekey))
                if trial == 0:
                    stage("tsne", lambda: plot_latent_space(
                        handle, x_test, y_test, f"{output_dir}/tsne.png",
                        n_plot=min(2000, len(x_test)), key=ekey))
                if full_eval:
                    stage("decoded_bundles",
                          lambda: plot_decoded_bundles(
                              handle, x_test, y_test,
                              f"{output_dir}/decoded_bundles.png",
                              class_names=class_names,
                              n_samples=min(500, len(x_test)), key=ekey))
                    stage("latent_interpolations",
                          lambda: plot_latent_interpolations(
                              handle, fixed_interp_pairs, output_dir,
                              n_steps=10, img_shape=IMG_SHAPE, key=ekey))

                print("running knn evaluation...")
                knn_metrics = stage(
                    "knn_evaluation",
                    lambda: perform_knn_evaluation(
                        handle, x_train, y_train, x_test, y_test,
                        [s for s in (100, 600, 1000) if s <= len(x_train)],
                        backend="torch", key=ekey),
                    default={})

                mean_vector_acc = stage(
                    "mean_vector_cosine",
                    lambda: evaluate_mean_vector_cosine(
                        handle, x_test, y_test,
                        compute_class_means(
                            handle, x_train[:5000], y_train[:5000],
                            max_per_class=1000, batch=args.batch_size,
                            key=ekey),
                        batch=args.batch_size, key=ekey)[0],
                    default=0.0)
                print("mean_vector_cosine_acc: ", mean_vector_acc)

                model_latent = handle.latent_dim
                fid_res = stage(
                    "generation_fid",
                    lambda: compute_fid(
                        handle, x_test, model.distribution, model_latent,
                        in_channels=in_channels,
                        n_samples=min(args.fid_samples, len(x_test)),
                        batch_size=256, key=ekey),
                    default={"fid": float("nan"),
                             "fid_features": "failed"})
                gen_fid = fid_res["fid"]
                print(f"generation FID: {gen_fid:.2f} "
                      f"({fid_res['fid_features']})")

                if did_sub:
                    knn_metrics = {k: v for k, v in sub_metrics.items()
                                   if k.startswith("knn_")}
                    mean_vector_acc = sub_metrics.get(
                        "mean_vector_cosine_acc", 0.0)
                    fid_res = {
                        "fid": sub_metrics.get("generation_fid",
                                               float("nan")),
                        "fid_features": sub_metrics.get("fid_features",
                                                        "subprocess"),
                    }
                    gen_fid = fid_res["fid"]
                    bundle_cap_raw = sub_vsa.get(
                        "bundle_cap", dict(EMPTY_CURVE))
                    role_filler_raw = sub_vsa.get(
                        "role_filler", dict(EMPTY_CURVE))
                    rf_results = {"role_filler_capacity": role_filler_raw}
                    fourier_star = {**EMPTY_BINDING,
                                    **sub_vsa.get("self_binding_star", {})}
                    fourier_perp = {**EMPTY_BINDING,
                                    **sub_vsa.get("self_binding_dagger", {})}
                    for fr in (fourier_star, fourier_perp):
                        if fr.get("k_sims"):
                            fr["binding_k_self_similarity"] = float(
                                fr["k_sims"][-1])

                if trial == 0 and not did_sub:
                    print("running cross-class bind/unbind test...")
                    if dataset_name in ("fashionmnist", "mnist32"):
                        # fashion uses the reference's fixed 5v6 pair;
                        # digits use 6v9 like mnist_clifpws.py:451-455
                        ca, cb = ((5, 6) if dataset_name == "fashionmnist"
                                  else (6, 9))
                        stage("cross_class",
                              lambda: test_cross_class_bind_unbind(
                                  handle, x_test[:500], y_test[:500],
                                  output_dir, img_shape=IMG_SHAPE,
                                  class_a=ca, class_b=cb, key=ekey))
                    else:
                        rng = np.random.RandomState(trial_num)
                        for _ in range(2):
                            a, b = rng.choice(10, 2, replace=False)
                            stage("cross_class",
                                  lambda a=a, b=b:
                                  test_cross_class_bind_unbind(
                                      handle, x_test[:500],
                                      y_test[:500], output_dir,
                                      img_shape=IMG_SHAPE,
                                      class_a=int(a), class_b=int(b),
                                      key=ekey))

                excluded_metrics = {}
                if x_excl is not None and len(x_excl):
                    print(f"\nevaluating on excluded class "
                          f"{args.exclude_class}...")
                    te = {"total": 0.0, "recon": 0.0, "kld": 0.0}
                    n_e = 0
                    one = torch.ones((), device=device)
                    for s in range(0, len(x_excl), args.batch_size):
                        xb = torch.as_tensor(x_excl[s:s + args.batch_size],
                                             device=device)
                        v = eval_step(xb, random.sample_key(
                            random.fold_in_words(ekey, 20_000 + s)), one)
                        for k, lk in [("total", "total_loss"),
                                      ("recon", "recon_loss"),
                                      ("kld", "kld_loss")]:
                            te[k] += float(v[lk]) * xb.shape[0]
                        n_e += xb.shape[0]
                    prefix = f"excluded_class_{args.exclude_class}"
                    excluded_metrics = {
                        f"{prefix}/test_total_loss": te["total"] / n_e,
                        f"{prefix}/test_recon_loss": te["recon"] / n_e,
                        f"{prefix}/test_kld_loss": te["kld"] / n_e,
                    }
                    plot_reconstructions(
                        handle, x_excl,
                        f"{output_dir}/reconstructions_excluded_class_"
                        f"{args.exclude_class}.png",
                        img_shape=IMG_SHAPE, key=ekey)

                fourier_metrics = {}
                fourier_metrics.update({
                    f"*/{k}": v for k, v in fourier_star.items()
                    if isinstance(v, (int, float, bool))})
                fourier_metrics.update({
                    f"†/{k}": v for k, v in fourier_perp.items()
                    if isinstance(v, (int, float, bool))})

                summary = {
                    "final_best_total_loss": best,
                    **fourier_metrics,
                    **knn_metrics,
                    **excluded_metrics,
                    "mean_vector_cosine_acc": float(mean_vector_acc),
                    **({"generation_fid": gen_fid}
                       if gen_fid is not None and not math.isnan(gen_fid)
                       else {}),
                    **({"iwae_ll": iwae_ll,
                        "iwae_samples": args.iwae_samples}
                       if iwae_ll is not None else {}),
                    "fid_features": fid_res["fid_features"],
                }
                if logger.use:
                    logger.log_summary(summary)
                    logger.finish_run()

                raw_vsa = {
                    "bundle_cap": bundle_cap_raw,
                    "role_filler": role_filler_raw,
                    "self_binding_star": {
                        "k_values": fourier_star.get("k_values", []),
                        "k_sims": fourier_star.get("k_sims", []),
                    },
                    "self_binding_dagger": {
                        "k_values": fourier_perp.get("k_values", []),
                        "k_sims": fourier_perp.get("k_sims", []),
                    },
                }
                with open(f"{output_dir}/vsa_raw.json", "w") as f:
                    json.dump(_jsonable(raw_vsa), f)
                with open(f"{output_dir}/metrics.json", "w") as f:
                    json.dump(_jsonable(summary), f, indent=2)
                print(f"saved metrics to {output_dir}/metrics.json")

                if not args.keep_ckpts:
                    delete_checkpoint(output_dir)

                eval_time = time.time() - eval_start_time
                exp_time = time.time() - exp_start_time
                timing_results[exp_name] = {
                    "train_time_s": train_time,
                    "eval_time_s": eval_time,
                    "total_exp_time_s": exp_time,
                }
                print(f"eval time: {eval_time:.2f}s, "
                      f"total exp time: {exp_time:.2f}s")

                dim_results[dist_name] = {
                    "bundle_cap": bundle_cap_raw,
                    "role_filler": role_filler_raw,
                    "role_filler_variants": rf_results,
                    "self_binding_k_sims": fourier_star.get("k_sims", []),
                    "self_binding_k_values": fourier_star.get("k_values", []),
                    "knn_acc": knn_metrics.get("knn_acc_1000", 0.0),
                    "mean_cosine": float(mean_vector_acc),
                }
                key_t = (latent_dim, dist_name)
                trial_metrics.setdefault(key_t, []).append({
                    "knn_acc_100": knn_metrics.get("knn_acc_100", 0.0),
                    "knn_acc_600": knn_metrics.get("knn_acc_600", 0.0),
                    "knn_acc_1000": knn_metrics.get("knn_acc_1000", 0.0),
                    "knn_f1_100": knn_metrics.get("knn_f1_100", 0.0),
                    "knn_f1_600": knn_metrics.get("knn_f1_600", 0.0),
                    "knn_f1_1000": knn_metrics.get("knn_f1_1000", 0.0),
                    "mvc": float(mean_vector_acc),
                    "fid": (gen_fid if gen_fid is not None
                            and not math.isnan(gen_fid) else float("nan")),
                    "best_loss": best,
                })
                for kk, mk in ACROSS_KEYS:
                    across_dim_results[dist_name][kk].append(
                        knn_metrics.get(mk, 0.0))
                across_dim_results[dist_name]["mean_cosine"].append(
                    float(mean_vector_acc))
                across_dim_results[dist_name]["dims"].append(latent_dim)

        # per-dim reference curves + cross-dist comparison (:1288-1371)
        if not is_rank0():
            continue
        try:
            dim_results.update(reference_curves(
                root_key, latent_dim, args.vsa_trials, device))
            comp_dir = ensure_dir(f"results/comparisons/{dataset_name}")
            # merge-on-write sidecar so per-family invocations aggregate
            dim_merged = _merge_json_write(
                f"{comp_dir}/dim{latent_dim}_data.json", dim_results)
            comp_path = plot_cross_dist_comparison_dim(
                dim_merged, latent_dim, dataset_name, comp_dir)
            print(f"saved cross-dist comparison to {comp_path}")
        except Exception as e:
            print(f"warning: cross-dist comparison failed for "
                  f"d={latent_dim}: {e!r}")

    if not is_rank0():
        return
    try:
        comp_dir = ensure_dir(f"results/comparisons/{dataset_name}")
        across_merged = _merge_across_dims(
            f"{comp_dir}/across_dims_data.json", across_dim_results)
        dims_union = sorted({d for v in across_merged.values()
                             for d in v.get("dims", [])})
        across_path = plot_across_dims_comparison(
            across_merged, dims_union, dataset_name, comp_dir)
        print(f"saved across-dims comparison to {across_path}")
    except Exception as e:
        print(f"warning: across-dims comparison failed: {e!r}")

    # unified CSV (``fashion_train.py:1382-1410``) — regenerated from a
    # merge-on-write sidecar so sliced per-family runs aggregate into one CSV
    if trial_metrics:
        merged_trials = _merge_json_write(
            f"{dataset_name}_trial_metrics.json",
            {f"{ld}|{dist}": trials
             for (ld, dist), trials in trial_metrics.items()})
        all_trials = {}
        for key, trials in merged_trials.items():
            ld, dist = key.split("|", 1)
            all_trials[(int(ld), dist)] = trials
        rows = results_rows(all_trials)
        csv_name = f"{dataset_name}_results.csv"
        write_results_csv(rows, csv_name)
        print(f"\n{'=' * 25} {dataset_name} results {'=' * 25}")
        print(format_table(rows))
        print(f"saved to {csv_name}")

    # merge-on-write: sequential per-family runs into one artifact dir must
    # not drop prior families' timings (ref emits one JSON per full sweep)
    timing_results["total_script_time_s"] = time.time() - script_start_time
    prior_total = _load_json(f"{timing_name}_timing.json").get(
        "total_script_time_s", 0.0)
    if isinstance(prior_total, (int, float)):
        timing_results["total_script_time_s"] += prior_total
    _merge_json_write(f"{timing_name}_timing.json", timing_results)
    print(f"\ntotal script execution time: "
          f"{timing_results['total_script_time_s']:.2f}s")
    # the launches of this process, as eval_checkpoint prints its own (a
    # sweep's trial logs end with them)
    print(f"kernel launches: {json.dumps(launch_counts())}")
