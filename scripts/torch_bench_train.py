#!/usr/bin/env python3
"""Train-step throughput of the PyTorch port on one GPU: the counterpart
of ``bench.py --config flagship32`` and ``--config cnn4096``.

    python3 scripts/torch_bench_train.py
        [--config flagship32|cnn4096|hybrid_fashion4096|mnist_mlp]
        [--dtype bfloat16|float32] [--sampler keyed|unfused|rng]
        [--distribution clifford|normal]

Builds the flagship32 ``CliffordARVAE`` (``default_config(32)``: 32 px,
1 channel, latent 16) or the cnn4096 ``CNNVAE`` (32 px, 1 channel, latent
4096), seeded random weights, batch 64, AdamW at lr 1e-4 behind a
global-norm clip of 1, beta 1, the reparameterised draw through the named
sampler route.  ``--config hybrid_fashion4096`` is the Fashion runner's
``--arch hybrid`` at the sweep's largest latent: ``HybridVAE`` (32 px, 1
channel, channels [64, 128, 256], 64 tokens of latent 256), float32 only
(the model has no other compute dtype), batch 256, AdamW at lr 1e-3.
``--config mnist_mlp`` is the MNIST sweep's ``MLPVAE`` at
d 5 (h_dim 128, float32, batch 128, Adam lr 1e-3, clip 1, binarised
synthetic images, beta 0.01; ``--distribution`` clifford or normal with
``l2_normalize``), and its line also gives the throughput of
``fit_trials`` with 20 lanes: trial steps per second over 2 epochs of
2048 training and 512 validation images, after one warm-up epoch.  After 3 warm-up steps it times 3
windows of 30 steps on one fixed batch (a new sampling key every step);
each window ends in ``torch.cuda.synchronize()``.  Prints one JSON line:
steps per second (the median window, with all three windows and the best
beside it), ms per step, the launch counts of the hand-written kernels per
step, the last loss, and the card's name and power limit as ``nvidia-smi``
gives them.  Raises without a CUDA device.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 64
WARMUP_STEPS = 3
MEASURE_STEPS = 30
N_WINDOWS = 3
LR = 1e-4
# the Fashion runner's batch and AdamW rate (cliffordtpu/configs)
HYBRID_BATCH, HYBRID_LR = 256, 1e-3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="flagship32",
                    choices=("flagship32", "cnn4096", "hybrid_fashion4096",
                             "mnist_mlp"))
    ap.add_argument("--sampler", default="keyed",
                    choices=("keyed", "unfused", "rng"),
                    help="route of the reparameterised draw")
    ap.add_argument("--distribution", default="clifford",
                    choices=("clifford", "normal"),
                    help="the latent of the mnist_mlp cell")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="compute dtype of the convolution stacks and the "
                         "transformer projections (parameters stay float32)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch_bench_train needs a CUDA device")
    sys.path.insert(0, ROOT)
    from cliffordtpu_torch.kernels import attention, build, sampler, torus
    from cliffordtpu_torch.nn.conv_vae import CNNVAE
    from cliffordtpu_torch.nn.hybrid_vae import HybridVAE
    from cliffordtpu_torch.nn.vit_vae import CliffordARVAE
    from cliffordtpu_torch.train.loop import make_cnn_train_step
    from cliffordtpu_torch.train.state import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    t0 = time.perf_counter()
    build.build_all()
    if args.config == "mnist_mlp":
        return bench_mnist(args, smi, t0)
    batch, lr = BATCH, LR
    if args.config == "hybrid_fashion4096":
        args.dtype = "float32"
        batch, lr = HYBRID_BATCH, HYBRID_LR
    dtype = getattr(torch, args.dtype)
    if args.config == "hybrid_fashion4096":
        model = HybridVAE(latent_dim=256, in_channels=1, img_size=32,
                          sampler=args.sampler, seed=0)
    elif args.config == "cnn4096":
        model = CNNVAE(latent_dim=4096, in_channels=1, img_size=32,
                       sampler=args.sampler, compute_dtype=dtype, seed=0)
    else:
        model = CliffordARVAE(latent_dim=16, image_size=32, in_channels=1,
                              sampler=args.sampler, compute_dtype=dtype,
                              seed=0)
    st = create_train_state(model, optimizer="adamw", lr=lr)
    step = make_cnn_train_step(st.model, st.optimizer)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(batch, 32, 32, 1, generator=gen, device="cuda") * 2 - 1
    beta = torch.ones((), device="cuda")
    for i in range(WARMUP_STEPS):
        losses = step(x, (0, i), beta)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def counts():
        return {"attention_fwd": attention.launches,
                "attention_bwd": attention.bwd_launches,
                "attention_dense": attention.dense_calls,
                "torus_fwd": torus.fwd_launches,
                "torus_bwd": torus.launches,
                "sampler_keyed": sampler.launches,
                "sampler_rng": sampler.rng_launches}

    before = counts()
    windows = []
    for w in range(N_WINDOWS):
        t0 = time.perf_counter()
        for i in range(MEASURE_STEPS):
            losses = step(x, (0, 100 + w * 1000 + i), beta)
        torch.cuda.synchronize()
        windows.append(MEASURE_STEPS / (time.perf_counter() - t0))
    after = counts()
    n = N_WINDOWS * MEASURE_STEPS
    sps = statistics.median(windows)
    print(json.dumps({
        "metric": {"cnn4096": "cnn_vae_d4096",
                   "hybrid_fashion4096": "hybrid_vae_d256x64"}.get(
                       args.config, "cliffordar_vae")
        + f"_train_steps_per_sec_b{batch}_32px",
        "config": args.config, "sampler": args.sampler,
        "steps_per_sec": sps, "ms_per_step": 1e3 / sps,
        "windows_steps_per_sec": windows, "best_steps_per_sec": max(windows),
        "compute_dtype": args.dtype, "batch": batch, "optimizer": "adamw",
        "lr": lr, "warmup_steps": WARMUP_STEPS,
        "measure_steps": MEASURE_STEPS, "n_windows": N_WINDOWS,
        "build_and_warmup_s": setup_s,
        "params_m": sum(p.numel() for p in st.model.parameters()) / 1e6,
        "kernel_launches_per_step": {k: (after[k] - before[k]) / n
                                     for k in after},
        "last_total_loss": losses["total_loss"].item(),
        "card": smi, "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
    }), flush=True)
    return 0


MLP_BATCH, MLP_D, MLP_BETA, MLP_TRIALS = 128, 5, 0.01, 20
MLP_TRAIN, MLP_VAL, MLP_EPOCHS = 2048, 512, 2


def bench_mnist(args, smi, t0) -> int:
    """The mnist_mlp cell: the MLPVAE step in windows, then fit_trials."""
    from cliffordtpu_torch.kernels import sampler, torus
    from cliffordtpu_torch.nn.mlp_vae import MLPVAE
    from cliffordtpu_torch.train import loop
    from cliffordtpu_torch.train.state import create_train_state

    dist = args.distribution
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand(MLP_TRAIN + MLP_VAL, 784, generator=gen,
                        device="cuda")
    beta = torch.full((), MLP_BETA, device="cuda")

    def model(seed=0):
        return MLPVAE(128, MLP_D, dist, dist == "normal", seed=seed)

    st = create_train_state(model(), optimizer="adam", lr=1e-3)
    step = loop.make_mlp_train_step(st.model, st.optimizer)
    x = images[:MLP_BATCH]
    for i in range(WARMUP_STEPS):
        losses = step(x, (0, i), beta)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    before = (sampler.launches, torus.launches)
    windows = []
    for w in range(N_WINDOWS):
        t1 = time.perf_counter()
        for i in range(MEASURE_STEPS):
            losses = step(x, (0, 100 + w * 1000 + i), beta)
        torch.cuda.synchronize()
        windows.append(MEASURE_STEPS / (time.perf_counter() - t1))
    n = N_WINDOWS * MEASURE_STEPS
    per_step = {"sampler_keyed": (sampler.launches - before[0]) / n,
                "torus_bwd": (torus.launches - before[1]) / n}
    lanes = loop.stack_trial_states([
        create_train_state(model(t), optimizer="adam", lr=1e-3)
        for t in range(MLP_TRIALS)])
    kw = dict(batch_size=MLP_BATCH, beta_fn=lambda e: MLP_BETA)
    keys = [(0, t) for t in range(MLP_TRIALS)]
    x_train, x_val = images[:MLP_TRAIN], images[MLP_TRAIN:]
    loop.fit_trials(lanes, keys, x_train, x_val, epochs=1, **kw)  # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loop.fit_trials(lanes, [(1, t) for t in range(MLP_TRIALS)], x_train,
                    x_val, epochs=MLP_EPOCHS, **kw)
    trials_s = time.perf_counter() - t1
    steps = MLP_TRAIN // MLP_BATCH
    sps = statistics.median(windows)
    print(json.dumps({
        "metric": "mlp_vae_d5_train_steps_per_sec_b128_mnist",
        "config": "mnist_mlp", "distribution": dist,
        "steps_per_sec": sps, "ms_per_step": 1e3 / sps,
        "windows_steps_per_sec": windows, "best_steps_per_sec": max(windows),
        "compute_dtype": "float32", "batch": MLP_BATCH, "d": MLP_D,
        "optimizer": "adam", "lr": 1e-3, "warmup_steps": WARMUP_STEPS,
        "measure_steps": MEASURE_STEPS, "n_windows": N_WINDOWS,
        "build_and_warmup_s": setup_s,
        "params_m": sum(p.numel() for p in st.model.parameters()) / 1e6,
        "kernel_launches_per_step": per_step,
        "last_total_loss": losses["total"].item(),
        "trials": MLP_TRIALS, "trial_epochs": MLP_EPOCHS,
        "trial_epoch_s": trials_s / MLP_EPOCHS,
        "trial_steps_per_sec": MLP_TRIALS * steps * MLP_EPOCHS / trials_s,
        "card": smi, "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
