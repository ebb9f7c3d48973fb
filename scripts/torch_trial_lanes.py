#!/usr/bin/env python3
"""Where ``fit_trials``' lanes part from their sequential ``fit``s, on one
GPU.

The setting is ``chip_smoke.py``'s mlp phase: the MLPVAE at d 5 with the
clifford latent, its seeded images, 20 trials (weights seeded t, keys
(0, 1000 + t)), batch 128, Adam lr 1e-3, clip 1, the beta warmup, two
epochs of 16 steps.  Three measurements, each printed as one JSON line:

1. ``first_step``: each lane's first-step gradients (``LaneMLPVAE``)
   against its own ``MLPVAE``'s on the same batch and key, relative to
   the lane's gradient norm, and the
   entries where the two first Adam updates differ by more than lr / 2
   (Adam's first update is about lr * sign(g));
2. ``steps``: each lane stepped as ``fit_trials`` steps it and each trial's
   ``MLPVAE`` as ``fit`` steps it, in lock-step on the same batches and
   keys; per lane, the relative train-loss difference at every step, the
   largest parameter difference, the epoch means' difference (what
   chip_smoke holds at 2e-4), and the first steps at which an entry's two
   updates differ by more than lr / 2, with that entry's gradient against
   its tensor's root mean square and the two paths' relative gradient
   difference there;
3. ``controls``: the same steps with the trials stacked in reverse lane
   order (does a trial's drift follow the trial or its slot?) and each
   trial alone in a stack of one lane (the batched product without other
   lanes).

Run from the root of a checkout: ``python3 scripts/torch_trial_lanes.py``.
The per-step numbers go to ``profiles/trial_lanes.json``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLIP = 0.5  # an update difference above FLIP * lr counts as a flipped sign


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from cliffordtpu_torch import random
    from cliffordtpu_torch.kernels import build
    from cliffordtpu_torch.nn.mlp_vae import MLPVAE
    from cliffordtpu_torch.train import loop, schedules, state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    build.build_all()

    dev, T, B, lr = cs.DEVICE, cs.MLP_TRIALS, cs.MLP_BATCH, cs.MLP_LR
    images = cs.mlp_images(cs.MLP_TRAIN + cs.MLP_VAL)
    x_train = images[:cs.MLP_TRAIN]
    n = x_train.shape[0]
    steps = n // B

    def single(t):
        return state.create_train_state(
            MLPVAE(cs.MLP_H_DIM, cs.MLP_D, "clifford", seed=t), "adam",
            cs.MLP_LR, device=dev)

    def stacked(order):
        return loop.stack_trial_states([single(t) for t in order])

    # the batches and keys of fit's two epochs, for every trial
    plan = []  # per step: (beta, x (T, B, 784), step rngs of the T trials)
    for epoch in range(cs.MLP_EPOCHS):
        beta = torch.full((), schedules.linear_kl_warmup(
            epoch, cs.MLP_WARMUP_EPOCHS), device=dev)
        ekeys = [random.fold_in_words((0, 1000 + t), epoch) for t in range(T)]
        ids = torch.stack([random.permutation(random.fold_in_words(ek, 0), n,
                                              dev)[:steps * B]
                           for ek in ekeys]).reshape(T, steps, B)
        for s in range(steps):
            plan.append((beta, x_train[ids[:, s]],
                         [random.fold_in_words(ek, s + 1) for ek in ekeys]))

    def lane_run(order):
        """Train losses (steps, len(order)) of the stacked trials."""
        st = stacked(order)
        step = loop.make_lane_train_step(st.model, st.optimizer)
        out = []
        for beta, x, rngs in plan:
            kb, ks = loop.lane_keys([[rngs[t] for t in order]], dev)
            out.append(step(x[list(order)], (kb[0], ks[0]), beta)["total"])
        return torch.stack(out), st

    # 1. first-step gradients and first updates, every lane
    beta, x, rngs = plan[0]
    lanes = stacked(range(T))
    kb, ks = loop.lane_keys([rngs], dev)
    lane_loss = loop.lane_losses(lanes.model, x, kb[0], ks[0], beta)
    lane_loss["total"].sum().backward()
    lane_grads = {k: p.grad.clone() for k, p in
                  lanes.model.named_parameters()}
    lane_norms = lanes.optimizer.step()
    first = []
    singles = [single(t) for t in range(T)]
    for t, st in enumerate(singles):
        st.optimizer.zero_grad()
        loss = loop.mlp_losses(st.model, x[t], rngs[t], beta)
        loss["total"].backward()
        g = {k: p.grad.clone() for k, p in st.model.named_parameters()}
        norm = st.optimizer.step()
        diff = {k: (lane_grads[k][t] - g[k]).abs().max().item() for k in g}
        worst = max(diff, key=diff.get)
        upd = {k: (lanes.model.state_dict()[k][t] - p).abs()
               for k, p in st.model.named_parameters()}
        flips = {k: int((u > FLIP * lr).sum()) for k, u in upd.items()}
        first.append(dict(
            lane=t, loss_rel=abs(lane_loss["total"][t].item()
                                 - loss["total"].item())
            / abs(loss["total"].item()),
            grad_norm=norm.item(),
            grad_norm_rel=abs(lane_norms[t].item() - norm.item())
            / norm.item(),
            grad_max_rel=diff[worst] / norm.item(), grad_max_param=worst,
            update_max=max(u.max().item() for u in upd.values()),
            flipped={k: v for k, v in flips.items() if v}))
    print(json.dumps({"first_step": first}), flush=True)
    del lanes, singles

    # 2. step by step, in lock-step: the lanes against each trial's steps
    singles = [single(t) for t in range(T)]
    single_steps = [loop.make_mlp_train_step(st.model, st.optimizer)
                    for st in singles]
    lanes = stacked(range(T))
    lane_step = loop.make_lane_train_step(lanes.model, lanes.optimizer)
    names = [k for k, _ in lanes.model.named_parameters()]
    got, seq = [], []
    flips = [[] for _ in range(T)]  # per lane: entries whose updates part
    for i, (beta, x, rngs) in enumerate(plan):
        lane_before = [p.detach().clone() for p in lanes.model.parameters()]
        kb, ks = loop.lane_keys([rngs], dev)
        got.append(lane_step(x, (kb[0], ks[0]), beta)["total"])
        row = []
        for t, (st, step) in enumerate(zip(singles, single_steps)):
            before = [p.detach().clone() for p in st.model.parameters()]
            row.append(step(x[t], rngs[t], beta)["total"])
            for name, lb, lp, sb, sp in zip(names, lane_before,
                                            lanes.model.parameters(), before,
                                            st.model.parameters()):
                parted = ((lp[t] - lb[t]) - (sp - sb)).abs() > FLIP * lr
                if not parted.any():
                    continue
                g, lg = sp.grad, lp.grad[t]  # the clipped gradients
                flips[t].append(dict(
                    step=i + 1, param=name, entries=int(parted.sum()),
                    grad_over_rms=(g[parted].abs().max()
                                   / g.pow(2).mean().sqrt()).item(),
                    grad_rel_diff=((lg[parted] - g[parted]).abs()
                                   / g[parted].abs()).max().item(),
                    sign_differs=int((torch.sign(lg[parted])
                                      != torch.sign(g[parted])).sum())))
        seq.append(torch.stack(row))
    got, seq = torch.stack(got), torch.stack(seq)  # (steps, T)
    rel = ((got - seq).abs() / seq.abs()).double().cpu()
    par = [max((p[t] - sp).abs().max().item()
               for p, sp in zip(lanes.model.parameters(),
                                singles[t].model.parameters()))
           for t in range(T)]

    def epoch_rel(a):
        a = a.double().reshape(cs.MLP_EPOCHS, steps, T).mean(1)
        b = seq.double().reshape(cs.MLP_EPOCHS, steps, T).mean(1)
        return ((a - b).abs() / b.abs()).max(0).values.cpu()

    def first_over(r, bar):
        hit = (r > bar).nonzero()
        return int(hit[0]) + 1 if len(hit) else None

    summary = [dict(lane=t, epoch_mean_rel=epoch_rel(got)[t].item(),
                    max_step_rel=rel[:, t].max().item(),
                    first_step_over_1e6=first_over(rel[:, t], 1e-6),
                    first_step_over_1e5=first_over(rel[:, t], 1e-5),
                    param_max_diff=par[t],
                    parted_steps=len({f["step"] for f in flips[t]}),
                    first_parted=flips[t][:3]) for t in range(T)]
    print(json.dumps({"steps": summary}), flush=True)

    # 3. controls: reverse lane order; each trial in a stack of one
    rev, _ = lane_run(range(T - 1, -1, -1))
    rev = rev.flip(1)
    alone = torch.cat([lane_run([t])[0] for t in range(T)], 1)
    controls = [dict(lane=t, reversed_epoch_mean_rel=epoch_rel(rev)[t].item(),
                     reversed_equals_forward=bool(torch.equal(rev[:, t],
                                                              got[:, t])),
                     alone_epoch_mean_rel=epoch_rel(alone)[t].item(),
                     alone_equals_forward=bool(torch.equal(alone[:, t],
                                                           got[:, t])))
                for t in range(T)]
    print(json.dumps({"controls": controls}), flush=True)

    out = os.path.join(ROOT, "profiles")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "trial_lanes.json"), "w") as f:
        json.dump({"card": smi, "first_step": first, "steps": summary,
                   "controls": controls, "step_rel": rel.tolist(),
                   "reversed_rel": ((rev - seq).abs() / seq.abs()).tolist(),
                   "alone_rel": ((alone - seq).abs() / seq.abs()).tolist()},
                  f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
