"""Time the two heavy pieces of the VSA eval battery on one device (port
of ``scripts/eval_battery_timing.py``): ``test_bundle_capacity`` and
``test_binding_unbinding_pairs`` at the reference's config (d 1024, 1000
items, 20 trials), one cold pass and ``--repeat`` warm ones, each ending
in a synchronise; prints one JSON line with the JAX script's keys
(``backend`` is the device type).

    python -m cliffordtpu_torch.scripts.eval_battery_timing
    python -m cliffordtpu_torch.scripts.eval_battery_timing --device cpu

``--device`` takes the place of ``--backend``; the default is the card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from cliffordtpu_torch.device import resolve_device
from cliffordtpu_torch.vsa.capacity import (
    test_binding_unbinding_pairs,
    test_bundle_capacity,
)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


def run_once(args, device, key_seed):
    """(bundle seconds, role-filler seconds) of one pass."""
    _sync(device)
    t0 = time.perf_counter()
    test_bundle_capacity(d=args.d, n_items=args.n_items,
                         n_trials=args.n_trials, key=(0, key_seed),
                         device=device)
    _sync(device)
    t1 = time.perf_counter()
    test_binding_unbinding_pairs(d=args.d, n_items=args.n_items,
                                 n_trials=args.n_trials,
                                 key=(0, key_seed + 1), device=device)
    _sync(device)
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the GPU (raises without "
                        "one)")
    p.add_argument("--d", type=int, default=1024)
    p.add_argument("--n_items", type=int, default=1000)
    p.add_argument("--n_trials", type=int, default=20)
    p.add_argument("--repeat", type=int, default=2,
                   help="repeats after the timed cold pass")
    return p


def timing(args) -> dict:
    device = resolve_device(args.device)
    cold_bundle, cold_rf = run_once(args, device, 0)
    warm = [run_once(args, device, i + 1) for i in range(args.repeat)]
    warm_bundle = min(w[0] for w in warm)
    warm_rf = min(w[1] for w in warm)
    return {
        "backend": device.type,
        "device": device_name(device),
        "d": args.d, "n_items": args.n_items, "n_trials": args.n_trials,
        "bundle_capacity_cold_s": round(cold_bundle, 3),
        "bundle_capacity_warm_s": round(warm_bundle, 3),
        "role_filler_cold_s": round(cold_rf, 3),
        "role_filler_warm_s": round(warm_rf, 3),
        "battery_cold_s": round(cold_bundle + cold_rf, 3),
        "battery_warm_s": round(warm_bundle + warm_rf, 3),
    }


def main(argv=None):
    print(json.dumps(timing(build_parser().parse_args(argv))))


if __name__ == "__main__":
    main()
