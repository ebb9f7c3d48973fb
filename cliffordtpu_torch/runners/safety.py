"""Warn-and-continue guards for the evaluation battery (the port's copy of
``cliffordtpu/runners/safety.py``).

The reference swallows eval-stage failures so a broken plot never kills a
multi-hour sweep (``utils/wandb_utils.py:59-85, 283-285``,
``fashion_train.py:1288-1371``).  ``safe_eval`` retries a failed stage
once, then prints a ``warning:`` line with the exception and returns the
stage's default, so the JSON dumps keep their schema.
"""

from __future__ import annotations

import traceback
from typing import Callable, Optional, TypeVar

T = TypeVar("T")

EMPTY_CURVE = {"k": [], "accuracy": [], "std": []}
EMPTY_BINDING = {
    "binding_k_self_similarity": 0.0,
    "similarity_after_k_binds_plot_path": None,
    "recon_after_k_binds_plot_path": None,
    "k_sims": [],
    "k_values": [],
}


def safe_eval(label: str, fn: Callable[[], T], default: Optional[T] = None,
              retries: int = 1) -> T:
    """Run an eval stage; on failure retry once, then warn and return the
    default so downstream JSON dumps keep their schema."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:
            if attempt < retries:
                print(f"warning: {label} failed ({e!r}); retrying...")
                continue
            print(f"warning: {label} failed: {e!r} — skipping")
            traceback.print_exc()
    return default
