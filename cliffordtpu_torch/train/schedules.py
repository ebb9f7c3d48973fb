"""KL-weight (beta) schedules (copy of
``cliffordtpu/train/schedules.py``)."""

from __future__ import annotations


def linear_kl_warmup(epoch: int, warmup_epochs: int) -> float:
    """beta = min(1, (epoch + 1) / warmup)."""
    return min(1.0, (epoch + 1) / max(1, warmup_epochs))


def cyclical_kl_beta(epoch: int, warmup_epochs: int, cycle_epochs: int,
                     min_beta: float, max_beta: float) -> float:
    """Linear warmup to ``max_beta``, then a triangle wave in
    [min_beta, max_beta] of period ``cycle_epochs``."""
    if epoch < warmup_epochs:
        return min(1.0, (epoch + 1) / max(1, warmup_epochs)) * max_beta
    if cycle_epochs <= 0:
        return max_beta
    cycle_pos = (epoch - warmup_epochs) % cycle_epochs
    half = max(1, cycle_epochs // 2)
    if cycle_pos <= half:
        t = cycle_pos / half
    else:
        t = (cycle_epochs - cycle_pos) / max(1, cycle_epochs - half)
    return min_beta + (max_beta - min_beta) * t
