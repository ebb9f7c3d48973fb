"""Profiling and debugging helpers (port of
``cliffordtpu/utils/profiling.py``):

* ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a Chrome / Perfetto trace (``trace.json``, open it in
  ui.perfetto.dev or chrome://tracing) of the enclosed steps, the CUDA
  activity included where there is a card;
* ``enable_debug_checks()``: ``torch.autograd.set_detect_anomaly``, the
  counterpart of ``jax_debug_nans`` / ``jax_debug_infs``.  It checks each
  backward function's output and raises at the first NaN gradient, with
  the traceback of the forward operation that made it.  It does not see
  what ``jax_debug_nans`` sees outside autograd: a NaN made by a forward
  or an inference computation passes unnoticed, and an infinity is never
  checked (``infs`` is accepted and changes nothing);
* ``nan_guard``: raises ``NaNLossError`` on a non-finite loss so that
  the caller restores the last good checkpoint.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed code on the CPU, and on CUDA where available;
    the trace goes to ``<logdir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_debug_checks(nans: bool = True, infs: bool = False):
    """Anomaly detection on (``nans``) or off; see the module docstring
    for what it catches."""
    torch.autograd.set_detect_anomaly(nans)


class NaNLossError(RuntimeError):
    pass


def nan_guard(loss_value, context: str = ""):
    """Raise NaNLossError on non-finite loss (caller restores checkpoint)."""
    v = float(loss_value)
    if not np.isfinite(v):
        raise NaNLossError(f"non-finite loss {v} {context}")
    return v
