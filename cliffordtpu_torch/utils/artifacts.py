"""Merge-on-write helpers for shared sweep artifacts (the port's copy of
``cliffordtpu/utils/artifacts.py``; one sidecar serves both packages, and
the lock file is keyed alike, so their writers exclude each other).

The reference emits one unified artifact set (CSV / timing / comparison
figures) per full sweep process (``cnn/fashion_train.py:1382-1410``,
``mnist/mnist_clifpws.py:659-698``).  Our runners additionally allow a
sweep to be SLICED across processes (per-family or per-dim invocations
into a shared ``--outdir``); these helpers make the shared artifacts
aggregate instead of clobber: raw per-key data is persisted to JSON
sidecars merged per key, and the unified CSV/figures are regenerated from
the merged data on every write.
"""

from __future__ import annotations

import fcntl
import json
import os
from contextlib import contextmanager
from typing import Dict


def jsonable(o):
    """Recursively convert numpy / torch leaves to plain JSON types (a
    tensor's ``tolist`` copies it to the host, on any device)."""
    if isinstance(o, dict):
        return {k: jsonable(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [jsonable(v) for v in o]
    if hasattr(o, "tolist"):
        return o.tolist()
    return o


def load_json(path) -> Dict:
    """Load a JSON sidecar; {} when missing.

    A CORRUPT sidecar is preserved as ``<path>.corrupt`` instead of being
    silently treated as empty: resetting to {} here would discard every
    previously merged sweep slice on the next write.  (With the atomic
    writes below, corruption should no longer occur — this is the
    recovery path for sidecars written by older code or alien tools.)
    """
    try:
        with open(path) as f:
            return json.load(f)
    except OSError:
        return {}
    except ValueError:
        backup = f"{path}.corrupt"
        try:
            os.replace(path, backup)
            print(f"warning: corrupt JSON sidecar {path} preserved as "
                  f"{backup}; starting a fresh merge")
        except OSError:
            print(f"warning: corrupt JSON sidecar {path} (backup failed); "
                  f"starting a fresh merge")
        return {}


def _atomic_dump(obj, path) -> None:
    """Write-to-temp + rename: a timeout-kill mid-write (the chains run
    sweeps under ``timeout`` BY DESIGN, relying on completed slices
    surviving) can never leave a truncated sidecar behind."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@contextmanager
def _sidecar_lock(path):
    """flock spanning the read-modify-write so two processes sharing an
    outdir (a trainer slice + scripts/rebuild_artifacts.py) can't lose
    each other's keys; auto-released on process death.  The lock file
    lives in the temp dir (keyed by the sidecar's absolute path) so
    artifact trees stay free of lock droppings."""
    import hashlib
    import tempfile

    digest = hashlib.sha1(
        os.path.abspath(str(path)).encode()).hexdigest()[:16]
    lock_path = os.path.join(tempfile.gettempdir(),
                             f"cliffordtpu_sidecar_{digest}.lock")
    fd = os.open(lock_path, os.O_RDWR | os.O_CREAT, 0o666)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def merge_json_write(path, new_data: Dict) -> Dict:
    """Merge-on-write: existing keys survive, this invocation's keys win.
    Atomic against kills; flocked against concurrent writers."""
    with _sidecar_lock(path):
        merged = load_json(path)
        merged.update(jsonable(new_data))
        _atomic_dump(merged, path)
    return merged


def merge_across_dims(path, new_data: Dict) -> Dict:
    """Merge across-dims curves keyed per (dist, dim) point.

    ``new_data`` maps dist -> {metric: [...], "dims": [...]} with lists
    aligned on "dims" (dims repeats once per trial).  This invocation's
    trial set replaces the whole (dist, dim) group; every other group is
    preserved, and the per-dist lists are re-sorted by dim.  Divergent
    dims x trials shapes across dists are fine: the across-dims plotter
    aligns by dim VALUE and aggregates trials to mean +- std
    (``eval/tables.py::plot_across_dims_comparison`` — deliberately
    unlike the reference's positional alignment, ``wandb_utils.py:958``,
    which misattributes values when shapes diverge).
    """

    def _group_by_dim(data):
        groups: Dict = {}
        for i, d in enumerate(data.get("dims", [])):
            entry = {m: (data[m][i] if i < len(data[m]) else float("nan"))
                     for m in data if m != "dims"}
            groups.setdefault(d, []).append(entry)
        return groups

    with _sidecar_lock(path):
        merged = load_json(path)
        for dist, data in jsonable(new_data).items():
            if not data.get("dims"):
                continue
            groups = _group_by_dim(merged.get(dist, {}))
            groups.update(_group_by_dim(data))
            all_metrics = sorted({m for entries in groups.values()
                                  for e in entries for m in e})
            out: Dict = {"dims": []}
            out.update({m: [] for m in all_metrics})
            for d in sorted(groups):
                for e in groups[d]:
                    out["dims"].append(d)
                    for m in all_metrics:
                        out[m].append(e.get(m, float("nan")))
            merged[dist] = out
        _atomic_dump(merged, path)
    return merged
