"""Helpers of the evaluation battery (the port's own copy of what it needs
from ``cliffordtpu/utils/__init__.py``) and the lazy pyplot of its
plots."""

from __future__ import annotations

import zlib


def stable_hash(*parts) -> int:
    """Deterministic 32-bit digest (crc32) of the parts, stringified and
    joined by "-": a fold for keys that stays the same across processes,
    where Python's salted ``hash()`` would not."""
    return zlib.crc32("-".join(map(str, parts)).encode())


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported when a plot is
    drawn: the card has no matplotlib, so no module imports it at load."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
