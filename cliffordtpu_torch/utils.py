"""Helpers of the evaluation battery (the port's own copy of what it needs
from ``cliffordtpu/utils/__init__.py``)."""

from __future__ import annotations

import zlib


def stable_hash(*parts) -> int:
    """Deterministic 32-bit digest (crc32) of the parts, stringified and
    joined by "-": a fold for keys that stays the same across processes,
    where Python's salted ``hash()`` would not."""
    return zlib.crc32("-".join(map(str, parts)).encode())
