"""Unique stage/feature identifiers.

Reference parity: `utils/src/main/scala/com/salesforce/op/UID.scala` — uids of
the form `ClassName_000000000012`, deterministic per-process counter so DAGs
built in the same order get the same uids (needed for serialization
round-trips and test reproducibility).
"""

from __future__ import annotations

import itertools
import re
import threading

_counter = itertools.count(1)
_lock = threading.Lock()

_UID_RE = re.compile(r"^(\w+)_(\w{12})$")


def UID(cls_or_name) -> str:
    """Generate the next uid for a class or class name."""
    name = cls_or_name if isinstance(cls_or_name, str) else cls_or_name.__name__
    with _lock:
        n = next(_counter)
    return f"{name}_{n:012d}"


def reset(start: int = 1) -> None:
    """Reset the uid counter (test use only)."""
    global _counter
    with _lock:
        _counter = itertools.count(start)


def from_string(uid: str) -> tuple:
    """Parse `ClassName_000000000012` into (class_name, suffix); raises on bad format."""
    m = _UID_RE.match(uid)
    if not m:
        raise ValueError(f"Invalid uid: {uid!r}")
    return m.group(1), m.group(2)
