"""Categorical pivot helpers (the port's copy of the host-side helpers in
the JAX package's `ops/categorical.py` that `SmartTextModel` and
`SmartTextVectorizer` use)."""

from __future__ import annotations

from collections import Counter
from typing import Dict, List

import numpy as np


def top_k_levels(counter: Counter, top_k: int, min_support: int) -> List[str]:
    """Most frequent levels, count-desc then lexicographic for
    determinism."""
    eligible = [(c, lvl) for lvl, c in counter.items() if c >= min_support]
    eligible.sort(key=lambda t: (-t[0], t[1]))
    return [lvl for _, lvl in eligible[:top_k]]


def pivot_encode_ids(values, lut: Dict[str, int], k: int) -> np.ndarray:
    """Map level strings → ids with OTHER=k, NULL=k+1. None and float NaN
    are both missing."""
    out = np.full(len(values), k + 1, dtype=np.int32)  # NULL id
    for i, v in enumerate(values):
        if v is not None and v == v:
            out[i] = lut.get(v, k)
    return out


def one_hot_np(ids: np.ndarray, k: int, track_nulls: bool) -> np.ndarray:
    """Host-side dense pivot block: k levels + OTHER (+ NULL if tracked)."""
    block = np.zeros((len(ids), k + 2), dtype=np.float32)
    block[np.arange(len(ids)), ids] = 1.0
    return block if track_nulls else block[:, : k + 1]
