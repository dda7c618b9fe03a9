"""Categorical pivot helpers (the port's copy of the host-side helpers in
the JAX package's `ops/categorical.py` that `SmartTextModel` uses)."""

from __future__ import annotations

from typing import Dict

import numpy as np


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
