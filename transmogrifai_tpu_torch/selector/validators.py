"""Validation strategies: k-fold CV and train/validation split.

The port's copy of the JAX package's `selector/validators.py`: a fold is
a pair of float32 row masks (train, validation) over the fixed training
matrix, drawn with the same numpy seeds, so the folds are the same rows.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class OpCrossValidation:
    """k-fold splits as (train_mask, val_mask) float32 vectors."""

    def __init__(self, n_folds: int = 3, seed: int = 42, stratify: bool = False):
        if n_folds < 2:
            raise ValueError("n_folds must be >= 2")
        self.n_folds = n_folds
        self.seed = seed
        self.stratify = stratify

    def splits(self, y: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
        n = len(y)
        rng = np.random.default_rng(self.seed)
        fold_of = np.empty(n, dtype=np.int64)
        if self.stratify:
            # per-class round-robin assignment after a shuffle
            # (stratifyKFolds, OpCrossValidation.scala:184)
            for lvl in np.unique(np.round(y).astype(np.int64)):
                idx = np.nonzero(np.round(y).astype(np.int64) == lvl)[0]
                idx = rng.permutation(idx)
                fold_of[idx] = np.arange(len(idx)) % self.n_folds
        else:
            fold_of = rng.permutation(n) % self.n_folds
        out = []
        for k in range(self.n_folds):
            val = (fold_of == k)
            out.append(((~val).astype(np.float32), val.astype(np.float32)))
        return out


class OpTrainValidationSplit:
    """Single split (OpTrainValidationSplit.scala), same mask contract."""

    def __init__(self, train_ratio: float = 0.75, seed: int = 42):
        self.train_ratio = train_ratio
        self.seed = seed

    def splits(self, y: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
        n = len(y)
        rng = np.random.default_rng(self.seed)
        train = rng.uniform(size=n) < self.train_ratio
        return [(train.astype(np.float32), (~train).astype(np.float32))]
