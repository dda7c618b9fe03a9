"""Hyperparameter grid builders.

The port's own copy of the JAX package's `selector/grids.py` (Spark's
ParamGridBuilder usage in `BinaryClassificationModelSelector.scala` and
`RandomParamBuilder.scala:52-150`). `RandomParamBuilder` draws from
numpy's `default_rng(seed)` in the same order as the JAX package, so its
grids are bit-equal to the JAX package's for the same seed and calls.
"""

from __future__ import annotations

from itertools import product
from typing import Any, Dict, List, Sequence

import numpy as np


class ParamGridBuilder:
    """Cartesian grid: `ParamGridBuilder().add("reg_param", [0.01, 0.1]).build()`."""

    def __init__(self):
        self._grids: Dict[str, Sequence[Any]] = {}

    def add(self, param: str, values: Sequence[Any]) -> "ParamGridBuilder":
        self._grids[param] = list(values)
        return self

    def build(self) -> List[Dict[str, Any]]:
        if not self._grids:
            return [{}]
        keys = list(self._grids)
        return [dict(zip(keys, combo))
                for combo in product(*(self._grids[k] for k in keys))]


class RandomParamBuilder:
    """Random search: uniform / exponential / subset draws per param."""

    def __init__(self, seed: int = 42):
        self._rng = np.random.default_rng(seed)
        self._specs: List = []

    def uniform(self, param: str, lo: float, hi: float) -> "RandomParamBuilder":
        self._specs.append((param, lambda: float(self._rng.uniform(lo, hi))))
        return self

    def exponential(self, param: str, lo: float, hi: float) -> "RandomParamBuilder":
        if lo <= 0 or hi <= 0:
            raise ValueError("exponential bounds must be positive")
        llo, lhi = np.log(lo), np.log(hi)
        self._specs.append(
            (param, lambda: float(np.exp(self._rng.uniform(llo, lhi)))))
        return self

    def uniform_int(self, param: str, lo: int, hi: int) -> "RandomParamBuilder":
        """Inclusive integer draw (RandomParamBuilder.scala uniform on
        IntParam)."""
        if hi < lo:
            raise ValueError("uniform_int: hi < lo")
        self._specs.append(
            (param, lambda: int(self._rng.integers(lo, hi + 1))))
        return self

    def subset(self, param: str, values: Sequence[Any]) -> "RandomParamBuilder":
        vals = list(values)
        if not vals:
            raise ValueError("subset: empty choices")
        self._specs.append(
            (param, lambda: vals[int(self._rng.integers(len(vals)))]))
        return self

    def build(self, n: int) -> List[Dict[str, Any]]:
        return [{p: draw() for p, draw in self._specs} for _ in range(n)]
