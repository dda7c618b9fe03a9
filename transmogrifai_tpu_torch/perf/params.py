"""PerfModelParams: the learned cost model's JSON-loadable configuration.

The port's own copy of the dataclass of the JAX package's
`perf/params.py`, as data only: `OpParams.perf_model` parses and writes
the same JSON as the JAX package. The cost model itself (its corpus, its
process-default installation and its consumers) is not ported yet
(ROADMAP.md queue 1, item 10), so `Workflow.train` refuses a
`perf_model` block.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

__all__ = ["PerfModelParams"]


@dataclass
class PerfModelParams:
    """JSON-loadable cost-model config (`OpParams.perf_model`).

    `model_path` points at a fitted model JSON (`CostModel.save`) so a
    saved workflow ships with the predictor that tuned it; when unset,
    the model is fitted lazily from the corpus. `min_rows` is the
    cold-start floor: a target with fewer training rows predicts None
    and every consumer falls back to today's heuristics exactly."""

    enabled: bool = True
    corpus_dir: Optional[str] = None      # default: env / ~/.cache/...
    model_path: Optional[str] = None      # fitted model JSON to load
    target_block_s: Optional[float] = None  # scheduler width sizing
    hbm_budget_gb: Optional[float] = None   # pre-dispatch OOM gate
    min_rows: int = 8                     # per-target cold-start floor

    _FIELDS = ("enabled", "corpus_dir", "model_path", "target_block_s",
               "hbm_budget_gb", "min_rows")

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "PerfModelParams":
        return PerfModelParams(**{k: d[k] for k in PerfModelParams._FIELDS
                                  if k in d})

    def to_json(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._FIELDS}
