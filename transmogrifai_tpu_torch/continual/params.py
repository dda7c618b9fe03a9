"""ContinualParams: the JSON-loadable knobs of the continuous-training loop.

The port's own copy of the JAX package's `continual/params.py`, as data
only: `OpParams.continual` parses and writes the same JSON as the JAX
package. The loop itself (drift monitor, warm refit, promotion gate,
rollback) is not ported yet (ROADMAP.md queue 1, item 10), so
`Workflow.train` refuses a `continual` block.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass
class ContinualParams:
    """Knobs of the JAX package's `continual.loop.ContinualLoop`.

    Drift: the monitor holds a sliding window of the most recent
    `window_rows` appended records and refuses to judge fewer than
    `min_window_rows` (PSI over a near-empty histogram is noise). Drift
    fires when any feature's PSI against the training fingerprint
    exceeds `psi_threshold` (0.2 is the standard "significant shift"
    line; 0.1-0.2 is "monitor") or the label rate moved more than
    `label_shift_threshold` absolute.

    Refit: `refit_max_iter` caps the warm-started optimizer budget
    (None = the estimator's own default — warm starts usually converge
    well inside it); `refit_max_rows` caps how many trailing store rows
    the refit trains on (None = all rows — set it for multi-GB stores,
    whose full materialization would otherwise dominate host RAM every
    cycle); `holdout_fraction` of the window is excluded from the refit
    and scores the candidate.

    Promotion: the candidate must not regress the holdout metric more
    than `metric_tolerance` below the resident model's. After the swap,
    `live_eval_rows` of held-out records are scored THROUGH the serving
    path; with `auto_rollback` a live regression (or an eval failure)
    restores the previous resident version.
    """

    window_rows: int = 4096
    min_window_rows: int = 256
    n_bins: int = 10                   # PSI histogram resolution
    psi_threshold: float = 0.2
    label_shift_threshold: float = 0.1
    holdout_fraction: float = 0.2
    refit_max_iter: Optional[int] = None
    refit_max_rows: Optional[int] = None  # cap on trailing store rows a
    #                                       refit trains on (bounds the
    #                                       host materialization of
    #                                       multi-GB stores; None = all)
    metric_tolerance: float = 0.02
    live_eval_rows: int = 512
    auto_rollback: bool = True
    check_interval_s: float = 1.0      # supervisor poll period
    versions_dir: Optional[str] = None  # promoted artifacts (default:
    #                                     "<model_dir>-versions")
    journal_dir: Optional[str] = None  # cycle journal for crash resume

    _FIELDS = ("window_rows", "min_window_rows", "n_bins", "psi_threshold",
               "label_shift_threshold", "holdout_fraction",
               "refit_max_iter", "refit_max_rows", "metric_tolerance",
               "live_eval_rows", "auto_rollback", "check_interval_s",
               "versions_dir", "journal_dir")

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ContinualParams":
        return ContinualParams(**{k: d[k] for k in ContinualParams._FIELDS
                                  if k in d})

    def to_json(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._FIELDS}

    def __post_init__(self):
        if not (0.0 < self.holdout_fraction < 1.0):
            raise ValueError("holdout_fraction must be in (0, 1)")
        if self.min_window_rows > self.window_rows:
            raise ValueError("min_window_rows cannot exceed window_rows")
        if self.n_bins < 2:
            raise ValueError("n_bins must be >= 2")
        if self.refit_max_rows is not None and self.refit_max_rows < 1:
            raise ValueError("refit_max_rows must be >= 1 (or None)")
