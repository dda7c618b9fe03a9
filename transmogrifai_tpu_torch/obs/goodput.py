"""Goodput accounting: roll a span tree into useful-work and badput buckets.

The port's own copy of the JAX package's `obs/goodput.py`: `build_report`
decomposes one trace's root wall time into badput buckets (retry backoff,
recompiles, ingest waits, OOM and fault redos) and the productive
remainder, so the buckets sum to the wall by construction, and rolls the
compiled scorer's ``device_dispatch`` events into the ``scoring``
section. The categories, names and JSON layout are the JAX package's, so
reports from the two packages compare key for key.

Nothing in the port emits a badput source yet: it has no ingest workers,
no retries, no tracing compiler and no redo paths, so every badput
bucket is 0 and the run is all productive. The JAX package's other
sections (savings from journal resumes and cache hits, mesh, continual,
perf, fleet, router, resilience, SLO) come with the subsystems that emit
their events (ROADMAP.md queue 1, items 7, 9 and 10); empty sections are
left out of the JSON in both packages.

The report lands in `RunProfile.to_json()["goodput"]`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional

from transmogrifai_tpu_torch.obs.trace import Span

__all__ = ["GoodputReport", "build_report", "BADPUT_BUCKETS"]

BADPUT_BUCKETS = ("retry_backoff_s", "recompile_s", "ingest_wait_s",
                  "oom_redo_s", "fault_redo_s")


@dataclass
class GoodputReport:
    """Wall-time decomposition of one trace (one run)."""

    wall_s: float = 0.0
    trace_id: Optional[str] = None
    buckets: Dict[str, float] = field(default_factory=dict)
    savings: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    # compiled-scoring accounting: rolled up from ``device_dispatch``
    # events (CompiledScorer._dispatch emits one per device-segment launch
    # with the bytes shipped in and returned). Empty when no compiled
    # scoring ran inside a span.
    scoring: Dict[str, Any] = field(default_factory=dict)

    @property
    def badput_s(self) -> float:
        return sum(v for k, v in self.buckets.items()
                   if k != "productive_s")

    @property
    def goodput_frac(self) -> float:
        if self.wall_s <= 0.0:
            return 1.0
        return max(0.0, min(1.0, self.buckets.get("productive_s", 0.0)
                            / self.wall_s))

    def to_json(self) -> Dict[str, Any]:
        out = {
            "wall_s": round(self.wall_s, 6),
            "trace_id": self.trace_id,
            "goodput_frac": round(self.goodput_frac, 4),
            "buckets": {k: round(v, 6)
                        for k, v in sorted(self.buckets.items())},
            "savings": {k: round(v, 6)
                        for k, v in sorted(self.savings.items())},
            "counts": dict(sorted(self.counts.items())),
        }
        if self.scoring:
            out["scoring"] = dict(sorted(self.scoring.items()))
        return out

    def pretty(self) -> str:
        lines = [f"goodput: {self.goodput_frac:.1%} of "
                 f"{self.wall_s:.2f}s wall"]
        for k, v in sorted(self.buckets.items()):
            lines.append(f"  {k}: {v:.3f}s")
        return "\n".join(lines)


def build_report(root: Span, spans: Iterable[Span]) -> GoodputReport:
    """Decompose `root`'s wall clock into the badput buckets (all 0: no
    port path emits a badput source) and the productive remainder, and
    roll the ``device_dispatch`` events of `spans` (one trace, root
    included or not) into the scoring section."""
    report = GoodputReport(wall_s=root.duration_s, trace_id=root.trace_id)
    report.buckets = {**{k: 0.0 for k in BADPUT_BUCKETS},
                      "productive_s": report.wall_s}
    scoring: Dict[str, Any] = {}
    seen: set = set()
    for sp in [root, *spans]:
        if sp.span_id in seen or sp.trace_id != root.trace_id:
            continue
        seen.add(sp.span_id)
        for name, _, attrs in sp.events:
            if name != "device_dispatch":
                continue
            scoring["dispatches"] = scoring.get("dispatches", 0) + 1
            scoring["bytes_in"] = scoring.get("bytes_in", 0) + int(
                attrs.get("bytes_in", 0) or 0)
            scoring["bytes_out"] = scoring.get("bytes_out", 0) + int(
                attrs.get("bytes_out", 0) or 0)
            scoring["dispatch_s"] = round(
                scoring.get("dispatch_s", 0.0)
                + float(attrs.get("dispatch_s", 0.0) or 0.0), 6)
            if attrs.get("quant"):
                scoring["quant_dispatches"] = \
                    scoring.get("quant_dispatches", 0) + 1
    report.scoring = scoring
    return report
