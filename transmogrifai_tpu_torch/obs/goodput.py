"""Goodput accounting: roll a span tree into useful-work and badput buckets.

The port's own copy of the JAX package's `obs/goodput.py`: `build_report`
decomposes one trace's root wall time into badput buckets (retry backoff,
recompiles, ingest waits, OOM and fault redos) and the productive
remainder, so the buckets sum to the wall by construction, and rolls the
compiled scorer's ``device_dispatch`` events into the ``scoring``
section. The categories, names and JSON layout are the JAX package's, so
reports from the two packages compare key for key.

The port's sources of badput and savings:

- ``retry_backoff_s`` — `runtime/retry.py` opens a ``retry:<site>``
  span (category ``retry``) around each backoff sleep;
- ``oom_redo_s`` — ``oom_redo`` events from `parallel/sweep.py`: the
  wall time of a sweep block that died of device OOM before its halves
  ran;
- ``fault_redo_s`` — ``fault_redo`` events: the wall time of failed
  attempts a `RetryPolicy` retried;
- ``recompile_s`` and ``ingest_wait_s`` stay 0: the port has no
  tracing compiler and its ingest opens no span;
- the savings section: ``resume_saved_s`` sums the journaled durations
  of the sweep blocks a resumed run skipped (``journal_resume`` events);
- the ``mesh`` section rolls up the scheduler's ``mesh_utilization``
  events (`parallel/scheduler.py`): the share of workers × wall the lanes
  spent running blocks, and the steal / requeue / idle counters;
- ``counts``: retries, OOM redos, resumed blocks, injected faults,
  steals and retired workers.

The JAX package's other sections (cache savings, continual, perf,
fleet, router, resilience, SLO) come with the subsystems that emit their
events (ROADMAP.md queue 1, item 10); empty sections are left out of the
JSON in both packages.

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
    # distributed-sweep packing: rolled up from the scheduler's
    # ``mesh_utilization`` events — how much of workers × wall the lanes
    # spent executing blocks, plus steal/requeue/idle counters. Empty
    # when no schedule ran.
    mesh: Dict[str, Any] = field(default_factory=dict)
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
        if self.mesh:
            out["mesh"] = dict(sorted(self.mesh.items()))
        if self.scoring:
            out["scoring"] = dict(sorted(self.scoring.items()))
        return out

    def pretty(self) -> str:
        lines = [f"goodput: {self.goodput_frac:.1%} of "
                 f"{self.wall_s:.2f}s wall"]
        for k, v in sorted(self.buckets.items()):
            lines.append(f"  {k}: {v:.3f}s")
        for k, v in sorted(self.savings.items()):
            lines.append(f"  (saved) {k}: {v:.3f}s")
        return "\n".join(lines)


def build_report(root: Span, spans: Iterable[Span]) -> GoodputReport:
    """Decompose `root`'s wall clock into the badput buckets and the
    productive remainder (they sum to the wall by construction), and roll
    the events of `spans` (one trace, root included or not) into the
    savings, mesh, counts and scoring sections. Badput is exclusive by
    source: a retry span counts its own duration once, and the redo
    buckets read their events' ``wasted_s``."""
    report = GoodputReport(wall_s=root.duration_s, trace_id=root.trace_id)
    b = {k: 0.0 for k in BADPUT_BUCKETS}
    counts = {"retries": 0, "oom_redos": 0, "resumed_blocks": 0,
              "faults_injected": 0, "steals": 0, "workers_retired": 0}
    saved = 0.0
    scoring: Dict[str, Any] = {}
    # several schedules (one per selector fit) can land in one trace:
    # utilization averages weighted by each schedule's workers × wall
    mesh_wall = 0.0
    mesh_busy = 0.0
    mesh: Dict[str, Any] = {}
    seen: set = set()
    for sp in [root, *spans]:
        if sp.span_id in seen or sp.trace_id != root.trace_id:
            continue
        seen.add(sp.span_id)
        if sp is not root and sp.category == "retry":
            b["retry_backoff_s"] += sp.duration_s
            counts["retries"] += 1
        # events count wherever they landed, the root included
        for name, _, attrs in sp.events:
            if name == "oom_redo":
                b["oom_redo_s"] += float(attrs.get("wasted_s", 0.0) or 0.0)
                counts["oom_redos"] += 1
            elif name == "fault_redo":
                b["fault_redo_s"] += float(attrs.get("wasted_s", 0.0) or 0.0)
            elif name == "journal_resume":
                saved += float(attrs.get("saved_s", 0.0) or 0.0)
                counts["resumed_blocks"] += int(attrs.get("blocks", 0) or 0)
            elif name == "fault":
                counts["faults_injected"] += 1
            elif name == "steal":
                counts["steals"] += 1
            elif name == "worker_retired":
                counts["workers_retired"] += 1
            elif name == "mesh_utilization":
                wall = float(attrs.get("wall_s", 0.0) or 0.0)
                workers = int(attrs.get("workers", 0) or 0)
                mesh_wall += wall * max(workers, 1)
                mesh_busy += (float(attrs.get("utilization_frac", 0.0)
                                    or 0.0) * wall * max(workers, 1))
                mesh["workers"] = max(mesh.get("workers", 0), workers)
                mesh["schedules"] = mesh.get("schedules", 0) + 1
                for key in ("steals", "requeues", "blocks"):
                    mesh[key] = mesh.get(key, 0) + int(
                        attrs.get(key, 0) or 0)
                mesh["idle_s"] = round(mesh.get("idle_s", 0.0) + float(
                    attrs.get("idle_s", 0.0) or 0.0), 6)
            elif name == "device_dispatch":
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
    # badput cannot exceed wall (overlapped worker backoffs can): clamp
    # proportionally so the decomposition stays a decomposition
    total_bad = sum(b.values())
    if total_bad > report.wall_s > 0.0:
        scale = report.wall_s / total_bad
        b = {k: v * scale for k, v in b.items()}
        total_bad = report.wall_s
    b["productive_s"] = max(0.0, report.wall_s - total_bad)
    report.buckets = b
    if saved > 0.0 or counts["resumed_blocks"]:
        report.savings["resume_saved_s"] = saved
    report.scoring = scoring
    if mesh:
        mesh["utilization_frac"] = round(
            mesh_busy / mesh_wall, 4) if mesh_wall > 0 else 0.0
        report.mesh = mesh
    report.counts = {k: v for k, v in counts.items() if v}
    return report
