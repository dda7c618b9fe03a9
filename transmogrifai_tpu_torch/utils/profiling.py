"""Per-phase run profiling (the OpSparkListener / JobGroupUtil analogue).

The port's own copy of the JAX package's `utils/profiling.py`: a
`RunProfile` times named phases (the reference's `OpStep.scala` names)
as wall-clock scopes, each opening a ``phase:<name>`` span in the run's
timeline (`obs/trace.py`). Durations come from `time.perf_counter()`;
`started_at` stays an epoch timestamp.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from transmogrifai_tpu_torch.obs.trace import TRACER

# OpStep.scala phase names
DATA_READING = "DataReadingAndFiltering"
FEATURE_ENG = "FeatureEngineering"
CV = "CrossValidation"
TRAINING = "Training"
SCORING = "Scoring"
EVALUATION = "Evaluation"


@dataclass
class PhaseMetric:
    name: str
    duration_s: float
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "duration_s": round(self.duration_s, 4),
                **self.extra}


@dataclass
class RunProfile:
    """Collected per-phase timings for one runner invocation
    (AppMetrics/StageMetrics analogue)."""

    run_type: str = ""
    custom_tag_name: Optional[str] = None
    custom_tag_value: Optional[str] = None
    phases: List[PhaseMetric] = field(default_factory=list)
    started_at: float = field(default_factory=time.time)  # epoch timestamp
    histograms: Dict[str, Any] = field(default_factory=dict)
    run_id: Optional[str] = None       # obs trace correlation id
    goodput: Optional[Dict[str, Any]] = None  # obs.goodput rollup
    # duration origin: monotonic, immune to wall-clock steps
    _t0: float = field(default_factory=time.perf_counter, repr=False)

    def record_histogram(self, name: str, hist) -> None:
        """Attach a distribution summary (p50/p95/p99/count/...) to the
        profile — `hist` is an `obs.metrics.Histogram` (or any object
        with a `summary()` dict). Used by the streaming scorer for
        per-batch latency, and by the serve run type for its registry."""
        self.histograms[name] = hist.summary() if hasattr(hist, "summary") \
            else dict(hist)

    def record_ingest(self, name: str, stats) -> None:
        """Attach a pipelined-ingest phase (`data.pipeline.IngestStats`
        or any object with `wall_s` + `to_extra()`): per-stage
        read/cast/upload-wait timers, overlap fraction, and GB/s become
        the phase extras, so upload efficiency shows up next to the
        framework phases in every profile dump."""
        self.phases.append(PhaseMetric(
            name, float(getattr(stats, "wall_s", 0.0)), stats.to_extra()))

    @contextlib.contextmanager
    def phase(self, name: str, **extra):
        """Time a named phase and open an `obs.trace` span for it in the
        run's timeline.

        A body that raises still records its phase — with an ``error``
        extra naming the exception — and re-raises: a failed run's
        profile must show WHERE the time went before the failure, not
        silently drop the phase that died."""
        extra = dict(extra)
        t0 = time.perf_counter()
        try:
            with TRACER.span(f"phase:{name}", category="phase", **extra):
                yield
        except BaseException as e:  # incl. injected kills/preemptions
            extra["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            self.phases.append(
                PhaseMetric(name, time.perf_counter() - t0, extra))

    @property
    def app_duration_s(self) -> float:
        return time.perf_counter() - self._t0

    def to_json(self) -> Dict[str, Any]:
        return {
            "run_type": self.run_type,
            "run_id": self.run_id,
            "custom_tag": ({self.custom_tag_name: self.custom_tag_value}
                           if self.custom_tag_name else None),
            "app_duration_s": round(self.app_duration_s, 4),
            "phases": [p.to_json() for p in self.phases],
            "histograms": self.histograms or None,
            "goodput": self.goodput,
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    def pretty(self) -> str:
        lines = [f"Run {self.run_type} "
                 f"({self.app_duration_s:.2f}s total):"]
        for p in self.phases:
            lines.append(f"  {p.name}: {p.duration_s:.2f}s "
                         + (str(p.extra) if p.extra else ""))
        if self.goodput:
            lines.append(f"  goodput: {self.goodput.get('goodput_frac')}"
                         f" of {self.goodput.get('wall_s')}s wall")
        return "\n".join(lines)
