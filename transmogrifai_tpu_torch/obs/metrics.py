"""Process-wide metrics registry: the counter part only.

The port's own copy of the counters of the JAX package's `obs/metrics.py`
(`Counter`, `MetricsRegistry.counter`, the read-side `find` and
`sum_family`, and the process-global `get_registry`): what the feature
cache (`data/feature_cache.py`: `feature_cache_hits_total`,
`feature_cache_misses_total`, `feature_cache_corrupt_total`,
`feature_cache_bytes_saved_total`, `feature_cache_seconds_saved_total`)
and the artifact store (`store_*_total`, labelled by backend) count into.
Metric names and labels are the JAX package's.

Not ported yet (ROADMAP queue 1, item 10): gauges, histograms with
exemplars, the JSON and Prometheus exports, snapshots and cross-replica
merges, and the rest of `obs/` (request traces, flight recorder, SLOs;
the run timeline, its exports and goodput are `trace.py`, `export.py`
and `goodput.py`).

All mutation is lock-protected: builders on several threads count into
the same registry.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

__all__ = ["Counter", "MetricsRegistry", "REGISTRY", "get_registry"]


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter (hits, misses, rejects, bytes)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class MetricsRegistry:
    """Named, labelled counter families."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> {"type", "help", "series": {label_key: metric}}
        self._families: Dict[str, Dict[str, Any]] = {}

    def counter(self, name: str, help: str = "",
                **labels: Any) -> Counter:
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = {"type": "counter", "help": help, "series": {}}
                self._families[name] = fam
            metric = fam["series"].get(key)
            if metric is None:
                metric = Counter()
                fam["series"][key] = metric
            return metric

    def find(self, name: str, **labels: Any):
        """The live counter for (name, labels), or None — a read that
        never mints a series."""
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam["series"].get(key)

    def sum_family(self, name: str, **label_filter: Any) -> float:
        """Sum of a family's counters whose labels match every (k, v) in
        `label_filter` (0.0 for a family never counted)."""
        want = {str(k): str(v) for k, v in label_filter.items()}
        with self._lock:
            fam = self._families.get(name)
            series = dict(fam["series"]) if fam is not None else {}
        return sum(m.value for key, m in series.items()
                   if all(dict(key).get(k) == v for k, v in want.items()))


# The single process-wide registry the port's builders count into.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
