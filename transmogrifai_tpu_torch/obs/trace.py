"""Thread-safe hierarchical span tracer: the run timeline.

The port's own copy of the span part of the JAX package's `obs/trace.py`
(`Span`, `Tracer`, `TRACER`, `new_run_id`, `current_span`,
`add_event`). A `Span` is a named, attributed interval with a parent, so
a runner invocation, its phases, each stage's fit and transform and each
sweep block nest into ONE tree, exported to Perfetto by `obs/export.py`
and rolled into goodput buckets by `obs/goodput.py`.

- The current span lives in a `contextvars.ContextVar`, so nesting needs
  no span handle in call signatures; worker threads do not inherit the
  caller's context, so a cross-thread parent is passed explicitly
  (``tracer.span(..., parent=span)``).
- Durations come from `time.perf_counter()`; each span also carries an
  epoch `start_at` for humans. Export timestamps are perf-clock offsets
  from one process epoch, so they are monotonic and non-negative.
- Finished spans collect in a ring (default 65,536); the oldest are
  dropped and counted past it.

Request tracing (`TraceContext`, `RequestTrace`, `TracingParams`,
`TailSampler`, traceparent parsing) and the finished-span sinks that feed
the crash flight recorder serve the HTTP front end and are not ported yet
(ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["Span", "Tracer", "TRACER", "current_span", "add_event",
           "new_run_id"]

# one process epoch for both clocks: export timestamps are
# perf_counter-relative to this origin, mapped onto the epoch origin
_EPOCH_PERF = time.perf_counter()
_EPOCH_TIME = time.time()

_span_ids = itertools.count(1)


def new_run_id() -> str:
    """Run-level correlation id: unique across processes, short enough
    to grep in a JSONL event log."""
    return uuid.uuid4().hex[:12]


class Span:
    """One named interval in a trace tree.

    `attributes` are set at open (`tracer.span(name, key=val)`) or later
    via `set()`; `events` are point-in-time markers inside the span
    (journal resumes, cache hits, injected faults). `end()` is
    idempotent; an un-ended span exports with "now" as its end so a
    live process can still dump a coherent trace.
    """

    __slots__ = ("name", "category", "span_id", "parent_id", "trace_id",
                 "start_s", "end_s", "start_at", "attributes", "events",
                 "thread_id", "thread_name", "error")

    def __init__(self, name: str, category: str = "span",
                 parent: Optional["Span"] = None,
                 trace_id: Optional[str] = None,
                 attributes: Optional[Dict[str, Any]] = None):
        self.name = name
        self.category = category
        self.span_id = next(_span_ids)
        self.parent_id = parent.span_id if parent is not None else None
        self.trace_id = trace_id or (
            parent.trace_id if parent is not None else new_run_id())
        self.start_s = time.perf_counter() - _EPOCH_PERF
        self.end_s: Optional[float] = None
        self.start_at = _EPOCH_TIME + self.start_s
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.events: List[Tuple[str, float, Dict[str, Any]]] = []
        t = threading.current_thread()
        self.thread_id = t.ident or 0
        self.thread_name = t.name
        self.error: Optional[str] = None

    # -- mutation ---------------------------------------------------------- #

    def set(self, **attributes: Any) -> "Span":
        self.attributes.update(attributes)
        return self

    def event(self, name: str, **attributes: Any) -> None:
        """Point-in-time marker inside this span (exported as a Perfetto
        instant event)."""
        self.events.append(
            (name, time.perf_counter() - _EPOCH_PERF, dict(attributes)))

    def end(self) -> None:
        if self.end_s is None:
            self.end_s = time.perf_counter() - _EPOCH_PERF

    # -- views ------------------------------------------------------------- #

    @property
    def duration_s(self) -> float:
        end = self.end_s if self.end_s is not None \
            else time.perf_counter() - _EPOCH_PERF
        return max(0.0, end - self.start_s)

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name, "category": self.category,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "start_at": round(self.start_at, 6),
            "duration_s": round(self.duration_s, 6),
            "thread": self.thread_name,
            "attributes": self.attributes,
            "events": [{"name": n, "offset_s": round(t - self.start_s, 6),
                        **a} for n, t, a in self.events],
            "error": self.error,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, {self.duration_s:.4f}s)")


class Tracer:
    """Process span collector + contextvar-based current-span tracking.

    One global instance (`TRACER`) serves the whole process.
    """

    def __init__(self, max_spans: int = 65536):
        self._lock = threading.Lock()
        self._finished: deque = deque(maxlen=max_spans)
        self._live: Dict[int, Span] = {}
        self.dropped = 0
        # NOTE: a per-Tracer ContextVar would leak on tracer churn;
        # module scope is fine because tests always reset the global.
        self._current: contextvars.ContextVar[Optional[Span]] = \
            contextvars.ContextVar(f"obs_span_{id(self)}", default=None)

    # -- span lifecycle ---------------------------------------------------- #

    @contextlib.contextmanager
    def span(self, name: str, category: str = "span",
             parent: Optional[Span] = None, new_trace: bool = False,
             trace_id: Optional[str] = None,
             **attributes: Any) -> Iterator[Span]:
        """Open a child of `parent` (explicit, for cross-thread nesting)
        or of the calling context's current span. `new_trace=True` roots
        a fresh trace — under `trace_id` when given (the runner passes
        its run correlation id, so the trace, the profile, and the JSONL
        event log all share ONE id), else a fresh one. Exceptions —
        including BaseExceptions like an injected kill — are recorded on
        the span and re-raised."""
        if parent is None and not new_trace:
            parent = self._current.get()
        sp = Span(name, category=category,
                  parent=None if new_trace else parent,
                  trace_id=(trace_id or new_run_id()) if new_trace
                  else trace_id,
                  attributes=attributes)
        with self._lock:
            self._live[sp.span_id] = sp
        token = self._current.set(sp)
        try:
            yield sp
        except BaseException as e:
            sp.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            self._current.reset(token)
            sp.end()
            with self._lock:
                self._live.pop(sp.span_id, None)
                if len(self._finished) == self._finished.maxlen:
                    self.dropped += 1
                self._finished.append(sp)

    def current(self) -> Optional[Span]:
        return self._current.get()

    # -- collection views --------------------------------------------------- #

    def trace_spans(self, trace_id: str,
                    include_live: bool = True) -> List[Span]:
        """Every span of one trace (one runner invocation), finished and
        — by default — still-open, sorted by start time."""
        with self._lock:
            out = [s for s in self._finished if s.trace_id == trace_id]
            if include_live:
                out += [s for s in self._live.values()
                        if s.trace_id == trace_id]
        return sorted(out, key=lambda s: (s.start_s, s.span_id))


TRACER = Tracer()


def current_span() -> Optional[Span]:
    """The calling context's innermost open span on the global tracer."""
    return TRACER.current()


def add_event(name: str, **attributes: Any) -> bool:
    """Attach an instant event to the current span, if any. The no-span
    case is a cheap no-op so library code can emit unconditionally."""
    sp = TRACER.current()
    if sp is None:
        return False
    sp.event(name, **attributes)
    return True
