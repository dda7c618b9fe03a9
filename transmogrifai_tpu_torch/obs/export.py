"""Trace export: Chrome-trace/Perfetto JSON and a JSONL structured event log.

The port's own copy of the JAX package's `obs/export.py`:

- `chrome_trace(spans)` renders a span tree in the Chrome Trace Event
  format that Perfetto and chrome://tracing load: one ``"X"`` event per
  span (ts/dur in microseconds, args with span/parent/trace ids and
  attributes), one ``"i"`` instant event per span event (injected
  faults, retries, OOM and fault redos, journal resumes, steals, the
  scheduler's ``mesh_utilization``), and thread-name metadata, so the
  scheduler's ``sweep:worker:<k>`` lanes and K11's ``sweep:lane:<k>``
  threads label their own rows. `write_chrome_trace` writes it where the
  runner's `trace_location` names.
- `EventLog` appends one JSON object per line, stamped with the run's
  correlation id and flushed per record, so a killed run's log still
  ends at the kill. `emit_event` writes to the installed log and is a
  no-op without one; `record_event` writes the same event to the current
  span and the log.

`validate_chrome_trace` checks a payload: well-formed events,
non-negative timestamps, every parent present and every child starting
inside its parent.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, IO, Iterable, List, Optional, Tuple

from transmogrifai_tpu_torch.obs.trace import Span, add_event

__all__ = ["chrome_trace", "write_chrome_trace", "validate_chrome_trace",
           "EventLog", "install_event_log", "uninstall_event_log",
           "emit_event", "record_event"]


# -- Chrome trace / Perfetto -------------------------------------------------- #

def _args_jsonable(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)
    return out


def chrome_trace(spans: Iterable[Span],
                 process_name: str = "transmogrifai_tpu_torch",
                 pid: int = 0) -> Dict[str, Any]:
    """Render spans as a Chrome Trace Event JSON object.

    Timestamps are the spans' perf-counter offsets from the process
    trace epoch, in integer microseconds — monotonic and non-negative
    regardless of wall-clock steps. Unfinished spans export with "now"
    as their end so a live process can dump a coherent trace.

    `pid` labels the Perfetto process row.
    """
    spans = list(spans)
    events: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    seen_tids = set()
    for sp in spans:
        if sp.thread_id not in seen_tids:
            seen_tids.add(sp.thread_id)
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": sp.thread_id, "args": {"name": sp.thread_name},
            })
        args = {
            "span_id": sp.span_id, "parent_id": sp.parent_id,
            "trace_id": sp.trace_id,
            **_args_jsonable(sp.attributes),
        }
        if sp.error:
            args["error"] = sp.error
        events.append({
            "ph": "X", "name": sp.name, "cat": sp.category,
            "ts": int(sp.start_s * 1e6),
            "dur": max(1, int(sp.duration_s * 1e6)),
            "pid": pid, "tid": sp.thread_id, "args": args,
        })
        for name, t_s, attrs in sp.events:
            events.append({
                "ph": "i", "name": name, "cat": sp.category,
                "ts": int(t_s * 1e6), "pid": pid, "tid": sp.thread_id,
                "s": "t",
                "args": {"span_id": sp.span_id, **_args_jsonable(attrs)},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable[Span],
                       process_name: str = "transmogrifai_tpu_torch") -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(spans, process_name=process_name), f)
    return path


def validate_chrome_trace(obj: Dict[str, Any]) -> List[str]:
    """Structural validation of a chrome_trace() payload; returns a list
    of problems (empty = valid). Checked: traceEvents shape, required
    keys per phase, non-negative ts / positive dur, span parenting
    (parents exist; a child starts inside its parent's interval), and —
    for multi-process payloads — that every pid carrying spans declares
    a ``process_name`` metadata event.

    Span ids are scoped PER PID: a merged multi-process trace (a fleet
    flight dump beside another process's run trace) may legitimately
    reuse span ids across pids, and a child's parent must live in its
    own process row."""
    problems: List[str] = []
    events = obj.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    # (pid, span_id) -> (ts, ts+dur); parent lookups stay inside the pid
    spans: Dict[Tuple[Any, int], Tuple[int, int]] = {}
    parents: List[Tuple[Any, int, Optional[int]]] = []
    named_pids = set()
    span_pids = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            problems.append(f"event {i}: not an object with 'ph'")
            continue
        ph = ev["ph"]
        if ph == "M":
            if ev.get("name") == "process_name":
                named_pids.add(ev.get("pid"))
            continue
        for key in ("name", "ts", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i} ({ph}): missing {key!r}")
        ts = ev.get("ts")
        if not isinstance(ts, int) or ts < 0:
            problems.append(f"event {i}: ts {ts!r} not a non-negative int")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, int) or dur <= 0:
                problems.append(f"event {i}: dur {dur!r} not a positive int")
                continue
            sid = ev.get("args", {}).get("span_id")
            if isinstance(sid, int):
                pid = ev.get("pid")
                span_pids.add(pid)
                spans[(pid, sid)] = (ts, ts + dur)
                parents.append((pid, sid, ev["args"].get("parent_id")))
    for pid in sorted(span_pids - named_pids, key=repr):
        problems.append(
            f"pid {pid}: spans present but no process_name metadata")
    for pid, sid, parent_id in parents:
        if parent_id is None:
            continue
        if (pid, parent_id) not in spans:
            problems.append(
                f"span {sid} (pid {pid}): parent {parent_id} not in trace")
            continue
        p0, p1 = spans[(pid, parent_id)]
        c0, _ = spans[(pid, sid)]
        # 1ms grace: parent/child read the clock microseconds apart
        if c0 + 1000 < p0 or c0 > p1 + 1000:
            problems.append(
                f"span {sid} (pid {pid}): starts at {c0}us outside "
                f"parent {parent_id} interval [{p0}, {p1}]us")
    return problems


# -- JSONL structured event log ----------------------------------------------- #

class EventLog:
    """Append-only JSONL event sink with a run correlation id.

    Each record: ``{"ts": epoch, "run_id": ..., "kind": ..., **fields}``.
    Flushed per record so a preempted run's log is complete up to the
    kill; `close()` is idempotent. Thread-safe: retry hooks fire from
    ingest workers and selector family threads concurrently.
    """

    def __init__(self, path: str, run_id: str):
        self.path = path
        self.run_id = run_id
        self._lock = threading.Lock()
        self._fh: Optional[IO[str]] = open(path, "a", encoding="utf-8")

    def emit(self, kind: str, **fields: Any) -> None:
        rec = {"ts": round(time.time(), 6), "run_id": self.run_id,
               "kind": kind, **fields}
        line = json.dumps(rec, default=repr)
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_LOG_LOCK = threading.Lock()
_LOG: Optional[EventLog] = None


def install_event_log(log: EventLog) -> None:
    """Install the process-global event log (one per runner invocation;
    the correlation id lives on the log, not the call sites)."""
    global _LOG
    with _LOG_LOCK:
        _LOG = log


def uninstall_event_log(log: Optional[EventLog] = None) -> None:
    """Remove the active log (if `log` is given, only when it is the one
    installed — a nested scope must not clear an outer log)."""
    global _LOG
    with _LOG_LOCK:
        if log is None or _LOG is log:
            _LOG = None


def emit_event(kind: str, **fields: Any) -> None:
    """Emit a structured event to the installed log; no-op when none is
    installed, so retry/fault/journal paths call it unconditionally."""
    log = _LOG
    if log is not None:
        log.emit(kind, **fields)


def record_event(name: str, **fields: Any) -> None:
    """Record one observability event in both sinks: an instant event on
    the current trace span and a structured JSONL record, with the same
    name and fields. (The JAX package also notes it in its crash flight
    recorder, which is not ported: ROADMAP.md queue 1, item 10.)"""
    add_event(name, **fields)
    emit_event(name, **fields)
