"""Dynamic micro-batcher: bounded queue + power-of-two shape buckets.

The port's copy of the JAX package's `serving/batcher.py` core. Requests
coalesce into one device batch, padded up to a small ladder of
power-of-two buckets (``1, 2, 4, ... max_batch``), so the device sees a
handful of batch shapes, each warmed once at start. The request queue is
bounded (a full queue sheds with ``queue_full``), every request carries a
deadline (expired requests are dropped at dequeue), and a request that
can never fit a bucket is rejected at admission.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from transmogrifai_tpu_torch.data.dataset import Dataset


class ScoreError(Exception):
    """Structured serving error: a machine-readable ``code`` plus a human
    message. Codes: ``queue_full``, ``deadline_exceeded``, ``bad_request``,
    ``internal``, ``shutdown``."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
        self.message = message

    def to_json(self) -> Dict[str, Any]:
        return {"error": self.code, "message": self.message}


def bucket_ladder(max_batch: int) -> Tuple[int, ...]:
    """Power-of-two bucket sizes from 1 up to and including ``max_batch``.

    ``max_batch`` itself is always the top rung even when it is not a
    power of two (the cap must be reachable, and one extra compiled
    shape is cheaper than refusing max-size batches)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    ladder: List[int] = []
    b = 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return tuple(ladder)


def bucket_for(n_rows: int, ladder: Tuple[int, ...]) -> int:
    """Smallest bucket >= n_rows; raises when no bucket fits."""
    for b in ladder:
        if n_rows <= b:
            return b
    raise ScoreError(
        "bad_request",
        f"request of {n_rows} rows exceeds the largest bucket "
        f"({ladder[-1]}); split it client-side")


class Request:
    """One in-flight scoring request: a future the caller blocks on and
    an absolute deadline. The payload is EITHER an already-columnar
    Dataset (the columnar wire) or raw row dicts + the model schema (the
    row wire); row requests are pivoted on the scoring thread, at first
    access of `dataset`."""

    __slots__ = ("_dataset", "rows", "_schema", "n_rows", "deadline",
                 "enqueued_at", "_event", "_result", "_error")

    def __init__(self, dataset: Optional[Dataset],
                 deadline: Optional[float],
                 rows: Optional[List[Dict[str, Any]]] = None,
                 schema: Optional[Dict[str, type]] = None):
        if dataset is None and rows is None:
            raise ValueError("Request needs a dataset or rows")
        self._dataset = dataset
        self.rows = rows if dataset is None else None
        self._schema = schema
        self.n_rows = len(dataset) if dataset is not None else len(rows)
        self.deadline = deadline          # absolute time.monotonic() or None
        self.enqueued_at = time.monotonic()
        self._event = threading.Event()
        self._result: Optional[Dict[str, Any]] = None
        self._error: Optional[ScoreError] = None

    @property
    def dataset(self) -> Dataset:
        """The request's columnar payload; row-wire requests encode on
        first access (scoring-thread-only by the threading model) and
        cache the result."""
        if self._dataset is None:
            self._dataset = Dataset.from_rows(self.rows, self._schema)
            self.rows = None
        return self._dataset

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now or time.monotonic()) > self.deadline)

    def resolve(self, result: Dict[str, Any]) -> None:
        self._result = result
        self._event.set()

    def fail(self, error: ScoreError) -> None:
        self._error = error
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._event.wait(timeout):
            raise ScoreError("deadline_exceeded",
                             "timed out waiting for a scoring slot")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


class MicroBatcher:
    """Bounded admission queue + batch assembly.

    ``put()`` runs on caller threads (admission control); ``next_batch()``
    runs on the single scoring thread and blocks up to ``batch_wait_s``
    to coalesce concurrent requests into one device batch of at most
    ``max_batch`` rows. A request that does not fit the current batch is
    carried into the next one (never reordered past its peers).
    """

    def __init__(self, max_queue: int, max_batch: int,
                 batch_wait_s: float = 0.002):
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch)
        self.batch_wait_s = float(batch_wait_s)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._queue: deque[Request] = deque()
        self._closed = False

    # -- admission (caller threads) --------------------------------------- #

    def put(self, req: Request) -> None:
        with self._lock:
            if self._closed:
                raise ScoreError("shutdown", "service is shutting down")
            if len(self._queue) >= self.max_queue:
                raise ScoreError(
                    "queue_full",
                    f"request queue at capacity ({self.max_queue}); "
                    "retry with backoff")
            self._queue.append(req)
            self._not_empty.notify()

    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def close(self) -> List[Request]:
        """Stop admissions; return (and clear) whatever was still queued
        so the service can fail those requests explicitly."""
        with self._lock:
            self._closed = True
            drained = list(self._queue)
            self._queue.clear()
            self._not_empty.notify_all()
            return drained

    # -- assembly (scoring thread) ---------------------------------------- #

    def _pop_fitting(self, budget: int) -> Optional[Request]:  # guarded-by: _lock
        """Pop the head request if it fits `budget` rows (caller holds
        the lock)."""
        if self._queue and self._queue[0].n_rows <= budget:
            return self._queue.popleft()
        return None

    def next_batch(self, poll_s: float = 0.05
                   ) -> Tuple[List[Request], List[Request]]:
        """Block until requests are available (or closed), then linger up
        to ``batch_wait_s`` filling the batch. Returns
        ``(batch, expired)`` — expired requests are returned separately
        so the service fails them with ``deadline_exceeded`` instead of
        scoring them. Empty batch + empty expired means closed/idle."""
        batch: List[Request] = []
        expired: List[Request] = []
        rows = 0
        with self._not_empty:
            while not self._queue and not self._closed:
                if not self._not_empty.wait(timeout=poll_s):
                    return [], []
            linger_until = time.monotonic() + self.batch_wait_s
            while rows < self.max_batch:
                req = self._pop_fitting(self.max_batch - rows)
                if req is not None:
                    if req.expired():
                        expired.append(req)
                    else:
                        batch.append(req)
                        rows += req.n_rows
                    continue
                if self._queue or self._closed:
                    break  # head doesn't fit (or closed): ship what we have
                remaining = linger_until - time.monotonic()
                if remaining <= 0 or not batch:
                    break
                self._not_empty.wait(timeout=remaining)
                if not self._queue:
                    break
        return batch, expired


def pad_requests(requests: List[Request], ladder: Tuple[int, ...]
                 ) -> Tuple[Dataset, int, int]:
    """Concatenate request datasets and pick the bucket: returns
    ``(combined_dataset, n_valid, bucket)``. The padding to the bucket
    happens inside the compiled scorer (`score_padded`)."""
    parts = [r.dataset for r in requests]
    ds = Dataset.concat(parts) if len(parts) > 1 else parts[0]
    n = len(ds)
    return ds, n, bucket_for(n, ladder)
