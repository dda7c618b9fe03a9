"""Bounded-depth host→device chunk pipeline for bulk ingest.

The port's counterpart of the JAX package's `data/pipeline.py`:
`run_chunk_pipeline` drives a host→device bulk transfer as a two-stage
pipeline,

- stage 1 (thread pool, `workers`): ``prepare(item)`` reads the chunk and
  casts it to the wire dtype — numpy memmap reads, dtype casts and
  PyTorch's CPU copies release the GIL, so workers overlap;
- stage 2 (main thread, `depth` in flight): ``upload(prepared)`` issues the
  device copy and the write and returns a completion token, a
  `torch.cuda.Event` recorded after them (the JAX package blocks on a tiny
  array computed from the written buffer instead). Once more than `depth`
  tokens are in flight the pipeline waits on the oldest, which is also
  what makes the per-chunk deadline check track real transfer progress.

All tokens are drained before returning, so the caller's buffers are
written and the recorded wall time is transfer time, not enqueue time.

`ChunkRing` is the host side of the builders (`parallel/bigdata.py`):
workers write each chunk into one of `size` host buffers in turn (pinned
when the chunks go to the card), and a buffer is written again only once
its previous chunk has been issued and, on the card, the event of that
chunk's copy has fired.

Per-stage timers land in `IngestStats` (read/cast seconds summed over
workers, main-thread dispatch and device-wait seconds, wall clock, bytes,
max in-flight depth) with the derived `overlap_frac` (the share of host
prep hidden behind transfers) and `gbps` (wire bytes / wall); a build
under the feature cache adds its outcome and key, the artifact's read
seconds and bytes on a hit and its tee seconds on a miss.

Absent here, and listed in ROADMAP.md: the JAX package's trace span and
metrics counters (`obs/`), its fault points and retry policy
(`runtime/faults.py`, `runtime/retry.py`) and its learned cost-model row
(`perf/`). `retry=` is refused.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

__all__ = ["IngestStats", "ChunkRing", "run_chunk_pipeline"]

RETRY_REFUSED = ("retry= is not ported (ROADMAP queue 1: the sweep journal, "
                 "checkpoints and resume — runtime/retry.py)")


@dataclass
class IngestStats:
    """Per-stage timers for one pipelined ingest.

    `read_s`/`cast_s` sum across worker threads; `upload_wait_s` is
    main-thread time blocked on device completion tokens (depth
    backpressure + final drain); `wall_s` covers the whole pipeline
    including the drain, so the buffers are written when it is recorded.
    """

    label: str = "ingest"
    workers: int = 0
    depth: int = 0
    chunks: int = 0
    bytes_read: int = 0
    bytes_wire: int = 0
    read_s: float = 0.0
    cast_s: float = 0.0
    dispatch_s: float = 0.0
    upload_wait_s: float = 0.0
    wall_s: float = 0.0
    max_in_flight: int = 0
    # feature-cache accounting (data/feature_cache.py): `read_s` /
    # `bytes_read` always mean STORE memmap reads, so a warm cache hit
    # shows 0 there and its artifact IO lands in `cache_read_s` /
    # `cache_bytes` instead
    wire: str = ""             # wire mode (float16, int8, int4, ...)
    cache: str = ""            # "", "miss", "hit", "resident"
    cache_key: str = ""        # content address of this build
    cache_read_s: float = 0.0  # artifact (warm) read seconds
    cache_bytes: int = 0       # artifact bytes read on a hit
    cache_write_s: float = 0.0  # artifact tee seconds on a readwrite miss
    bytes_saved_wire: int = 0  # f16-equivalent bytes NOT shipped (quant)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def note_read(self, seconds: float, nbytes: int) -> None:
        with self._lock:
            self.read_s += seconds
            self.bytes_read += nbytes

    def note_cast(self, seconds: float, wire_nbytes: int) -> None:
        with self._lock:
            self.cast_s += seconds
            self.bytes_wire += wire_nbytes
            self.chunks += 1

    def note_cache_read(self, seconds: float, nbytes: int) -> None:
        with self._lock:
            self.cache_read_s += seconds
            self.cache_bytes += nbytes

    @property
    def cache_hit(self) -> bool:
        """This build replayed a cached artifact (disk or resident)
        instead of sweeping the store."""
        return self.cache in ("hit", "resident")

    @property
    def host_s(self) -> float:
        # a warm replay reads its artifact on the same worker threads
        return self.read_s + self.cast_s + self.cache_read_s

    @property
    def overlap_frac(self) -> float:
        """Fraction of host prep time hidden behind the device side
        (dispatch + transfer waits, or other workers): 0 = fully serial
        (wall = host + dispatch + wait), 1 = host work fully overlapped
        (wall ≈ dispatch + wait)."""
        if self.host_s <= 0.0:
            return 0.0
        hidden = (self.host_s + self.dispatch_s + self.upload_wait_s
                  - self.wall_s)
        return max(0.0, min(1.0, hidden / self.host_s))

    @property
    def gbps(self) -> float:
        """Wire GB/s over the full pipeline wall clock."""
        if self.wall_s <= 0.0:
            return 0.0
        return self.bytes_wire / self.wall_s / 1e9

    def to_extra(self) -> Dict[str, Any]:
        return {
            "chunks": self.chunks, "bytes_wire": self.bytes_wire,
            "read_s": self.read_s, "cast_s": self.cast_s,
            "dispatch_s": self.dispatch_s,
            "upload_wait_s": self.upload_wait_s, "wall_s": self.wall_s,
            "overlap_frac": self.overlap_frac, "gbps": self.gbps,
            "workers": self.workers, "depth": self.depth,
            "max_in_flight": self.max_in_flight, "wire": self.wire,
            **({"cache": self.cache, "cache_key": self.cache_key,
                "cache_read_s": self.cache_read_s,
                "cache_bytes": self.cache_bytes,
                "cache_write_s": self.cache_write_s,
                "bytes_saved_wire": self.bytes_saved_wire}
               if self.cache else {})}


class ChunkRing:
    """`size` host buffers of one chunk each (pinned with `pin`), used in
    turn: chunk j goes into buffer j % size. `acquire(j)` (a worker) waits
    until chunk j − size has been issued out of that buffer and, if its
    copy left an event, that event has fired; `issued(j, event)` (the main
    thread) records chunk j's copy (event None: the chunk was consumed
    synchronously). `abort()` wakes every waiting worker with an error, so
    a failed pipeline never leaves a worker blocked."""

    def __init__(self, size: int, shape, dtype: torch.dtype, pin: bool):
        self.size = max(1, int(size))
        self.buffers = [torch.empty(shape, dtype=dtype, pin_memory=pin)
                        for _ in range(self.size)]
        self._events: List[Optional[torch.cuda.Event]] = [None] * self.size
        self._issued = [-1] * self.size
        self._aborted = False
        self._cond = threading.Condition()

    def acquire(self, j: int) -> torch.Tensor:
        i = j % self.size
        with self._cond:
            while self._issued[i] < j - self.size and not self._aborted:
                self._cond.wait()
            if self._aborted:
                raise RuntimeError("chunk ring aborted")
            event = self._events[i]
        if event is not None:
            event.synchronize()
        return self.buffers[i]

    def issued(self, j: int, event: Optional[torch.cuda.Event]) -> None:
        i = j % self.size
        with self._cond:
            self._events[i] = event
            self._issued[i] = j
            self._cond.notify_all()

    def abort(self) -> None:
        with self._cond:
            self._aborted = True
            self._cond.notify_all()


def run_chunk_pipeline(items: Iterable[Any],
                       prepare: Callable[[Any], Any],
                       upload: Callable[[Any], Any],
                       *, workers: int = 2, depth: int = 2,
                       deadline_s: Optional[float] = None,
                       label: str = "ingest",
                       stats: Optional[IngestStats] = None,
                       retry: Optional[Any] = None,
                       on_error: Optional[Callable[[], None]] = None
                       ) -> IngestStats:
    """Drive `items` through prepare (worker threads) → upload (main
    thread, bounded depth). Returns the filled `IngestStats`.

    `prepare(item)` runs on the pool and should call
    `stats.note_read`/`stats.note_cast` around its IO/cast phases.
    `upload(prepared)` runs on the caller thread in ITEM ORDER and returns
    a completion token (anything with `synchronize()`, a CUDA event), or
    None to skip depth accounting for that item.

    Worker errors propagate on the failing item's turn (futures re-raise
    in submission order); nothing hangs: `on_error()` runs first (the CUDA
    builders abort their pinned ring there, waking blocked workers), then
    queued reads are cancelled. `deadline_s` is checked against real
    elapsed time before each upload; the depth bound makes elapsed time
    track transfer progress to within `depth` chunks. The deadline is not
    re-checked after the final drain: a finished buffer is returned.
    `retry` is refused (not ported)."""
    if retry is not None:
        raise NotImplementedError(RETRY_REFUSED)
    st = stats if stats is not None else IngestStats(label=label)
    st.workers = workers
    st.depth = depth
    t_start = time.perf_counter()
    it = iter(items)
    pending: deque = deque()      # prepare futures, submission order
    in_flight: deque = deque()    # upload completion tokens
    lookahead = max(1, workers) + max(1, depth)

    def elapsed() -> float:
        return time.perf_counter() - t_start

    pool = ThreadPoolExecutor(max_workers=max(1, workers))
    try:
        def fill() -> None:
            while len(pending) < lookahead:
                try:
                    item = next(it)
                except StopIteration:
                    return
                pending.append(pool.submit(prepare, item))

        fill()
        i = 0
        while pending:
            prepared = pending.popleft().result()  # re-raises worker errors
            fill()
            if deadline_s is not None and elapsed() > deadline_s:
                raise TimeoutError(
                    f"{label} past {deadline_s:.0f}s deadline at chunk "
                    f"{i} ({elapsed():.1f}s elapsed)")
            t0 = time.perf_counter()
            token = upload(prepared)
            st.dispatch_s += time.perf_counter() - t0
            i += 1
            if token is not None:
                in_flight.append(token)
                while len(in_flight) > max(1, depth):
                    t0 = time.perf_counter()
                    in_flight.popleft().synchronize()
                    st.upload_wait_s += time.perf_counter() - t0
                st.max_in_flight = max(st.max_in_flight, len(in_flight))
        while in_flight:
            t0 = time.perf_counter()
            in_flight.popleft().synchronize()
            st.upload_wait_s += time.perf_counter() - t0
    except BaseException:
        if on_error is not None:
            on_error()
        pool.shutdown(wait=False, cancel_futures=True)
        raise
    finally:
        pool.shutdown(wait=True)
        st.wall_s = elapsed()
    return st
