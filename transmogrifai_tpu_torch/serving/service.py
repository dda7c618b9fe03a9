"""ScoringService: online scoring over a loaded model (minimal).

The port's counterpart of the core of the JAX package's
`serving/service.py`. Callers submit rows (`score`) or columns
(`score_columns`); one scoring thread coalesces queued requests into one
batch, pads it to a bucket of the ladder and scores it with the model's
`CompiledScorer.score_padded` (one CUDA graph per bucket on a CUDA
device), then hands each request its rows as numpy arrays. Every bucket
is scored once at `start()`, so each bucket's graph is captured and the
first request of each size meets warm kernels and resident tables.
`ServingConfig.quantize` serves on the quantized wire.

Usage::

    svc = ScoringService.from_path("model_dir").start()
    result = svc.score([{"age": 31.0, "sex": "male", ...}])
    svc.stop()
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import to_host
from transmogrifai_tpu_torch.data.dataset import Dataset
from transmogrifai_tpu_torch.device import DeviceLike
from transmogrifai_tpu_torch.serving.batcher import (
    MicroBatcher, Request, ScoreError, bucket_for, bucket_ladder,
    pad_requests)
from transmogrifai_tpu_torch.workflow.compiled import slice_result_tree

log = logging.getLogger(__name__)

DEFAULT_DEADLINE_MS = 2000.0   # a request's deadline when it names none


@dataclass
class ServingConfig:
    max_batch: int = 64            # top bucket = largest device batch
    max_queue: int = 256           # bounded admission queue
    batch_wait_ms: float = 2.0     # linger to coalesce concurrent requests
    # quantized inference ("int8", "int4" or their "-calibrated" variants,
    # workflow.compiled.ScoringQuant): the request's numeric columns ride
    # an affine uint8 wire (stated per-feature tolerance scale/2 =
    # (hi − lo)/(2·(2^bits − 1))) and the fitted tables compute in
    # narrowed dtypes; calibrated modes quantize against the model's
    # fit-time ranges, so a row scores alike in any batch. None = f32
    quantize: Optional[str] = None

    def ladder(self) -> Tuple[int, ...]:
        return bucket_ladder(self.max_batch)


def raw_schema(model) -> Dict[str, type]:
    """Raw input column name -> feature type, from the model's graph."""
    schema: Dict[str, type] = {}
    for rf in model.result_features:
        for f in rf.raw_features():
            schema[f.name] = f.ftype
    return schema


def _synthetic_rows(schema: Dict[str, type], n: int,
                    response_names: Sequence[str] = ()
                    ) -> List[Dict[str, Any]]:
    """Type-appropriate warmup rows: numerics 0, text-kinds None."""
    row: Dict[str, Any] = {}
    for name, ftype in schema.items():
        if name in response_names:
            continue
        if issubclass(ftype, T.Binary):
            row[name] = False
        elif issubclass(ftype, T.OPNumeric):
            row[name] = 0.0
        else:
            row[name] = None
    return [dict(row) for _ in range(n)]


@dataclass
class ScoreResult:
    """Per-request outcome: result feature name -> numpy arrays for this
    request's rows."""

    outputs: Dict[str, Any]
    n_rows: int = 0
    latency_s: float = 0.0


def _host_tree(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _host_tree(v) for k, v in value.items()}
    return to_host(value)


class ScoringService:
    def __init__(self, model, config: Optional[ServingConfig] = None):
        self.model = model
        self.config = config or ServingConfig()
        self.ladder = self.config.ladder()
        self.scorer = model._ensure_compiled(quant=self.config.quantize)
        self._schema = raw_schema(model)
        self._batcher = MicroBatcher(
            self.config.max_queue, self.ladder[-1],
            batch_wait_s=self.config.batch_wait_ms / 1000.0)
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._started_mono = time.monotonic()
        self._lock = threading.Lock()
        self._batches = 0   # guarded-by: _lock
        self._rows = 0      # guarded-by: _lock
        self._errors = 0    # guarded-by: _lock

    @classmethod
    def from_path(cls, model_location: str,
                  config: Optional[ServingConfig] = None,
                  device: DeviceLike = "cuda") -> "ScoringService":
        """Serve a saved model directory on `device` (default CUDA;
        raises without it unless ``device="cpu"``)."""
        from transmogrifai_tpu_torch.workflow.serialization import load_model
        return cls(load_model(model_location, device=device), config=config)

    # -- lifecycle --------------------------------------------------------- #

    def warm(self) -> None:
        """Score one synthetic batch at every bucket of the ladder."""
        responses = [f.name for rf in self.model.result_features
                     for f in rf.raw_features() if f.is_response]
        rows = _synthetic_rows(self._schema, 1, responses)
        base = Dataset.from_rows(
            rows, schema={k: v for k, v in self._schema.items()
                          if k in rows[0]})
        for bucket in self.ladder:
            self.scorer.score_padded(base, bucket)

    def start(self) -> "ScoringService":
        if self._running:
            return self
        self.warm()
        if self._batcher.closed:  # restart after stop(): fresh admissions
            self._batcher = MicroBatcher(
                self.config.max_queue, self.ladder[-1],
                batch_wait_s=self.config.batch_wait_ms / 1000.0)
        self._running = True
        self._thread = threading.Thread(
            target=self._serve_loop, name="scoring-batcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._running = False
        for req in self._batcher.close():
            req.fail(ScoreError("shutdown", "service stopped"))
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"scoring thread did not stop within {timeout}s")
            self._thread = None

    def health(self) -> Dict[str, Any]:
        with self._lock:
            counts = {"batches": self._batches, "rows": self._rows,
                      "errors": self._errors}
        q = self.scorer.quant
        return {
            "status": "ok" if self._running else "down",
            "device": str(self.model.device),
            "quantize": None if q is None else (
                q.mode + ("-calibrated" if q.calibrated else "")),
            "cuda_graphs": self.scorer.graphs,
            "uptime_s": round(time.monotonic() - self._started_mono, 3),
            "queue_depth": self._batcher.depth(),
            "buckets": list(self.ladder),
            **counts,
        }

    # -- request side ------------------------------------------------------ #

    def score(self, rows: List[Dict[str, Any]],
              deadline_ms: Optional[float] = None) -> ScoreResult:
        """Score `rows` (raw-column dicts). Blocks until the scoring
        thread answers or the deadline passes; raises ScoreError."""
        self._admit()
        if not rows:
            raise ScoreError("bad_request", "empty rows")
        for r in rows:
            if not isinstance(r, dict):
                raise ScoreError(
                    "bad_request",
                    f"rows must be objects, got {type(r).__name__}")
        bucket_for(len(rows), self.ladder)
        ms = self._deadline_ms(deadline_ms)
        return self._enqueue(Request(None, self._deadline(ms), rows=rows,
                                     schema=self._schema), ms)

    def score_columns(self, columns: Dict[str, List[Any]],
                      deadline_ms: Optional[float] = None) -> ScoreResult:
        """Score ``{name: [values...]}`` with no row pivot; the answers
        equal the row wire's for the same data."""
        self._admit()
        if not isinstance(columns, dict) or not columns:
            raise ScoreError("bad_request",
                             'expected {name: [values...]} columns')
        unknown = set(columns) - set(self._schema)
        if unknown:
            raise ScoreError(
                "bad_request",
                f"unknown columns {sorted(unknown)}; this model's raw "
                f"schema is {sorted(self._schema)}")
        lengths = {len(v) for v in columns.values()}
        if len(lengths) != 1:
            raise ScoreError("bad_request",
                             f"ragged column lengths {sorted(lengths)}")
        try:
            ds = Dataset.from_columns(columns, self._schema)
        except (TypeError, ValueError) as e:
            raise ScoreError("bad_request", f"uncastable cells: {e}")
        if len(ds) == 0:
            raise ScoreError("bad_request", "empty columns")
        bucket_for(len(ds), self.ladder)
        ms = self._deadline_ms(deadline_ms)
        return self._enqueue(Request(ds, self._deadline(ms)), ms)

    def _admit(self) -> None:
        if not self._running:
            raise ScoreError("shutdown", "service is not running")

    def _deadline_ms(self, deadline_ms: Optional[float]) -> float:
        """The request's deadline in ms (<= 0: none)."""
        if deadline_ms is None:
            return DEFAULT_DEADLINE_MS
        try:
            return float(deadline_ms)
        except (TypeError, ValueError):
            raise ScoreError(
                "bad_request",
                f"deadline_ms must be a number, got {deadline_ms!r}")

    @staticmethod
    def _deadline(ms: float) -> Optional[float]:
        return time.monotonic() + ms / 1000.0 if ms > 0 else None

    def _enqueue(self, req: Request, ms: float) -> ScoreResult:
        self._batcher.put(req)
        outputs = req.wait(ms / 1000.0 + 30.0 if ms > 0 else None)
        return ScoreResult(outputs=outputs, n_rows=req.n_rows,
                           latency_s=time.monotonic() - req.enqueued_at)

    # -- scoring thread ---------------------------------------------------- #

    def _serve_loop(self) -> None:
        while self._running:
            batch, expired = self._batcher.next_batch()
            for req in expired:
                req.fail(ScoreError("deadline_exceeded",
                                    "request expired in the queue"))
            if batch:
                self._score_batch(batch)

    def _score_batch(self, batch: List[Request]) -> None:
        try:
            ds, n_valid, bucket = pad_requests(batch, self.ladder)
            out = _host_tree(self.scorer.score_padded(ds, bucket))
        except Exception as e:  # the loop must keep serving
            if len(batch) > 1:
                # one bad request must fail alone: re-score each by itself
                for req in batch:
                    self._score_batch([req])
                return
            log.exception("serving: request of %d rows failed",
                          batch[0].n_rows)
            with self._lock:
                self._errors += 1
            batch[0].fail(ScoreError("internal",
                                     f"{type(e).__name__}: {e}"))
            return
        with self._lock:
            self._batches += 1
            self._rows += n_valid
        off = 0
        for req in batch:
            req.resolve({name: slice_result_tree(v, off, off + req.n_rows)
                         for name, v in out.items()})
            off += req.n_rows
