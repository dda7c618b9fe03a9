"""Readers: record ingestion, key-grouped event aggregation, joins, streaming.

The port's own copy of the JAX package's `readers/readers.py` (host
Python): a reader's product is a host-side columnar `Dataset`; the device
sees only the dense batches built from it later. Aggregating readers fold
each key's events through the monoid aggregators (`aggregators.py`), so
the row width stays constant whatever the history length, and emit
*pre-extracted* datasets: columns are final typed feature values keyed by
feature name, which `FeatureGeneratorStage.materialize` reads as they are.

`CSVReader` reads through the port's python CSV path and `AvroReader`
through its Avro container codec (`data/avro.py`). `ParquetReader` (and
the parquet branch of `StreamingReader`) is refused by name: it needs
pyarrow, which the GPU machine does not have.
"""

from __future__ import annotations

import csv as _csv
import logging
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.aggregators import (
    CutOffTime, Event, MonoidAggregator, aggregate_events, default_aggregator)
from transmogrifai_tpu_torch.data.dataset import Dataset

KEY_COLUMN = "key"  # reference: DataFrameFieldNames.KeyFieldName

log = logging.getLogger(__name__)


def _record_value(stage, record: Mapping[str, Any]) -> Any:
    """Extract one raw value from a record via the feature's generator stage
    (extract fn or named column) — DataReader.scala:174-213."""
    if stage.extract is not None:
        return stage.extract(record)
    return record.get(stage.column)


def _mark_pre_extracted(ds: Dataset, names) -> Dataset:
    # per-column marking read by FeatureGeneratorStage.materialize — a
    # dataset-global flag would wrongly bypass extract/null_fill for columns
    # contributed by a non-aggregating side of a join
    ds.pre_extracted = set(names)
    return ds


def _own_features(reader, raw_features: Sequence) -> List:
    """Restrict to the raw features this reader produces (its `features`
    allowlist when given — the analogue of each reader in a join owning its
    own feature set, JoinedDataReader.scala:119-180)."""
    allow = getattr(reader, "features", None)
    if allow is None:
        return list(raw_features)
    names = {f.name if hasattr(f, "name") else str(f) for f in allow}
    return [f for f in raw_features if f.name in names]


def _derivable_features(reader, raw_features: Sequence,
                        probe_limit: int = 100) -> List:
    """Features actually derivable from this reader's records, probed over
    the first `probe_limit` records (event streams have heterogeneous
    records, so one record is not enough): column-based features need their
    column present in SOME record; extract-fn features must yield a
    non-None value on some record. Used when an aggregating reader joins
    another reader without declaring a features= allowlist — it must not
    aggregate (and then shadow) raw features owned by the other side.

    Caveat: an extract fn with a non-None fallback (e.g.
    `lambda r: r.get("age", 0.0)`) probes as derivable on ANY record and
    will be claimed by the wrong side — declare a features= allowlist on
    joined aggregating readers whenever extract fns have defaults."""
    records = list(getattr(reader, "records", None) or [])
    # column-based features: exact check over ALL records (cheap key scan —
    # rare record types can first appear arbitrarily late in a stream)
    all_keys: set = set()
    for r in records:
        all_keys.update(r.keys())
    probes = records[:probe_limit]
    out = []
    for f in raw_features:
        stage = f.origin_stage
        if stage.extract is None:
            if stage.column in all_keys:
                out.append(f)
            continue
        for probe in probes:
            try:
                if stage.extract(probe) is not None:
                    out.append(f)
                    break
            except Exception:
                # an extract-fn crash on a probe record means "not
                # derivable from this record" — try the next probe
                log.debug("probe record rejected by extract fn for %r",
                          f.name, exc_info=True)
                continue
        else:
            log.warning(
                "JoinedDataReader: feature %r (extract fn) probed "
                "non-derivable on the first %d records of an aggregating "
                "side with no features= allowlist — it will come from the "
                "other side / null-fill; declare features= to silence",
                f.name, len(probes))
    return out


class Reader:
    """Base reader: `read(raw_features) -> Dataset`."""

    def read(self, raw_features: Optional[Sequence] = None) -> Dataset:
        raise NotImplementedError

    # -- composition (Reader.scala `innerJoin/leftOuterJoin/outerJoin`) --- #

    def inner_join(self, other: "Reader") -> "JoinedDataReader":
        return JoinedDataReader(self, other, how="inner")

    def left_outer_join(self, other: "Reader") -> "JoinedDataReader":
        return JoinedDataReader(self, other, how="left")

    def outer_join(self, other: "Reader") -> "JoinedDataReader":
        return JoinedDataReader(self, other, how="outer")


class SimpleReader(Reader):
    """Non-aggregating reader over records or a prebuilt Dataset
    (DataReaders.Simple — one row per record, raw features extracted
    lazily by the workflow's generator stages)."""

    def __init__(self, records: Optional[Sequence[Mapping[str, Any]]] = None,
                 dataset: Optional[Dataset] = None,
                 key_fn: Optional[Callable[[Mapping[str, Any]], str]] = None,
                 schema: Optional[Mapping[str, type]] = None):
        if (records is None) == (dataset is None):
            raise ValueError("SimpleReader: pass exactly one of records/dataset")
        self.records = records
        self.dataset = dataset
        self.key_fn = key_fn
        self.schema = schema

    def read(self, raw_features: Optional[Sequence] = None) -> Dataset:
        if self.dataset is not None:
            ds = self.dataset
        else:
            ds = Dataset.from_rows(list(self.records), schema=self.schema)
        if self.key_fn is not None and KEY_COLUMN not in ds.columns:
            rows = self.records if self.records is not None else ds.to_rows()
            keys = np.array([str(self.key_fn(r)) for r in rows], dtype=object)
            ds = ds.with_column(KEY_COLUMN, keys, T.ID)
        return ds


def _with_key_column(ds: Dataset, key_column: Optional[str]) -> Dataset:
    """Stringify a key column into the reserved KEY_COLUMN; integral-typed
    keys format without the float-storage ".0" suffix."""
    if not key_column or key_column not in ds.columns \
            or KEY_COLUMN in ds.columns:
        return ds
    ftype = ds.schema.get(key_column)
    integral = ftype is not None and issubclass(
        ftype, (T.Integral, T.Date, T.DateTime))

    def fmt(v) -> str:
        if integral and isinstance(v, float) and not np.isnan(v) \
                and v == int(v):
            return str(int(v))
        return str(v)
    keys = np.array([fmt(v) for v in ds.column(key_column)], dtype=object)
    return ds.with_column(KEY_COLUMN, keys, T.ID)


class CSVReader(SimpleReader):
    """CSV-file reader (CSVAutoReaders/CSVReaders analogue): schema inferred
    unless given."""

    def __init__(self, path: str, schema: Optional[Mapping[str, type]] = None,
                 key_column: Optional[str] = None, delimiter: str = ","):
        self.path = path
        self._schema = schema
        self.key_column = key_column
        self.delimiter = delimiter
        self.key_fn = None
        self.dataset = None
        self.records = None

    def read(self, raw_features: Optional[Sequence] = None) -> Dataset:
        ds = Dataset.from_csv(self.path, schema=self._schema,
                              delimiter=self.delimiter)
        return _with_key_column(ds, self.key_column)


PARQUET_REFUSAL = ("Parquet is not read by the port: it needs pyarrow, "
                   "which the GPU machine does not have; read CSV "
                   "(CSVReader), Avro (AvroReader) or records instead")


class AvroReader(Reader):
    """Avro container-file reader (AvroReaders.scala analogue), decoded by
    the port's container codec (`data/avro.py`)."""

    def __init__(self, path: str, schema: Optional[Mapping[str, type]] = None,
                 key_column: Optional[str] = None):
        self.path = path
        self._schema = schema
        self.key_column = key_column
        self.features = None

    def read(self, raw_features: Optional[Sequence] = None) -> Dataset:
        ds = Dataset.from_avro(self.path, schema=self._schema)
        return _with_key_column(ds, self.key_column)


class ParquetReader(Reader):
    """Columnar Parquet reader (ParquetProductReader.scala analogue).
    `read` raises: the port has no pyarrow."""

    def __init__(self, path: str, schema: Optional[Mapping[str, type]] = None,
                 key_column: Optional[str] = None):
        self.path = path
        self._schema = schema
        self.key_column = key_column
        self.features = None

    def read(self, raw_features: Optional[Sequence] = None) -> Dataset:
        raise NotImplementedError(PARQUET_REFUSAL)


def _group_events(records: Iterable[Mapping[str, Any]],
                  key_fn: Callable, time_fn: Callable
                  ) -> Dict[str, List[Any]]:
    groups: Dict[str, List[Any]] = {}
    for rec in records:
        groups.setdefault(str(key_fn(rec)), []).append(
            (int(time_fn(rec)), rec))
    return groups


def _aggregate_groups(groups: Dict[str, List[Any]], raw_features: Sequence,
                      cutoffs: Mapping[str, Optional[CutOffTime]],
                      response_window_ms: Optional[int] = None,
                      predictor_window_ms: Optional[int] = None) -> Dataset:
    """Fold each key's event list through every raw feature's aggregator
    (DataReader.scala:229-330: groupBy key → monoid fold per feature).
    Reader-level windows apply when a feature has no aggregate window of
    its own (FeatureAggregator.scala specialTimeWindow.orElse)."""
    rows: List[Dict[str, Any]] = []
    schema: Dict[str, type] = {KEY_COLUMN: T.ID}
    for f in raw_features:
        schema[f.name] = f.ftype
    for key in groups:
        events_rec = groups[key]
        row: Dict[str, Any] = {KEY_COLUMN: key}
        for f in raw_features:
            stage = f.origin_stage
            agg: Optional[MonoidAggregator] = stage.params.get("aggregator")
            window = stage.params.get("aggregate_window")
            events = [Event(t, _record_value(stage, rec))
                      for t, rec in events_rec]
            row[f.name] = aggregate_events(
                events, f.ftype, aggregator=agg, cutoff=cutoffs.get(key),
                is_response=f.is_response, window_ms=window,
                response_window_ms=response_window_ms,
                predictor_window_ms=predictor_window_ms)
        rows.append(row)
    return _mark_pre_extracted(Dataset.from_rows(rows, schema=schema),
                               [f.name for f in raw_features])


def _columnar_result(cols: Dict[str, List[Any]], keys: np.ndarray,
                     raw_features: Sequence,
                     keep: Optional[np.ndarray] = None) -> Dataset:
    schema: Dict[str, type] = {KEY_COLUMN: T.ID}
    rows: List[Dict[str, Any]] = []
    for f in raw_features:
        schema[f.name] = f.ftype
    idxs = range(len(keys)) if keep is None else np.flatnonzero(keep)
    for i in idxs:
        row: Dict[str, Any] = {KEY_COLUMN: str(keys[i])}
        for f in raw_features:
            row[f.name] = cols[f.name][i]
        rows.append(row)
    return _mark_pre_extracted(Dataset.from_rows(rows, schema=schema),
                               [f.name for f in raw_features])


class AggregateDataReader(Reader):
    """Event-time aggregating reader (DataReaders.Aggregate,
    DataReader.scala:216-300): group records by key, fold each feature's
    events through its monoid with a global `CutOffTime` — predictors see
    pre-cutoff events, responses post-cutoff.

    Two cores: the per-record Python fold (`records` = row mappings with
    `key_fn`/`time_fn` — the semantic oracle), and a VECTORIZED groupby
    (`records` = a columnar `Dataset` with `key_column`/`time_column` —
    one lexsort + per-feature reduceat, `readers/columnar_agg.py`) that
    aggregates ~1M events in under a second (scale parity with
    DataReader.scala's cluster groupBy)."""

    def __init__(self, records,
                 key_fn: Optional[Callable[[Mapping[str, Any]], str]] = None,
                 time_fn: Optional[Callable[[Mapping[str, Any]], int]] = None,
                 cutoff: Optional[CutOffTime] = None,
                 features: Optional[Sequence] = None,
                 key_column: Optional[str] = None,
                 time_column: Optional[str] = None):
        self.records = records
        self.key_fn = key_fn
        self.time_fn = time_fn
        self.cutoff = cutoff or CutOffTime.no_cutoff()
        self.features = features  # allowlist when joined with other readers
        self.key_column = key_column
        self.time_column = time_column
        if self._columnar() and (key_column is None or time_column is None):
            raise ValueError("columnar Dataset records need key_column "
                             "and time_column")
        if not self._columnar() and (key_fn is None or time_fn is None):
            raise ValueError("row records need key_fn and time_fn")

    def _columnar(self) -> bool:
        return isinstance(self.records, Dataset)

    def read(self, raw_features: Optional[Sequence] = None) -> Dataset:
        raw_features = _own_features(self, raw_features or [])
        if not raw_features:
            raise ValueError(
                "AggregateDataReader needs the workflow's raw features to "
                "aggregate (call through Workflow, or pass raw_features)")
        if self._columnar():
            from transmogrifai_tpu_torch.readers.columnar_agg import (
                aggregate_columnar)
            ts = self.cutoff.timestamp
            v = np.nan if ts is None else float(ts)
            cols, keys = aggregate_columnar(
                self.records, self.key_column, self.time_column,
                raw_features,
                lambda g: np.full(g.n_groups, v, np.float64))
            return _columnar_result(cols, keys, raw_features)
        groups = _group_events(self.records, self.key_fn, self.time_fn)
        cutoffs = {k: self.cutoff for k in groups}
        return _aggregate_groups(groups, raw_features, cutoffs)

    def surviving_keys(self) -> List[str]:
        """Keys this reader would emit (all of them — no row-dropping)."""
        if self._columnar():
            return sorted({str(k)
                           for k in self.records.column(self.key_column)})
        return sorted({str(self.key_fn(r)) for r in self.records})


_WEEK_MS = 7 * 24 * 3600 * 1000  # reference default response/predictor window


class ConditionalDataReader(Reader):
    """Per-key dynamic cutoff (DataReaders.Conditional,
    DataReader.scala:303-367): each key's cutoff is chosen among the times
    of its records satisfying `target_condition` — "simulate the state at
    the moment event X happened". Reference-parity defaults
    (ConditionalParams, DataReader.scala:369-375): unmatched keys are KEPT
    (`drop_if_not_met=False`), `time_stamp_to_keep="random"` (seeded here,
    unlike the reference's unseeded Random), and 7-day response/predictor
    windows. Unmatched kept keys aggregate every event as predictor via an
    infinite-future cutoff (deterministic, where the reference anchors at
    wall-clock now())."""

    def __init__(self, records,
                 key_fn: Optional[Callable[[Mapping[str, Any]], str]] = None,
                 time_fn: Optional[Callable[[Mapping[str, Any]], int]] = None,
                 target_condition: Optional[
                     Callable[[Mapping[str, Any]], bool]] = None,
                 drop_if_not_met: bool = False,
                 time_stamp_to_keep: str = "random",
                 response_window_ms: Optional[int] = _WEEK_MS,
                 predictor_window_ms: Optional[int] = _WEEK_MS,
                 seed: int = 42,
                 features: Optional[Sequence] = None,
                 key_column: Optional[str] = None,
                 time_column: Optional[str] = None,
                 condition_column: Optional[str] = None):
        if time_stamp_to_keep not in ("min", "max", "random"):
            raise ValueError(
                f"time_stamp_to_keep must be min/max/random, "
                f"got {time_stamp_to_keep!r}")
        self.records = records
        self.key_fn = key_fn
        self.time_fn = time_fn
        self.target_condition = target_condition
        self.drop_if_not_met = drop_if_not_met
        self.time_stamp_to_keep = time_stamp_to_keep
        self.response_window_ms = response_window_ms
        self.predictor_window_ms = predictor_window_ms
        self.seed = seed
        self.features = features
        self.key_column = key_column
        self.time_column = time_column
        self.condition_column = condition_column
        if self._columnar():
            if key_column is None or time_column is None \
                    or condition_column is None:
                raise ValueError(
                    "columnar Dataset records need key_column, time_column "
                    "and condition_column")
        elif key_fn is None or time_fn is None or target_condition is None:
            raise ValueError(
                "row records need key_fn, time_fn and target_condition")

    def _columnar(self) -> bool:
        return isinstance(self.records, Dataset)

    def _columnar_cutoffs(self, g) -> np.ndarray:
        """Per-group cutoff timestamps (float64; +inf = unmatched key kept
        as all-predictor): same sorted-key iteration and seeded draws as
        the row path, so 'random' picks identical timestamps."""
        cond = np.asarray(
            self.records.column(self.condition_column)).astype(bool)
        cond_s = cond[g.order]
        rng = np.random.default_rng(self.seed)
        ends = np.r_[g.starts[1:], len(g.times)]
        out = np.full(g.n_groups, np.inf, np.float64)
        for i, (s, e) in enumerate(zip(g.starts, ends)):
            match = g.times[s:e][cond_s[s:e]]  # ascending within group
            if len(match):
                if self.time_stamp_to_keep == "min":
                    out[i] = match[0]
                elif self.time_stamp_to_keep == "max":
                    out[i] = match[-1]
                else:
                    out[i] = match[int(rng.integers(len(match)))]
        return out

    def _read_columnar(self, raw_features) -> Dataset:
        from transmogrifai_tpu_torch.readers.columnar_agg import aggregate_columnar
        holder: Dict[str, np.ndarray] = {}

        def cutoffs(g):
            holder["cut"] = self._columnar_cutoffs(g)
            return holder["cut"]

        cols, keys = aggregate_columnar(
            self.records, self.key_column, self.time_column, raw_features,
            cutoffs, response_window_ms=self.response_window_ms,
            predictor_window_ms=self.predictor_window_ms)
        keep = None
        if self.drop_if_not_met:
            keep = np.isfinite(holder["cut"])
        return _columnar_result(cols, keys, raw_features, keep)

    def read(self, raw_features: Optional[Sequence] = None) -> Dataset:
        raw_features = _own_features(self, raw_features or [])
        if not raw_features:
            raise ValueError("ConditionalDataReader needs raw features")
        if self._columnar():
            return self._read_columnar(raw_features)
        groups = _group_events(self.records, self.key_fn, self.time_fn)
        rng = np.random.default_rng(self.seed)
        cutoffs: Dict[str, Optional[CutOffTime]] = {}
        # sorted iteration: the per-key random draw must not depend on
        # record order
        for key in sorted(groups):
            match = [t for t, rec in groups[key] if self.target_condition(rec)]
            if match:
                if self.time_stamp_to_keep == "min":
                    ts = min(match)
                elif self.time_stamp_to_keep == "max":
                    ts = max(match)
                else:  # draw from sorted times: independent of record order
                    ts = sorted(match)[int(rng.integers(len(match)))]
                cutoffs[key] = CutOffTime.unix_epoch(ts)
            elif self.drop_if_not_met:
                del groups[key]
            else:
                # unmatched keys: all events are predictors, responses stay
                # empty (an infinite-future cutoff — nothing is ever at/after)
                cutoffs[key] = CutOffTime.infinite_future()
        return _aggregate_groups(
            groups, raw_features, cutoffs,
            response_window_ms=self.response_window_ms,
            predictor_window_ms=self.predictor_window_ms)

    def surviving_keys(self) -> List[str]:
        """Keys this reader would emit — honors target_condition +
        drop_if_not_met (keys a read() would drop must not reappear when a
        join uses this side for keys only)."""
        if self._columnar():
            keys = np.asarray(self.records.column(self.key_column)) \
                .astype(str)
            if not self.drop_if_not_met:
                return sorted(set(keys))
            cond = np.asarray(
                self.records.column(self.condition_column)).astype(bool)
            return sorted(set(keys[cond]))
        groups = _group_events(self.records, self.key_fn, self.time_fn)
        out = []
        for key, evs in groups.items():
            if (not self.drop_if_not_met
                    or any(self.target_condition(rec) for _, rec in evs)):
                out.append(key)
        return sorted(out)


class JoinedDataReader(Reader):
    """Key-based join of two readers (JoinedDataReader.scala:119-356):
    both sides are read (each producing a keyed Dataset), then joined on
    `key`. `with_secondary_aggregation` folds duplicate right-side rows per
    key through type-default monoids (the post-join aggregation stage)."""

    def __init__(self, left: Reader, right: Reader, how: str = "left"):
        if how not in ("inner", "left", "outer"):
            raise ValueError(f"Unsupported join type {how!r}")
        self.left = left
        self.right = right
        self.how = how
        self._secondary = False

    def with_secondary_aggregation(self) -> "JoinedDataReader":
        """Fold duplicate right-side rows per key through type-default
        monoids. (Time-windowed post-join filtering belongs in the child
        reader's own CutOffTime — joined rows no longer carry event times.)"""
        self._secondary = True
        return self

    def read(self, raw_features: Optional[Sequence] = None) -> Dataset:
        raw_features = list(raw_features or [])
        aggregating = (AggregateDataReader, ConditionalDataReader)
        if (isinstance(self.left, aggregating) and self.left.features is None
                and isinstance(self.right, aggregating)
                and self.right.features is None):
            raise ValueError(
                "Joining two aggregating readers requires each to declare "
                "its own features= allowlist, otherwise both sides "
                "aggregate every raw feature and shadow each other")
        def read_side(side) -> Dataset:
            # an aggregating reader without an allowlist must not aggregate
            # raw features it cannot derive (extract fns over the wrong
            # records yield None/garbage, and the pre_extracted marking
            # would then shadow the other side's real columns) — restrict
            # it to features probed derivable from its own records; with
            # none derivable it contributes join keys only
            if isinstance(side, aggregating) and side.features is None:
                feats = _derivable_features(side, raw_features)
                if not feats:
                    # surviving_keys honors the reader's own row-dropping
                    # semantics (conditional target_condition etc.)
                    return Dataset(
                        {KEY_COLUMN: np.array(side.surviving_keys(),
                                              dtype=object)},
                        {KEY_COLUMN: T.ID})
                return side.read(feats)
            return side.read(raw_features)

        left_ds = read_side(self.left)
        right_ds = read_side(self.right)
        for side, ds in (("left", left_ds), ("right", right_ds)):
            if KEY_COLUMN not in ds.columns:
                raise ValueError(
                    f"JoinedDataReader: {side} reader produced no "
                    f"{KEY_COLUMN!r} column (give it a key_fn)")

        lrows = left_ds.to_rows()
        rrows = right_ds.to_rows()
        rindex: Dict[str, List[Dict[str, Any]]] = {}
        for r in rrows:
            rindex.setdefault(str(r[KEY_COLUMN]), []).append(r)

        schema: Dict[str, type] = dict(left_ds.schema)
        for name, t in right_ds.schema.items():
            schema.setdefault(name, t)
        rcols = [c for c in right_ds.schema if c != KEY_COLUMN
                 and c not in left_ds.schema]

        ftypes = {f.name: f.ftype for f in raw_features}

        def merge(l_row: Optional[Dict], r_group: List[Dict]) -> Dict[str, Any]:
            if l_row is not None:
                row = dict(l_row)
                copy_cols = rcols  # left values win on shared names
            else:  # right-only row: every right column carries over
                row = {KEY_COLUMN: r_group[0][KEY_COLUMN]}
                copy_cols = [c for c in right_ds.schema if c != KEY_COLUMN]
            if not r_group:
                for c in copy_cols:
                    row.setdefault(c, None)
            elif len(r_group) == 1 or not self._secondary:
                for c in copy_cols:
                    row[c] = r_group[0].get(c)
            else:  # secondary aggregation of duplicate child rows
                for c in copy_cols:
                    ftype = ftypes.get(c) or right_ds.schema.get(c, T.Text)
                    events = [Event(0, g.get(c)) for g in r_group]
                    row[c] = default_aggregator(ftype)(events)
            return row

        out: List[Dict[str, Any]] = []
        seen_keys = set()
        for l_row in lrows:
            k = str(l_row[KEY_COLUMN])
            seen_keys.add(k)
            group = rindex.get(k, [])
            if group and not self._secondary and len(group) > 1:
                # no secondary aggregation: one output row per child match
                for g in group:
                    out.append(merge(l_row, [g]))
            elif group:
                out.append(merge(l_row, group))
            elif self.how in ("left", "outer"):
                out.append(merge(l_row, []))
        if self.how == "outer":
            for k, group in rindex.items():
                if k in seen_keys:
                    continue
                if not self._secondary and len(group) > 1:
                    for g in group:  # same per-child expansion as left matches
                        out.append(merge(None, [g]))
                else:
                    out.append(merge(None, group))
        ds = Dataset.from_rows(out, schema=schema)
        pre = set(getattr(left_ds, "pre_extracted", ()) or ()) | \
            set(getattr(right_ds, "pre_extracted", ()) or ())
        if pre:
            _mark_pre_extracted(ds, pre & set(ds.columns))
        return ds


class StreamingReader(Reader):
    """Micro-batch streaming source (StreamingReader.scala:54): yields
    Datasets of up to `batch_size` records for the runner's streaming-score
    loop. `read()` materializes everything (the batch path)."""

    def __init__(self, records: Optional[Iterable[Mapping[str, Any]]] = None,
                 csv_path: Optional[str] = None,
                 parquet_path: Optional[str] = None, batch_size: int = 1024,
                 schema: Optional[Mapping[str, type]] = None,
                 avro_path: Optional[str] = None):
        sources = sum(x is not None
                      for x in (records, csv_path, parquet_path, avro_path))
        if sources != 1:
            raise ValueError("StreamingReader: pass exactly one of "
                             "records/csv_path/parquet_path/avro_path")
        self.records = records
        self.csv_path = csv_path
        self.parquet_path = parquet_path
        self.avro_path = avro_path
        self.batch_size = int(batch_size)
        self.schema = schema

    def _record_iter(self) -> Iterator[Mapping[str, Any]]:
        if self.records is not None:
            yield from self.records
            return
        if self.avro_path is not None:
            from transmogrifai_tpu_torch.data.avro import (
                container_ftypes, read_container)
            avsc, recs = read_container(self.avro_path)
            if self.schema is None and isinstance(avsc, dict) \
                    and avsc.get("type") == "record":
                self.schema = container_ftypes(avsc)
            yield from recs
            return
        # parse CSV cells with the same typed inference as Dataset.from_csv
        # so the streaming path matches DataReaders.csv on the same file
        from transmogrifai_tpu_torch.data.dataset import (
            _infer_ftype, _parse_cell)
        with open(self.csv_path, "r", newline="") as f:
            reader = _csv.DictReader(f)
            rows = list(reader)
        if self.schema is None:
            fields = rows[0].keys() if rows else ()
            self.schema = {
                name: _infer_ftype([r.get(name) or None for r in rows])
                for name in fields}
        for r in rows:
            yield {k: _parse_cell(v, self.schema.get(k, T.Text))
                   for k, v in r.items()}

    def stream(self) -> Iterator[Dataset]:
        if self.parquet_path is not None:
            raise NotImplementedError(PARQUET_REFUSAL)
        buf: List[Mapping[str, Any]] = []
        for rec in self._record_iter():
            buf.append(rec)
            if len(buf) >= self.batch_size:
                yield Dataset.from_rows(buf, schema=self.schema)
                buf = []
        if buf:
            yield Dataset.from_rows(buf, schema=self.schema)

    def read(self, raw_features: Optional[Sequence] = None) -> Dataset:
        if self.parquet_path is not None:
            raise NotImplementedError(PARQUET_REFUSAL)
        return Dataset.from_rows(list(self._record_iter()), schema=self.schema)


class DataReaders:
    """Factory namespace mirroring `DataReaders.Simple/Aggregate/Conditional`
    (DataReaders.scala:44-290)."""

    @staticmethod
    def simple(records=None, dataset=None, key_fn=None, schema=None) -> SimpleReader:
        return SimpleReader(records=records, dataset=dataset, key_fn=key_fn,
                            schema=schema)

    @staticmethod
    def csv(path, schema=None, key_column=None, delimiter=",") -> CSVReader:
        return CSVReader(path, schema=schema, key_column=key_column,
                         delimiter=delimiter)

    @staticmethod
    def parquet(path, schema=None, key_column=None) -> "ParquetReader":
        return ParquetReader(path, schema=schema, key_column=key_column)

    @staticmethod
    def avro(path, schema=None, key_column=None) -> "AvroReader":
        return AvroReader(path, schema=schema, key_column=key_column)

    @staticmethod
    def aggregate(records, key_fn=None, time_fn=None, cutoff=None,
                  features=None, key_column=None,
                  time_column=None) -> AggregateDataReader:
        """Row records + key_fn/time_fn = the Python monoid fold;
        a columnar `Dataset` + key_column/time_column = the vectorized
        groupby core (readers/columnar_agg.py)."""
        return AggregateDataReader(records, key_fn, time_fn, cutoff=cutoff,
                                   features=features, key_column=key_column,
                                   time_column=time_column)

    @staticmethod
    def conditional(records, key_fn=None, time_fn=None, target_condition=None,
                    drop_if_not_met=False, time_stamp_to_keep="random",
                    response_window_ms=_WEEK_MS, predictor_window_ms=_WEEK_MS,
                    seed=42, features=None, key_column=None,
                    time_column=None,
                    condition_column=None) -> ConditionalDataReader:
        return ConditionalDataReader(records, key_fn, time_fn,
                                     target_condition,
                                     drop_if_not_met=drop_if_not_met,
                                     time_stamp_to_keep=time_stamp_to_keep,
                                     response_window_ms=response_window_ms,
                                     predictor_window_ms=predictor_window_ms,
                                     seed=seed, features=features,
                                     key_column=key_column,
                                     time_column=time_column,
                                     condition_column=condition_column)

    @staticmethod
    def stream(records=None, csv_path=None, parquet_path=None,
               batch_size=1024, schema=None, avro_path=None) -> StreamingReader:
        return StreamingReader(records=records, csv_path=csv_path,
                               parquet_path=parquet_path,
                               batch_size=batch_size, schema=schema,
                               avro_path=avro_path)
