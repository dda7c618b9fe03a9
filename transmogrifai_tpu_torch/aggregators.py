"""Monoid aggregators for event-time feature aggregation.

The port's own copy of the JAX package's `aggregators.py` (host Python,
no device code): `Event`, `CutOffTime`, `MonoidAggregator`, the `*_agg`
factories, `default_aggregator` (the reference's per-type defaults table,
`MonoidAggregatorDefaults.scala:52-120`) and `aggregate_events`. The
readers fold each key's events through these before any data reaches the
device.

Missing values follow the JAX package: `SumReal`'s monoid zero is None,
so a key whose qualifying event set is empty folds to missing, while
`SumRealNN` (zero 0.0) folds to 0.0.

An aggregator is (prepare, combine, present):
    prepare(Event) -> state        # lift one event into the monoid
    combine(state, state) -> state # associative merge; None is identity
    present(state|None) -> value   # final typed value (None = empty)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from transmogrifai_tpu_torch import types as T


# --------------------------------------------------------------------- #
# events & cutoffs                                                      #
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class Event:
    """A timestamped raw value (aggregators/Event.scala): `time` is epoch
    milliseconds, matching the reference's Long date fields."""

    time: int
    value: Any

    @staticmethod
    def of(value: Any, time: int) -> "Event":
        return Event(int(time), value)


MS_PER_DAY = 24 * 60 * 60 * 1000


class CutOffTime:
    """Cutoff separating predictor events (strictly before) from response
    events (at/after) — `aggregators/CutOffTime.scala`, kinds in
    `CutOffTimeTypes.scala` (UnixEpoch / DaysAgo / WeeksAgo / DDMMYYYY /
    NoCutoff)."""

    def __init__(self, kind: str, timestamp: Optional[int]):
        self.kind = kind
        self.timestamp = timestamp  # epoch ms; None = no cutoff

    @staticmethod
    def no_cutoff() -> "CutOffTime":
        return CutOffTime("NoCutoff", None)

    @staticmethod
    def infinite_future() -> "CutOffTime":
        """Every event is a predictor event; responses stay empty (used for
        unmatched conditional-reader keys)."""
        return CutOffTime("InfiniteFuture", math.inf)

    @staticmethod
    def unix_epoch(ms: int) -> "CutOffTime":
        return CutOffTime("UnixEpoch", int(ms))

    @staticmethod
    def days_ago(days: int, now_ms: int) -> "CutOffTime":
        return CutOffTime("DaysAgo", int(now_ms) - days * MS_PER_DAY)

    @staticmethod
    def weeks_ago(weeks: int, now_ms: int) -> "CutOffTime":
        return CutOffTime("WeeksAgo", int(now_ms) - weeks * 7 * MS_PER_DAY)

    @staticmethod
    def ddmmyyyy(date: str) -> "CutOffTime":
        """'ddMMyyyy' string, as the reference's DDMMYYYY cutoff."""
        import datetime
        d = datetime.datetime.strptime(date, "%d%m%Y")
        d = d.replace(tzinfo=datetime.timezone.utc)
        return CutOffTime("DDMMYYYY", int(d.timestamp() * 1000))

    def __repr__(self) -> str:
        return f"CutOffTime({self.kind}, {self.timestamp})"


# --------------------------------------------------------------------- #
# aggregator core                                                       #
# --------------------------------------------------------------------- #

class MonoidAggregator:
    """(prepare, combine, present) triple over Events. `name` keeps the
    reference's case-object vocabulary for serialization/debug."""

    def __init__(self, name: str,
                 prepare: Callable[[Event], Any],
                 combine: Callable[[Any, Any], Any],
                 present: Callable[[Optional[Any]], Any],
                 zero: Any = None):
        self.name = name
        self._prepare = prepare
        self._combine = combine
        self._present = present
        # monoid zero: the fold's START state, so an EMPTY fold presents
        # the zero instead of missing — the reference distinguishes e.g.
        # SumReal (zero=None → empty folds to null) from SumRealNN
        # (zero=Some(0.0) → empty folds to 0.0), Numerics.scala:18-21
        self._zero = zero

    def __call__(self, events: Sequence[Event]) -> Any:
        """Fold events → final value (None-states are identity)."""
        acc = self._zero
        for e in events:
            s = self._prepare(e)
            if s is None:
                continue
            acc = s if acc is None else self._combine(acc, s)
        return self._present(acc)

    def __repr__(self) -> str:
        return f"MonoidAggregator({self.name})"


def _value_prepare(e: Event) -> Any:
    return e.value if e.value is not None else None


# -- numeric ----------------------------------------------------------- #

def sum_agg(name: str = "Sum", integral: bool = False,
            zero: Any = None) -> MonoidAggregator:
    """SumReal/SumIntegral/SumCurrency (zero=None → empty folds missing);
    SumRealNN passes zero=0.0 (aggregators/Numerics.scala:18-21)."""
    def present(s):
        if s is None:
            return None
        return int(s) if integral else float(s)
    return MonoidAggregator(name, _value_prepare, lambda a, b: a + b, present,
                            zero=zero)


def mean_agg(name: str = "Mean", zero: Any = None) -> MonoidAggregator:
    """MeanReal/MeanPercent/MeanCurrency: intermediate (sum, count).
    MeanRealNN passes zero=(0.0, 0), presenting 0.0 on an empty fold
    (Numerics.scala MeanDouble present: count==0 → 0.0)."""
    return MonoidAggregator(
        name,
        lambda e: None if e.value is None else (float(e.value), 1),
        lambda a, b: (a[0] + b[0], a[1] + b[1]),
        lambda s: None if s is None else (s[0] / s[1] if s[1] else 0.0),
        zero=zero)


def min_agg(name: str = "Min", integral: bool = False,
            zero: Any = None) -> MonoidAggregator:
    """MinReal/... (MinRealNN passes zero=+inf, Numerics.scala:41)."""
    def present(s):
        if s is None:
            return None
        return int(s) if integral else float(s)
    return MonoidAggregator(name, _value_prepare, min, present, zero=zero)


def max_agg(name: str = "Max", integral: bool = False,
            zero: Any = None) -> MonoidAggregator:
    """MaxReal/... (MaxRealNN passes zero=-inf, Numerics.scala:34)."""
    def present(s):
        if s is None:
            return None
        return int(s) if integral else float(s)
    return MonoidAggregator(name, _value_prepare, max, present, zero=zero)


def logical_or_agg() -> MonoidAggregator:
    """LogicalOr — the Binary default."""
    return MonoidAggregator(
        "LogicalOr", _value_prepare, lambda a, b: bool(a or b),
        lambda s: None if s is None else bool(s))


def logical_and_agg() -> MonoidAggregator:
    return MonoidAggregator(
        "LogicalAnd", _value_prepare, lambda a, b: bool(a and b),
        lambda s: None if s is None else bool(s))


def logical_xor_agg() -> MonoidAggregator:
    return MonoidAggregator(
        "LogicalXor", _value_prepare, lambda a, b: bool(a) ^ bool(b),
        lambda s: None if s is None else bool(s))


# -- text -------------------------------------------------------------- #

def concat_agg(separator: str = " ", name: str = "ConcatText") -> MonoidAggregator:
    """ConcatText* (aggregators/Text.scala): join non-empty texts."""
    return MonoidAggregator(
        name,
        lambda e: None if e.value in (None, "") else str(e.value),
        lambda a, b: a + separator + b,
        lambda s: s)


def mode_agg(name: str = "ModePickList") -> MonoidAggregator:
    """ModePickList (aggregators/Text.scala, ExtendedMultiset): most frequent
    value; ties broken by lexicographic min, matching the multiset fold."""
    def present(s: Optional[Dict[str, int]]):
        if not s:
            return None
        best = max(s.items(), key=lambda kv: (kv[1], ), default=None)
        top = best[1]
        return min(k for k, v in s.items() if v == top)
    return MonoidAggregator(
        name,
        lambda e: None if e.value is None else {str(e.value): 1},
        lambda a, b: {k: a.get(k, 0) + b.get(k, 0) for k in {*a, *b}},
        present)


# -- collections ------------------------------------------------------- #

def concat_list_agg(name: str = "ConcatList") -> MonoidAggregator:
    """ConcatTextList/ConcatDateList/ConcatDateTimeList (Lists.scala)."""
    return MonoidAggregator(
        name,
        lambda e: None if e.value is None else list(e.value),
        lambda a, b: a + b,
        lambda s: s)


def union_set_agg(name: str = "UnionMultiPickList") -> MonoidAggregator:
    """UnionMultiPickList (Sets.scala)."""
    return MonoidAggregator(
        name,
        lambda e: None if e.value is None else set(e.value),
        lambda a, b: a | b,
        lambda s: s)


def combine_vector_agg(name: str = "CombineVector") -> MonoidAggregator:
    """CombineVector (OPVector.scala): concatenate vectors."""
    return MonoidAggregator(
        name,
        lambda e: None if e.value is None else list(e.value),
        lambda a, b: a + b,
        lambda s: s)


def sum_vector_agg(name: str = "SumVector") -> MonoidAggregator:
    """SumVector (OPVector.scala): elementwise sum."""
    return MonoidAggregator(
        name,
        lambda e: None if e.value is None else list(e.value),
        lambda a, b: [x + y for x, y in zip(a, b)],
        lambda s: s)


def geolocation_midpoint_agg(name: str = "GeolocationMidpoint") -> MonoidAggregator:
    """GeolocationMidpoint (aggregators/Geolocation.scala): average the
    lat/lon points in 3-D Cartesian space, convert back, keep max accuracy
    (the reference's documented midpoint algorithm)."""
    def prepare(e: Event):
        v = e.value
        if v is None or len(v) < 2:
            return None
        lat, lon = math.radians(v[0]), math.radians(v[1])
        acc = v[2] if len(v) > 2 else 0.0
        return (math.cos(lat) * math.cos(lon), math.cos(lat) * math.sin(lon),
                math.sin(lat), acc, 1)

    def combine(a, b):
        # cartesian components + count sum; accuracy keeps the max
        return (a[0] + b[0], a[1] + b[1], a[2] + b[2],
                max(a[3], b[3]), a[4] + b[4])

    def present(s):
        if s is None:
            return None
        x, y, z, acc, n = s
        x, y, z = x / n, y / n, z / n
        lon = math.atan2(y, x)
        lat = math.atan2(z, math.sqrt(x * x + y * y))
        return [math.degrees(lat), math.degrees(lon), acc]

    return MonoidAggregator(name, prepare, combine, present)


# -- maps -------------------------------------------------------------- #

def union_map_agg(inner: MonoidAggregator, name: str = "UnionMap") -> MonoidAggregator:
    """Union*Map (aggregators/Maps.scala): per-key combine with an inner
    aggregator (UnionRealMap = union_map(sum), UnionConcatTextMap =
    union_map(concat), UnionMeanPercentMap = union_map(mean), …).

    State: {key: inner_state}."""
    def prepare(e: Event):
        if e.value is None:
            return None
        out = {}
        for k, v in dict(e.value).items():
            s = inner._prepare(Event(e.time, v))
            if s is not None:
                out[k] = s
        return out or None

    def combine(a, b):
        out = dict(a)
        for k, s in b.items():
            out[k] = inner._combine(out[k], s) if k in out else s
        return out

    def present(s):
        if s is None:
            return None
        return {k: inner._present(v) for k, v in s.items()}

    return MonoidAggregator(name, prepare, combine, present)


# -- time-based -------------------------------------------------------- #

def first_agg(name: str = "First") -> MonoidAggregator:
    """First* (TimeBasedAggregator.scala): value of the earliest event."""
    return MonoidAggregator(
        name,
        lambda e: None if e.value is None else (e.time, e.value),
        lambda a, b: a if a[0] <= b[0] else b,
        lambda s: None if s is None else s[1])


def last_agg(name: str = "Last") -> MonoidAggregator:
    """Last*: value of the latest event."""
    return MonoidAggregator(
        name,
        lambda e: None if e.value is None else (e.time, e.value),
        lambda a, b: a if a[0] > b[0] else b,
        lambda s: None if s is None else s[1])


def custom_agg(fn: Callable[[Any, Any], Any], name: str = "Custom",
               prepare: Optional[Callable[[Any], Any]] = None) -> MonoidAggregator:
    """CustomMonoidAggregator.scala: user-supplied associative combine."""
    return MonoidAggregator(
        name,
        (lambda e: None if e.value is None else prepare(e.value)) if prepare
        else _value_prepare,
        fn, lambda s: s)


# --------------------------------------------------------------------- #
# defaults dispatch (MonoidAggregatorDefaults.aggregatorOf)             #
# --------------------------------------------------------------------- #

def default_aggregator(ftype: type) -> MonoidAggregator:
    """Per-type default, reproducing the dispatch table at
    `MonoidAggregatorDefaults.scala:52-120`: vectors combine; lists concat;
    geolocation midpoint; maps union with a type-appropriate inner combine;
    Binary OR; Currency/Integral/Real/RealNN sum; Percent mean;
    Date/DateTime max; sets union; PickList mode; other texts concat."""
    t = ftype
    # maps first (they subclass OPMap); inner combine mirrors the scalar rule
    if issubclass(t, T.GeolocationMap):
        return union_map_agg(geolocation_midpoint_agg(), "UnionGeolocationMidpointMap")
    if issubclass(t, T.BinaryMap):
        return union_map_agg(logical_or_agg(), "UnionBinaryMap")
    if issubclass(t, T.PercentMap):
        return union_map_agg(mean_agg(), "UnionMeanPercentMap")
    if issubclass(t, (T.DateMap, T.DateTimeMap)):
        return union_map_agg(max_agg(integral=True), "UnionMaxDateMap")
    if issubclass(t, T.IntegralMap):
        return union_map_agg(sum_agg(integral=True), "UnionIntegralMap")
    if issubclass(t, T.Prediction):
        return union_map_agg(mean_agg(), "UnionMeanPrediction")
    if issubclass(t, (T.CurrencyMap, T.RealMap)):
        return union_map_agg(sum_agg(), "UnionRealMap")
    if issubclass(t, T.MultiPickListMap):
        return union_map_agg(union_set_agg(), "UnionMultiPickListMap")
    if issubclass(t, (T.NameStats,)) or issubclass(t, T.OPMap):
        return union_map_agg(concat_agg(), "UnionConcatTextMap")
    # collections
    if issubclass(t, T.OPVector):
        return combine_vector_agg()
    if issubclass(t, T.Geolocation):
        return geolocation_midpoint_agg()
    if issubclass(t, (T.TextList, T.DateList, T.DateTimeList)):
        return concat_list_agg()
    if issubclass(t, T.MultiPickList):
        return union_set_agg()
    # numerics
    if issubclass(t, T.Binary):
        return logical_or_agg()
    if issubclass(t, T.Percent):
        return mean_agg("MeanPercent")
    if issubclass(t, (T.Date, T.DateTime)):
        return max_agg("MaxDate", integral=True)
    if issubclass(t, (T.Integral,)):
        return sum_agg("SumIntegral", integral=True)
    if issubclass(t, T.RealNN):
        # RealNN is non-nullable: its sum carries a real monoid zero, so
        # an empty fold is 0.0, not missing (SumRealNN, Numerics.scala:21)
        return sum_agg("SumRealNN", zero=0.0)
    if issubclass(t, (T.Currency, T.Real)):
        return sum_agg("SumReal")
    # text
    if issubclass(t, T.PickList):
        return mode_agg()
    if issubclass(t, T.Text):
        return concat_agg()
    raise T.FeatureTypeError(f"No default aggregator for {ftype.__name__}")


def aggregate_events(events: List[Event], ftype: type,
                     aggregator: Optional[MonoidAggregator] = None,
                     cutoff: Optional[CutOffTime] = None,
                     is_response: bool = False,
                     window_ms: Optional[int] = None,
                     response_window_ms: Optional[int] = None,
                     predictor_window_ms: Optional[int] = None) -> Any:
    """FeatureAggregator.extract (aggregators/FeatureAggregator.scala):
    split events around the cutoff — predictors fold events strictly
    *before* it (optionally only within the window back from it),
    responses fold events *at/after* it (optionally only the window
    forward) — then apply the monoid.

    `window_ms` is the feature's own aggregate window and wins over the
    reader-level `response_window_ms`/`predictor_window_ms`
    (`specialTimeWindow.orElse(timeWindow)`, FeatureAggregator.scala)."""
    agg = aggregator or default_aggregator(ftype)
    if window_ms is None:
        window_ms = response_window_ms if is_response else predictor_window_ms
    ts = None if cutoff is None else cutoff.timestamp
    if ts is None:
        kept = events
    elif is_response:
        # inclusive upper bound: the reference keeps events exactly at
        # cutoff + window (FeatureAggregator.scala filterByDateWithCutoff)
        hi = None if window_ms is None else ts + window_ms
        kept = [e for e in events if e.time >= ts and (hi is None or e.time <= hi)]
    else:
        # an infinite-future cutoff means "everything is a predictor" — a
        # window anchored at infinity must not filter anything out
        lo = None if (window_ms is None or math.isinf(ts)) else ts - window_ms
        kept = [e for e in events if e.time < ts and (lo is None or e.time >= lo)]
    out = agg(kept)
    if out is None and issubclass(ftype, T.NonNullable):
        # non-nullable types present the monoid zero, not an empty value
        # (SumRealNN's zero is 0.0 — aggregators/Numerics.scala)
        return 0.0 if issubclass(ftype, T.OPNumeric) else ftype.empty_value
    return out
