"""Vectorized event-time aggregation: the scale half of the aggregating
readers.

The port's own copy of the JAX package's `readers/columnar_agg.py` (host
numpy): one `np.lexsort` over (key, time) and per-feature masked
`ufunc.reduceat` group reductions compute the same rows as the per-record
fold in `readers.py` (`_aggregate_groups`), which stays the semantic
oracle and the fallback for monoids with no vectorized form (mode,
concat, lists/sets/maps/geo) and for extract-function features.

Vectorized monoids (by `MonoidAggregator.name` prefix): Sum*, Mean*,
Min*, Max*, MaxDate, LogicalOr, LogicalAnd.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.aggregators import CutOffTime, Event, aggregate_events

_VEC_OPS: Dict[str, Tuple[np.ufunc, float]] = {
    # ufunc, identity fill for masked-out events
    "Sum": (np.add, 0.0),
    "Mean": (np.add, 0.0),           # sum/count presented later
    "Min": (np.minimum, np.inf),
    "Max": (np.maximum, -np.inf),
    "LogicalOr": (np.maximum, 0.0),  # bools as 0/1
    "LogicalAnd": (np.minimum, 1.0),
}


def vector_op_of(agg_name: str) -> Optional[Tuple[str, np.ufunc, float]]:
    for prefix, (ufunc, fill) in _VEC_OPS.items():
        if agg_name.startswith(prefix):
            return prefix, ufunc, fill
    return None


class GroupedEvents:
    """Events sorted by (key, time) + group boundaries — built once per
    read, shared by every feature's reduction."""

    def __init__(self, keys: np.ndarray, times: np.ndarray):
        keys = np.asarray(keys).astype(str)
        times = np.asarray(times, dtype=np.int64)
        self.order = np.lexsort((times, keys))
        keys_s = keys[self.order]
        self.times = times[self.order]
        new_group = np.empty(len(keys_s), dtype=bool)
        if len(keys_s):
            new_group[0] = True
            new_group[1:] = keys_s[1:] != keys_s[:-1]
        self.starts = np.flatnonzero(new_group)
        self.group_keys = keys_s[self.starts]

    @property
    def n_groups(self) -> int:
        return len(self.starts)

    def group_slices(self):
        ends = np.r_[self.starts[1:], len(self.times)]
        return zip(self.group_keys, self.starts, ends)


def _masked_reduceat(values: np.ndarray, mask: np.ndarray,
                     starts: np.ndarray, ufunc: np.ufunc, fill: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group ufunc reduction of `values` where `mask`; returns
    (reduced, valid_count). Masked-out slots carry the identity fill."""
    filled = np.where(mask, values, fill)
    out = ufunc.reduceat(filled, starts) if len(values) else \
        np.empty(0, values.dtype)
    counts = np.add.reduceat(mask.astype(np.int64), starts) if len(values) \
        else np.empty(0, np.int64)
    return out, counts


def _event_mask(times: np.ndarray, cut_ts: np.ndarray, is_response: bool,
                window_ms: Optional[int]) -> np.ndarray:
    """The reference's cutoff/window filter, vectorized
    (`FeatureAggregator.scala` filterByDateWithCutoff semantics, matching
    `aggregators.aggregate_events`): predictors strictly before the
    cutoff (window back), responses at/after it (window forward,
    inclusive). Conventions in `cut_ts`: NaN = no cutoff (keep all for
    both roles), +inf = infinite-future cutoff (all predictor, no
    response); an infinite cutoff disables the predictor window."""
    nocut = np.isnan(cut_ts)
    if is_response:
        m = times >= cut_ts
        if window_ms is not None:
            m &= times <= cut_ts + window_ms
        return m | nocut
    with np.errstate(invalid="ignore"):
        m = times < cut_ts
        if window_ms is not None:
            finite = np.isfinite(cut_ts)
            m &= ~finite | (times >= cut_ts - window_ms)
    return m | nocut


def aggregate_columnar(dataset, key_column: str, time_column: str,
                       raw_features: Sequence,
                       cutoff_ts_per_group: Callable[[np.ndarray],
                                                     np.ndarray],
                       response_window_ms: Optional[int] = None,
                       predictor_window_ms: Optional[int] = None):
    """Columnar group-aggregate: returns ({feature_name: list}, group
    keys). `cutoff_ts_per_group(group_index_of_event) -> (n_groups,)
    float64 cutoff timestamps` (inf = no cutoff).

    Features whose aggregator has a vectorized form reduce via reduceat;
    the rest fold through the Python oracle per group slice."""
    from transmogrifai_tpu_torch.aggregators import default_aggregator

    g = GroupedEvents(np.asarray(dataset.column(key_column)),
                      np.asarray(dataset.column(time_column)))
    n_groups = g.n_groups
    ends = np.r_[g.starts[1:], len(g.times)]
    group_of = np.repeat(np.arange(n_groups), ends - g.starts)
    cut_ts = np.asarray(cutoff_ts_per_group(g), dtype=np.float64)
    cut_per_event = cut_ts[group_of]

    out: Dict[str, List[Any]] = {}
    slow_cols: Dict[str, np.ndarray] = {}
    rows_cache: List = []  # materialized once, shared by extract features
    for f in raw_features:
        stage = f.origin_stage
        agg = stage.params.get("aggregator") or default_aggregator(f.ftype)
        window = stage.params.get("aggregate_window")
        if window is None:
            window = (response_window_ms if f.is_response
                      else predictor_window_ms)
        vec = vector_op_of(agg.name) if stage.extract is None else None
        integral = issubclass(f.ftype, (T.Integral, T.Date, T.DateTime)) \
            and not issubclass(f.ftype, T.Binary)
        nn_zero = issubclass(f.ftype, T.NonNullable) and \
            issubclass(f.ftype, T.OPNumeric)

        if vec is not None and stage.column in dataset.columns:
            raw = dataset.column(stage.column)
            if raw.dtype == object:
                vals = np.array([np.nan if v is None else float(v)
                                 for v in raw], np.float64)
            else:
                vals = raw.astype(np.float64)
            vals = vals[g.order]
            mask = _event_mask(g.times, cut_per_event, f.is_response,
                               window) & ~np.isnan(vals)
            prefix, ufunc, fill = vec
            red, counts = _masked_reduceat(vals, mask, g.starts, ufunc,
                                           fill)
            if prefix == "Mean":
                with np.errstate(invalid="ignore"):
                    red = red / counts
            col: List[Any] = []
            for i in range(n_groups):
                if counts[i] == 0:
                    col.append(0.0 if nn_zero else None)
                elif prefix in ("LogicalOr", "LogicalAnd"):
                    col.append(bool(red[i]))
                elif integral:
                    col.append(int(red[i]))
                else:
                    col.append(float(red[i]))
            out[f.name] = col
        else:
            # oracle fallback per group slice (mode/concat/list/map/geo
            # monoids, extract-fn features)
            if f.name not in slow_cols:
                if stage.extract is not None:
                    if not rows_cache:
                        rows_cache.append(dataset.to_rows())
                    slow_cols[f.name] = np.array(
                        [stage.extract(r) for r in rows_cache[0]],
                        dtype=object)
                else:
                    raw = np.asarray(dataset.column(stage.column))
                    slow_cols[f.name] = raw
            vals_o = slow_cols[f.name][g.order]
            col = []
            for gi, (key, s, e) in enumerate(g.group_slices()):
                events = [Event(int(t), None if _is_missing(v) else v)
                          for t, v in zip(g.times[s:e], vals_o[s:e])]
                ts = cut_ts[gi]
                if np.isnan(ts):
                    cut = CutOffTime.no_cutoff()
                elif np.isinf(ts):
                    cut = CutOffTime.infinite_future()
                else:
                    cut = CutOffTime.unix_epoch(int(ts))
                col.append(aggregate_events(
                    events, f.ftype,
                    aggregator=stage.params.get("aggregator"),
                    cutoff=cut, is_response=f.is_response,
                    window_ms=stage.params.get("aggregate_window"),
                    response_window_ms=response_window_ms,
                    predictor_window_ms=predictor_window_ms))
            out[f.name] = col
    return out, g.group_keys


def _is_missing(v) -> bool:
    if v is None:
        return True
    return isinstance(v, float) and np.isnan(v)
