"""Dates: unit-circle encodings, calendar units and date-list pivots.

The port's counterpart of the JAX package's `ops/dates.py`. The calendar
math runs on the host over int64 epoch milliseconds (f32 cannot hold
them) and yields phase fractions in [0, 1); the device takes
sin(2π·phase) and cos(2π·phase) times the presence mask, so a missing
date lands on the origin (0, 0), which no date on the circle can hit.

`sin` and `cos` are not the same functions in XLA, in torch on the CPU
and in CUDA: the unit-circle columns agree with the JAX package's within
an ulp or so (the tests state 1e-6), and every other column is
bit-equal.

`DateListVectorizer`'s SinceFirst / SinceLast without `reference_ms`
measure from the latest event of the batch being transformed, as the
JAX package does, so a served row's value depends on the other rows of
its batch (F21 in ROADMAP.md); pass `reference_ms` to serve it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.data.metadata import (
    NULL_INDICATOR, VectorColumnMetadata, VectorMetadata)
from transmogrifai_tpu_torch.stages.base import Transformer

DEFAULT_PERIODS = ("HourOfDay", "DayOfWeek", "DayOfMonth", "DayOfYear")

_MS_PER_DAY = 86_400_000
_MS_PER_HOUR = 3_600_000
_TWO_PI = 2.0 * math.pi


def _phase_fraction(ms: np.ndarray, period: str) -> np.ndarray:
    """Fraction in [0, 1) of the given calendar period (host, int64-exact)."""
    if period == "HourOfDay":
        return (ms % _MS_PER_DAY) / _MS_PER_DAY
    if period == "DayOfWeek":
        day = ms // _MS_PER_DAY
        # 1970-01-01 was a Thursday; ISO Monday=0 → offset 3
        return ((day + 3) % 7) / 7.0
    days = (ms // _MS_PER_DAY).astype("datetime64[D]")
    if period == "DayOfMonth":
        month_start = days.astype("datetime64[M]")
        return (days - month_start).astype(np.int64) / 31.0
    if period == "DayOfYear":
        year_start = days.astype("datetime64[Y]")
        return (days - year_start).astype(np.int64) / 366.0
    if period == "MonthOfYear":
        months = days.astype("datetime64[M]").astype(np.int64)
        return (months % 12) / 12.0
    if period == "WeekOfYear":
        year_start = days.astype("datetime64[Y]")
        return ((days - year_start).astype(np.int64) // 7) / 53.0
    raise ValueError(f"Unknown time period {period!r}")


def date_phases(ms: np.ndarray, periods: Sequence[str]) -> np.ndarray:
    """(n, len(periods)) f32 phase fractions of int64 epoch ms."""
    return np.stack([np.asarray(_phase_fraction(ms, p), dtype=np.float32)
                     for p in periods], axis=1)


def unit_circle(phases: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(n, 2p): [sin, cos] of 2π·phase per period, interleaved, times the
    presence mask (f32 throughout, as the JAX package computes it)."""
    theta = _TWO_PI * phases
    m = mask[:, None]
    sc = torch.stack([torch.sin(theta) * m, torch.cos(theta) * m], dim=2)
    return sc.reshape(phases.shape[0], 2 * phases.shape[1])


class DateToUnitCircleVectorizer(Transformer):
    """N Date features → [sin, cos] per period per feature (stateless)."""

    in_types = (T.Date, Ellipsis)
    out_type = T.OPVector

    def __init__(self, periods: Sequence[str] = DEFAULT_PERIODS,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, periods=list(periods))
        self.periods = tuple(periods)

    def host_prepare(self, cols: Sequence[Optional[Column]]):
        return [{"phases": date_phases(
                    np.asarray(c.data["value"], dtype=np.int64),
                    self.periods),
                 "mask": np.asarray(c.data["mask"], dtype=np.float32)}
                for c in cols]

    def device_apply(self, enc, dev):
        return torch.cat([unit_circle(e["phases"], e["mask"]) for e in enc],
                         dim=1)

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for f in self.input_features:
            for p in self.periods:
                for fn in ("sin", "cos"):
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        descriptor_value=f"{p}_{fn}"))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()


# -- calendar units and date-list pivots ------------------------------------ #

TIME_PERIODS = ("DayOfMonth", "DayOfWeek", "DayOfYear", "HourOfDay",
                "MonthOfYear", "WeekOfMonth", "WeekOfYear")


def time_period_value(ms: np.ndarray, period: str) -> np.ndarray:
    """Integral calendar unit (TimePeriod.scala): 1-based days and months,
    0-based hours and weeks."""
    day = ms // _MS_PER_DAY
    days = day.astype("datetime64[D]")
    if period == "HourOfDay":
        return (ms % _MS_PER_DAY) // _MS_PER_HOUR
    if period == "DayOfWeek":
        return (day + 3) % 7 + 1  # Monday=1..Sunday=7 (ISO)
    if period == "DayOfMonth":
        return (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    if period == "DayOfYear":
        return (days - days.astype("datetime64[Y]")).astype(np.int64) + 1
    if period == "MonthOfYear":
        return days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    if period == "WeekOfMonth":
        dom = (days - days.astype("datetime64[M]")).astype(np.int64)
        return dom // 7
    if period == "WeekOfYear":
        doy = (days - days.astype("datetime64[Y]")).astype(np.int64)
        return doy // 7
    raise ValueError(f"Unknown time period {period!r}")


class TimePeriodTransformer(Transformer):
    """Date → Integral calendar unit (TimePeriodTransformer.scala). All of
    its work is host calendar math over the Date column, so it runs in
    the scorer's host segments (`jittable = False`)."""

    in_types = (T.Date,)
    out_type = T.Integral
    jittable = False

    def __init__(self, period: str = "DayOfWeek", uid: Optional[str] = None):
        if period not in TIME_PERIODS:
            raise ValueError(f"period must be one of {TIME_PERIODS}")
        super().__init__(uid=uid, period=period)
        self.period = period

    def host_prepare(self, cols):
        ms = np.asarray(cols[0].data["value"], dtype=np.int64)
        mask = np.asarray(cols[0].data["mask"]).astype(bool)
        vals = time_period_value(ms, self.period).astype(np.float64)
        return {"value": np.where(mask, vals, 0.0), "mask": mask}

    def device_apply(self, enc, dev):
        return enc


class TimePeriodListTransformer(Transformer):
    """DateList → each date's calendar unit as a string (a host TextList
    output)."""

    in_types = (T.DateList,)
    out_type = T.TextList
    jittable = False

    def __init__(self, period: str = "DayOfWeek", uid: Optional[str] = None):
        super().__init__(uid=uid, period=period)
        self.period = period

    def transform(self, cols, device=None) -> Column:
        out = np.empty(len(cols[0].data), dtype=object)
        for i, lst in enumerate(cols[0].data):
            if not lst:
                out[i] = []
            else:
                ms = np.asarray(list(lst), dtype=np.int64)
                out[i] = [str(int(v))
                          for v in time_period_value(ms, self.period)]
        return Column(T.TextList, out)


DATE_LIST_PIVOTS = ("SinceFirst", "SinceLast", "ModeDay", "ModeMonth",
                    "ModeHour")


class DateListVectorizer(Transformer):
    """N DateList features → OPVector (DateListVectorizer.scala):

    - SinceFirst / SinceLast: days from the first / last event to the
      reference instant (`reference_ms`, else the batch's latest event),
      then a null indicator;
    - ModeDay / ModeMonth / ModeHour: one-hot of the modal day of week,
      month or hour of the list, then a null indicator.
    """

    in_types = (T.DateList, Ellipsis)
    out_type = T.OPVector
    jittable = False  # the list input needs host extraction

    def __init__(self, pivot: str = "SinceLast",
                 reference_ms: Optional[int] = None,
                 track_nulls: bool = True, uid: Optional[str] = None):
        if pivot not in DATE_LIST_PIVOTS:
            raise ValueError(f"pivot must be one of {DATE_LIST_PIVOTS}")
        super().__init__(uid=uid, pivot=pivot, reference_ms=reference_ms,
                         track_nulls=track_nulls)
        self.pivot = pivot
        self.reference_ms = reference_ms
        self.track_nulls = track_nulls

    def _pivot_width(self) -> Optional[int]:
        return {"ModeDay": 7, "ModeMonth": 12, "ModeHour": 24}.get(
            self.pivot)

    def host_prepare(self, cols):
        out = []
        period = {"ModeDay": "DayOfWeek", "ModeMonth": "MonthOfYear",
                  "ModeHour": "HourOfDay"}.get(self.pivot)
        for c in cols:
            n = len(c.data)
            mask = np.zeros(n, dtype=np.float32)
            if period is None:  # SinceFirst / SinceLast
                val = np.zeros(n, dtype=np.float32)
                ref = self.reference_ms
                if ref is None:  # the batch's latest event (F21)
                    ref = max((max(lst) for lst in c.data if lst),
                              default=0)
                for i, lst in enumerate(c.data):
                    if lst:
                        pick = (min(lst) if self.pivot == "SinceFirst"
                                else max(lst))
                        val[i] = (ref - pick) / _MS_PER_DAY
                        mask[i] = 1.0
                out.append({"value": val, "mask": mask})
            else:
                w = self._pivot_width()
                oh = np.zeros((n, w), dtype=np.float32)
                base = 0 if period == "HourOfDay" else 1
                for i, lst in enumerate(c.data):
                    if lst:
                        units = time_period_value(
                            np.asarray(list(lst), dtype=np.int64),
                            period) - base
                        counts = np.bincount(units.astype(np.int64),
                                             minlength=w)[:w]
                        oh[i, int(np.argmax(counts))] = 1.0
                        mask[i] = 1.0
                out.append({"onehot": oh, "mask": mask})
        return out

    def device_apply(self, enc, dev):
        parts = []
        for e in enc:
            parts.append(e["onehot"] if "onehot" in e
                         else e["value"][:, None])
            if self.track_nulls:
                parts.append(1.0 - e["mask"][:, None])
        return torch.cat(parts, dim=1)

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        w = self._pivot_width()
        for f in self.input_features:
            if w is None:
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    descriptor_value=self.pivot))
            else:
                for j in range(w):
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        indicator_value=f"{self.pivot}_{j}"))
            if self.track_nulls:
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()
