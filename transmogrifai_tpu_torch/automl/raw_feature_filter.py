"""RawFeatureFilter: the train/score comparison of raw feature
distributions before modeling.

The port's copy of the JAX package's `automl/raw_feature_filter.py`,
host numpy over the columnar Dataset (the filter runs before anything is
vectorized for the device). Two passes: a `Summary` and a binned
`FeatureDistribution` per raw feature (one per key of a map), then the
drop rules: training or scoring fill rate below `min_fill`, fill-rate
difference above `max_fill_difference`, fill ratio above
`max_fill_ratio_diff`, Jensen-Shannon divergence above
`max_js_divergence`, and the null indicator's correlation with the label
above `max_correlation` (leakage). A map loses its failing keys, or
whole when every key fails. The defaults are the reference's
(`OpWorkflow.withRawFeatureFilter`): bins 100, min fill 0.001, max fill
difference 0.90, max fill ratio 20.0, max JS divergence 0.90, max
correlation 0.95, min scoring rows 500. Text is hashed with the port's
own `murmur3_32` (`ops/text.py`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import SCALAR, kind_of
from transmogrifai_tpu_torch.ops.text import murmur3_32


MIN_SCORING_ROWS_DEFAULT = 500  # RawFeatureFilter.minScoringRowsDefault


@dataclass
class Summary:
    """Pre-binning value summary (filters/Summary.scala:43)."""

    min: float = math.inf
    max: float = -math.inf
    sum: float = 0.0
    count: float = 0.0

    @staticmethod
    def of(values: np.ndarray) -> "Summary":
        if values.size == 0:
            return Summary()
        return Summary(float(np.min(values)), float(np.max(values)),
                       float(np.sum(values)), float(values.size))


def text_bins_formula(summary: Summary, bins: int) -> int:
    """Hashed-token bin count for text features
    (RawFeatureFilter.textBinsFormula:588-596 — identity by default)."""
    return bins


@dataclass
class FeatureDistribution:
    """Binned distribution of one raw feature (or one map key)
    (filters/FeatureDistribution.scala): `distribution` is histogram counts
    for numerics / hashed token counts for text; `nulls` counts missing."""

    name: str
    key: Optional[str]  # map key, None for non-map features
    count: int
    nulls: int
    distribution: np.ndarray
    summary: Summary = field(default_factory=Summary)

    @property
    def fill_rate(self) -> float:
        return 0.0 if self.count == 0 else (self.count - self.nulls) / self.count

    def relative_fill_rate(self, other: "FeatureDistribution") -> float:
        """Absolute fill-rate difference."""
        return abs(self.fill_rate - other.fill_rate)

    def relative_fill_ratio(self, other: "FeatureDistribution") -> float:
        """larger/smaller fill ratio (∞ when one side is empty-filled)."""
        a, b = self.fill_rate, other.fill_rate
        lo, hi = min(a, b), max(a, b)
        if hi == 0.0:
            return 1.0
        return math.inf if lo == 0.0 else hi / lo

    def js_divergence(self, other: "FeatureDistribution") -> float:
        """Jensen-Shannon divergence (log base 2 → [0, 1]) between the two
        normalized binned distributions."""
        p, q = self.distribution.astype(float), other.distribution.astype(float)
        if p.sum() == 0.0 or q.sum() == 0.0:
            return 0.0
        n = min(len(p), len(q))
        p, q = p[:n] / p.sum(), q[:n] / q.sum()
        m = 0.5 * (p + q)

        def kl(a, b):
            mask = a > 0
            return float(np.sum(a[mask] * np.log2(a[mask] / b[mask])))

        return 0.5 * kl(p, m) + 0.5 * kl(q, m)


# --------------------------------------------------------------------- #
# distribution builders (host columnar)                                 #
# --------------------------------------------------------------------- #

def _numeric_dist(name: str, key: Optional[str], values: np.ndarray,
                  mask: np.ndarray, bins: int,
                  edges: Optional[np.ndarray]) -> Tuple[FeatureDistribution, np.ndarray]:
    vals = values[mask]
    summ = Summary.of(vals)
    if edges is None:
        lo = summ.min if summ.count else 0.0
        hi = summ.max if summ.count else 1.0
        if not (hi > lo):
            hi = lo + 1.0
        edges = np.linspace(lo, hi, bins + 1)
    hist, _ = np.histogram(np.clip(vals, edges[0], edges[-1]), bins=edges)
    return FeatureDistribution(name, key, len(values), int((~mask).sum()),
                               hist, summ), edges


def _tokens_of(v: Any) -> List[str]:
    if v is None:
        return []
    if isinstance(v, str):
        return v.lower().split()
    if isinstance(v, (list, tuple, set, frozenset)):
        return [str(x) for x in v]
    return [str(v)]


def _text_dist(name: str, key: Optional[str], values: Sequence[Any],
               bins: int) -> FeatureDistribution:
    counts = np.zeros(bins, dtype=np.int64)
    nulls = 0
    for v in values:
        toks = _tokens_of(v)
        if not toks:
            nulls += 1
            continue
        for t in toks:
            counts[murmur3_32(t.encode("utf-8")) % bins] += 1
    return FeatureDistribution(name, key, len(values), nulls, counts)


def _feature_distributions(feature, dataset, bins: int,
                           train_edges: Optional[Dict[Tuple[str, Optional[str]], np.ndarray]],
                           edges_out: Dict[Tuple[str, Optional[str]], np.ndarray]
                           ) -> List[FeatureDistribution]:
    """Distributions for one raw feature: one entry, or one per key for maps.
    Binned with `train_edges` when given (score pass) so train/score
    histograms are comparable (computeFeatureStats:138-200)."""
    stage = feature.origin_stage
    col = stage.materialize(dataset, allow_missing_response=True)
    ftype = feature.ftype
    out: List[FeatureDistribution] = []
    if issubclass(ftype, T.OPMap) and not issubclass(ftype, T.Prediction):
        values = col.data  # map kind: object array of dicts
        keys: List[str] = []
        for v in values:
            if isinstance(v, dict):
                for k in v:
                    if k not in keys:
                        keys.append(k)
        numeric_vals = issubclass(ftype, (T.RealMap, T.IntegralMap,
                                          T.BinaryMap, T.CurrencyMap,
                                          T.PercentMap, T.DateMap,
                                          T.DateTimeMap))
        for k in keys:
            sub = [v.get(k) if isinstance(v, dict) else None for v in values]
            if numeric_vals:
                arr = np.array([float(x) if x is not None else np.nan
                                for x in sub], dtype=np.float64)
                mask = ~np.isnan(arr)
                ek = (feature.name, k)
                d, e = _numeric_dist(feature.name, k, arr, mask, bins,
                                     None if train_edges is None
                                     else train_edges.get(ek))
                edges_out[ek] = e
                out.append(d)
            else:
                out.append(_text_dist(feature.name, k, sub, bins))
        return out
    if kind_of(ftype) == SCALAR:
        values, mask = col.data["value"], col.data["mask"]
        ek = (feature.name, None)
        d, e = _numeric_dist(feature.name, None, np.asarray(values, dtype=np.float64),
                             np.asarray(mask, dtype=bool), bins,
                             None if train_edges is None else train_edges.get(ek))
        edges_out[ek] = e
        out.append(d)
        return out
    # host kinds: text/lists/sets/geolocation → hashed token counts
    out.append(_text_dist(feature.name, None, list(col.data), bins))
    return out


# --------------------------------------------------------------------- #
# results model                                                         #
# --------------------------------------------------------------------- #

@dataclass
class RawFeatureFilterMetrics:
    """Per-distribution metrics + drop reasons
    (RawFeatureFilterResults.scala)."""

    name: str
    key: Optional[str]
    training_fill_rate: float
    scoring_fill_rate: Optional[float]
    fill_rate_diff: Optional[float]
    fill_ratio_diff: Optional[float]
    js_divergence: Optional[float]
    null_label_correlation: Optional[float]
    reasons: List[str] = field(default_factory=list)

    @property
    def dropped(self) -> bool:
        return bool(self.reasons)


@dataclass
class RawFeatureFilterResults:
    """Full filter outcome: config + metrics + exclusions."""

    config: Dict[str, Any]
    metrics: List[RawFeatureFilterMetrics]
    dropped_features: List[str]
    dropped_map_keys: Dict[str, List[str]]

    def to_json(self) -> Dict[str, Any]:
        return {
            "config": self.config,
            "metrics": [vars(m) for m in self.metrics],
            "dropped_features": self.dropped_features,
            "dropped_map_keys": self.dropped_map_keys,
        }


@dataclass
class FilteredRawData:
    """generateFilteredRaw product (RawFeatureFilter.scala:616)."""

    clean_dataset: Any
    features_to_drop: List[str]
    map_keys_to_drop: Dict[str, List[str]]
    results: RawFeatureFilterResults


# --------------------------------------------------------------------- #
# the filter                                                            #
# --------------------------------------------------------------------- #

class RawFeatureFilter:
    """Compare raw-feature distributions between training and scoring data;
    drop features whose fill rate, fill-rate shift, distribution shift (JS
    divergence) or null-label leakage correlation violates the thresholds
    (RawFeatureFilter.scala:90-636)."""

    def __init__(self, bins: int = 100, min_fill: float = 0.001,
                 max_fill_difference: float = 0.90,
                 max_fill_ratio_diff: float = 20.0,
                 max_js_divergence: float = 0.90,
                 max_correlation: float = 0.95,
                 protected_features: Sequence[str] = (),
                 js_divergence_protected: Sequence[str] = (),
                 min_scoring_rows: int = MIN_SCORING_ROWS_DEFAULT):
        if not (1 < bins):
            raise ValueError(f"bins must be > 1, got {bins}")
        for nm, v, lo, hi in (("min_fill", min_fill, 0.0, 1.0),
                              ("max_fill_difference", max_fill_difference, 0.0, 1.0),
                              ("max_js_divergence", max_js_divergence, 0.0, 1.0)):
            if not (lo <= v <= hi):
                raise ValueError(f"{nm} must be in [{lo}, {hi}], got {v}")
        self.bins = bins
        self.min_fill = min_fill
        self.max_fill_difference = max_fill_difference
        self.max_fill_ratio_diff = max_fill_ratio_diff
        self.max_js_divergence = max_js_divergence
        self.max_correlation = max_correlation
        self.protected_features = set(protected_features)
        self.js_divergence_protected = set(js_divergence_protected)
        self.min_scoring_rows = min_scoring_rows

    # -- leakage ---------------------------------------------------------- #

    def _null_label_corr(self, feature, dataset, label_values: Optional[np.ndarray]
                         ) -> Dict[Optional[str], float]:
        """Pearson corr between each distribution's null indicator and the
        label (RawFeatureFilter.scala:181-194)."""
        if label_values is None:
            return {}
        col = feature.origin_stage.materialize(dataset, allow_missing_response=True)
        y = label_values
        out: Dict[Optional[str], float] = {}

        def corr(null_ind: np.ndarray) -> float:
            if null_ind.std() == 0 or y.std() == 0:
                return 0.0
            return float(np.corrcoef(null_ind, y)[0, 1])

        if issubclass(feature.ftype, T.OPMap) and not issubclass(feature.ftype, T.Prediction):
            values = col.data
            keys: Set[str] = set()
            for v in values:
                if isinstance(v, dict):
                    keys |= set(v)
            for k in keys:
                null_ind = np.array(
                    [0.0 if isinstance(v, dict) and v.get(k) is not None else 1.0
                     for v in values])
                out[k] = corr(null_ind)
        elif kind_of(feature.ftype) == SCALAR:
            out[None] = corr((~np.asarray(col.data["mask"], bool)).astype(float))
        else:
            null_ind = np.array([1.0 if not _tokens_of(v) else 0.0 for v in col.data])
            out[None] = corr(null_ind)
        return out

    # -- main entry ------------------------------------------------------- #

    def generate_filtered_raw(self, train_dataset, raw_features: Sequence,
                              score_dataset=None,
                              label_feature=None) -> FilteredRawData:
        predictors = [f for f in raw_features if not f.is_response]
        label_values: Optional[np.ndarray] = None
        if label_feature is not None:
            lcol = label_feature.origin_stage.materialize(train_dataset)
            label_values = np.asarray(lcol.data["value"], dtype=np.float64)

        use_score = (score_dataset is not None
                     and len(score_dataset) >= self.min_scoring_rows)
        train_edges: Dict[Tuple[str, Optional[str]], np.ndarray] = {}
        metrics: List[RawFeatureFilterMetrics] = []
        drop_features: List[str] = []
        drop_keys: Dict[str, List[str]] = {}

        for f in predictors:
            t_dists = _feature_distributions(f, train_dataset, self.bins,
                                             None, train_edges)
            s_by_key: Dict[Optional[str], FeatureDistribution] = {}
            if use_score:
                s_dists = _feature_distributions(f, score_dataset, self.bins,
                                                 train_edges, {})
                s_by_key = {d.key: d for d in s_dists}
            corrs = self._null_label_corr(f, train_dataset, label_values)

            f_metrics: List[RawFeatureFilterMetrics] = []
            for td in t_dists:
                sd = s_by_key.get(td.key)
                reasons: List[str] = []
                if td.fill_rate < self.min_fill:
                    reasons.append(
                        f"training fill rate {td.fill_rate:.4f} < min fill {self.min_fill}")
                js = None
                if sd is not None:
                    if sd.fill_rate < self.min_fill:
                        reasons.append(
                            f"scoring fill rate {sd.fill_rate:.4f} < min fill {self.min_fill}")
                    if td.relative_fill_rate(sd) > self.max_fill_difference:
                        reasons.append(
                            f"fill rate difference {td.relative_fill_rate(sd):.4f} "
                            f"> {self.max_fill_difference}")
                    if td.relative_fill_ratio(sd) > self.max_fill_ratio_diff:
                        reasons.append(
                            f"fill ratio {td.relative_fill_ratio(sd):.2f} "
                            f"> {self.max_fill_ratio_diff}")
                    js = td.js_divergence(sd)
                    if (f.name not in self.js_divergence_protected
                            and js > self.max_js_divergence):
                        reasons.append(
                            f"JS divergence {js:.4f} > {self.max_js_divergence}")
                c = corrs.get(td.key)
                if c is not None and abs(c) > self.max_correlation:
                    reasons.append(
                        f"null-label correlation {c:.4f} exceeds {self.max_correlation} "
                        "(potential leakage)")
                if f.name in self.protected_features:
                    reasons = []
                f_metrics.append(RawFeatureFilterMetrics(
                    name=f.name, key=td.key,
                    training_fill_rate=td.fill_rate,
                    scoring_fill_rate=None if sd is None else sd.fill_rate,
                    fill_rate_diff=None if sd is None else td.relative_fill_rate(sd),
                    fill_ratio_diff=None if sd is None else td.relative_fill_ratio(sd),
                    js_divergence=js, null_label_correlation=c,
                    reasons=reasons))
            metrics.extend(f_metrics)
            f.distributions = t_dists  # attach for ModelInsights

            is_map = issubclass(f.ftype, T.OPMap) and not issubclass(f.ftype, T.Prediction)
            if is_map and f_metrics:
                bad = [m.key for m in f_metrics if m.dropped and m.key is not None]
                if bad:
                    if len(bad) == len(f_metrics):
                        drop_features.append(f.name)
                    else:
                        drop_keys[f.name] = bad
            elif any(m.dropped for m in f_metrics):
                drop_features.append(f.name)

        clean = self._clean_dataset(train_dataset, drop_keys)
        results = RawFeatureFilterResults(
            config={
                "bins": self.bins, "min_fill": self.min_fill,
                "max_fill_difference": self.max_fill_difference,
                "max_fill_ratio_diff": self.max_fill_ratio_diff,
                "max_js_divergence": self.max_js_divergence,
                "max_correlation": self.max_correlation,
                "min_scoring_rows": self.min_scoring_rows,
                "scoring_set_used": use_score,
            },
            metrics=metrics, dropped_features=drop_features,
            dropped_map_keys={k: sorted(v) for k, v in drop_keys.items()})
        return FilteredRawData(clean, drop_features, results.dropped_map_keys,
                               results)

    @staticmethod
    def _clean_dataset(dataset, drop_keys: Dict[str, List[str]]):
        """The training data with the dropped map keys taken out of each
        row's map."""
        if not drop_keys:
            return dataset
        ds = dataset
        for name, keys in drop_keys.items():
            if name not in ds.columns:
                continue
            kset = set(keys)
            old = ds.column(name)
            new = np.empty(len(old), dtype=object)
            for i, v in enumerate(old):
                new[i] = ({k: x for k, x in v.items() if k not in kset}
                          if isinstance(v, dict) else v)
            ds = ds.with_column(name, new, ds.schema[name])
        return ds
