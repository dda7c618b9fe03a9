"""Numeric bucketizers: one-hot of bucket membership over given splits,
and label-aware splits from a single-feature decision tree.

The port's counterpart of the JAX package's `ops/bucketizers.py`
(numeric stages only). `NumericBucketizerModel` one-hots a value's
bucket among monotonic splits (left-inclusive) with optional null and
out-of-bounds columns; `DecisionTreeNumericBucketizer` fits the splits
against the label on the host (an exact sorted prefix-sum scan,
`decision_tree_splits`), and its model one-hots like the numeric one.

The device part is `torch.searchsorted` on the inner splits plus a
compare. It compares f32 values with the splits narrowed to f32, as the
JAX package's compiled scorer does (its splits become f32 arrays with
x64 off, and its bound compares run in f32 inside the jitted program):
never in f64, so a value just beside an f64 split that f32 cannot hold
lands where the JAX package's scorer puts it. Splits may be ±inf. A
subnormal value compares as zero, as in XLA's CPU programs (F11). The
JAX package's eager transform differs in one place: there the bound
compares see host numpy arrays and run in f64.

`DecisionTreeNumericMapBucketizer` fits the same splits per key of a
numeric map; its model runs on the host segments of the scorer (its
values come from a map) and compares in f32 like the others.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.data.metadata import (
    NULL_INDICATOR, VectorColumnMetadata, VectorMetadata)
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, Transformer, flush_subnormals)


def _bucket_labels(splits: Sequence[float]) -> List[str]:
    s = ["-Inf" if not np.isfinite(a) else f"{a:g}" for a in splits]
    s[-1] = "Inf" if not np.isfinite(splits[-1]) else s[-1]
    return [f"[{a}-{b})" for a, b in zip(s[:-1], s[1:])]


class _InnerSplits(torch.nn.Module):
    """The inner splits, narrowed to f32, as a buffer on the device."""

    def __init__(self, splits: np.ndarray):
        super().__init__()
        self.register_buffer("inner", torch.as_tensor(
            np.asarray(splits[1:-1], dtype=np.float32)))


def _onehot_buckets(inner: torch.Tensor, lo: float, hi: float,
                    n_buckets: int, x: torch.Tensor, m: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(one-hot (n, n_buckets) f32, valid (n,) bool) of f32 values x with
    presence m: bucket = searchsorted(inner, x, side="right"), valid =
    present and lo <= x < hi (lo and hi f32-narrowed); subnormal x as 0."""
    x = flush_subnormals(x)
    valid = m & (x >= lo) & (x < hi)
    return _onehot(inner, n_buckets, x, valid), valid


def _onehot(inner: torch.Tensor, n_buckets: int, x: torch.Tensor,
            keep: torch.Tensor) -> torch.Tensor:
    """One-hot (n, n_buckets) f32 of searchsorted(inner, x, side="right"),
    zero in the rows that `keep` leaves out."""
    idx = torch.searchsorted(inner, x, right=True)
    buckets = torch.arange(n_buckets, device=x.device)
    return ((buckets[None, :] == idx[:, None])
            & keep[:, None]).to(torch.float32)


class NumericBucketizerModel(Transformer):
    """One-hot of bucket membership given monotonic `splits`
    (left-inclusive), then an out-of-bounds column (`track_invalid`) and a
    null column (`track_nulls`)."""

    in_types = (T.OPNumeric,)
    out_type = T.OPVector

    def __init__(self, splits: Sequence[float], track_nulls: bool = True,
                 track_invalid: bool = False,
                 labels: Optional[Sequence[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.splits = np.asarray(splits, dtype=np.float64)
        if len(self.splits) < 2 or np.any(np.diff(self.splits) <= 0):
            raise ValueError("splits must be ≥2 strictly increasing values")
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid
        self.labels = (list(labels) if labels is not None and len(labels)
                       else _bucket_labels(self.splits))

    @property
    def n_buckets(self) -> int:
        return len(self.splits) - 1

    def device_constants(self, device):
        return _InnerSplits(self.splits).to(device)

    def device_apply_with(self, consts, enc, dev):
        x, m = dev[0]["value"], dev[0]["mask"].bool()
        onehot, valid = _onehot_buckets(
            consts.inner, float(np.float32(self.splits[0])),
            float(np.float32(self.splits[-1])), self.n_buckets, x, m)
        cols = [onehot]
        if self.track_invalid:
            cols.append((m & ~valid)[:, None].to(torch.float32))
        if self.track_nulls:
            cols.append((~m)[:, None].to(torch.float32))
        return torch.cat(cols, dim=1)

    def output_meta(self) -> VectorMetadata:
        f = self.input_features[0]
        cols = [VectorColumnMetadata(parent_name=f.name,
                                     parent_type=f.ftype.__name__,
                                     indicator_value=lbl)
                for lbl in self.labels]
        if self.track_invalid:
            cols.append(VectorColumnMetadata(
                parent_name=f.name, parent_type=f.ftype.__name__,
                indicator_value="OutOfBounds"))
        if self.track_nulls:
            cols.append(VectorColumnMetadata(
                parent_name=f.name, parent_type=f.ftype.__name__,
                indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()

    def get_params(self):
        return {"splits": self.splits.tolist(),
                "track_nulls": self.track_nulls,
                "track_invalid": self.track_invalid, "labels": self.labels}


class NumericBucketizer(NumericBucketizerModel):
    """The public unsupervised bucketizer (already a transformer)."""


# --------------------------------------------------------------------------- #
# supervised split search (host numpy)                                        #
# --------------------------------------------------------------------------- #

def _best_split(x: np.ndarray, y: np.ndarray, classification: bool,
                min_leaf: int) -> Tuple[Optional[float], float]:
    """Best threshold by impurity decrease via one sorted prefix-sum scan:
    (threshold, gain), threshold None when no split is valid. Candidates
    are midpoints between distinct consecutive sorted values."""
    n = x.shape[0]
    if n < 2 * min_leaf:
        return None, 0.0
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order]
    change = xs[1:] != xs[:-1]
    pos = np.arange(1, n)
    ok = change & (pos >= min_leaf) & (n - pos >= min_leaf)
    if not ok.any():
        return None, 0.0
    if classification:
        classes, yi = np.unique(ys, return_inverse=True)
        k = len(classes)
        onehot = np.zeros((n, k), dtype=np.float64)
        onehot[np.arange(n), yi] = 1.0
        left = np.cumsum(onehot, axis=0)[:-1]
        total = onehot.sum(axis=0)
        right = total[None, :] - left
        nl = pos.astype(np.float64)
        nr = (n - pos).astype(np.float64)
        gini_l = 1.0 - ((left / nl[:, None]) ** 2).sum(axis=1)
        gini_r = 1.0 - ((right / nr[:, None]) ** 2).sum(axis=1)
        p = onehot.sum(axis=0) / n
        parent = 1.0 - (p ** 2).sum()
        gain = parent - (nl / n) * gini_l - (nr / n) * gini_r
    else:
        s = np.cumsum(ys)[:-1]
        s2 = np.cumsum(ys ** 2)[:-1]
        st, s2t = ys.sum(), (ys ** 2).sum()
        nl = pos.astype(np.float64)
        nr = (n - pos).astype(np.float64)
        var_l = s2 / nl - (s / nl) ** 2
        var_r = (s2t - s2) / nr - ((st - s) / nr) ** 2
        parent = s2t / n - (st / n) ** 2
        gain = parent - (nl / n) * var_l - (nr / n) * var_r
    gain = np.where(ok, gain, -np.inf)
    i = int(np.argmax(gain))
    if not np.isfinite(gain[i]) or gain[i] <= 0:
        return None, 0.0
    # split index i puts xs[0..i] left and xs[i+1..] right
    return float((xs[i] + xs[i + 1]) / 2.0), float(gain[i])


def decision_tree_splits(x: np.ndarray, y: np.ndarray, classification: bool,
                         max_depth: int = 2, min_leaf: int = 1,
                         min_info_gain: float = 1e-6) -> List[float]:
    """Thresholds of a greedy depth-`max_depth` single-feature tree."""
    thresholds: List[float] = []

    def grow(idx: np.ndarray, depth: int) -> None:
        if depth >= max_depth or idx.size < 2 * min_leaf:
            return
        thr, gain = _best_split(x[idx], y[idx], classification, min_leaf)
        if thr is None or gain < min_info_gain:
            return
        thresholds.append(thr)
        grow(idx[x[idx] < thr], depth + 1)
        grow(idx[x[idx] >= thr], depth + 1)

    grow(np.arange(x.shape[0]), 0)
    return sorted(thresholds)


def _is_classification(y: np.ndarray, max_classes: int = 32) -> bool:
    u = np.unique(y)
    return u.size <= max_classes and np.allclose(u, np.round(u))


class DecisionTreeNumericBucketizer(Estimator):
    """(label, numeric) → one-hot of label-aware buckets; no bucket
    columns (only the null indicator, if tracked) when no useful split
    exists."""

    in_types = (T.OPNumeric, T.OPNumeric)  # (response, numeric predictor)
    out_type = T.OPVector

    def __init__(self, max_depth: int = 2, min_info_gain: float = 1e-6,
                 min_instances_per_node: int = 1, track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, max_depth=max_depth,
                         min_info_gain=min_info_gain,
                         min_instances_per_node=min_instances_per_node,
                         track_nulls=track_nulls)
        self.max_depth = max_depth
        self.min_info_gain = min_info_gain
        self.min_instances_per_node = min_instances_per_node
        self.track_nulls = track_nulls

    def _fit_splits(self, label: Column, num: Column) -> List[float]:
        y = np.asarray(label.data["value"], dtype=np.float64)
        x = np.asarray(num.data["value"], dtype=np.float64)
        m = (np.asarray(num.data["mask"]).astype(bool)
             & np.asarray(label.data["mask"]).astype(bool))
        if not m.any():
            return []
        x, y = x[m], y[m]
        return decision_tree_splits(
            x, y, _is_classification(y), self.max_depth,
            self.min_instances_per_node, self.min_info_gain)

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        thr = self._fit_splits(cols[0], cols[1])
        return DecisionTreeBucketizerModel(thr, track_nulls=self.track_nulls)


class DecisionTreeBucketizerModel(Transformer):
    """The fitted supervised bucketizer. Its inputs stay (label, numeric);
    the label is not read at transform time (absent when scoring)."""

    in_types = (T.OPNumeric, T.OPNumeric)
    out_type = T.OPVector

    def __init__(self, thresholds: Sequence[float], track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.thresholds = [float(t) for t in thresholds]
        self.track_nulls = track_nulls
        # splits span ±inf, so every present value is in bounds and no
        # out-of-bounds column exists
        self._inner = (NumericBucketizerModel(
            [-np.inf] + self.thresholds + [np.inf], track_nulls=False,
            track_invalid=False) if self.thresholds else None)

    @property
    def did_split(self) -> bool:
        return self._inner is not None

    def device_constants(self, device):
        if self._inner is None:
            return None
        return self._inner.device_constants(device)

    def device_apply(self, enc, dev):
        return self.device_apply_with(None, enc, dev)

    def device_apply_with(self, consts, enc, dev):
        d = dev[1]
        m = d["mask"].bool()
        cols = []
        if self._inner is not None:
            cols.append(self._inner.device_apply_with(consts, None, [d]))
        if self.track_nulls:
            cols.append((~m)[:, None].to(torch.float32))
        if not cols:
            return torch.zeros((d["value"].shape[0], 0), dtype=torch.float32,
                               device=d["value"].device)
        return torch.cat(cols, dim=1)

    def output_meta(self) -> VectorMetadata:
        f = self.input_features[1]
        cols: List[VectorColumnMetadata] = []
        if self._inner is not None:
            for lbl in self._inner.labels:
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    indicator_value=lbl))
        if self.track_nulls:
            cols.append(VectorColumnMetadata(
                parent_name=f.name, parent_type=f.ftype.__name__,
                indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()

    def get_params(self):
        return {"thresholds": self.thresholds, "track_nulls": self.track_nulls}


def _map_key_values(rows, key: str) -> np.ndarray:
    """One key of a numeric map column as f64, NaN where absent."""
    return np.array([float(row[key]) if row and key in row
                     and row[key] is not None else np.nan for row in rows],
                    dtype=np.float64)


class DecisionTreeNumericMapBucketizer(Estimator):
    """(label, numeric map) → label-aware buckets per map key, then a null
    indicator per key (DecisionTreeNumericMapBucketizer.scala)."""

    in_types = (T.OPNumeric, T.OPMap)
    out_type = T.OPVector

    def __init__(self, max_depth: int = 2, min_info_gain: float = 1e-6,
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(uid=uid, max_depth=max_depth,
                         min_info_gain=min_info_gain,
                         track_nulls=track_nulls)
        self.max_depth = max_depth
        self.min_info_gain = min_info_gain
        self.track_nulls = track_nulls

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        label, mapped = cols
        y_all = np.asarray(label.data["value"], dtype=np.float64)
        ym = np.asarray(label.data["mask"]).astype(bool)
        keys = sorted({k for row in mapped.data for k in (row or {})})
        per_key = {}
        for k in keys:
            x = _map_key_values(mapped.data, k)
            m = ~np.isnan(x) & ym
            thr: List[float] = []
            if m.any():
                thr = decision_tree_splits(
                    x[m], y_all[m], _is_classification(y_all[ym]),
                    self.max_depth, 1, self.min_info_gain)
            per_key[k] = thr
        return DecisionTreeMapBucketizerModel(per_key, self.track_nulls)


class DecisionTreeMapBucketizerModel(Transformer):
    """The fitted map bucketizer: per key (in the fit's key order) the
    one-hot of its buckets, where it split, and a null indicator. Its
    values come from the host as f64 (absent keys 0, NaN as 0, ±inf as
    ±max f64) and are compared in f32 with the f32-narrowed splits, as the
    JAX package's eager `searchsorted` does (F18); every present value is
    in bounds."""

    in_types = (T.OPNumeric, T.OPMap)
    out_type = T.OPVector
    jittable = False  # the map input needs host-side key extraction

    def __init__(self, splits_by_key, track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.splits_by_key = {k: [float(t) for t in v]
                              for k, v in dict(splits_by_key).items()}
        self.track_nulls = track_nulls

    def host_prepare(self, cols):
        out = {}
        for k in self.splits_by_key:
            x = _map_key_values(cols[1].data, k)
            out[k] = {"value": np.nan_to_num(x), "mask": ~np.isnan(x)}
        return out

    def device_apply(self, enc, dev):
        groups = []
        for k, thr in self.splits_by_key.items():
            x, m = enc[k]["value"], enc[k]["mask"]
            if thr:
                inner = torch.as_tensor(np.asarray(thr, dtype=np.float32),
                                        device=x.device)
                # the outer splits are ±inf, so every present value is
                # in bounds, f32 ±inf (an f64 beyond f32's range) too
                groups.append(_onehot(
                    inner, len(thr) + 1,
                    flush_subnormals(x.to(torch.float32)), m))
            if self.track_nulls:
                groups.append((~m)[:, None].to(torch.float32))
        if not groups:
            n = len(next(iter(enc.values()))["value"]) if enc else 0
            return torch.zeros((n, 0), dtype=torch.float32)
        return torch.cat(groups, dim=1)

    def output_meta(self) -> VectorMetadata:
        f = self.input_features[1]
        cols: List[VectorColumnMetadata] = []
        for k, thr in self.splits_by_key.items():
            if thr:
                for lbl in _bucket_labels([-np.inf] + list(thr) + [np.inf]):
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        grouping=k, indicator_value=lbl))
            if self.track_nulls:
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    grouping=k, indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()

    def get_params(self):
        return {"splits_by_key": {k: list(v)
                                  for k, v in self.splits_by_key.items()},
                "track_nulls": self.track_nulls}
