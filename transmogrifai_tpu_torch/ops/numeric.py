"""Numeric vectorizers: impute + null-indicator encoding.

The port's counterpart of the JAX package's `ops/numeric.py`: Real
(mean fill), Integral (mode fill) and Binary (constant fill) vectorizer
estimators and their fitted models, and the stateless RealNN stack. Each
input of a vectorizer contributes `[filled value, null indicator]`
columns, computed as `v·m + fill·(1 − m)` and `1 − m` in f32 from the
scalar column's value/mask pair — the same arithmetic on the same f32
values, so the outputs agree with the JAX package exactly.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.data.metadata import (
    NULL_INDICATOR, VectorColumnMetadata, VectorMetadata)
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, Transformer)


class _NumericModelBase(Transformer):
    """Fitted numeric vectorizer: fill + optional null-indicator columns."""

    out_type = T.OPVector

    def __init__(self, fill_values: Sequence[float], track_nulls: bool = True,
                 descriptor: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.fill_values = np.asarray(fill_values, dtype=np.float32)
        self.track_nulls = track_nulls
        self.descriptor = descriptor

    def device_apply(self, enc, dev):
        cols = []
        for i, d in enumerate(dev):
            v, m = d["value"], d["mask"]
            fill = float(self.fill_values[i])  # an f32 value, exact
            cols.append(v * m + fill * (1.0 - m))
            if self.track_nulls:
                cols.append(1.0 - m)
        return torch.stack(cols, dim=1)

    def get_params(self):
        return {"fill_values": self.fill_values.tolist(),
                "track_nulls": self.track_nulls,
                "descriptor": self.descriptor}

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for f in self.input_features:
            cols.append(VectorColumnMetadata(
                parent_name=f.name, parent_type=f.ftype.__name__,
                descriptor_value=self.descriptor))
            if self.track_nulls:
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()


class RealVectorizerModel(_NumericModelBase):
    pass


class RealVectorizer(Estimator):
    """N Real features → [imputed value, null indicator] per feature.

    fill_value: "mean" (default, f32 on the fit's device) | "median" |
    a number."""

    in_types = (T.Real, Ellipsis)
    out_type = T.OPVector

    def __init__(self, fill_value="mean", track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, fill_value=fill_value,
                         track_nulls=track_nulls)
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        if self.fill_value == "mean":
            dev = [c.device_value(ctx.device) for c in cols]
            value = torch.stack([d["value"] for d in dev], 1)
            mask = torch.stack([d["mask"] for d in dev], 1)
            denom = torch.clamp(mask.sum(0), min=1.0)
            fills = ((value * mask).sum(0) / denom).cpu().numpy()
        elif self.fill_value == "median":
            fills = []
            for c in cols:
                v = np.asarray(c.data["value"], dtype=np.float64)
                m = np.asarray(c.data["mask"])
                fills.append(float(np.median(v[m])) if m.any() else 0.0)
            fills = np.asarray(fills)
        else:
            fills = np.full(len(cols), float(self.fill_value))
        return RealVectorizerModel(fills, self.track_nulls)


class IntegralVectorizerModel(_NumericModelBase):
    pass


class IntegralVectorizer(Estimator):
    """N Integral features → [mode-imputed value, null indicator] each
    (ties go to the smallest value)."""

    in_types = (T.Integral, Ellipsis)
    out_type = T.OPVector

    def __init__(self, fill_value="mode", track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, fill_value=fill_value,
                         track_nulls=track_nulls)
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        fills = []
        for c in cols:
            if self.fill_value == "mode":
                v = np.asarray(c.data["value"])[np.asarray(c.data["mask"])]
                if v.size == 0:
                    fills.append(0.0)
                else:
                    vals, counts = np.unique(v, return_counts=True)
                    fills.append(float(vals[np.argmax(counts)]))
            else:
                fills.append(float(self.fill_value))
        return IntegralVectorizerModel(np.asarray(fills), self.track_nulls)


class BinaryVectorizerModel(_NumericModelBase):
    pass


class BinaryVectorizer(Estimator):
    """N Binary features → [value (null → fill), null indicator] each."""

    in_types = (T.Binary, Ellipsis)
    out_type = T.OPVector

    def __init__(self, fill_value: bool = False, track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, fill_value=fill_value,
                         track_nulls=track_nulls)
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        fills = np.full(len(cols), 1.0 if self.fill_value else 0.0)
        return BinaryVectorizerModel(fills, self.track_nulls)


class RealNNVectorizer(Transformer):
    """N RealNN features → their values stacked (RealNNVectorizer.scala):
    stateless, no nulls possible."""

    in_types = (T.RealNN, Ellipsis)
    out_type = T.OPVector

    def device_apply(self, enc, dev):
        return torch.stack([d["value"] for d in dev], dim=1)

    def output_meta(self) -> VectorMetadata:
        cols = tuple(
            VectorColumnMetadata(parent_name=f.name,
                                 parent_type=f.ftype.__name__)
            for f in self.input_features)
        return VectorMetadata(self.output_name(), cols).with_indices()
