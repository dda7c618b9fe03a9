"""Geolocation vectorization (GeolocationVectorizer.scala): each
(lat, lon, accuracy) triple mean-imputed, then a null indicator.

The port's counterpart of the JAX package's `ops/geo.py`. The fill is
`fill_missing` (stages/base.py), which rounds as the JAX package's XLA
programs do (F11).
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
    ConstantArrays, Estimator, FitContext, Transformer, fill_missing)


def _geo_arrays(col: Column):
    n = len(col.data)
    vals = np.zeros((n, 3), dtype=np.float32)
    mask = np.zeros(n, dtype=np.float32)
    for i, v in enumerate(col.data):
        if v is not None:
            vals[i] = v
            mask[i] = 1.0
    return vals, mask


class GeolocationModel(Transformer):
    out_type = T.OPVector

    def __init__(self, fills: Sequence[Sequence[float]],
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.fills = np.asarray(fills, dtype=np.float32).reshape(-1, 3)
        self.track_nulls = track_nulls

    def host_prepare(self, cols: Sequence[Optional[Column]]):
        return [{"value": v, "mask": m}
                for v, m in (_geo_arrays(c) for c in cols)]

    def device_constants(self, device):
        return ConstantArrays([self.fills]).to(device)

    def device_apply_with(self, consts, enc, dev):
        parts = []
        for i, e in enumerate(enc):
            m = e["mask"][:, None]
            parts.append(fill_missing(e["value"], m, consts[0][i][None, :]))
            if self.track_nulls:
                parts.append(1.0 - m)
        return torch.cat(parts, dim=1)

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for f in self.input_features:
            for d in ("lat", "lon", "accuracy"):
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    descriptor_value=d))
            if self.track_nulls:
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()

    def get_params(self):
        return {"fills": self.fills.tolist(), "track_nulls": self.track_nulls}


class GeolocationVectorizer(Estimator):
    """N Geolocation features → [lat, lon, accuracy (mean-imputed), null]
    each."""

    in_types = (T.Geolocation, Ellipsis)
    out_type = T.OPVector

    def __init__(self, track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(uid=uid, track_nulls=track_nulls)
        self.track_nulls = track_nulls

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        fills = []
        for c in cols:
            vals, mask = _geo_arrays(c)
            denom = max(float(mask.sum()), 1.0)
            fills.append((vals * mask[:, None]).sum(axis=0) / denom)
        return GeolocationModel(np.asarray(fills), self.track_nulls)
