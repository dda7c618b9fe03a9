"""RecordInsightsCorr: correlation-based per-record prediction insights.

The port's counterpart of the JAX package's `insights/corr.py`
(`core/.../insights/RecordInsightsCorr.scala:56-160`): the fit correlates
every feature column with every prediction column (Pearson, or Spearman
on average ranks) and fits a feature normalizer (minMax / zNorm /
minMaxCentered, `NormType`); the transform scores each row as
importance[k, j] = corr[k, j] · normalized_feature[j] and keeps the top-K
features per record, in LOCO's TextMap format (feature → JSON
[[pred_index, importance], …], `RecordInsightsParser`-readable).

The fit's centered Gram `Pcᵀ·Xc` and column norms run on the fit's
device in f32 (`torch.matmul`, TF32 off), as the JAX package sends its
f64 centered matrices through `jnp.asarray` (f32 unless x64 is on); the
centering, the normalizer and the rest are the JAX package's numpy, op
for op. Spearman ranks come from the port's rank transform
(`automl/sanity_checker._rank_transform`, equal to pandas' average
ranks), not pandas. The fitted model is a host stage, as there.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column, to_host
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, Transformer)

NORM_TYPES = ("minmax", "znorm", "minmax_centered")


def _pred_matrix(pred_col: Column) -> np.ndarray:
    """Prediction column → (n, p) f64 score matrix: the probability when
    it has columns, else the scalar prediction."""
    data = pred_col.data
    prob = data.get("probability")
    if prob is not None:
        prob = to_host(prob)
        if prob.ndim == 2 and prob.shape[1] > 0:
            return prob.astype(np.float64)
    return to_host(data["prediction"]).astype(np.float64)[:, None]


def _vector_f64(vec_col: Column) -> np.ndarray:
    """The vector's f32 values as f64 (the JAX package reads its device
    value, f32, into f64 numpy)."""
    return to_host(vec_col.data).astype(np.float32).astype(np.float64)


def _ranks(A: np.ndarray, device) -> np.ndarray:
    from transmogrifai_tpu_torch.automl.sanity_checker import (
        _rank_transform)
    t = torch.as_tensor(A.astype(np.float32), device=device)
    return to_host(_rank_transform(t)).astype(np.float64)


class RecordInsightsCorrModel(Transformer):
    in_types = (T.Prediction, T.OPVector)
    out_type = T.TextMap
    # a host stage: transform() is numpy end to end
    jittable = False

    def __init__(self, corr=None, shift=None, scale=None, names=None,
                 top_k: int = 20, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.corr = np.asarray(corr, dtype=np.float64)      # (p, d)
        self.shift = np.asarray(shift, dtype=np.float64)    # (d,)
        self.scale = np.asarray(scale, dtype=np.float64)    # (d,)
        self.names = list(names or [])
        self.top_k = int(top_k)

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        X = _vector_f64(cols[1])
        n, d = X.shape
        if d != self.corr.shape[1]:
            raise ValueError(
                f"feature width {d} != fitted width {self.corr.shape[1]}")
        with np.errstate(divide="ignore", invalid="ignore"):
            Z = np.where(self.scale != 0, (X - self.shift) / self.scale, 0.0)
        corr = np.where(np.isnan(self.corr), 0.0, self.corr)
        # max_k |corr[k,j]·Z[i,j]| factors: the top-k selection needs only
        # the (n, d) strength matrix, never an (n, p, d) tensor
        strength = np.abs(Z) * np.abs(corr).max(axis=0)[None, :]
        k = min(self.top_k, d)
        top = np.argsort(-strength, axis=1)[:, :k]
        names = (self.names if len(self.names) == d
                 else [f"column_{j}" for j in range(d)])
        out = np.empty(n, dtype=object)
        p = corr.shape[0]
        for i in range(n):
            row: Dict[str, str] = {}
            for j in top[i]:
                imp_j = corr[:, j] * Z[i, j]
                row[names[j]] = json.dumps(
                    [[c, round(float(imp_j[c]), 9)] for c in range(p)])
            out[i] = row
        return Column(T.TextMap, out)

    def get_params(self) -> Dict[str, Any]:
        return {"corr": self.corr, "shift": self.shift, "scale": self.scale,
                "names": list(self.names), "top_k": self.top_k}


def centered_gram(Cx: np.ndarray, Cp: np.ndarray, device
                  ) -> Sequence[np.ndarray]:
    """(Pcᵀ·Xc, ‖Xc‖, ‖Pc‖) of the column-centered matrices as f32 numpy:
    the product and the column norms in f32 on `device`."""
    Xc = torch.as_tensor((Cx - Cx.mean(0)).astype(np.float32), device=device)
    Pc = torch.as_tensor((Cp - Cp.mean(0)).astype(np.float32), device=device)
    gram = to_host(torch.matmul(Pc.T, Xc))
    sx = to_host(torch.sqrt(torch.clamp((Xc * Xc).sum(0), min=0.0)))
    sp = to_host(torch.sqrt(torch.clamp((Pc * Pc).sum(0), min=0.0)))
    return gram, sx, sp


class RecordInsightsCorr(Estimator):
    """(Prediction, OPVector) → TextMap.

    `RecordInsightsCorr().set_input(prediction, feature_vector)`: the
    first input must be the model's prediction feature."""

    in_types = (T.Prediction, T.OPVector)
    out_type = T.TextMap

    def __init__(self, top_k: int = 20, norm_type: str = "minmax",
                 correlation_type: str = "pearson",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        if norm_type not in NORM_TYPES:
            raise ValueError(f"norm_type must be one of {NORM_TYPES}")
        if correlation_type not in ("pearson", "spearman"):
            raise ValueError("correlation_type must be pearson|spearman")
        self.params.update(top_k=int(top_k), norm_type=norm_type,
                           correlation_type=correlation_type)

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        pred_col, vec_col = cols
        P = _pred_matrix(pred_col)                           # (n, p)
        X = _vector_f64(vec_col)
        n, d = X.shape
        if self.params["correlation_type"] == "spearman":
            Cx, Cp = _ranks(X, ctx.device), _ranks(P, ctx.device)
        else:
            Cx, Cp = X, P
        gram, sx, sp = centered_gram(Cx, Cp, ctx.device)
        cov = gram / max(n - 1, 1)                           # (p, d)
        sx = sx / np.sqrt(max(n - 1, 1))
        sp = sp / np.sqrt(max(n - 1, 1))
        denom = np.outer(sp, sx)
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = np.where(denom > 0, cov / denom, np.nan)

        # normalizer from raw-X column stats (NormType.makeNormalizer)
        mn, mx = X.min(0), X.max(0)
        mean, sd = X.mean(0), X.std(0, ddof=1) if n > 1 else np.zeros(d)
        nt = self.params["norm_type"]
        if nt == "minmax":
            shift, scale = mn, mx - mn
        elif nt == "znorm":
            shift, scale = mean, sd
        else:  # minmax_centered: (x - min) / ((max - min)/2) - 1
            shift, scale = mn + (mx - mn) / 2.0, (mx - mn) / 2.0
        meta = vec_col.meta
        names = (meta.column_names() if meta is not None
                 and meta.size == d else [])
        return RecordInsightsCorrModel(
            corr=corr, shift=shift, scale=scale, names=names,
            top_k=self.params["top_k"], uid=self.uid + "_model")
