"""Scaling, imputation and calibration stages for scalar features.

The port's counterpart of the JAX package's `ops/scalers.py`: the
z-normalizer (`OpScalarStandardScaler`), mean imputation
(`FillMissingWithMean`), the invertible `ScalerTransformer` and its
`DescalerTransformer`, and the `PercentileCalibrator`. Fits are host
numpy reductions (f64), as in the JAX package; transforms are
elementwise torch with the fitted numbers as Python scalars rounded to
f32, or (the calibrator's quantiles) an f32 buffer built once per device;
a division by a fitted number, and a·x + b, round as the JAX package's do
in each path (`div_const`, `mul_add_const`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, Transformer, div_const, mul_add_const)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _masked_mean_std(value: np.ndarray, mask: np.ndarray):
    m = mask.astype(bool)
    n = max(int(m.sum()), 1)
    mean = float(np.where(m, value, 0.0).sum() / n)
    var = float((np.where(m, value - mean, 0.0) ** 2).sum() / n)
    return mean, float(np.sqrt(var))


def _present(m: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(m, dtype=torch.float32)


class StandardScalerModel(Transformer):
    in_types = (T.OPNumeric,)
    out_type = T.RealNN

    def __init__(self, mean: float, std: float, with_mean: bool = True,
                 with_std: bool = True, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.mean, self.std = float(mean), float(std)
        self.with_mean, self.with_std = with_mean, with_std

    def device_apply(self, enc, dev):
        x, m = dev[0]["value"], dev[0]["mask"].bool()
        v = torch.where(m, x, _f32(self.mean))
        if self.with_mean:
            v = v - _f32(self.mean)
        if self.with_std:
            v = div_const(v, self.std if self.std > 0 else 1.0)
        return {"value": v, "mask": _present(m)}

    def get_params(self):
        return {"mean": self.mean, "std": self.std,
                "with_mean": self.with_mean, "with_std": self.with_std}


class OpScalarStandardScaler(Estimator):
    """z-normalize one numeric feature (missing imputed with the mean)."""

    in_types = (T.OPNumeric,)
    out_type = T.RealNN

    def __init__(self, with_mean: bool = True, with_std: bool = True,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, with_mean=with_mean, with_std=with_std)
        self.with_mean, self.with_std = with_mean, with_std

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        mean, std = _masked_mean_std(
            np.asarray(cols[0].data["value"], dtype=np.float64),
            np.asarray(cols[0].data["mask"]))
        return StandardScalerModel(mean, std, self.with_mean, self.with_std)


class FillMissingWithMeanModel(Transformer):
    in_types = (T.OPNumeric,)
    out_type = T.RealNN

    def __init__(self, fill: float, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.fill = float(fill)

    def device_apply(self, enc, dev):
        x, m = dev[0]["value"], dev[0]["mask"].bool()
        return {"value": torch.where(m, x, _f32(self.fill)),
                "mask": _present(m)}

    def get_params(self):
        return {"fill": self.fill}


class FillMissingWithMean(Estimator):
    """Real → RealNN: impute missing with the training mean (or `default`
    when the whole column is missing)."""

    in_types = (T.OPNumeric,)
    out_type = T.RealNN

    def __init__(self, default: float = 0.0, uid: Optional[str] = None):
        super().__init__(uid=uid, default=default)
        self.default = float(default)

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        v = np.asarray(cols[0].data["value"], dtype=np.float64)
        m = np.asarray(cols[0].data["mask"]).astype(bool)
        fill = float(v[m].mean()) if m.any() else self.default
        return FillMissingWithMeanModel(fill)


class ScalerTransformer(Transformer):
    """Invertible scaling of a Real feature: 'linear' (slope, intercept) or
    'log'. The args are stage params, so `DescalerTransformer` inverts by
    walking its second input's origin stage."""

    in_types = (T.Real,)
    out_type = T.Real

    def __init__(self, scaling_type: str = "linear", slope: float = 1.0,
                 intercept: float = 0.0, uid: Optional[str] = None):
        if scaling_type not in ("linear", "log"):
            raise ValueError(f"unknown scaling_type {scaling_type!r}")
        super().__init__(uid=uid, scaling_type=scaling_type, slope=slope,
                         intercept=intercept)
        self.scaling_type = scaling_type
        self.slope, self.intercept = float(slope), float(intercept)

    def device_apply(self, enc, dev):
        x, m = dev[0]["value"], dev[0]["mask"].bool()
        if self.scaling_type == "linear":
            v = mul_add_const(x, self.slope, self.intercept)
        else:
            v = torch.log(torch.where(x > 0, x, float("nan")))
            m = m & torch.isfinite(v)
            v = torch.where(m, v, 0.0)
        return {"value": v, "mask": m.to(torch.float32)}

    def invert(self, value: torch.Tensor, mask: torch.Tensor):
        if self.scaling_type == "linear":
            slope = self.slope if self.slope != 0 else 1.0
            return div_const(value - _f32(self.intercept), slope), mask
        return torch.exp(value), mask


class DescalerTransformer(Transformer):
    """(scaled value, scaled feature) → Real: the inverse of the
    ScalerTransformer that produced input 2, applied to input 1."""

    in_types = (T.Real, T.Real)
    out_type = T.Real

    def _scaler(self) -> ScalerTransformer:
        origin = self.input_features[1].origin_stage
        if not isinstance(origin, ScalerTransformer):
            raise TypeError(
                "DescalerTransformer input 2 must be produced by a "
                f"ScalerTransformer; got {type(origin).__name__}")
        return origin

    def device_apply(self, enc, dev):
        x, m = dev[0]["value"], dev[0]["mask"]
        v, m = self._scaler().invert(x, m)
        return {"value": v, "mask": m}


class _Quantiles(torch.nn.Module):
    """A calibrator's fitted quantiles as an f32 buffer."""

    def __init__(self, quantiles: np.ndarray):
        super().__init__()
        self.register_buffer("q", torch.as_tensor(
            np.asarray(quantiles, dtype=np.float32)))


class PercentileCalibratorModel(Transformer):
    in_types = (T.OPNumeric,)
    out_type = T.RealNN

    def __init__(self, quantiles: Sequence[float], uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.quantiles = np.asarray(quantiles, dtype=np.float64)

    def device_constants(self, device):
        return _Quantiles(self.quantiles).to(device)

    def device_apply_with(self, consts, enc, dev):
        x, m = dev[0]["value"], dev[0]["mask"].bool()
        buckets = torch.searchsorted(consts.q, x.contiguous(),
                                     right=True).to(torch.float32)
        hi = float(len(self.quantiles))
        v = torch.clamp(buckets * _f32(99.0 / max(hi, 1.0)), 0.0, 99.0)
        return {"value": torch.where(m, torch.round(v), 0.0),
                "mask": m.to(torch.float32)}

    def get_params(self):
        return {"quantiles": self.quantiles.tolist()}


class PercentileCalibrator(Estimator):
    """RealNN score → percentile bucket in [0, 99] via fitted quantiles."""

    in_types = (T.OPNumeric,)
    out_type = T.RealNN

    def __init__(self, buckets: int = 100, uid: Optional[str] = None):
        super().__init__(uid=uid, buckets=buckets)
        self.buckets = int(buckets)

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        v = np.asarray(cols[0].data["value"], dtype=np.float64)
        m = np.asarray(cols[0].data["mask"]).astype(bool)
        vals = v[m]
        if vals.size == 0:
            return PercentileCalibratorModel([0.0])
        qs = np.quantile(vals, np.linspace(0, 1, self.buckets + 1)[1:-1])
        return PercentileCalibratorModel(np.unique(qs))
