"""Isotonic regression calibrator (pool-adjacent-violators).

The port's counterpart of the JAX package's `models/isotonic.py`
(`IsotonicRegressionCalibrator.scala`, Spark IsotonicRegression). The PAV
fit runs on the host in f64 (it is sequential), as in the JAX package;
the fitted model interpolates the f32 knots piecewise-linearly on the
device, as plain torch: `torch.searchsorted` plus a lerp.

The lerp is `jnp.interp`'s formula, rounded as the JAX package rounds
it. `jnp.interp` is itself a jitted function, so the JAX package's eager
transform and its compiled scorer both run it as one XLA program, and
XLA's CPU program contracts ``fp[i-1] + (delta / dx) * df`` into one
fused multiply-add in both; the port rounds it once (`fma_f32`) in both
paths too. PAV knots repeat (a one-point block gives ``[x, x]``, and tied
scores end one block and start the next at the same value), so the
zero-width branch (`dx0`) and the right-side search are live on every
real fit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, Transformer, fma_f32)

# jnp.interp's zero-width threshold for f32 knots: np.spacing(eps_f32)
_DX0 = float(np.spacing(np.finfo(np.float32).eps))
_F32_TINY = float(np.finfo(np.float32).tiny)  # the least normal f32


def pav_fit(x: np.ndarray, y: np.ndarray, w: Optional[np.ndarray] = None,
            increasing: bool = True):
    """Pool-adjacent-violators → (boundaries, values) knots, f64 (the JAX
    package's `pav_fit`, step for step)."""
    order = np.argsort(x, kind="mergesort")
    xs, ys = x[order], y[order].astype(np.float64)
    ws = (np.ones_like(ys) if w is None else w[order]).astype(np.float64)
    if not increasing:
        ys = -ys
    # blocks as (weighted mean, weight, start index)
    means: List[float] = []
    weights: List[float] = []
    starts: List[int] = []
    for i in range(len(ys)):
        means.append(ys[i])
        weights.append(ws[i])
        starts.append(i)
        while len(means) > 1 and means[-2] > means[-1]:
            m2, w2 = means.pop(), weights.pop()
            starts.pop()
            means[-1] = (means[-1] * weights[-1] + m2 * w2) \
                / (weights[-1] + w2)
            weights[-1] += w2
    bounds, values = [], []
    for bi, s in enumerate(starts):
        e = starts[bi + 1] - 1 if bi + 1 < len(starts) else len(xs) - 1
        v = means[bi] if increasing else -means[bi]
        bounds.extend([xs[s], xs[e]])
        values.extend([v, v])
    return (np.asarray(bounds, dtype=np.float64),
            np.asarray(values, dtype=np.float64))


class _Knots(torch.nn.Module):
    """The f32 knots (boundaries xp, values fp) as buffers."""

    def __init__(self, boundaries: np.ndarray, values: np.ndarray):
        super().__init__()
        self.register_buffer("xp", torch.as_tensor(boundaries))
        self.register_buffer("fp", torch.as_tensor(values))


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """`jnp.interp(x, xp, fp)` for f32 tensors, rounded as XLA's CPU
    program rounds it: i = clip(searchsorted(xp, x, right), 1, len − 1);
    where |dx| ≤ spacing(eps) the left value, else fp[i−1] + (delta / dx)
    · df as one fused multiply-add; fp[0] strictly below xp[0], fp[−1]
    strictly above xp[−1]. Subnormal inputs count as zero (the program
    flushes them, F11)."""
    x = torch.where(x.abs() < _F32_TINY, torch.zeros_like(x), x)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    df = fp[i] - f0
    dx = xp[i] - x0
    dx0 = dx.abs() <= _DX0
    q = (x - x0) / torch.where(dx0, torch.ones_like(dx), dx)
    f = torch.where(dx0, f0, fma_f32(q, df, f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class IsotonicCalibratorModel(Transformer):
    """Fitted calibrator: the score input interpolated on the knots."""

    out_type = T.RealNN

    def __init__(self, boundaries: Sequence[float], values: Sequence[float],
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.boundaries = np.asarray(boundaries, dtype=np.float32)
        self.values = np.asarray(values, dtype=np.float32)

    def device_constants(self, device):
        return _Knots(self.boundaries, self.values).to(device)

    def device_apply_with(self, consts, enc, dev):
        score = dev[-1]
        return {"value": interp(score["value"], consts.xp, consts.fp),
                "mask": score["mask"]}

    def get_params(self):
        return {"boundaries": self.boundaries.tolist(),
                "values": self.values.tolist()}


class IsotonicRegressionCalibrator(Estimator):
    """(RealNN label, RealNN score) → calibrated RealNN."""

    in_types = (T.RealNN, T.RealNN)
    out_type = T.RealNN

    def __init__(self, increasing: bool = True, uid: Optional[str] = None):
        super().__init__(uid=uid, increasing=increasing)
        self.increasing = increasing

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        label, score = cols
        y = np.asarray(label.data["value"], dtype=np.float64)
        x = np.asarray(score.data["value"], dtype=np.float64)
        bounds, values = pav_fit(x, y, increasing=self.increasing)
        return IsotonicCalibratorModel(bounds, values)
