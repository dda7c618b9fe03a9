"""Predictor base classes: a model maps the (label, features) inputs to the
Prediction pytree `{"prediction", "rawPrediction", "probability"}` of
tensors; an estimator fits one from a feature matrix, labels and row
weights (`fit_arrays`)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, Transformer)


class PredictionModel(Transformer):
    """Fitted predictor: `device_apply_with` returns the Prediction dict.
    Subclasses build their fitted arrays as an `nn.Module` in
    `device_constants(device)` and apply it to the feature matrix."""

    out_type = T.Prediction

    def predict(self, consts: torch.nn.Module,
                X: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError(type(self).__name__)

    def predict_arrays(self, X: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The Prediction dict of a feature matrix, on X's device."""
        return self.predict(self.device_constants(X.device), X)

    def device_apply_with(self, consts, enc, dev):
        # inputs are (label, features); the label is unused at scoring
        return self.predict(consts, dev[-1])


class PredictorEstimator(Estimator):
    """Base for model estimators. Subclasses implement `fit_arrays(X, y,
    w, ctx)` over tensors on the fit's device; `w` is a per-row weight
    vector. Warm starts (`init_params`) are not ported yet."""

    in_types = (T.RealNN, T.OPVector)
    out_type = T.Prediction
    init_params: Optional[Dict[str, Any]] = None

    def fit_arrays(self, X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   ctx: FitContext) -> PredictionModel:
        raise NotImplementedError(type(self).__name__)

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        label, vec = cols
        y = torch.as_tensor(np.asarray(label.data["value"], np.float32),
                            device=ctx.device)
        X = vec.device_value(ctx.device)
        return self.fit_arrays(X, y, torch.ones_like(y), ctx)


def regression_pred(pred: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The Prediction dict of regression values (n,): the values as the
    prediction and the one-column rawPrediction, no probability column."""
    return {"prediction": pred, "rawPrediction": pred[:, None],
            "probability": pred.new_zeros((pred.shape[0], 0))}


def binary_margin_pred(margin: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The Prediction dict of binary margins (n,): class 1 where the
    margin is positive, rawPrediction (−m, m), sigmoid probabilities."""
    p1 = torch.sigmoid(margin)
    return {"prediction": (margin > 0).to(torch.float32),
            "rawPrediction": torch.stack([-margin, margin], dim=-1),
            "probability": torch.stack([1 - p1, p1], dim=-1)}


def infer_n_classes(y: np.ndarray) -> int:
    """Label cardinality for classification (labels must be 0..k-1)."""
    k = int(np.asarray(y).max(initial=0)) + 1
    return max(k, 2)


Param = Union[float, int, Sequence[float], torch.Tensor]

# where ROADMAP.md queues the warm starts the estimators raise on
WARM_STARTS = "queue 1: selector and workflow completeness"


def per_pair(v: Param, P: int, device, dtype=torch.float32) -> torch.Tensor:
    """A hyperparameter of P fits at once as a (P,) tensor: one value for
    every pair, or one per pair."""
    t = torch.as_tensor(v, dtype=dtype, device=device)
    if t.dim() == 0:
        t = t.expand(P)
    if t.shape != (P,):
        raise ValueError(f"per-pair parameter of shape {tuple(t.shape)}, "
                         f"expected ({P},)")
    return t.contiguous()
