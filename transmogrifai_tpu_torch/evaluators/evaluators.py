"""Evaluators: score a Prediction column against a label column.

The port's counterpart of the JAX package's `evaluators/evaluators.py`
(binary, multiclass and regression). An Evaluator is not a DAG stage; it
consumes (label Column, prediction Column) and returns a metrics
dataclass. `default_metric` names the value used for model selection.
"""

from __future__ import annotations

import numpy as np

from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.evaluators.metrics import (
    binary_metrics, multiclass_metrics, regression_metrics)


class Evaluator:
    name: str = "evaluator"
    default_metric: str = ""
    is_larger_better: bool = True

    def evaluate(self, label: Column, prediction: Column):
        raise NotImplementedError

    def metric_value(self, label: Column, prediction: Column) -> float:
        m = self.evaluate(label, prediction).to_json()
        return float(m[self.default_metric])


class BinaryClassificationEvaluator(Evaluator):
    """AuPR default, matching BinaryClassificationModelSelector's default."""

    name = "binEval"
    default_metric = "AuPR"

    def __init__(self, metric: str = "AuPR", threshold: float = 0.5):
        self.default_metric = metric
        self.threshold = threshold
        self.is_larger_better = metric not in ("Error",)

    def evaluate(self, label: Column, prediction: Column):
        y = np.asarray(label.data["value"], dtype=np.float64)
        prob = np.asarray(prediction.data["probability"])
        if prob.ndim == 2 and prob.shape[1] >= 2:
            scores = prob[:, 1]
        else:
            scores = np.asarray(prediction.data["prediction"],
                                dtype=np.float64)
        return binary_metrics(y, scores, self.threshold)


class MultiClassificationEvaluator(Evaluator):
    """F1 default (OpMultiClassificationEvaluator)."""

    name = "multiEval"
    default_metric = "F1"

    def __init__(self, metric: str = "F1"):
        self.default_metric = metric
        self.is_larger_better = metric not in ("Error",)

    def evaluate(self, label: Column, prediction: Column):
        y = np.asarray(label.data["value"], dtype=np.float64)
        pred = np.asarray(prediction.data["prediction"], dtype=np.float64)
        return multiclass_metrics(y, pred)


class RegressionEvaluator(Evaluator):
    """RMSE default, smaller is better (OpRegressionEvaluator)."""

    name = "regEval"
    default_metric = "RMSE"
    is_larger_better = False

    def __init__(self, metric: str = "RMSE"):
        self.default_metric = metric
        self.is_larger_better = metric in ("R2",)

    def evaluate(self, label: Column, prediction: Column):
        y = np.asarray(label.data["value"], dtype=np.float64)
        pred = np.asarray(prediction.data["prediction"], dtype=np.float64)
        return regression_metrics(y, pred)
