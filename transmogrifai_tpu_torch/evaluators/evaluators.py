"""Evaluators: score a Prediction column against a label column.

The port's counterpart of the JAX package's `evaluators/evaluators.py`:
binary, multiclass and regression, the bin-score calibration
(`BinScoreEvaluator`), forecast (`ForecastEvaluator`) and custom-metric
(`LambdaEvaluator`) evaluators, and the `Evaluators` factories. An
Evaluator is not a DAG stage; it consumes (label Column, prediction
Column) and returns a metrics object with `to_json()`. `default_metric`
names the value used for model selection. Every metric is host numpy in
f64; a selector sweeps the evaluators without a device metric through the
host-metric fallback (`parallel/sweep.py`).
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


class BinScoreEvaluator(Evaluator):
    """Score-decile calibration (`OpBinScoreEvaluator.scala:53`)."""

    name = "binScoreEval"
    default_metric = "BrierScore"
    is_larger_better = False

    def __init__(self, num_bins: int = 10):
        self.num_bins = num_bins

    def evaluate(self, label: Column, prediction: Column):
        from transmogrifai_tpu_torch.evaluators.metrics import bin_score_metrics
        y = np.asarray(label.data["value"], dtype=np.float64)
        prob = np.asarray(prediction.data["probability"])
        scores = (prob[:, 1] if prob.ndim == 2 and prob.shape[1] >= 2
                  else np.asarray(prediction.data["prediction"], dtype=np.float64))
        return bin_score_metrics(y, scores, self.num_bins)


class ForecastEvaluator(Evaluator):
    """SMAPE/seasonal-error metrics (`OpForecastEvaluator.scala:59`)."""

    name = "forecastEval"
    default_metric = "SMAPE"
    is_larger_better = False

    def __init__(self, seasonal_window: int = 1):
        self.seasonal_window = seasonal_window

    def evaluate(self, label: Column, prediction: Column):
        from transmogrifai_tpu_torch.evaluators.metrics import forecast_metrics
        y = np.asarray(label.data["value"], dtype=np.float64)
        pred = np.asarray(prediction.data["prediction"], dtype=np.float64)
        return forecast_metrics(y, pred, self.seasonal_window)


class LambdaEvaluator(Evaluator):
    """Custom-metric evaluator (`Evaluators.scala` custom lambda factories)."""

    def __init__(self, name: str, fn, is_larger_better: bool = True):
        self.name = name
        self.default_metric = name
        self.fn = fn
        self.is_larger_better = is_larger_better

    def evaluate(self, label: Column, prediction: Column):
        value = float(self.fn(label, prediction))
        metric_name = self.default_metric

        class _M:
            def to_json(self) -> dict:
                return {metric_name: value}

        return _M()


class Evaluators:
    """Thin factories mirroring `Evaluators.scala:40-316`:
    `Evaluators.BinaryClassification.au_pr()` etc."""

    class BinaryClassification:
        @staticmethod
        def au_pr():
            return BinaryClassificationEvaluator(metric="AuPR")

        @staticmethod
        def au_roc():
            return BinaryClassificationEvaluator(metric="AuROC")

        @staticmethod
        def precision():
            return BinaryClassificationEvaluator(metric="Precision")

        @staticmethod
        def recall():
            return BinaryClassificationEvaluator(metric="Recall")

        @staticmethod
        def f1():
            return BinaryClassificationEvaluator(metric="F1")

        @staticmethod
        def error():
            return BinaryClassificationEvaluator(metric="Error")

        @staticmethod
        def brier_score():
            return BinScoreEvaluator()

        @staticmethod
        def custom(metric_name: str, fn, is_larger_better: bool = True):
            return LambdaEvaluator(metric_name, fn, is_larger_better)

    class MultiClassification:
        @staticmethod
        def f1():
            return MultiClassificationEvaluator(metric="F1")

        @staticmethod
        def precision():
            return MultiClassificationEvaluator(metric="Precision")

        @staticmethod
        def recall():
            return MultiClassificationEvaluator(metric="Recall")

        @staticmethod
        def error():
            return MultiClassificationEvaluator(metric="Error")

        @staticmethod
        def custom(metric_name: str, fn, is_larger_better: bool = True):
            return LambdaEvaluator(metric_name, fn, is_larger_better)

    class Regression:
        @staticmethod
        def rmse():
            return RegressionEvaluator(metric="RMSE")

        @staticmethod
        def mse():
            return RegressionEvaluator(metric="MSE")

        @staticmethod
        def mae():
            return RegressionEvaluator(metric="MAE")

        @staticmethod
        def r2():
            return RegressionEvaluator(metric="R2")

        @staticmethod
        def custom(metric_name: str, fn, is_larger_better: bool = True):
            return LambdaEvaluator(metric_name, fn, is_larger_better)

    class Forecast:
        @staticmethod
        def smape(seasonal_window: int = 1):
            return ForecastEvaluator(seasonal_window)
