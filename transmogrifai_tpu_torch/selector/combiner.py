"""SelectedModelCombiner: blend the Prediction outputs of two ModelSelectors.

The port's counterpart of the JAX package's `selector/combiner.py`
(`SelectedModelCombiner.scala:72-180`, strategies from
`CombinationStrategy.scala`): the weights come from each selector's
validation metric — `best` passes the winner through, `weighted` mixes by
relative metric, `equal` averages. The fitted combiner is a device stage
of plain torch: it serves through `score_compiled` and its CUDA graphs
like any other.

Rounding follows the JAX package's compiled scorer (F11): there the
blend ``w1·a + w2·b`` of fitted constants is one XLA program, which
contracts it into ``fma(w1, a, w2·b)``, while the eager transform rounds
each product and the sum. The port rounds the same way in each path
(`stages.base.add_scaled_const`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, Transformer, add_scaled_const)

BEST, WEIGHTED, EQUAL = "best", "weighted", "equal"


class SelectedCombinerModel(Transformer):
    """Fitted combiner: prediction = argmax of the blended probabilities,
    or the blended prediction for regression (no probability columns)."""

    out_type = T.Prediction

    def __init__(self, weight1: float = 0.5, weight2: float = 0.5,
                 strategy: str = BEST, metric_name: str = "",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.weight1 = float(weight1)
        self.weight2 = float(weight2)
        self.strategy = strategy
        self.metric_name = metric_name
        self.summary = None

    def device_apply(self, enc, dev):
        _, p1, p2 = dev
        w1, w2 = self.weight1, self.weight2
        prob = add_scaled_const(p1["probability"], w1, p2["probability"], w2)
        raw = add_scaled_const(p1["rawPrediction"], w1, p2["rawPrediction"],
                               w2)
        if prob.shape[1] > 0:
            pred = torch.argmax(prob, dim=1).to(torch.float32)
        else:  # regression predictions blend directly
            pred = add_scaled_const(p1["prediction"], w1, p2["prediction"],
                                    w2)
        return {"prediction": pred, "probability": prob,
                "rawPrediction": raw}

    def get_params(self) -> Dict[str, Any]:
        return {"weight1": self.weight1, "weight2": self.weight2,
                "strategy": self.strategy, "metric_name": self.metric_name}


class SelectedModelCombiner(Estimator):
    """(RealNN, Prediction, Prediction) → Prediction. Both prediction
    inputs must come from ModelSelectors: their summaries carry the
    validation metric the weights come from."""

    in_types = (T.RealNN, T.Prediction, T.Prediction)
    out_type = T.Prediction

    def __init__(self, strategy: str = BEST, uid: Optional[str] = None):
        if strategy not in (BEST, WEIGHTED, EQUAL):
            raise ValueError(
                f"strategy must be best/weighted/equal, got {strategy!r}")
        super().__init__(uid=uid, strategy=strategy)
        self.strategy = strategy

    def _selector_metric(self, feature) -> tuple:
        stage = feature.origin_stage
        summary = getattr(stage, "summary", None)
        if summary is None:
            est = getattr(stage, "_estimator", None)
            summary = getattr(est, "summary", None)
        if summary is None:
            raise ValueError(
                "SelectedModelCombiner inputs must be ModelSelector outputs "
                f"(no summary on {feature.name!r})")
        metric = summary.holdout_metrics.get(summary.metric_name)
        if metric is None:  # a real 0.0 must not fall through
            metric = summary.train_metrics.get(summary.metric_name)
        if metric is None:
            sign = 1.0 if getattr(summary, "larger_is_better", True) else -1.0
            best = max(summary.validation_results,
                       key=lambda r: sign * r.mean_metric)
            metric = best.mean_metric
        return float(metric), summary

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        f1, f2 = self.input_features[1], self.input_features[2]
        m1, s1 = self._selector_metric(f1)
        m2, s2 = self._selector_metric(f2)
        larger_better = getattr(s1, "larger_is_better", True)
        if self.strategy == BEST:
            first_wins = (m1 > m2) == larger_better or m1 == m2
            w1, w2 = (1.0, 0.0) if first_wins else (0.0, 1.0)
        elif self.strategy == WEIGHTED:
            total = m1 + m2
            if not total:
                w1, w2 = 0.5, 0.5
            elif larger_better:
                w1, w2 = m1 / total, m2 / total
            else:  # smaller is better (RMSE): the better model gets the
                w1, w2 = m2 / total, m1 / total  # larger weight
        else:
            w1, w2 = 0.5, 0.5
        model = SelectedCombinerModel(
            w1, w2, self.strategy, metric_name=s1.metric_name)
        model.summary = s1 if w1 >= w2 else s2
        return model
