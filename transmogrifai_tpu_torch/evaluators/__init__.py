from transmogrifai_tpu_torch.evaluators.evaluators import (
    BinaryClassificationEvaluator, BinScoreEvaluator, Evaluator, Evaluators,
    ForecastEvaluator, LambdaEvaluator, MultiClassificationEvaluator,
    RegressionEvaluator)
from transmogrifai_tpu_torch.evaluators.metrics import (
    BinaryClassificationMetrics, MultiClassificationMetrics,
    RegressionMetrics, aupr_score, auroc_score, binary_metrics,
    multiclass_metrics, regression_metrics)

__all__ = ["BinaryClassificationEvaluator", "BinaryClassificationMetrics",
           "BinScoreEvaluator", "Evaluator", "Evaluators",
           "ForecastEvaluator", "LambdaEvaluator", "MultiClassificationEvaluator",
           "MultiClassificationMetrics", "RegressionEvaluator",
           "RegressionMetrics", "aupr_score", "auroc_score",
           "binary_metrics", "multiclass_metrics", "regression_metrics"]
