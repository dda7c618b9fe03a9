from transmogrifai_tpu_torch.evaluators.evaluators import (
    BinaryClassificationEvaluator, Evaluator)
from transmogrifai_tpu_torch.evaluators.metrics import (
    BinaryClassificationMetrics, aupr_score, auroc_score, binary_metrics)

__all__ = ["BinaryClassificationEvaluator", "BinaryClassificationMetrics",
           "Evaluator", "aupr_score", "auroc_score", "binary_metrics"]
