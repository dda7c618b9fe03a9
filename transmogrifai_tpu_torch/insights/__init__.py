"""Model explanation artifacts: ModelInsights and the per-record LOCO and
correlation insights."""

from transmogrifai_tpu_torch.insights.corr import (
    RecordInsightsCorr, RecordInsightsCorrModel)
from transmogrifai_tpu_torch.insights.loco import (
    RecordInsightsLOCO, RecordInsightsParser)
from transmogrifai_tpu_torch.insights.model_insights import (
    DerivedFeatureInsights, FeatureInsights, ModelInsights)

__all__ = ["DerivedFeatureInsights", "FeatureInsights", "ModelInsights",
           "RecordInsightsCorr", "RecordInsightsCorrModel",
           "RecordInsightsLOCO", "RecordInsightsParser"]
