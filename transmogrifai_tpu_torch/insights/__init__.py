"""Model explanation artifacts: ModelInsights."""

from transmogrifai_tpu_torch.insights.model_insights import (
    DerivedFeatureInsights, FeatureInsights, ModelInsights)

__all__ = ["DerivedFeatureInsights", "FeatureInsights", "ModelInsights"]
