from transmogrifai_tpu_torch.features.feature import Feature
from transmogrifai_tpu_torch.features.dag import (
    FeatureCycleError, topological_layers)

__all__ = ["Feature", "FeatureCycleError", "topological_layers"]
