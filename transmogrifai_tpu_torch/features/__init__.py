from transmogrifai_tpu_torch.features.feature import Feature, FeatureBuilder
from transmogrifai_tpu_torch.features.dag import (
    FeatureCycleError, clone_graph, topological_layers)

__all__ = ["Feature", "FeatureBuilder", "FeatureCycleError", "clone_graph",
           "topological_layers"]
