from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, ModelSelector, ModelSelectorSummary,
    ValidationResult)
from transmogrifai_tpu_torch.selector.splitters import (
    DataBalancer, DataSplitter)
from transmogrifai_tpu_torch.selector.validators import (
    OpCrossValidation, OpTrainValidationSplit)

__all__ = ["BinaryClassificationModelSelector", "DataBalancer",
           "DataSplitter", "ModelSelector", "ModelSelectorSummary",
           "OpCrossValidation", "OpTrainValidationSplit", "ValidationResult"]
