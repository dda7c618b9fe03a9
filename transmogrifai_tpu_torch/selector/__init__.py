from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, ModelSelector, ModelSelectorSummary,
    MultiClassificationModelSelector, RegressionModelSelector,
    ValidationResult)
from transmogrifai_tpu_torch.selector.splitters import (
    DataBalancer, DataCutter, DataSplitter)
from transmogrifai_tpu_torch.selector.validators import (
    OpCrossValidation, OpTrainValidationSplit)

__all__ = ["BinaryClassificationModelSelector", "DataBalancer",
           "DataCutter", "DataSplitter", "ModelSelector",
           "ModelSelectorSummary", "MultiClassificationModelSelector",
           "OpCrossValidation", "OpTrainValidationSplit",
           "RegressionModelSelector", "ValidationResult"]
