from transmogrifai_tpu_torch.selector.combiner import (
    SelectedCombinerModel, SelectedModelCombiner)
from transmogrifai_tpu_torch.selector.grids import (
    ParamGridBuilder, RandomParamBuilder)
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
           "ParamGridBuilder", "RandomParamBuilder",
           "RegressionModelSelector", "SelectedCombinerModel",
           "SelectedModelCombiner", "ValidationResult"]
