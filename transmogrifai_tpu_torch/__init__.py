"""transmogrifai_tpu_torch — the PyTorch/CUDA port of the JAX package
`transmogrifai_tpu`.

This package trains the README quickstart — transmogrify, the sanity
checker and the default LR + RF + XGB binary sweep — and the Iris
(multiclass: LR + RF) and Boston (regression: linear + RF + GBT) examples
with their default selectors, and the selectors' other families (L-BFGS
logistic regression, linear SVC, GLM, naive Bayes, MLP, decision trees,
multiclass XGBoost), and serves the models that it or the JAX package
(`transmogrifai_tpu`) trained, on an NVIDIA GPU (Hopper). Feature
validation runs at the reference's full scope: the RawFeatureFilter,
workflow-level CV, Pearson or Spearman sanity checks at any width, and
the numeric bucketizers. It runs as an application (`workflow/runner.py`:
`WorkflowRunner` over an `OpParams` JSON, with a trace, an event log, a
run profile and a goodput report), reads through readers with
event-time aggregation (`readers/`, `aggregators.py`), warm-starts every
family, sweeps random grids, custom evaluators and unknown estimator
classes (the host-metric fallbacks), blends selectors
(`SelectedModelCombiner`) and calibrates scores
(`IsotonicRegressionCalibrator`). Out of core
(`parallel/bigdata.py`) it streams a memmapped columnar store into
resident bf16 and int8 matrices and fits the elastic-net grid, lockstep
forests and boosting at millions of rows. The tree learner's histograms,
sibling subtraction, split search, routing and leaf sums, the binned
AuPR, the sweep's confusion counts and regression sums, the binning, the
ensemble walk, the class-tree walk of softmax boosting, the quantized
wire's dequantization, the out-of-core row writes and the wide sanity
check's extraction of correlated pairs are kernels written by hand in
CUDA C++ (`csrc/`). It imports torch and numpy and nothing of
the JAX package.

    from transmogrifai_tpu_torch import (
        BinaryClassificationModelSelector, Dataset, FeatureBuilder,
        Workflow, load_model, transmogrify)
    ds = Dataset.from_csv("titanic.csv")
    preds, label = FeatureBuilder.from_dataset(ds, response="survived")
    checked = label.sanity_check(transmogrify(preds),
                                 remove_bad_features=True)
    pred = BinaryClassificationModelSelector.with_cross_validation() \
        .set_input(label, checked).get_output()
    model = Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).train()          # device="cuda" by default
    model.save("model_dir")                     # the JAX package's format
    scores = load_model("model_dir").score_compiled(ds)

Entry points default to ``device="cuda"`` and raise without CUDA unless
the caller passes ``device="cpu"``.
"""

from transmogrifai_tpu_torch import dsl  # noqa: F401  (attaches the DSL)
from transmogrifai_tpu_torch.aggregators import CutOffTime, Event
from transmogrifai_tpu_torch.automl.transmogrify import transmogrify
from transmogrifai_tpu_torch.data.dataset import Dataset
from transmogrifai_tpu_torch.features.feature import FeatureBuilder
from transmogrifai_tpu_torch.models import (
    IsotonicRegressionCalibrator, OpDecisionTreeClassifier, OpDecisionTreeRegressor, OpGBTClassifier,
    OpGBTRegressor, OpGeneralizedLinearRegression, OpLinearRegression,
    OpLinearSVC, OpLogisticRegression, OpMultilayerPerceptronClassifier,
    OpNaiveBayes, OpRandomForestClassifier, OpRandomForestRegressor,
    OpXGBoostClassifier, OpXGBoostRegressor)
from transmogrifai_tpu_torch.readers import DataReaders
from transmogrifai_tpu_torch.selector.combiner import SelectedModelCombiner
from transmogrifai_tpu_torch.selector.grids import (
    ParamGridBuilder, RandomParamBuilder)
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, MultiClassificationModelSelector,
    RegressionModelSelector)
from transmogrifai_tpu_torch.workflow.serialization import (
    from_jax_params, load_model)
from transmogrifai_tpu_torch.workflow.workflow import Workflow, WorkflowModel

__all__ = ["BinaryClassificationModelSelector", "CutOffTime", "DataReaders",
           "Dataset", "Event", "FeatureBuilder",
           "IsotonicRegressionCalibrator",
           "MultiClassificationModelSelector", "OpDecisionTreeClassifier",
           "OpDecisionTreeRegressor", "OpGBTClassifier", "OpGBTRegressor",
           "OpGeneralizedLinearRegression", "OpLinearRegression",
           "OpLinearSVC", "OpLogisticRegression",
           "OpMultilayerPerceptronClassifier", "OpNaiveBayes",
           "OpRandomForestClassifier", "OpRandomForestRegressor",
           "OpXGBoostClassifier", "OpXGBoostRegressor",
           "ParamGridBuilder", "RandomParamBuilder",
           "RegressionModelSelector", "SelectedModelCombiner", "Workflow",
           "WorkflowModel",
           "from_jax_params", "load_model", "transmogrify"]
