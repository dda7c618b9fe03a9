"""The port's model families and the isotonic calibrator, under the JAX
package's names (`transmogrifai_tpu/models/__init__.py`)."""

from transmogrifai_tpu_torch.models.base import (
    PredictionModel, PredictorEstimator)
from transmogrifai_tpu_torch.models.isotonic import (
    IsotonicCalibratorModel, IsotonicRegressionCalibrator)
from transmogrifai_tpu_torch.models.glm import (
    GLMModel, OpGeneralizedLinearRegression)
from transmogrifai_tpu_torch.models.linear import (
    LinearRegressionModel, OpLinearRegression)
from transmogrifai_tpu_torch.models.linear_svc import (
    LinearSVCModel, OpLinearSVC)
from transmogrifai_tpu_torch.models.logistic import (
    LogisticRegressionModel, OpLogisticRegression)
from transmogrifai_tpu_torch.models.mlp import (
    MLPModel, OpMultilayerPerceptronClassifier)
from transmogrifai_tpu_torch.models.naive_bayes import (
    NaiveBayesModel, OpNaiveBayes)
from transmogrifai_tpu_torch.models.trees import (
    OpDecisionTreeClassifier, OpDecisionTreeRegressor, OpGBTClassifier,
    OpGBTRegressor, OpRandomForestClassifier, OpRandomForestRegressor,
    OpXGBoostClassifier, OpXGBoostRegressor)

__all__ = [
    "PredictorEstimator", "PredictionModel",
    "OpLogisticRegression", "LogisticRegressionModel",
    "OpLinearRegression", "LinearRegressionModel",
    "OpNaiveBayes", "NaiveBayesModel",
    "OpLinearSVC", "LinearSVCModel",
    "OpMultilayerPerceptronClassifier", "MLPModel",
    "OpGeneralizedLinearRegression", "GLMModel",
    "OpDecisionTreeClassifier", "OpDecisionTreeRegressor",
    "OpRandomForestClassifier", "OpRandomForestRegressor",
    "OpGBTClassifier", "OpGBTRegressor",
    "OpXGBoostClassifier", "OpXGBoostRegressor",
    "IsotonicRegressionCalibrator", "IsotonicCalibratorModel",
]
