"""Saved models of the selectors' other families in the JAX package's
format, both ways: a model of each new class (L-BFGS logistic regression,
linear SVC, naive Bayes, decision tree, MLP and multiclass XGBoost in the
Iris example's workflow; GLM and regression tree in the Boston example's)
saved by the port loads in the JAX package, and the JAX package's save of
it loads in the port; each scores alike in both (rawPrediction within
2e-5, probability within 1e-5, predicted classes equal, regression
predictions within 1e-6 relative), and the port's own reload scores
exactly as the model it saved.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_multiclass import (  # noqa: E402
    PRED_KEYS, example_dataset, example_pipeline, package, prediction_of)

CLASSES = {
    "iris": [("OpLogisticRegression", {"reg_param": 0.01, "max_iter": 20}),
             ("OpLinearSVC", {"reg_param": 0.01, "max_iter": 20}),
             ("OpNaiveBayes", {}),
             ("OpDecisionTreeClassifier", {"max_depth": 4}),
             ("OpMultilayerPerceptronClassifier",
              {"hidden_layers": (5,), "max_iter": 20}),
             ("OpXGBoostClassifier", {"n_estimators": 4, "max_depth": 3})],
    "boston": [("OpGeneralizedLinearRegression",
                {"family": "poisson", "link": "log", "max_iter": 20}),
               ("OpDecisionTreeRegressor", {"max_depth": 5})],
}
MODEL_CLASS = {"OpLogisticRegression": "LogisticRegressionModel",
               "OpLinearSVC": "LinearSVCModel",
               "OpNaiveBayes": "NaiveBayesModel",
               "OpDecisionTreeClassifier": "ForestClassificationModel",
               "OpMultilayerPerceptronClassifier": "MLPModel",
               "OpXGBoostClassifier": "GBTMulticlassModel",
               "OpGeneralizedLinearRegression": "GLMModel",
               "OpDecisionTreeRegressor": "ForestRegressionModel"}


@pytest.fixture(scope="module")
def trained():
    """The port's Iris and Boston workflows (one decision-tree config
    each) and, per example, its selector's training matrix."""
    ns = package("port")
    from transmogrifai_tpu_torch import types as PT

    out = {}
    for example, est in (("iris", ns.models.OpDecisionTreeClassifier()),
                         ("boston", ns.models.OpDecisionTreeRegressor())):
        ds = example_dataset(ns, example)
        label, pred = example_pipeline(ns, example,
                                       [(est, [{"max_depth": 3}])])
        model = ns.Workflow().set_result_features(pred, label) \
            .set_input_dataset(ds).train(device="cpu")
        pf = next(f for f in model.result_features
                  if f.ftype is PT.Prediction)
        cols = model.score(ds, keep_intermediate=True)
        X = cols[pf.parents[1].uid].device_value("cpu")
        y = torch.as_tensor(np.asarray(cols[pf.parents[0].uid]
                                       .data["value"], np.float32))
        out[example] = (model, ds, pf.origin_stage.uid, X, y)
    return out


def _scores_close(got, want):
    if want["probability"].shape[1]:  # classes: the same class per row
        np.testing.assert_array_equal(got["prediction"], want["prediction"])
    else:  # regression: mu = g⁻¹(eta) rounds in another order
        np.testing.assert_allclose(got["prediction"], want["prediction"],
                                   rtol=1e-6, atol=0)
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("example,name,kw", [
    (ex, name, kw) for ex, cases in CLASSES.items() for name, kw in cases])
def test_new_model_classes_save_and_load_both_ways(trained, tmp_path,
                                                   example, name, kw):
    import transmogrifai_tpu.automl.sanity_checker  # noqa: F401 (ROADMAP F6)
    from transmogrifai_tpu.workflow.serialization import (
        load_model as jax_load)
    from transmogrifai_tpu_torch import load_model
    from transmogrifai_tpu_torch.stages.base import FitContext

    ns = package("port")
    model, ds, uid, X, y = trained[example]
    if name == "OpLinearSVC":
        y = (y == 0).to(torch.float32)
    fitted = getattr(ns.models, name)(**kw).fit_arrays(
        X, y, torch.ones_like(y), FitContext(n_rows=len(y), seed=3))
    assert type(fitted).__name__ == MODEL_CLASS[name]
    old = model.fitted[uid]
    fitted.uid, fitted.input_features = uid, old.input_features
    fitted._output = old._output
    model.fitted[uid] = fitted
    model._compiled = None
    mine = prediction_of(model.score_compiled(ds))
    path = str(tmp_path / "port")
    model.save(path)
    again = prediction_of(load_model(path, device="cpu").score_compiled(ds))
    for k in PRED_KEYS:
        np.testing.assert_array_equal(again[k], mine[k])
    jds = example_dataset(package("jax"), example)
    jm = jax_load(path)
    theirs = prediction_of(jm.score_compiled(jds))
    _scores_close(mine, theirs)
    jpath = str(tmp_path / "jax")
    jm.save(jpath)
    back = prediction_of(load_model(jpath, device="cpu").score_compiled(ds))
    _scores_close(back, theirs)
