"""Parity of the selector's other controls with the JAX package on the CPU.

- Grids: `ParamGridBuilder` and `RandomParamBuilder` (numpy's
  `default_rng` draws in the same order) bit-equal.
- Evaluators: `BinScoreEvaluator`, `ForecastEvaluator`, `LambdaEvaluator`,
  the `Evaluators` factories and the host metrics of `metrics.py` within
  1e-12 relative (host f64 in both).
- The host-metric fallback (`HostMetricFallback`): the LR, forest and GBT
  families swept with a custom and a bin-score evaluator; fold metrics
  within the families' tolerances of PERF.md §2 (LR 1e-4, trees and XGB
  1e-2; the forest with the JAX package's draws injected), and the host
  AuPR of a custom evaluator equal to the device AuPR of the binary one.
- `_sweep_generic`: a test-local estimator class through both packages'
  generic loops; the same rows weighted in every fold's fit, fold metrics
  within 1e-6.
- Warm starts (`init_params`) of every family from the same resident fit:
  FISTA logistic and linear coefficients within 1e-5, the L-BFGS fits
  (logistic, GLM) within 1e-4 relative (F5's converged-fit rule), the
  forest's replacement trees equal with the JAX package's draws injected
  (F3's choice for tree warm refits: inject the draws, as the forest and
  decision-tree tests do; integer class sums make the tables equal), the
  GBT's appended rounds (no sampling: nothing is drawn) with equal splits
  and leaves within 1e-5; `Workflow.with_model_stages` reuses the fitted stages and
  refits what `exclude` names.
- `SelectedModelCombiner` over two LR selectors under best, weighted and
  equal: weights equal, probabilities within 1e-6, predictions equal,
  eagerly and through `score_compiled`.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_multiclass import package  # noqa: E402
from test_torch_train import jax_forest_draws  # noqa: E402

METRIC_RTOL = 1e-12
FAMILY_ATOL = {"logistic": 1e-4, "forest": 1e-2, "gbt": 1e-2}


@pytest.fixture
def exact_histograms(monkeypatch):
    from transmogrifai_tpu.models import trees as jt
    monkeypatch.setattr(jt, "HIST_PRECISION", "f32")
    return jt


# --------------------------------------------------------------------------- #
# grids                                                                       #
# --------------------------------------------------------------------------- #

def grids_of(name, seed):
    if name == "jax":
        from transmogrifai_tpu.selector import grids
    else:
        from transmogrifai_tpu_torch.selector import grids
    random = (grids.RandomParamBuilder(seed=seed)
              .uniform("reg_param", 0.001, 0.1)
              .exponential("lr", 1e-4, 1e-1)
              .uniform_int("depth", 2, 6)
              .subset("bins", [16, 32, 64]).build(25))
    cartesian = (grids.ParamGridBuilder().add("a", [1, 2, 3])
                 .add("b", ["x", "y"]).add("c", [0.5]).build())
    return random, cartesian, grids.ParamGridBuilder().build()


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_grids_bit_equal_to_jax(seed):
    got, want = grids_of("port", seed), grids_of("jax", seed)
    assert got == want
    for g, w in zip(got[0], want[0]):
        for k in g:
            assert type(g[k]) is type(w[k])


# --------------------------------------------------------------------------- #
# evaluators                                                                  #
# --------------------------------------------------------------------------- #

def flat(m) -> dict:
    """A metrics object's JSON with nested lists and dicts flattened."""
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}/{k}", x)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{prefix}/{i}", x)
        else:
            out[prefix] = v
    walk("", m.to_json() if hasattr(m, "to_json") else m)
    return out


def assert_metrics_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], float):
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                       atol=0, err_msg=k)
        else:
            assert got[k] == want[k], k


def brier_like(label, prediction):
    """A custom metric over the evaluator's columns: the mean squared gap
    of the class-1 probability and the label."""
    y = np.asarray(label.data["value"], np.float64)
    p = np.asarray(prediction.data["probability"], np.float64)[:, 1]
    return float(np.mean((p - y) ** 2))


def eval_columns(name, kind, seed=3, n=500):
    ns = package(name)
    if name == "jax":
        from transmogrifai_tpu.data.columns import Column
    else:
        from transmogrifai_tpu_torch.data.columns import Column
    rng = np.random.default_rng(seed)
    if kind == "binary":
        p1 = np.round(rng.uniform(size=n), 3)
        y = (rng.uniform(size=n) < p1).astype(np.float64)
        pred = {"prediction": (p1 > 0.5).astype(np.float32),
                "rawPrediction": np.stack([-p1, p1], 1).astype(np.float32),
                "probability": np.stack([1 - p1, p1], 1).astype(np.float32)}
    else:
        y = np.cumsum(rng.normal(size=n)) + 10.0
        yhat = y + rng.normal(0, 0.5, size=n)
        pred = {"prediction": yhat.astype(np.float32),
                "rawPrediction": yhat[:, None].astype(np.float32),
                "probability": np.zeros((n, 0), np.float32)}
    return (Column(ns.t.RealNN, {"value": y, "mask": np.ones(n, bool)}),
            Column(ns.t.Prediction, pred))


def evaluator_of(name, which):
    if name == "jax":
        from transmogrifai_tpu.evaluators import evaluators as ev
    else:
        from transmogrifai_tpu_torch.evaluators import evaluators as ev
    return {"bin_score": lambda: ev.BinScoreEvaluator(num_bins=7),
            "forecast": lambda: ev.ForecastEvaluator(seasonal_window=3),
            "lambda": lambda: ev.LambdaEvaluator("brierLike", brier_like,
                                                 is_larger_better=False),
            "brier_factory": ev.Evaluators.BinaryClassification.brier_score,
            "smape_factory": lambda: ev.Evaluators.Forecast.smape(2),
            "custom_factory": lambda: ev.Evaluators.Regression.custom(
                "c", lambda lab, pr: float(np.max(np.abs(
                    pr.data["prediction"] - lab.data["value"]))), False),
            }[which]()


@pytest.mark.parametrize("which", ["bin_score", "forecast", "lambda",
                                   "brier_factory", "smape_factory",
                                   "custom_factory"])
def test_evaluator_metrics_match_jax(which):
    kind = "regression" if which in ("forecast", "smape_factory",
                                     "custom_factory") else "binary"
    got_ev, want_ev = evaluator_of("port", which), evaluator_of("jax", which)
    assert (type(got_ev).__name__, got_ev.default_metric,
            got_ev.is_larger_better) == (type(want_ev).__name__,
                                         want_ev.default_metric,
                                         want_ev.is_larger_better)
    got = got_ev.evaluate(*eval_columns("port", kind))
    want = want_ev.evaluate(*eval_columns("jax", kind))
    assert_metrics_close(flat(got), flat(want))
    np.testing.assert_allclose(
        got_ev.metric_value(*eval_columns("port", kind)),
        want_ev.metric_value(*eval_columns("jax", kind)), rtol=METRIC_RTOL)


@pytest.mark.parametrize("fn", ["binary_threshold_metrics",
                                "multiclass_threshold_metrics",
                                "misclassifications_per_category",
                                "bin_score_metrics", "forecast_metrics"])
def test_host_metrics_match_jax(fn):
    from transmogrifai_tpu.evaluators import metrics as jm
    from transmogrifai_tpu_torch.evaluators import metrics as pm
    rng = np.random.default_rng(11)
    n = 400
    y2 = (rng.uniform(size=n) < 0.4).astype(np.float64)
    s = np.round(rng.uniform(size=n), 2)
    y3 = rng.integers(0, 4, n)
    probs = rng.dirichlet(np.ones(4), n)
    args = {"binary_threshold_metrics": (y2, s, 20),
            "multiclass_threshold_metrics": (y3, probs),
            "misclassifications_per_category": (y3, rng.integers(0, 4, n),
                                                5),
            "bin_score_metrics": (y2, s, 10),
            "forecast_metrics": (np.cumsum(rng.normal(size=n)),
                                 np.cumsum(rng.normal(size=n)), 2)}[fn]
    assert_metrics_close(flat(getattr(pm, fn)(*args)),
                         flat(getattr(jm, fn)(*args)))


def test_evaluators_factories_match_jax():
    from transmogrifai_tpu.evaluators.evaluators import Evaluators as JE
    from transmogrifai_tpu_torch.evaluators import Evaluators as PE
    for group in ("BinaryClassification", "MultiClassification",
                  "Regression", "Forecast"):
        jg, pg = getattr(JE, group), getattr(PE, group)
        names = sorted(k for k in vars(jg) if not k.startswith("_"))
        assert names == sorted(k for k in vars(pg) if not k.startswith("_"))
        for k in names:
            if k == "custom":
                j, p = jg.custom("m", brier_like), pg.custom("m", brier_like)
            else:
                j, p = getattr(jg, k)(), getattr(pg, k)()
            assert (type(p).__name__, p.default_metric,
                    p.is_larger_better) == (type(j).__name__,
                                            j.default_metric,
                                            j.is_larger_better), (group, k)


# --------------------------------------------------------------------------- #
# the host-metric fallback                                                    #
# --------------------------------------------------------------------------- #

N, D = 300, 5


def binary_data(seed=21):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    y = (X[:, 0] + 0.7 * X[:, 1] + rng.normal(0, 0.8, N) > 0) \
        .astype(np.float32)
    return X, y


def aupr_of(label, prediction):
    """AuPR of the class-1 probability as a custom (host) metric."""
    from transmogrifai_tpu_torch.evaluators.metrics import aupr_score
    return aupr_score(np.asarray(label.data["value"], np.float64),
                      np.asarray(prediction.data["probability"],
                                 np.float64)[:, 1])


FAMILIES = {
    "logistic": ("OpLogisticRegression", {"max_iter": 30},
                 [{"reg_param": 0.01, "elastic_net_param": 0.1},
                  {"reg_param": 0.1, "elastic_net_param": 0.5}]),
    "forest": ("OpRandomForestClassifier", {"n_trees": 6, "max_bins": 16},
               [{"max_depth": 3}, {"max_depth": 5,
                                   "min_instances_per_node": 10.0}]),
    "gbt": ("OpXGBoostClassifier", {"n_estimators": 6, "max_depth": 3,
                                    "eta": 0.3, "max_bins": 16},
            [{"min_child_weight": 1.0}, {"min_child_weight": 10.0}]),
}


def sweep(name, family, evaluator, seed=9):
    X, y = binary_data()
    est_name, kw, grids = FAMILIES[family]
    if name == "jax":
        from transmogrifai_tpu import models
        from transmogrifai_tpu.parallel.sweep import run_sweep
        from transmogrifai_tpu.selector.validators import OpCrossValidation
        from transmogrifai_tpu.stages.base import FitContext
        Xa, ya = jnp.asarray(X), jnp.asarray(y)
    else:
        import transmogrifai_tpu_torch as models
        from transmogrifai_tpu_torch.parallel.sweep import run_sweep
        from transmogrifai_tpu_torch.selector.validators import (
            OpCrossValidation)
        from transmogrifai_tpu_torch.stages.base import FitContext
        Xa, ya = torch.from_numpy(X), torch.from_numpy(y)
    folds = OpCrossValidation(n_folds=3, seed=7).splits(y.astype(np.float64))
    return np.array(run_sweep(getattr(models, est_name)(**kw), grids, Xa, ya,
                              folds, evaluator, FitContext(n_rows=N,
                                                           seed=seed)))


def port_evaluator(which):
    from transmogrifai_tpu_torch.evaluators import evaluators as ev
    return (ev.LambdaEvaluator("aupr", aupr_of) if which == "lambda"
            else ev.BinScoreEvaluator())


def jax_evaluator(which):
    from transmogrifai_tpu.evaluators import evaluators as ev
    return (ev.LambdaEvaluator("aupr", aupr_of) if which == "lambda"
            else ev.BinScoreEvaluator())


@pytest.mark.parametrize("which", ["lambda", "bin_score"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_host_metric_fallback_matches_jax(exact_histograms, family, which):
    from transmogrifai_tpu_torch.models import trees as pt
    with pt.injected_forest_draws(jax_forest_draws):
        got = sweep("port", family, port_evaluator(which))
    want = sweep("jax", family, jax_evaluator(which))
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=FAMILY_ATOL[family])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_host_metric_equals_the_device_metric(family):
    """The fallback's host AuPR of the batched fits equals the device
    AuPR of the same fits (the binary evaluator's sorted curve, f32
    scores), within 1e-6."""
    from transmogrifai_tpu_torch.evaluators.evaluators import (
        BinaryClassificationEvaluator)
    host = sweep("port", family, port_evaluator("lambda"))
    device = sweep("port", family, BinaryClassificationEvaluator())
    np.testing.assert_allclose(host, device, rtol=0, atol=1e-6)


def test_host_metrics_move_each_block_to_the_host_once(monkeypatch):
    """The fallback copies a block's stacked predictions to the host in
    one transfer per prediction key, not one per (config, fold)."""
    from transmogrifai_tpu_torch.parallel import sweep as psweep
    calls = []
    real = psweep._host_metrics

    def counting(metric_fn, y_np, preds, masks):
        calls.append(len(preds))
        return real(metric_fn, y_np, preds, masks)
    monkeypatch.setattr(psweep, "_host_metrics", counting)
    sweep("port", "logistic", port_evaluator("lambda"))
    # one static group (both configs elastic-net): its six pairs
    assert calls == [6]


# --------------------------------------------------------------------------- #
# the generic sweep                                                           #
# --------------------------------------------------------------------------- #

def centroid_classes(name, record):
    """A test-local estimator class in package `name`: a weighted
    nearest-centroid classifier whose fits record their row weights."""
    if name == "jax":
        from transmogrifai_tpu.models.base import (
            PredictionModel, PredictorEstimator)
        xp = jnp
    else:
        from transmogrifai_tpu_torch.models.base import (
            PredictionModel, PredictorEstimator)
        xp = torch

    class CentroidModel(PredictionModel):
        def __init__(self, c0=None, c1=None, temp=1.0, uid=None):
            super().__init__(uid=uid)
            self.c0, self.c1, self.temp = c0, c1, temp

        def predict_arrays(self, X):
            d0 = ((X - self.c0) ** 2).sum(1)
            d1 = ((X - self.c1) ** 2).sum(1)
            m = (d0 - d1) / self.temp
            p1 = 1.0 / (1.0 + xp.exp(-m))
            return {"prediction": (m > 0).astype(xp.float32)
                    if name == "jax" else (m > 0).to(torch.float32),
                    "rawPrediction": xp.stack([-m, m], 1),
                    "probability": xp.stack([1 - p1, p1], 1)}

    class OpCentroidClassifier(PredictorEstimator):
        def __init__(self, temp=1.0, uid=None):
            super().__init__(uid=uid, temp=temp)
            self.temp = temp

        def fit_arrays(self, X, y, w, ctx):
            record.append(np.asarray(w, np.float64).copy())
            w1, w0 = w * y, w * (1 - y)
            c1 = (X * w1[:, None]).sum(0) / w1.sum()
            c0 = (X * w0[:, None]).sum(0) / w0.sum()
            return CentroidModel(c0, c1, self.temp)

    return OpCentroidClassifier


def generic_sweep(name):
    record = []
    cls = centroid_classes(name, record)
    X, y = binary_data(5)
    grids = [{"temp": 1.0}, {"temp": 4.0}]
    if name == "jax":
        from transmogrifai_tpu.evaluators.evaluators import (
            BinaryClassificationEvaluator)
        from transmogrifai_tpu.parallel.sweep import run_sweep
        from transmogrifai_tpu.selector.validators import OpCrossValidation
        from transmogrifai_tpu.stages.base import FitContext
        Xa, ya = jnp.asarray(X), jnp.asarray(y)
    else:
        from transmogrifai_tpu_torch.evaluators.evaluators import (
            BinaryClassificationEvaluator)
        from transmogrifai_tpu_torch.parallel.sweep import run_sweep
        from transmogrifai_tpu_torch.selector.validators import (
            OpCrossValidation)
        from transmogrifai_tpu_torch.stages.base import FitContext
        Xa, ya = torch.from_numpy(X), torch.from_numpy(y)
    folds = OpCrossValidation(n_folds=3, seed=2).splits(y.astype(np.float64))
    got = run_sweep(cls(), grids, Xa, ya, folds,
                    BinaryClassificationEvaluator(metric="AuROC"),
                    FitContext(n_rows=len(y), seed=1))
    return np.array(got), record, folds


def test_generic_sweep_matches_jax():
    got, rows, folds = generic_sweep("port")
    want, j_rows, _ = generic_sweep("jax")
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # every fold's fit saw the fold's training rows as its weights
    assert len(rows) == len(j_rows) == 6
    for w, jw, (tr, _) in zip(rows, j_rows, folds * 2):
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(w, np.asarray(tr, np.float64))


def test_generic_class_trains_in_a_selector():
    """An estimator class the dispatch does not know sweeps through the
    generic loop inside a selector, wins and refits."""
    import transmogrifai_tpu_torch as port
    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.data.columns import Column
    from transmogrifai_tpu_torch.stages.base import FitContext
    cls = centroid_classes("port", [])
    X, y = binary_data(5)
    sel = port.BinaryClassificationModelSelector.with_cross_validation(
        models=[(cls(), [{"temp": 1.0}, {"temp": 2.0}])], n_folds=2)
    cols = [Column(PT.RealNN, {"value": y.astype(np.float64),
                               "mask": np.ones(len(y), bool)}),
            Column(PT.OPVector, X)]
    model = sel.fit_model(cols, FitContext(n_rows=len(y), device="cpu"))
    assert model.summary.best_model == "OpCentroidClassifier"
    assert len(model.summary.validation_results) == 2


# --------------------------------------------------------------------------- #
# warm starts                                                                 #
# --------------------------------------------------------------------------- #

def regression_data(seed=31, counts=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    eta = 0.3 * X[:, 0] - 0.2 * X[:, 1] + 0.5
    y = (rng.poisson(np.exp(eta)) if counts
         else eta + rng.normal(0, 0.3, N)).astype(np.float32)
    return X, y


WARM = {
    "logistic_fista": ("OpLogisticRegression",
                       {"reg_param": 0.01, "elastic_net_param": 0.5,
                        "max_iter": 10}, "binary", ("W", "b"), 1e-5),
    "logistic_lbfgs": ("OpLogisticRegression",
                       {"reg_param": 0.05, "max_iter": 60}, "binary",
                       ("W", "b"), 1e-4),
    "glm": ("OpGeneralizedLinearRegression",
            {"family": "poisson", "reg_param": 0.01, "max_iter": 60},
            "counts", ("beta", "b"), 1e-4),
    "linear_enet": ("OpLinearRegression",
                    {"reg_param": 0.01, "elastic_net_param": 0.5},
                    "regression", ("beta", "intercept"), 1e-5),
}


def warm_fit(name, case, shift=0.0):
    """A cold fit of package `name`, then a warm refit from the JAX
    package's cold fit on data with the labels moved by `shift`."""
    est_name, kw, kind, keys, _ = WARM[case]
    X, y = binary_data() if kind == "binary" else regression_data(
        counts=kind == "counts")
    y2 = y if kind != "regression" else y + shift
    from transmogrifai_tpu import models as jm
    jcold = getattr(jm, est_name)(**kw).fit_arrays(
        jnp.asarray(X), jnp.asarray(y), jnp.ones(N), None)
    init = {k: np.asarray(v) for k, v in jcold.get_params().items()
            if k in keys}
    if name == "jax":
        est = getattr(jm, est_name)(**kw)
        est.init_params = init
        return est.fit_arrays(jnp.asarray(X), jnp.asarray(y2), jnp.ones(N),
                              None).get_params(), init
    import transmogrifai_tpu_torch as port
    est = getattr(port, est_name)(**kw)
    est.init_params = init
    return est.fit_arrays(torch.from_numpy(X), torch.from_numpy(y2),
                          torch.ones(N), None).get_params(), init


@pytest.mark.parametrize("case", sorted(WARM))
def test_linear_family_warm_starts_match_jax(case):
    keys, tol = WARM[case][3], WARM[case][4]
    got, init = warm_fit("port", case, shift=0.25)
    want, _ = warm_fit("jax", case, shift=0.25)
    for k in keys:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k],
                                                          np.float64)
        if tol == 1e-4:  # L-BFGS: converged coefficients, relative
            np.testing.assert_allclose(g, w, rtol=tol,
                                       atol=tol * np.abs(w).max(), err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)


def tree_warm(name, kind, X, y, warm, seed=13):
    est_kw = dict(max_depth=3, max_bins=16)
    if name == "jax":
        from transmogrifai_tpu import models as jm
        from transmogrifai_tpu.stages.base import FitContext
        Xa, ya, wa = jnp.asarray(X), jnp.asarray(y), jnp.ones(len(y))
        mods = jm
    else:
        import transmogrifai_tpu_torch as mods
        from transmogrifai_tpu_torch.stages.base import FitContext
        Xa, ya, wa = torch.from_numpy(X), torch.from_numpy(y), \
            torch.ones(len(y))
    if kind == "forest":
        est = mods.OpRandomForestClassifier(n_trees=6, **est_kw)
    else:
        est = mods.OpXGBoostClassifier(n_estimators=8, eta=0.3, **est_kw)
    est.init_params = warm
    return est.fit_arrays(Xa, ya, wa, FitContext(n_rows=len(y), seed=seed))


@pytest.mark.parametrize("kind", ["forest", "gbt"])
def test_tree_warm_refits_match_jax(exact_histograms, kind):
    """The resident ensemble is the JAX package's cold fit; both packages
    refit it warm on data with 60 appended rows (`delta_rows`)."""
    from transmogrifai_tpu_torch.models import trees as pt
    X, y = binary_data(41)
    X2, y2 = binary_data(42)
    X2, y2 = np.concatenate([X, X2[:60]]), np.concatenate([y, y2[:60]])
    cold = tree_warm("jax", kind, X, y, None)
    warm = {"edges": np.asarray(cold.edges),
            "trees": {k: np.asarray(v) for k, v in cold.trees.items()},
            "delta_rows": 60}
    if kind == "gbt":
        warm["learning_rate"] = 0.3
    want = tree_warm("jax", kind, X2, y2, warm)
    with pt.injected_forest_draws(jax_forest_draws):
        got = tree_warm("port", kind, X2, y2, warm)
    n_old = warm["trees"]["feat"].shape[0]
    assert got.trees["feat"].shape == want.trees["feat"].shape
    if kind == "forest":
        # the oldest tree swapped for one grown on the delta rows
        assert got.trees["feat"].shape[0] == n_old
    else:
        assert got.trees["feat"].shape[0] == n_old + 2  # n_estimators // 4
    np.testing.assert_array_equal(got.edges, want.edges)
    for k in ("feat", "bin"):
        np.testing.assert_array_equal(got.trees[k], want.trees[k])
    np.testing.assert_allclose(got.trees["leaf"], want.trees["leaf"],
                               rtol=0, atol=0 if kind == "forest" else 1e-5)


def warm_workflow(name, exclude_checker=False):
    """tests/test_selector_extras.py's warm start: transmogrify, a
    SanityChecker and an LR, trained, then retrained warm; the checker's
    fits counted."""
    ns = package(name)
    if name == "jax":
        from transmogrifai_tpu.automl.sanity_checker import SanityChecker
    else:
        from transmogrifai_tpu_torch.automl.sanity_checker import (
            SanityChecker)
    rng = np.random.default_rng(0)
    n = 240
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    yv = (x1 + 0.5 * x2 + rng.normal(0, 0.6, size=n) > 0).astype(float)
    t = ns.t
    ds = ns.Dataset({"x1": x1, "x2": x2, "y": yv},
                    {"x1": t.Real, "x2": t.Real, "y": t.Integral})
    preds, label = ns.FeatureBuilder.from_dataset(ds, response="y")
    checked = SanityChecker(max_correlation=2.0).set_input(
        label, ns.transmogrify(preds)).get_output()
    pf = ns.models.OpLogisticRegression(max_iter=15).set_input(
        label, checked).get_output()
    kw = {} if name == "jax" else {"device": "cpu"}
    m1 = ns.Workflow().set_result_features(pf, label) \
        .set_input_dataset(ds).train(**kw)
    calls = {"n": 0}
    orig = SanityChecker.fit_model

    def counting(self, cols, ctx):
        calls["n"] += 1
        return orig(self, cols, ctx)
    SanityChecker.fit_model = counting
    try:
        exclude = [checked.origin_stage.uid] if exclude_checker else []
        m2 = ns.Workflow().set_result_features(pf, label) \
            .set_input_dataset(ds).with_model_stages(m1, exclude=exclude) \
            .train(**kw)
    finally:
        SanityChecker.fit_model = orig
    p1 = np.asarray(m1.score(ds)[pf.name].data["probability"])
    p2 = np.asarray(m2.score(ds)[pf.name].data["probability"])
    return calls["n"], p1, p2


@pytest.mark.parametrize("exclude", [False, True])
def test_with_model_stages_reuses_fits_like_jax(exclude):
    n, p1, p2 = warm_workflow("port", exclude)
    j_n, j_p1, j_p2 = warm_workflow("jax", exclude)
    assert n == j_n == (1 if exclude else 0)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_allclose(p2, j_p2, rtol=0, atol=1e-4)


# --------------------------------------------------------------------------- #
# the combiner                                                                #
# --------------------------------------------------------------------------- #

def combined(name, strategy):
    """Two LR selectors over one vector, combined: (model, dataset,
    combined feature, fitted combiner)."""
    ns = package(name)
    if name == "jax":
        from transmogrifai_tpu.selector import SelectedModelCombiner
        from transmogrifai_tpu.selector.splitters import DataSplitter
    else:
        from transmogrifai_tpu_torch.selector import (
            DataSplitter, SelectedModelCombiner)
    rng = np.random.default_rng(0)
    n = 240
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    yv = (x1 + 0.5 * x2 + rng.normal(0, 0.6, size=n) > 0).astype(float)
    t = ns.t
    ds = ns.Dataset({"x1": x1, "x2": x2, "y": yv},
                    {"x1": t.Real, "x2": t.Real, "y": t.Integral})
    preds, label = ns.FeatureBuilder.from_dataset(ds, response="y")
    vec = ns.transmogrify(preds)
    sels = []
    for reg, seed in ((0.001, 42), (0.3, 7)):
        sels.append(ns.ms.BinaryClassificationModelSelector
                    .with_cross_validation(
                        models=[(ns.models.OpLogisticRegression(max_iter=15),
                                 [{"reg_param": reg,
                                   "elastic_net_param": 0.1}])], n_folds=2,
                        splitter=DataSplitter(reserve_test_fraction=0.15,
                                              seed=seed))
                    .set_input(label, vec).get_output())
    comb = SelectedModelCombiner(strategy=strategy).set_input(
        label, *sels).get_output()
    kw = {} if name == "jax" else {"device": "cpu"}
    model = ns.Workflow().set_result_features(comb, label) \
        .set_input_dataset(ds).train(**kw)
    return model, ds, comb, model.fitted[comb.origin_stage.uid]


@pytest.mark.parametrize("strategy", ["best", "weighted", "equal"])
def test_combiner_strategies_match_jax(strategy):
    pm, pds, pc, pfit = combined("port", strategy)
    jm, jds, jc, jfit = combined("jax", strategy)
    assert (pfit.weight1, pfit.weight2, pfit.strategy, pfit.metric_name) \
        == (jfit.weight1, jfit.weight2, jfit.strategy, jfit.metric_name)
    eager = pm.score(pds)[pc.name].data
    compiled = {k: v.cpu().numpy()
                for k, v in pm.score_compiled(pds)[pc.name].items()}
    j_eager = jm.score(jds)[jc.name].data
    j_compiled = {k: np.asarray(v)
                  for k, v in jm.score_compiled(jds)[jc.name].items()}
    for got in (eager, compiled):
        for want in (j_eager, j_compiled):
            np.testing.assert_allclose(got["probability"],
                                       want["probability"], rtol=0,
                                       atol=1e-6)
            np.testing.assert_array_equal(got["prediction"],
                                          want["prediction"])
