"""Parity of the PyTorch port's regression path with the JAX package: the
Boston example (`examples/op_boston_simple.py`), the PickList pivot and
RealNN stack of its features, linear regression (FISTA elastic net and
the ridge solve), regression forests, the squared-loss GBT, the masked
regression sums (K8-reg) and the regression metrics. The example's
pipeline, the JAX package's subprocess runs and the committed fixture's
generator live in tests/test_torch_multiclass.py.

Tolerances, port on the CPU against the JAX package:
- K8-reg: RMSE/MSE/MAE/R2 of the plain `regression_moments` within 1e-6
  relative of `regression_dev` (the port sums in f64, XLA in f32);
- linear regression: coefficients within 1e-5 relative of the largest,
  intercepts within 1e-4 (f32 products summed in another order);
- K1/K2/K3 with the y channel (m = 1): histograms rtol 1e-5 / atol 1e-4
  (float sums in another order), trees with equal split bins and
  features and leaves within 1e-4 relative on data without near-tie
  splits;
- regression forests from the JAX package's draws (labels on a 1/4 grid,
  whose sums are exact in any order) and the squared GBT: the same, and
  predictions within 1e-4 relative;
- the quick Boston run (2 elastic-net configs, RF of 3 trees and GBT of 5
  rounds at depths 3 and 6): kept columns, configs and winner equal,
  linear validation RMSE within 1e-4 relative, forest and GBT within
  1e-2 relative (y sums in f32 are order-dependent, so near-tie splits go
  either way, as for the XGB family), holdout RMSE within 1e-2 relative;
  a saved model scores alike in both packages.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_multiclass import (  # noqa: E402
    PRED_KEYS, default_models, example_dataset, example_fixture_dir,
    fitted_named, jax_quick_result, jax_quick_run, package,
    port_example_run, prediction_of, quick_models, selected)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


# --------------------------------------------------------------------------- #
# K8-reg and the regression metrics                                           #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,weights", [(301, "01"), (4096, "01"),
                                       (333, "frac"), (5, "01")])
def test_regression_moments_match_regression_dev(n, weights):
    from transmogrifai_tpu.evaluators import device_metrics as jdm
    from transmogrifai_tpu_torch.evaluators import device_metrics as pdm

    rng = np.random.default_rng(n)
    P = 4
    y = (rng.normal(size=n) * 9 + 22).astype(np.float32)
    pred = (y + rng.normal(size=(P, n)) * 3).astype(np.float32)
    mask = ((rng.random((P, n)) < 0.3).astype(np.float32) if weights == "01"
            else rng.uniform(0, 2, (P, n)).astype(np.float32))
    mask[0, 0] = 1.0
    got = pdm.regression_dev(torch.from_numpy(y), torch.from_numpy(pred),
                             torch.from_numpy(mask))
    mom = pdm.regression_moments(torch.from_numpy(pred),
                                 torch.from_numpy(y),
                                 torch.from_numpy(mask)).numpy()
    for p in range(P):
        e = (pred[p].astype(np.float64) - y) * mask[p]
        np.testing.assert_allclose(
            mom[p, :4], [mask[p].sum(), (e * e).sum(), np.abs(e).sum(),
                         (y * mask[p]).sum()], rtol=1e-6)
        want = jdm.regression_dev(jnp.asarray(y), jnp.asarray(pred[p]),
                                  jnp.asarray(mask[p]))
        for k in want:
            w = float(want[k])
            assert abs(float(got[k][p]) - w) <= 1e-6 * max(abs(w), 1.0), k


def test_regression_host_metrics_and_evaluator_match_jax():
    from transmogrifai_tpu.evaluators import evaluators as jev
    from transmogrifai_tpu.evaluators import metrics as jmetrics
    from transmogrifai_tpu_torch.evaluators import evaluators as pev
    from transmogrifai_tpu_torch.evaluators import metrics as pmetrics

    rng = np.random.default_rng(9)
    y = rng.normal(size=200) * 9 + 22
    y[:3] = 0.0
    p = y + rng.normal(size=200) * 4
    assert pmetrics.regression_metrics(y, p).to_json() == \
        jmetrics.regression_metrics(y, p).to_json()
    assert not pev.RegressionEvaluator().is_larger_better
    assert pev.RegressionEvaluator("R2").is_larger_better == \
        jev.RegressionEvaluator("R2").is_larger_better


# --------------------------------------------------------------------------- #
# linear regression                                                           #
# --------------------------------------------------------------------------- #

def _linear_data(seed, n=300, d=13):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * rng.uniform(0.1, 50, d)).astype(
        np.float32)
    X[:, 3] = 0.0  # a constant column: the ridge jitter keeps it solvable
    y = (X @ (rng.normal(size=d) * 0.05) + 22 + rng.normal(size=n)).astype(
        np.float32)
    w = (rng.random((3, n)) < 0.7).astype(np.float32)
    return X, y, w


def test_fit_linreg_enet_and_ridge_match_jax():
    from transmogrifai_tpu.models import linear as jl
    from transmogrifai_tpu_torch.models import linear as pl

    X, y, w = _linear_data(1)
    l1, l2 = [0.0001, 0.05, 0.1], [0.0009, 0.05, 0.1]
    args = (torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w))
    for got, fit in ((pl.fit_linreg_enet(*args, l1, l2), "enet"),
                     (pl.fit_linreg(*args, l2), "ridge")):
        assert got["beta"].shape == (3, 13)
        for p in range(3):
            ja = (jnp.asarray(X), jnp.asarray(y), jnp.asarray(w[p]))
            want = (jl.fit_linreg_enet(*ja, jnp.float32(l1[p]),
                                       jnp.float32(l2[p]))
                    if fit == "enet" else
                    jl.fit_linreg(*ja, jnp.float32(l2[p])))
            b = np.asarray(want["beta"])
            np.testing.assert_allclose(got["beta"][p].numpy(), b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
            assert abs(float(got["intercept"][p])
                       - float(want["intercept"])) <= 1e-4, fit


def test_linear_regression_estimator_and_model_match_jax():
    from transmogrifai_tpu.models import linear as jl
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    from transmogrifai_tpu_torch import from_jax_params
    from transmogrifai_tpu_torch.models import linear as pl

    X, y, _ = _linear_data(2)
    for kw in ({"reg_param": 0.1, "elastic_net_param": 0.5},
               {"reg_param": 0.01}):
        jm = jl.OpLinearRegression(**kw).fit_arrays(
            jnp.asarray(X), jnp.asarray(y), jnp.ones(len(y)),
            JaxCtx(n_rows=len(y)))
        pm = pl.OpLinearRegression(**kw).fit_arrays(
            torch.from_numpy(X), torch.from_numpy(y), torch.ones(len(y)),
            None)
        assert pm.get_params().keys() == jm.get_params().keys()
        got = pm.predict_arrays(torch.from_numpy(X))
        want = jm.predict_arrays(jnp.asarray(X))
        for k in PRED_KEYS:
            assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got["prediction"].numpy(),
                                   np.asarray(want["prediction"]),
                                   rtol=1e-5, atol=1e-4)
        # the JAX model's parameters rebuild the same model in the port
        again = from_jax_params("LinearRegressionModel", jm.get_params())
        np.testing.assert_allclose(
            again.predict_arrays(torch.from_numpy(X))["prediction"].numpy(),
            np.asarray(want["prediction"]), rtol=1e-6, atol=1e-5)


# --------------------------------------------------------------------------- #
# K1 / K2 / K3 with the y channel, forests and the squared GBT               #
# --------------------------------------------------------------------------- #

N1, D1, B1, P1 = 240, 8, 16, 3


@pytest.fixture
def jt(monkeypatch):
    from transmogrifai_tpu.models import trees as jtrees
    monkeypatch.setattr(jtrees, "HIST_PRECISION", "f32")
    return jtrees


def _regression_values(seed):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, B1, (N1, D1)).astype(np.int8)
    y = (Xb[:, 0] * 1.5 - Xb[:, 2] + rng.normal(size=N1) * 2 + 22).astype(
        np.float32)
    boot = rng.poisson(1.0, (P1, N1)).astype(np.float32)
    return Xb, y, (y[None, None, :] * boot[:, None, :]).astype(np.float32), \
        boot


def _assert_close_trees(got, want, n_bins):
    wb = np.asarray(want["bin"])
    np.testing.assert_array_equal(np.asarray(got["bin"]), wb)
    split = wb < n_bins
    assert split.any()
    np.testing.assert_array_equal(np.asarray(got["feat"])[split],
                                  np.asarray(want["feat"])[split])
    np.testing.assert_allclose(np.asarray(got["leaf"]),
                               np.asarray(want["leaf"]), rtol=1e-4,
                               atol=1e-4)


def test_histograms_of_the_y_channel_match_jax(jt):
    from transmogrifai_tpu_torch.models import trees as pt

    Xb, _, G, H = _regression_values(3)
    node = np.random.default_rng(4).integers(0, 8, (P1, N1)).astype(np.int32)
    hg, hh = pt.histograms(torch.from_numpy(Xb), torch.from_numpy(node),
                           torch.from_numpy(G), torch.from_numpy(H), 8, B1)
    Bj = jt.bins_onehot(jnp.asarray(Xb), B1)
    for p in range(P1):
        wg, wh = jt._histograms(Bj, jnp.asarray(node[p]),
                                jnp.asarray(G[p].T), jnp.asarray(H[p]), 8)
        np.testing.assert_allclose(hg[p].numpy(), np.asarray(wg), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_array_equal(hh[p].numpy(), np.asarray(wh))


@pytest.mark.parametrize("depth", [4, 12])
def test_grow_trees_on_the_y_channel_match_jax(jt, depth):
    from transmogrifai_tpu_torch.models import trees as pt

    Xb, _, G, H = _regression_values(10 + depth)
    mcw, mgn = [1.0, 5.0, 2.0], [0.0, 0.01, 0.1]
    tree, node = pt.grow_trees(
        torch.from_numpy(Xb), torch.from_numpy(G), torch.from_numpy(H),
        depth, B1, reg_lambda=1e-6, min_child_weight=mcw, min_gain_norm=mgn)
    grow = jax.jit(jax.vmap(lambda g, h, c, t: jt.grow_tree(
        jnp.asarray(Xb), g, h, depth, B1, reg_lambda=1e-6,
        min_child_weight=c, min_gain_norm=t)))
    want = grow(jnp.asarray(np.swapaxes(G, 1, 2)), jnp.asarray(H),
                jnp.asarray(mcw, jnp.float32), jnp.asarray(mgn, jnp.float32))
    _assert_close_trees(tree, want, B1)


def test_regression_forest_estimator_matches_jax_with_its_draws():
    from test_torch_train import jax_forest_draws
    from transmogrifai_tpu.models.trees import (
        OpRandomForestRegressor as JaxRF)
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.stages.base import FitContext

    rng = np.random.default_rng(21)
    X = rng.normal(size=(N1, D1)).astype(np.float32)
    # labels on a 1/4 grid: their bootstrap-weighted f32 sums are exact in
    # any order, so the trees are equal split for split (on general floats
    # a near-tie split may go either way; the quick run holds that at the
    # metric level)
    y = np.round((X[:, 0] * 3 - X[:, 4] * 2 + rng.normal(size=N1) + 20)
                 * 4).astype(np.float32) / 4
    kw = dict(n_trees=4, max_depth=6, min_info_gain=0.001,
              min_instances_per_node=5.0)
    jm = JaxRF(**kw).fit_arrays(jnp.asarray(X), jnp.asarray(y),
                                jnp.ones(N1, jnp.float32),
                                JaxCtx(n_rows=N1, seed=8))
    with pt.injected_forest_draws(jax_forest_draws):
        pm = pt.OpRandomForestRegressor(**kw).fit_arrays(
            torch.from_numpy(X), torch.from_numpy(y), torch.ones(N1),
            FitContext(n_rows=N1, seed=8, device="cpu"))
    assert type(pm).__name__ == type(jm).__name__ == "ForestRegressionModel"
    _assert_close_trees(pm.trees, jm.trees, 32)
    got = pm.predict_arrays(torch.from_numpy(X))
    want = jm.predict_arrays(jnp.asarray(X))
    for k in PRED_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cls", ["OpGBTRegressor", "OpXGBoostRegressor"])
def test_squared_gbt_matches_jax(cls):
    """The squared objective from a zero margin (`_gbt_scan` gradients g =
    (margin − y)·w, h = w) through the estimators, trees and
    predictions."""
    import transmogrifai_tpu.models as jmodels
    import transmogrifai_tpu.models.trees as jtrees
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.stages.base import FitContext

    old = jtrees.HIST_PRECISION
    jtrees.HIST_PRECISION = "f32"
    try:
        rng = np.random.default_rng(31)
        X = rng.normal(size=(N1, D1)).astype(np.float32)
        y = (X[:, 1] * 4 + np.abs(X[:, 2]) * 3 + rng.normal(size=N1)
             + 15).astype(np.float32)
        kw = dict(n_estimators=6, max_depth=4, min_info_gain=0.01,
                  min_instances_per_node=5.0)
        kw["eta" if cls == "OpXGBoostRegressor" else "learning_rate"] = 0.3
        jm = getattr(jmodels, cls)(**kw).fit_arrays(
            jnp.asarray(X), jnp.asarray(y), jnp.ones(N1, jnp.float32),
            JaxCtx(n_rows=N1, seed=3))
        pm = getattr(pt, cls)(**kw).fit_arrays(
            torch.from_numpy(X), torch.from_numpy(y), torch.ones(N1),
            FitContext(n_rows=N1, seed=3, device="cpu"))
    finally:
        jtrees.HIST_PRECISION = old
    assert type(pm).__name__ == type(jm).__name__ == "GBTRegressionModel"
    _assert_close_trees(pm.trees, jm.trees, 32)
    got = pm.predict_arrays(torch.from_numpy(X))
    want = jm.predict_arrays(jnp.asarray(X))
    for k in PRED_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4)
    assert pm.get_params().keys() == jm.get_params().keys()


# --------------------------------------------------------------------------- #
# the Boston features                                                         #
# --------------------------------------------------------------------------- #

def test_pivot_and_realnn_vectors_match_jax():
    """transmogrify's pivot group (OneHotVectorizer over PickList) and
    RealNN stack on Boston's features, fitted and applied by both."""
    jns, pns = package("jax"), package("port")
    out = {}
    for name, ns in (("jax", jns), ("port", pns)):
        ds = example_dataset(ns, "boston")
        FB = ns.FeatureBuilder
        chas = FB.PickList("chas").from_column("chas").as_predictor()
        rm = FB.RealNN("rm").from_column("rm").as_predictor()
        lstat = FB.RealNN("lstat").from_column("lstat").as_predictor()
        vec = ns.transmogrify([chas, rm, lstat])
        label = FB.RealNN("medv").from_column("medv").as_response()
        model = ns.Workflow().set_result_features(vec, label) \
            .set_input_dataset(ds).train(
                **({} if name == "jax" else {"device": "cpu"}))
        col = model.score(ds)[vec.name]
        out[name] = (np.asarray(col.data), col.meta.column_names())
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    assert out["port"][0].shape == (333, 2 + 4)  # rm, lstat; 0, 1, OTHER, NULL


def test_default_regression_models_match_jax():
    jns, pns = package("jax"), package("port")
    for (je, jg), (pe, pg) in zip(default_models(jns, "boston"),
                                  default_models(pns, "boston")):
        assert type(je).__name__ == type(pe).__name__
        assert je.get_params() == pe.get_params() and jg == pg
    assert len(sum((g for _, g in default_models(pns, "boston")), [])) == 44


@pytest.mark.parametrize("name", [
    "OpLinearRegression", "OpRandomForestRegressor", "OpGBTRegressor",
    "OpXGBoostRegressor", "OpStringIndexer", "OneHotVectorizer",
    "RealNNVectorizer"])
def test_new_stages_rebuild_from_jax_params(name):
    """Every estimator of the two examples, built from the JAX package's
    params (as `load_model` and the saved selectors do), keeps them."""
    import transmogrifai_tpu.models as jmodels
    import transmogrifai_tpu.ops.categorical as jcat
    import transmogrifai_tpu.ops.indexers as jidx
    import transmogrifai_tpu.ops.numeric as jnum
    from transmogrifai_tpu_torch import from_jax_params

    kw = {"OpLinearRegression": {"reg_param": 0.1,
                                 "elastic_net_param": 0.5},
          "OpRandomForestRegressor": {"n_trees": 50},
          "OpGBTRegressor": {"n_estimators": 20, "learning_rate": 0.1},
          "OpXGBoostRegressor": {"n_estimators": 20, "max_depth": 3}
          }.get(name, {})
    cls = next(getattr(m, name) for m in (jmodels, jcat, jidx, jnum)
               if hasattr(m, name))
    est = cls(**kw)
    mine = from_jax_params(name, est.get_params())
    assert type(mine).__module__.startswith("transmogrifai_tpu_torch.")
    assert mine.get_params() == est.get_params()


# --------------------------------------------------------------------------- #
# the Boston example, quick and at full width                                 #
# --------------------------------------------------------------------------- #

# validation RMSE tolerance (relative) per family of the quick run
QUICK_RMSE_RTOL = {"OpLinearRegression": 1e-4,
                   "OpRandomForestRegressor": 1e-2, "OpGBTRegressor": 1e-2}


@pytest.fixture(scope="module")
def quick_boston(tmp_path_factory):
    proc, out, saved = jax_quick_run(tmp_path_factory, "boston")
    import transmogrifai_tpu_torch as port
    model, ds = port_example_run("boston", quick_models(port, "boston"))
    res, arr = jax_quick_result(proc, out)
    return res, arr, saved, model, ds


def test_quick_boston_selects_like_jax(quick_boston):
    res, arr, _, model, _ = quick_boston
    summ = selected(model).summary
    np.testing.assert_array_equal(
        fitted_named(model, "SanityCheckerModel").indices,
        arr["kept_indices"])
    assert [{"model": r.model, "grid": r.grid}
            for r in summ.validation_results] == res["results"]
    for r, want in zip(summ.validation_results, res["fold_metrics"]):
        np.testing.assert_allclose(r.fold_metrics, want,
                                   rtol=QUICK_RMSE_RTOL[r.model])
    assert (summ.best_model, summ.best_grid) == (res["best_model"],
                                                 res["best_grid"])
    assert summ.problem_type == "regression"
    assert summ.splitter_summary == res["splitter"]
    for k in ("RMSE", "MAE", "R2"):
        assert abs(summ.holdout_metrics[k] - res["holdout_metrics"][k]) \
            <= 1e-2 * abs(res["holdout_metrics"][k]), k


def test_quick_boston_scores_and_saves_like_jax(quick_boston, tmp_path):
    """The port's save loads in both packages and scores alike (the same
    tables, summed in another order); the JAX package's saved model loads
    in the port and scores as the JAX package does."""
    res, arr, jax_saved, model, ds = quick_boston
    got = prediction_of(model.score_compiled(ds))
    assert got["probability"].shape == (333, 0)
    np.testing.assert_allclose(got["prediction"], arr["prediction"],
                               rtol=2e-2, atol=0)
    path = str(tmp_path / "port_boston")
    model.save(path)
    pns, jns = package("port"), package("jax")
    again = prediction_of(pns.load_model(path, device="cpu")
                          .score_compiled(ds))
    for k in PRED_KEYS:
        np.testing.assert_array_equal(again[k], got[k])
    import transmogrifai_tpu.automl.sanity_checker  # noqa: F401 (ROADMAP F6)
    jds = example_dataset(jns, "boston")
    theirs = prediction_of(jns.load_model(path).score_compiled(jds))
    np.testing.assert_allclose(theirs["prediction"], got["prediction"],
                               rtol=1e-5, atol=1e-5)
    mine = prediction_of(pns.load_model(jax_saved, device="cpu")
                         .score_compiled(ds))
    np.testing.assert_allclose(mine["prediction"], arr["prediction"],
                               rtol=1e-5, atol=1e-5)


def test_boston_fixture_is_the_default_sweep():
    with open(os.path.join(example_fixture_dir("boston"), "results.json")) \
            as fh:
        res = json.load(fh)
    ns = package("port")
    want = [{"model": type(e).__name__, "grid": g}
            for e, grids in default_models(ns, "boston") for g in grids]
    assert res["results"] == want and res["problem_type"] == "regression"
    hold = res["holdout_metrics"]
    assert hold["RMSE"] <= 6.0 and hold["R2"] >= 0.6
    with np.load(os.path.join(example_fixture_dir("boston"),
                              "scores.npz")) as z:
        assert z["forest_boot"].shape == (50, res["n_train"])
        assert z["prediction"].shape == (333,)
