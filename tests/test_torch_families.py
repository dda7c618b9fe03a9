"""Parity of the PyTorch port's other model families with the JAX package:
L-BFGS logistic regression (α = 0), linear SVC, the GLM's families and
links, naive Bayes, the MLP, decision trees and multiclass boosting, their
sweep handlers, their saved models, and three selector runs over them.

The three runs (`RUNS`) are the README quickstart's pipeline with a
binary cross-validated selector, and the Iris and Boston examples'
pipelines with a train/validation split, each over the families its
`family_models` lists (29, 27 and 34 configs). The committed fixtures
`transmogrifai_tpu_torch/testdata/families_{binary,iris,boston}_f32/`
hold the JAX package's runs in its exact-f32 histogram mode: the kept
columns, the configs in the selector's order with their validation
metrics, the winner, its train and holdout metrics and scores, the MLP's
initial weights for the run's layer shapes and seed, per new model class
a one-config run at the family's first grid point (its holdout metrics
and scores on every row), and for each family fitted by an f32 optimizer
path (L-BFGS, Adam) its noise runs: the family's sweep and refit with
the selector's matrix moved by one ulp per cell, 16 seeds — the
spread that the JAX package's own result has under float noise. The Iris
fixture also holds the multiclass XGBoost model of its one-config run as
tables with the JAX package's margins on the binned rows.
`chip_smoke.py` holds the port's runs on the card to them. The generator
runs one part per process, a few at a time, into a parts directory (a
part already there is kept), then merges them (about ten minutes with
four processes, `FIXTURE_PROCESSES`):

    JAX_PLATFORMS=cpu python tests/test_torch_families.py fixture <parts_dir>

Tolerances, port on the CPU against the JAX package (each beside its
test): L-BFGS fits (logistic, SVC, GLM) of well-conditioned problems
converge to coefficients within 1e-4 relative and losses within 1e-6
relative; naive Bayes parameters within 1e-5 and predictions equal; the
MLP from the JAX package's initial weights within 1e-4 after 50 Adam
steps; decision trees equal (split features and bins equal, leaves within
1e-6); multiclass boosting on well-separated classes equal trees, leaves
within 1e-5, and K5-mc on the JAX package's trees within 2e-5 of its
margins; handler fold metrics within 1e-3 of the JAX package's
`run_sweep`; saved models score within rawPrediction 2e-5 / probability
1e-5 in the other package.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_multiclass import (  # noqa: E402
    F32_ENV, PRED_KEYS, REPO, TESTDATA, example_dataset, example_pipeline,
    fitted_named, package, prediction_of, selected)

sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402  (the runs and their tolerance rule)

TITANIC = os.path.join(REPO, "examples", "data", "titanic.csv")
RUNS = ("binary", "iris", "boston")


def fixture_dir(run: str) -> str:
    return os.path.join(TESTDATA, f"families_{run}_f32")


# --------------------------------------------------------------------------- #
# the three runs, in either package                                           #
# --------------------------------------------------------------------------- #

def family_models(ns, run: str):
    """The (estimator, grids) list of `run` from either package's
    namespace (`package(...)`): the selector's `models=`, as
    `chip_smoke.family_models` defines it."""
    return cs.family_models(ns.models, ns.ms, run)


def run_dataset(ns, run: str):
    if run == "binary":
        return ns.Dataset.from_csv(TITANIC)
    return example_dataset(ns, run)


def run_pipeline(ns, run: str, models):
    """(label, prediction) of `run` over `models`: the README quickstart
    with a cross-validated binary selector, or the example's program."""
    if run != "binary":
        return example_pipeline(ns, run, models)
    ds = ns.Dataset.from_csv(TITANIC)
    predictors, label = ns.FeatureBuilder.from_dataset(ds,
                                                       response="survived")
    checked = label.sanity_check(ns.transmogrify(predictors),
                                 remove_bad_features=True)
    pred = ns.ms.BinaryClassificationModelSelector.with_cross_validation(
        models=models).set_input(label, checked).get_output()
    return label, pred


def mlp_layers(run: str, d: int):
    est = next(e for e, _ in family_models(package("jax"), run)
               if type(e).__name__ == "OpMultilayerPerceptronClassifier")
    k = {"binary": 2, "iris": 3}[run]
    return (d,) + tuple(est.hidden_layers) + (k,)


def jax_mlp_init(seed: int, layers):
    """The JAX package's initial MLP weights for `layers` and `seed`
    (`models/mlp.py:_init_params` from PRNGKey(seed)): one W per layer."""
    import jax
    from transmogrifai_tpu.models.mlp import _init_params
    return [np.asarray(p["W"]) for p in
            _init_params(tuple(layers), jax.random.PRNGKey(int(seed)))]


# --------------------------------------------------------------------------- #
# the JAX package's runs (subprocesses, f32 histogram mode)                   #
# --------------------------------------------------------------------------- #

# the noise runs of each optimizer-path family (`chip_smoke.OPTIMIZER_PATH`:
# on badly conditioned data one ulp of input noise moves their metrics, in
# the JAX package itself, far beyond the deterministic families' ulps)
NOISE_SEEDS = tuple(range(1, 17))


def _parts(run: str):
    """The run's sweep parts (one family each), its one-config parts (one
    per new model class: the family's first grid point) and, for each
    optimizer-path family, its noise parts (the family's sweep and refit
    with the selector's matrix moved by one ulp, one part per seed)."""
    names = [type(e).__name__ for e, _ in family_models(package("jax"),
                                                        run)]
    return ([f"{run}:sweep:{i}" for i in range(len(names))]
            + [f"{run}:one:{i}" for i in range(len(names))]
            + [f"{run}:noise{s}:{i}" for s in NOISE_SEEDS
               for i, name in enumerate(names) if name in cs.OPTIMIZER_PATH])


def one_ulp_noise(X: np.ndarray, seed: int) -> np.ndarray:
    """X with each cell moved by −1, 0 or +1 ulp (seeded)."""
    r = np.random.default_rng(seed).integers(-1, 2, X.shape)
    return (X * (1.0 + r * 2.0 ** -23)).astype(np.float32)


def jax_part(part: str, out_dir: str) -> None:
    """Train one part with the JAX package (TRANSMOGRIFAI_HIST_PRECISION=f32
    set before it is imported) and write `results.json` and `scores.npz`
    to `out_dir`."""
    from transmogrifai_tpu.models import trees as jt

    run, kind, idx = part.split(":")
    ns = package("jax")
    assert jt.HIST_PRECISION == "f32", jt.HIST_PRECISION
    est, grids = family_models(ns, run)[int(idx)]
    if kind == "one":
        grids = grids[:1]
    if kind.startswith("noise"):
        import dataclasses
        fit_model = ns.ms.ModelSelector.fit_model
        seed = int(kind[len("noise"):])

        def noisy_fit_model(self, cols, ctx):
            label_col, vec_col = cols
            vec_col = dataclasses.replace(vec_col, data=one_ulp_noise(
                np.asarray(vec_col.data, dtype=np.float32), seed))
            return fit_model(self, [label_col, vec_col], ctx)

        ns.ms.ModelSelector.fit_model = noisy_fit_model
    seen = {}
    sweep = ns.ms.ModelSelector._run_sweep_with_retry

    def recording_sweep(self, est, grids, X, y_dev, folds, ctx, *a, **kw):
        seen["seed"], seen["shape"] = int(ctx.seed), tuple(X.shape)
        return sweep(self, est, grids, X, y_dev, folds, ctx, *a, **kw)

    ns.ms.ModelSelector._run_sweep_with_retry = recording_sweep
    ds = run_dataset(ns, run)
    label, pred = run_pipeline(ns, run, [(est, grids)])
    model = ns.Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).train()
    best = selected(model)
    summ = best.summary
    checker = fitted_named(model, "SanityCheckerModel")
    p = prediction_of(model.score_compiled(ds))
    res = {"part": part, "n_kept": len(checker.indices),
           "seed": seen.get("seed"), "n_train": (seen.get("shape") or [0])[0],
           "problem_type": summ.problem_type, "metric": summ.metric_name,
           "results": [{"model": r.model, "grid": r.grid}
                       for r in summ.validation_results],
           "fold_metrics": [r.fold_metrics for r in summ.validation_results],
           "best_model": summ.best_model, "best_grid": summ.best_grid,
           "best_class": type(best).__name__,
           "train_metrics": summ.train_metrics,
           "holdout_metrics": summ.holdout_metrics,
           "splitter": summ.splitter_summary}
    if run == "iris":
        res["labels"] = fitted_named(model, "StringIndexerModel").labels
    arrays = {"kept_indices": np.asarray(checker.indices, dtype=np.int32),
              **{k: p[k] for k in PRED_KEYS}}
    if type(est).__name__ == "OpMultilayerPerceptronClassifier":
        layers = mlp_layers(run, len(checker.indices))
        for i, W in enumerate(jax_mlp_init(seen["seed"], layers)):
            arrays[f"mlp_init_W{i}"] = W
    if kind == "one" and type(best).__name__ == "GBTMulticlassModel":
        import jax.numpy as jnp
        from transmogrifai_tpu.models.trees import (
            bin_features, predict_gbt_multiclass_margin)
        X = _model_input_matrix(model, ds, best)
        Xb = bin_features(jnp.asarray(X), jnp.asarray(best.edges))
        margin = predict_gbt_multiclass_margin(
            {k: jnp.asarray(v) for k, v in best.trees.items()}, Xb,
            jnp.float32(best.learning_rate))
        arrays.update(
            xgb_Xb=np.asarray(Xb), xgb_edges=best.edges,
            xgb_feat=best.trees["feat"].astype(np.int16),
            xgb_bin=best.trees["bin"].astype(np.int16),
            xgb_leaf=best.trees["leaf"],
            xgb_learning_rate=np.float32(best.learning_rate),
            xgb_margin=np.asarray(margin))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    np.savez_compressed(os.path.join(out_dir, "scores.npz"), **arrays)


def _model_input_matrix(model, ds, best):
    """The feature matrix the selector's model scores (its vector input)
    on every row, from the JAX package's eager scorer."""
    cols = model.score(ds, keep_intermediate=True)
    return np.asarray(cols[best.input_features[-1].uid].device_value())


def merge_parts(run: str, parts_dir: str, out_dir: str) -> None:
    """The run from its parts: every config's validation metrics in the
    selector's order, the winner by its rule (the first best mean:
    largest AuPR / F1, smallest RMSE), the winner's part's refit metrics
    and scores (the same config, rows and seed as in the whole run), and
    each one-config part's holdout metrics and scores."""
    res, arr = {}, {}
    for part in _parts(run):
        d = os.path.join(parts_dir, part.replace(":", "_"))
        with open(os.path.join(d, "results.json")) as fh:
            res[part] = json.load(fh)
        with np.load(os.path.join(d, "scores.npz")) as z:
            arr[part] = {k: z[k] for k in z.files}
    sweeps = [p for p in _parts(run) if ":sweep:" in p]
    ones = [p for p in _parts(run) if ":one:" in p]
    noise = {}
    for p in _parts(run):
        if ":noise" in p:
            r = res[p]
            rec = noise.setdefault(r["results"][0]["model"], {
                "fold_metrics": [], "best_grid": [], "holdout_metrics": []})
            rec["fold_metrics"].append(r["fold_metrics"])
            rec["best_grid"].append(r["best_grid"])
            rec["holdout_metrics"].append(r["holdout_metrics"])
    first = res[sweeps[0]]
    for key in ("seed", "n_train", "n_kept", "splitter", "problem_type",
                "metric"):
        assert all(res[p][key] == first[key] for p in res), key
    for p in sweeps + ones:
        np.testing.assert_array_equal(arr[p]["kept_indices"],
                                      arr[sweeps[0]]["kept_indices"])
    results, folds, owner = [], [], []
    for p in sweeps:
        results += res[p]["results"]
        folds += res[p]["fold_metrics"]
        owner += [p] * len(res[p]["results"])
    sign = -1.0 if first["metric"] in ("RMSE", "MSE", "MAE", "Error") \
        else 1.0
    means = [sign * float(np.mean(f)) for f in folds]
    win = max(range(len(means)), key=lambda i: means[i])
    part = owner[win]
    assert res[part]["best_grid"] == results[win]["grid"], part
    assert res[part]["best_model"] == results[win]["model"], part
    extra = {k: first[k] for k in ("labels",) if k in first}
    arrays = {"kept_indices": arr[sweeps[0]]["kept_indices"],
              **{k: arr[part][k] for k in PRED_KEYS}}
    one_rec = []
    for i, p in enumerate(ones):
        one_rec.append({k: res[p][k] for k in (
            "results", "fold_metrics", "best_class", "train_metrics",
            "holdout_metrics")})
        for k in PRED_KEYS:
            arrays[f"one{i}_{k}"] = arr[p][k]
        for k, v in arr[p].items():
            if k.startswith("xgb_"):
                arrays[k] = v
    for p in sweeps:
        for k, v in arr[p].items():
            if k.startswith("mlp_init_"):
                arrays[k] = v
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as fh:
        json.dump({
            "run": run, "n_kept": first["n_kept"], "seed": first["seed"],
            "n_train": first["n_train"],
            "problem_type": first["problem_type"], "metric": first["metric"],
            "results": results, "fold_metrics": folds,
            "best_model": results[win]["model"],
            "best_grid": results[win]["grid"],
            "best_class": res[part]["best_class"],
            "train_metrics": res[part]["train_metrics"],
            "holdout_metrics": res[part]["holdout_metrics"],
            "splitter": first["splitter"], "one_config": one_rec,
            "noise": noise, **extra},
            fh, indent=1)
    np.savez_compressed(os.path.join(out_dir, "scores.npz"), **arrays)


def _main() -> None:
    """python tests/test_torch_families.py MODE ... (see the module
    docstring); every JAX run is in f32 histogram mode."""
    args = sys.argv[1:]
    mode = args[0]
    if mode == "part":
        jax_part(args[1], args[2])
    elif mode == "fixture":
        parts_dir = args[1]
        runs = args[2:] or list(RUNS)
        width = int(os.environ.get("FIXTURE_PROCESSES", "4"))
        env = dict(os.environ, **F32_ENV)
        todo = [p for run in runs for p in _parts(run)
                if not os.path.exists(os.path.join(
                    parts_dir, p.replace(":", "_"), "scores.npz"))]
        running = []
        while todo or running:
            while todo and len(running) < width:
                p = todo.pop(0)
                running.append((p, subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "part", p,
                     os.path.join(parts_dir, p.replace(":", "_"))],
                    env=env)))
            p, proc = running.pop(0)
            if proc.wait() != 0:
                raise SystemExit(f"part {p} failed")
        for run in runs:
            merge_parts(run, parts_dir, fixture_dir(run))
    else:
        raise SystemExit(f"unknown mode {mode!r}")


# --------------------------------------------------------------------------- #
# naive Bayes, the MLP, decision trees, softmax boosting                      #
# --------------------------------------------------------------------------- #

N, D = 240, 6


@pytest.fixture
def exact_histograms(monkeypatch):
    from transmogrifai_tpu.models import trees as jt
    monkeypatch.setattr(jt, "HIST_PRECISION", "f32")
    return jt


def _classes(seed, k=3, n=N, d=D, sep=1.0):
    """Features and labels 0..k-1 whose first k features carry the class
    (`sep` scales how far apart the classes lie)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[np.arange(n), y % d] += sep * 2.0
    return X, y.astype(np.float32)


@pytest.mark.parametrize("k", [2, 3])
def test_naive_bayes_matches_jax(k):
    """Parameters within 1e-5, predictions equal (non-negative counts)."""
    import jax.numpy as jnp
    from transmogrifai_tpu.models import naive_bayes as jn
    from transmogrifai_tpu_torch.models import naive_bayes as pn

    rng = np.random.default_rng(k)
    X = rng.poisson(2.0, (N, D)).astype(np.float32)
    y = rng.integers(0, k, N).astype(np.float32)
    X[y == 1, 0] += 3
    w = (rng.random((2, N)) < 0.8).astype(np.float32)
    got = pn.fit_naive_bayes(torch.from_numpy(X), torch.from_numpy(y),
                             torch.from_numpy(w), [1.0, 0.5], k)
    for q, sm in enumerate((1.0, 0.5)):
        want = jn.fit_naive_bayes(jnp.asarray(X), jnp.asarray(y),
                                  jnp.asarray(w[q]), jnp.float32(sm), k)
        for key in ("log_prior", "log_theta"):
            np.testing.assert_allclose(got[key][q].numpy(),
                                       np.asarray(want[key]), rtol=0,
                                       atol=1e-5)
        model = pn.NaiveBayesModel(got["log_prior"][q].numpy(),
                                   got["log_theta"][q].numpy())
        mine = model.predict_arrays(torch.from_numpy(X))
        theirs = jn.predict_naive_bayes(want, jnp.asarray(X))
        np.testing.assert_array_equal(mine["prediction"].numpy(),
                                      np.asarray(theirs["prediction"]))
    with pytest.raises(ValueError, match="non-negative"):
        pn.OpNaiveBayes().fit_arrays(torch.from_numpy(X - 5.0),
                                     torch.from_numpy(y), torch.ones(N), None)


def test_mlp_from_the_jax_init_matches_jax():
    """50 Adam steps from the JAX package's threefry initial weights:
    weights within 1e-4, for two pairs (two learning rates) at once."""
    import jax
    import jax.numpy as jnp
    from transmogrifai_tpu.models import mlp as jm
    from transmogrifai_tpu_torch.models import mlp as pm

    X, y = _classes(11)
    layers = (D, 5, 3)
    init = [np.asarray(p["W"]) for p in
            jm._init_params(layers, jax.random.PRNGKey(3))]
    w = np.ones(N, np.float32)
    with pm.injected_mlp_init(lambda seed, lay: init if (seed, lay) == (
            3, layers) else None):
        got = pm.fit_mlp(torch.from_numpy(X), torch.from_numpy(y),
                         torch.from_numpy(np.stack([w, w])), layers, 50,
                         [0.05, 0.01], seed=3)
    for q, lr in enumerate((0.05, 0.01)):
        want = jm.fit_mlp(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                          layers, 50, lr, 3)
        for mine, theirs in zip(got, want):
            for key in ("W", "b"):
                np.testing.assert_allclose(mine[key][q].numpy(),
                                           np.asarray(theirs[key]), rtol=0,
                                           atol=1e-4)
    # without injected weights the port draws its own, the same every call
    a = pm.init_weights(layers, 3)
    b = pm.init_weights(layers, 3)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert [tuple(t.shape) for t in a] == [(D, 5), (5, 3)]


def _assert_trees_equal(got, want, n_bins, leaf_atol):
    wb = np.asarray(want["bin"])
    np.testing.assert_array_equal(np.asarray(got["bin"]), wb)
    split = wb < n_bins
    assert split.any()
    np.testing.assert_array_equal(np.asarray(got["feat"])[split],
                                  np.asarray(want["feat"])[split])
    np.testing.assert_allclose(np.asarray(got["leaf"]),
                               np.asarray(want["leaf"]), rtol=0,
                               atol=leaf_atol)


@pytest.mark.parametrize("labels", ["classes", "regression"])
def test_decision_tree_matches_jax(exact_histograms, labels):
    """One deterministic tree (no bootstrap, all features, λ 1e-6): equal
    trees, leaves within 1e-6 (class counts, or labels on a 1/4 grid, so
    every sum is exact), and its predictions."""
    import jax.numpy as jnp
    from transmogrifai_tpu.models import trees as jt
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.stages.base import FitContext

    X, y = _classes(21)
    kw = dict(max_depth=6, min_info_gain=0.001, min_instances_per_node=5.0)
    if labels == "regression":
        y = np.round((X[:, 0] * 2 + X[:, 1]) * 4) / 4
        jest, pest = (jt.OpDecisionTreeRegressor(**kw),
                      pt.OpDecisionTreeRegressor(**kw))
    else:
        jest, pest = (jt.OpDecisionTreeClassifier(**kw),
                      pt.OpDecisionTreeClassifier(**kw))
    y = y.astype(np.float32)
    jm = jest.fit_arrays(jnp.asarray(X), jnp.asarray(y),
                         jnp.ones(N, jnp.float32), JaxCtx(n_rows=N, seed=5))
    # an injected forest draw must not reach a tree that draws nothing
    with pt.injected_forest_draws(lambda *a: (_ for _ in ()).throw(
            AssertionError("a decision tree took forest draws"))):
        pm = pest.fit_arrays(torch.from_numpy(X), torch.from_numpy(y),
                             torch.ones(N), FitContext(n_rows=N, seed=5))
    assert type(pm).__name__ == type(jm).__name__
    _assert_trees_equal(pm.trees, jm.trees, 32, 1e-6)
    got = pm.predict_arrays(torch.from_numpy(X))
    want = jm.predict_arrays(jnp.asarray(X))
    np.testing.assert_allclose(got["prediction"].numpy(),
                               np.asarray(want["prediction"]), atol=1e-6)
    assert pest.get_params() == jest.get_params()


def test_multiclass_boosting_matches_jax(exact_histograms):
    """Softmax boosting at depth 3 over 5 rounds on well-separated
    classes: equal trees (rounds × classes), leaves within 1e-5 (softmax
    gradients summed in another order), and the refit model's margin
    through K5-mc's plain version within 1e-5 of the JAX package's."""
    import jax.numpy as jnp
    from transmogrifai_tpu.models import trees as jt
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.stages.base import FitContext

    X, y = _classes(31, k=4, sep=2.0)
    kw = dict(n_estimators=5, max_depth=3, eta=0.3, gamma=0.1,
              min_child_weight=2.0, early_stopping_rounds=20)
    jm = jt.OpXGBoostClassifier(**kw).fit_arrays(
        jnp.asarray(X), jnp.asarray(y), jnp.ones(N, jnp.float32),
        JaxCtx(n_rows=N, seed=5))
    pm = pt.OpXGBoostClassifier(**kw).fit_arrays(
        torch.from_numpy(X), torch.from_numpy(y), torch.ones(N),
        FitContext(n_rows=N, seed=5))
    assert type(pm).__name__ == type(jm).__name__ == "GBTMulticlassModel"
    assert pm.trees["leaf"].shape == (5, 4, 8, 1)
    _assert_trees_equal(pm.trees, jm.trees, 32, 1e-5)
    got = pm.predict_arrays(torch.from_numpy(X))
    want = jm.predict_arrays(jnp.asarray(X))
    np.testing.assert_allclose(got["rawPrediction"].numpy(),
                               np.asarray(want["rawPrediction"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got["prediction"].numpy(),
                                  np.asarray(want["prediction"]))


def test_k5mc_on_the_jax_packages_iris_trees():
    """K5-mc's plain version (the CPU path) on the Iris fixture's JAX
    model (200 rounds × 3 classes at depth 10, int8 bins): the margins
    within 2e-5 of the JAX package's; with int32 bins the same sums."""
    from transmogrifai_tpu_torch.models import trees as pt

    with np.load(os.path.join(fixture_dir("iris"), "scores.npz")) as z:
        arr = {k: z[k] for k in z.files}
    trees = {k: torch.from_numpy(arr[f"xgb_{k}"].astype(
        np.float32 if k == "leaf" else np.int32)) for k in
        ("feat", "bin", "leaf")}
    Xb = torch.from_numpy(arr["xgb_Xb"])
    assert Xb.dtype == torch.int8 and trees["feat"].shape == (200, 3, 10,
                                                              1024)
    lr = float(arr["xgb_learning_rate"])
    margin = pt.predict_gbt_multiclass_margin(trees, Xb, lr)
    np.testing.assert_allclose(margin.numpy(), arr["xgb_margin"], rtol=0,
                               atol=2e-5)
    again = pt.predict_gbt_multiclass_margin(trees, Xb.to(torch.int32), lr)
    assert torch.equal(again, margin)


def test_class_tree_walk_adds_rounds_in_order_for_many_classes():
    """K > 8 classes (one class per grid row on the card): each class's
    sum is its trees' leaves added round by round in f32."""
    from transmogrifai_tpu_torch.models import trees as pt

    rng = np.random.default_rng(5)
    T, K, depth, d, n = 7, 11, 4, 5, 50
    feat = torch.from_numpy(rng.integers(0, d, (T, K, depth, 2 ** depth))
                            .astype(np.int32))
    bins = torch.from_numpy(rng.integers(0, 9, (T, K, depth, 2 ** depth))
                            .astype(np.int32))
    leaf = torch.from_numpy(rng.normal(size=(T, K, 2 ** depth, 1))
                            .astype(np.float32))
    Xb = torch.from_numpy(rng.integers(0, 9, (n, d)).astype(np.int8))
    got = pt.tree_walk_classes(Xb, feat, bins, leaf)
    assert got.shape == (n, K)
    for k in range(K):
        want = torch.zeros(n)
        for t in range(T):
            want = want + pt.tree_walk_plain(
                Xb, feat[t, k][None], bins[t, k][None], leaf[t, k][None])[:, 0]
        assert torch.equal(got[:, k], want)
    with pytest.raises(ValueError, match="rounds, classes"):
        pt.tree_walk_classes(Xb, feat[0], bins[0], leaf[0])


# --------------------------------------------------------------------------- #
# the sweep handlers against the JAX package's run_sweep                      #
# --------------------------------------------------------------------------- #

def _handler_case(name):
    """(estimator name, estimator kwargs, grids, labels kind)."""
    reg = [{"reg_param": 0.01}, {"reg_param": 0.2}]
    return {
        "logistic_lbfgs": ("OpLogisticRegression", {"max_iter": 30},
                           [dict(g, elastic_net_param=0.0) for g in reg],
                           "multiclass"),
        "svc": ("OpLinearSVC", {"max_iter": 30}, reg, "binary"),
        "glm": ("OpGeneralizedLinearRegression", {"max_iter": 30},
                [{"family": "poisson", "link": "log", "reg_param": 0.01},
                 {"family": "gaussian", "link": "identity",
                  "reg_param": 0.1}], "counts"),
        "naive_bayes": ("OpNaiveBayes", {}, [{"smoothing": 1.0},
                                             {"smoothing": 0.5}], "counts3"),
        "mlp": ("OpMultilayerPerceptronClassifier",
                {"hidden_layers": (4,), "max_iter": 30},
                [{"learning_rate": 0.05}, {"learning_rate": 0.01}],
                "multiclass"),
        "dt_classes": ("OpDecisionTreeClassifier", {},
                       [{"max_depth": 3, "min_instances_per_node": 5.0},
                        {"max_depth": 6, "min_info_gain": 0.01}],
                       "multiclass"),
        "dt_regression": ("OpDecisionTreeRegressor", {},
                          [{"max_depth": 3}, {"max_depth": 5,
                                              "min_info_gain": 0.01}],
                          "quarters"),
        "xgb_multiclass": ("OpXGBoostClassifier",
                           {"n_estimators": 4, "max_depth": 3, "eta": 0.3},
                           [{"min_child_weight": 1.0},
                            {"min_child_weight": 5.0}], "multiclass"),
    }[name]


@pytest.mark.parametrize("case", [
    "logistic_lbfgs", "svc", "glm", "naive_bayes", "mlp", "dt_classes",
    "dt_regression", "xgb_multiclass"])
def test_handler_fold_metrics_match_jax_run_sweep(exact_histograms, case):
    """Each new handler's fold metrics (3-fold CV, the family's evaluator)
    within 1e-3 of the JAX package's `run_sweep` on the same folds (the
    MLP from the JAX package's initial weights)."""
    import jax
    import jax.numpy as jnp
    from transmogrifai_tpu import models as jmodels
    from transmogrifai_tpu.evaluators import evaluators as jev
    from transmogrifai_tpu.models.mlp import _init_params
    from transmogrifai_tpu.parallel.sweep import run_sweep as jax_sweep
    from transmogrifai_tpu.selector.validators import OpCrossValidation
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    import transmogrifai_tpu_torch as port
    from transmogrifai_tpu_torch.evaluators import evaluators as pev
    from transmogrifai_tpu_torch.models import mlp as pm
    from transmogrifai_tpu_torch.parallel.sweep import run_sweep
    from transmogrifai_tpu_torch.stages.base import FitContext

    name, kw, grids, kind = _handler_case(case)
    X, y = _classes(41)
    if kind == "binary":
        y = (y == 1).astype(np.float32)
    elif kind in ("counts", "counts3"):
        rng = np.random.default_rng(42)
        X = rng.poisson(1.5, (N, D)).astype(np.float32)
        y = (rng.poisson(np.exp(0.2 * X[:, 0])) if kind == "counts"
             else rng.integers(0, 3, N)).astype(np.float32)
        X[y == 1, 1] += 2
    elif kind == "quarters":
        y = (np.round((X[:, 0] * 2 + X[:, 1]) * 4) / 4).astype(np.float32)
    ev_name = {"binary": "BinaryClassificationEvaluator",
               "counts": "RegressionEvaluator",
               "quarters": "RegressionEvaluator"}.get(
        kind, "MultiClassificationEvaluator")
    folds = OpCrossValidation(n_folds=3, seed=7).splits(y.astype(np.float64))
    seed = 9
    want = jax_sweep(getattr(jmodels, name)(**kw), grids, jnp.asarray(X),
                     jnp.asarray(y), folds, getattr(jev, ev_name)(),
                     JaxCtx(n_rows=N, seed=seed))
    layers = (D,) + tuple(kw.get("hidden_layers", ())) + (3,)
    init = [np.asarray(p["W"]) for p in _init_params(
        layers, jax.random.PRNGKey(seed))] if case == "mlp" else None
    with pm.injected_mlp_init(init or (lambda *a: None)):
        got = run_sweep(getattr(port, name)(**kw), grids,
                        torch.from_numpy(X), torch.from_numpy(y), folds,
                        getattr(pev, ev_name)(),
                        FitContext(n_rows=N, seed=seed))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=0,
                               atol=1e-3)


def test_naive_bayes_family_is_dropped_on_negative_features():
    """A family that raises (naive Bayes on negative features) is dropped
    and logged, and the selector goes on with the other families; an
    unported path still raises."""
    from transmogrifai_tpu_torch import (
        MultiClassificationModelSelector, OpDecisionTreeClassifier,
        OpNaiveBayes)
    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.data.columns import Column
    from transmogrifai_tpu_torch.models.base import PredictorEstimator
    from transmogrifai_tpu_torch.stages.base import FitContext

    X, y = _classes(51)
    sel = MultiClassificationModelSelector.with_train_validation_split(
        models=[(OpNaiveBayes(), [{"smoothing": 1.0}]),
                (OpDecisionTreeClassifier(), [{"max_depth": 3}])])
    cols = [Column(PT.RealNN, {"value": y.astype(np.float64),
                               "mask": np.ones(N, bool)}),
            Column(PT.OPVector, X)]
    model = sel.fit_model(cols, FitContext(n_rows=N, device="cpu"))
    assert {r.model for r in model.summary.validation_results} == {
        "OpDecisionTreeClassifier"}

    class OpUnported(PredictorEstimator):
        pass

    sel = MultiClassificationModelSelector.with_train_validation_split(
        models=[(OpUnported(), [{}]),
                (OpDecisionTreeClassifier(), [{"max_depth": 3}])])
    with pytest.raises(NotImplementedError, match="OpUnported"):
        sel.fit_model(cols, FitContext(n_rows=N, device="cpu"))


def test_new_estimators_rebuild_from_jax_params():
    """Each new estimator class rebuilds from the JAX package's params
    under its own name, with the same params (the selector's refit and
    `load_model` construct them that way)."""
    from transmogrifai_tpu import models as jm
    from transmogrifai_tpu_torch import from_jax_params

    for est in (jm.OpLinearSVC(reg_param=0.1, max_iter=50),
                jm.OpGeneralizedLinearRegression(family="gamma",
                                                 link="identity"),
                jm.OpNaiveBayes(smoothing=0.5),
                jm.OpMultilayerPerceptronClassifier(hidden_layers=(4, 3)),
                jm.OpDecisionTreeClassifier(max_depth=7),
                jm.OpDecisionTreeRegressor(min_info_gain=0.1),
                jm.OpLogisticRegression(reg_param=0.2)):
        mine = from_jax_params(type(est).__name__, est.get_params())
        assert type(mine).__module__.startswith("transmogrifai_tpu_torch.")
        assert mine.get_params() == est.get_params()


def test_families_fixtures_are_the_runs():
    """Each fixture holds its run's configs in the selector's order, a
    winner by the selector's rule, finite metrics, the noise runs of the
    optimizer-path families, the MLP's initial weights and the one-config
    runs of every new model class."""
    ns = package("port")
    for run in RUNS:
        with open(os.path.join(fixture_dir(run), "results.json")) as fh:
            res = json.load(fh)
        with np.load(os.path.join(fixture_dir(run), "scores.npz")) as z:
            arr = {k: z[k] for k in z.files}
        models = family_models(ns, run)
        assert res["results"] == [{"model": type(e).__name__, "grid": g}
                                  for e, gs in models for g in gs]
        folds = np.array(res["fold_metrics"])
        assert np.isfinite(folds).all()
        sign = -1.0 if res["metric"] == "RMSE" else 1.0
        win = int(np.argmax(sign * folds.mean(1)))
        assert res["results"][win] == {"model": res["best_model"],
                                       "grid": res["best_grid"]}
        assert set(res["noise"]) == {type(e).__name__ for e, _ in models
                                     if type(e).__name__ in cs.OPTIMIZER_PATH}
        assert len(res["one_config"]) == len(models)
        for i in range(len(models)):
            assert np.isfinite(arr[f"one{i}_prediction"]).all()
    assert len(sum((g for _, g in family_models(ns, "binary")), [])) == 29
    assert len(sum((g for _, g in family_models(ns, "iris")), [])) == 27
    assert len(sum((g for _, g in family_models(ns, "boston")), [])) == 34


if __name__ == "__main__":
    os.environ["TRANSMOGRIFAI_PERF_MODEL"] = "0"
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    _main()
