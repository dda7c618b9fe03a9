"""Parity of the PyTorch port's multiclass path with the JAX package: the
Iris example (`examples/op_iris_simple.py`), its label indexer, the
multinomial logistic regression and multiclass forests, the masked
confusion counts (K8-mc) and the multiclass metrics.

The Iris and Boston examples are built the same way in both packages by
`example_pipeline` (the examples' own code, with the selector's `models`
as a parameter). The committed fixtures
`transmogrifai_tpu_torch/testdata/iris_default_f32/` and
`.../boston_default_f32/` hold the JAX package's default sweep of each
example in its exact-f32 histogram mode: the sanity checker's kept
columns, the configs in the selector's order with their validation
metric, the winner, its train and holdout metrics, its scores on every
row, and the forest draws (bootstrap counts and feature masks) of the
selector's seed. `chip_smoke.py` holds the port's training on the card to
them. The generator runs one family, and the forest and GBT one depth
bucket, per process into a parts directory (a part already there is
kept), then merges them (a few minutes on 8 CPU cores):

    JAX_PLATFORMS=cpu python tests/test_torch_multiclass.py \\
        example-fixture iris <parts_dir>
    JAX_PLATFORMS=cpu python tests/test_torch_multiclass.py \\
        example-fixture boston <parts_dir>

Tolerances, port on the CPU against the JAX package:
- K8-mc: the plain `confusion_counts` equals the masked scatter of
  `multiclass_dev` (small-integer and 0/1-weighted sums are exact), and
  the multiclass metrics are within 1e-6;
- K1/K2/K3 with m = 3 class channels: histograms rtol/atol 1e-5, trees
  with equal split bins and features and leaves within 1e-6 (the counts
  are exact in any order);
- forests from the JAX package's draws: equal trees, leaves within 1e-6;
- the multinomial FISTA fit: probabilities within 1e-4 (the same steps,
  products summed in another order);
- the quick Iris run (LR 2 configs, RF of 3 trees at depths 3 and 6):
  kept columns, label order, configs and winner equal; validation F1 and
  holdout metrics within 1e-6 (the same class predictions; the weighted
  average of per-class F1 rounds in f32 in another order); predictions
  equal and probabilities within 1e-4; a saved model scores alike in
  both packages (probabilities within 1e-5).
"""

import importlib
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "examples", "data")
TESTDATA = os.path.join(REPO, "transmogrifai_tpu_torch", "testdata")
PRED_KEYS = ("prediction", "rawPrediction", "probability")
F32_ENV = {"TRANSMOGRIFAI_HIST_PRECISION": "f32", "JAX_PLATFORMS": "cpu"}


# --------------------------------------------------------------------------- #
# the two examples, in either package                                        #
# --------------------------------------------------------------------------- #

def package(name: str) -> SimpleNamespace:
    """The entry points the examples use, from the JAX package ("jax") or
    the port ("port")."""
    if name == "jax":
        import transmogrifai_tpu  # noqa: F401  (attaches the DSL)
        import transmogrifai_tpu.types as t
        from transmogrifai_tpu import models
        from transmogrifai_tpu.automl import transmogrify
        from transmogrifai_tpu.data import Dataset
        from transmogrifai_tpu.features import FeatureBuilder
        from transmogrifai_tpu.selector import model_selector as ms
        from transmogrifai_tpu.workflow import Workflow
        from transmogrifai_tpu.workflow.serialization import load_model
    else:
        import transmogrifai_tpu_torch as models
        import transmogrifai_tpu_torch.types as t
        from transmogrifai_tpu_torch import (
            Dataset, FeatureBuilder, Workflow, load_model, transmogrify)
        from transmogrifai_tpu_torch.selector import model_selector as ms
    return SimpleNamespace(
        t=t, models=models, transmogrify=transmogrify, Dataset=Dataset,
        FeatureBuilder=FeatureBuilder, Workflow=Workflow, ms=ms,
        load_model=load_model)


def example_schema(ns, example: str):
    t = ns.t
    if example == "iris":
        return {"id": t.Integral, "sepalLength": t.Real,
                "sepalWidth": t.Real, "petalLength": t.Real,
                "petalWidth": t.Real, "irisClass": t.Text}
    return {"rowId": t.Integral, "crim": t.RealNN, "zn": t.RealNN,
            "indus": t.RealNN, "chas": t.PickList, "nox": t.RealNN,
            "rm": t.RealNN, "age": t.RealNN, "dis": t.RealNN,
            "rad": t.Integral, "tax": t.RealNN, "ptratio": t.RealNN,
            "b": t.RealNN, "lstat": t.RealNN, "medv": t.RealNN}


def example_dataset(ns, example: str):
    return ns.Dataset.from_csv(os.path.join(DATA, f"{example}.csv"),
                               schema=example_schema(ns, example))


def example_pipeline(ns, example: str, models=None):
    """The example's pipeline (examples/op_iris_simple.py and
    examples/op_boston_simple.py), its selector over `models` (its default
    with None): (label, prediction)."""
    FB = ns.FeatureBuilder
    if example == "iris":
        preds = [FB.Real(c).from_column(c).as_predictor() for c in (
            "sepalLength", "sepalWidth", "petalLength", "petalWidth")]
        label = FB.Text("irisClass").from_column("irisClass") \
            .as_response().indexed()
        selector = ns.ms.MultiClassificationModelSelector
    else:
        kinds = {"chas": "PickList", "rad": "Integral"}
        preds = [getattr(FB, kinds.get(c, "RealNN"))(c).from_column(c)
                 .as_predictor() for c in (
                     "crim", "zn", "indus", "chas", "nox", "rm", "age",
                     "dis", "rad", "tax", "ptratio", "b", "lstat")]
        label = FB.RealNN("medv").from_column("medv").as_response()
        selector = ns.ms.RegressionModelSelector
    checked = label.sanity_check(ns.transmogrify(preds),
                                 remove_bad_features=True)
    prediction = selector.with_train_validation_split(models=models) \
        .set_input(label, checked).get_output()
    return label, prediction


def selected(model):
    return next(s for s in model.fitted.values()
                if hasattr(getattr(s, "summary", None), "validation_results"))


def fitted_named(model, name):
    return next(s for s in model.fitted.values()
                if type(s).__name__ == name)


def prediction_of(scores):
    names = [k for k, v in scores.items()
             if isinstance(v, dict) and "prediction" in v]
    assert len(names) == 1, names
    return {k: np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor)
                          else v) for k, v in scores[names[0]].items()}


# --------------------------------------------------------------------------- #
# the JAX package's runs (subprocesses, f32 histogram mode)                   #
# --------------------------------------------------------------------------- #

# each example's default selector split into parts, one process each:
# (family index in the default models, max_depth or None for all configs)
EXAMPLE_PARTS = {
    "iris": {"lr": (0, None), "rf3": (1, 3), "rf6": (1, 6), "rf12": (1, 12)},
    "boston": {"linreg": (0, None), "rf3": (1, 3), "rf6": (1, 6),
               "rf12": (1, 12), "gbt3": (2, 3), "gbt6": (2, 6),
               "gbt12": (2, 12)},
    "titanic_simple": {"lr": (0, None), "rf3": (1, 3), "rf6": (1, 6),
                       "rf12": (1, 12), "xgb": (2, None)},
}


def default_models(ns, example: str):
    if example == "titanic_simple":
        return ns.ms._default_binary_models()
    return (ns.ms._default_multiclass_models() if example == "iris"
            else ns.ms._default_regression_models())


def registered_age_group(ns):
    """`chip_smoke.titanic_age_group`, registered with package `ns`'s
    `extract_fn` so that a model using it saves and loads."""
    import chip_smoke
    fnser = importlib.import_module(ns.t.__name__.rsplit(".", 1)[0]
                                    + ".utils.fnser")
    if "titanic_age_group" not in fnser._EXTRACT_REGISTRY:
        fnser.extract_fn("titanic_age_group")(chip_smoke.titanic_age_group)
    return chip_smoke.titanic_age_group


def example_inputs(ns, example: str, models=None):
    """(dataset, label, prediction) of the example over `models`; the
    Titanic program (examples/op_titanic_simple.py) takes its `age_group`
    from the registered module-level function."""
    if example == "titanic_simple":
        import chip_smoke
        return chip_smoke.titanic_simple_pipeline(
            ns, models, age_group=registered_age_group(ns))
    label, pred = example_pipeline(ns, example, models)
    return example_dataset(ns, example), label, pred


def jax_example_run(example: str, models, out_dir: str,
                    forest_trees: int = 0, save_model_to: str = None):
    """Train the example with the JAX package (TRANSMOGRIFAI_HIST_PRECISION
    =f32 set before it is imported) over `models` (its default with None);
    write `results.json` and `scores.npz` (the kept columns, the winner's
    scores and, with `forest_trees`, the forest draws of the selector's
    seed) to `out_dir`."""
    from test_torch_train import jax_forest_draws
    from transmogrifai_tpu.models import trees as jt

    ns = package("jax")
    assert jt.HIST_PRECISION == "f32", jt.HIST_PRECISION
    seen = {}
    sweep = ns.ms.ModelSelector._run_sweep_with_retry

    def recording_sweep(self, est, grids, X, y_dev, folds, ctx, *a, **kw):
        seen["seed"], seen["shape"] = int(ctx.seed), tuple(X.shape)
        return sweep(self, est, grids, X, y_dev, folds, ctx, *a, **kw)

    ns.ms.ModelSelector._run_sweep_with_retry = recording_sweep
    ds, label, pred = example_inputs(ns, example, models)
    model = ns.Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).train()
    best = selected(model)
    checker = fitted_named(model, "SanityCheckerModel")
    summ = best.summary
    extra = {}
    if example == "iris":
        extra["labels"] = fitted_named(model, "StringIndexerModel").labels
    if example == "titanic_simple":
        ranked = sorted(model.model_insights().features,
                        key=lambda f: -f.importance)
        extra["insights_top"] = [[f.name, f.importance]
                                 for f in ranked[:10]]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as fh:
        json.dump({
            "n_kept": len(checker.indices), "seed": seen["seed"],
            "n_train": seen["shape"][0],
            "problem_type": summ.problem_type, "metric": summ.metric_name,
            "results": [{"model": r.model, "grid": r.grid}
                        for r in summ.validation_results],
            "fold_metrics": [r.fold_metrics
                             for r in summ.validation_results],
            "best_model": summ.best_model, "best_grid": summ.best_grid,
            "best_class": type(best).__name__,
            "train_metrics": summ.train_metrics,
            "holdout_metrics": summ.holdout_metrics,
            "splitter": summ.splitter_summary, **extra}, fh, indent=1)
    p = prediction_of(model.score_compiled(ds))
    arrays = {}
    if forest_trees:
        arrays["forest_boot"], arrays["forest_mask"] = jax_forest_draws(
            seen["seed"], forest_trees, *seen["shape"])
    np.savez_compressed(
        os.path.join(out_dir, "scores.npz"),
        kept_indices=np.asarray(checker.indices, dtype=np.int32),
        **{k: p[k] for k in PRED_KEYS}, **arrays)
    if save_model_to:
        model.save(save_model_to)


def jax_example_part(example: str, part: str, out_dir: str) -> None:
    ns = package("jax")
    mi, depth = EXAMPLE_PARTS[example][part]
    est, grids = default_models(ns, example)[mi]
    if depth is not None:
        grids = [g for g in grids if g["max_depth"] == depth]
    trees = getattr(est, "n_trees", 0) if part.startswith("rf") else 0
    jax_example_run(example, [(est, grids)], out_dir, forest_trees=trees,
                    save_model_to=(os.path.join(out_dir, "model")
                                   if example == "titanic_simple" else None))


def merge_example_parts(example: str, parts_dir: str, out_dir: str) -> None:
    """The example's default sweep from its parts: the configs' validation
    metrics in the selector's order, the winner by its rule (the first
    best mean: largest F1, smallest RMSE), and the winner's part's refit
    metrics and scores (the same config, rows and seed as in the whole
    run)."""
    res, arr = {}, {}
    parts = list(EXAMPLE_PARTS[example])
    for part in parts:
        with open(os.path.join(parts_dir, part, "results.json")) as fh:
            res[part] = json.load(fh)
        with np.load(os.path.join(parts_dir, part, "scores.npz")) as z:
            arr[part] = {k: z[k] for k in z.files}
    first = res[parts[0]]
    for key in ("seed", "n_train", "n_kept", "splitter", "problem_type",
                "metric"):
        assert all(res[p][key] == first[key] for p in parts), key
    for p in parts:
        np.testing.assert_array_equal(arr[p]["kept_indices"],
                                      arr[parts[0]]["kept_indices"])
    rf = [p for p in parts if p.startswith("rf")]
    for p in rf[1:]:
        for k in ("forest_boot", "forest_mask"):
            assert np.array_equal(arr[p][k], arr[rf[0]][k]), (p, k)
    results, folds, owner = [], [], []
    for p in parts:
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
    if "insights_top" in res[part]:
        extra["insights_top"] = res[part]["insights_top"]
        shutil.rmtree(os.path.join(out_dir, "model"), ignore_errors=True)
        shutil.copytree(os.path.join(parts_dir, part, "model"),
                        os.path.join(out_dir, "model"))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as fh:
        json.dump({
            "example": example, "n_kept": first["n_kept"],
            "seed": first["seed"], "n_train": first["n_train"],
            "problem_type": first["problem_type"], "metric": first["metric"],
            "results": results, "fold_metrics": folds,
            "best_model": results[win]["model"],
            "best_grid": results[win]["grid"],
            "best_class": res[part]["best_class"],
            "train_metrics": res[part]["train_metrics"],
            "holdout_metrics": res[part]["holdout_metrics"],
            "splitter": first["splitter"], **extra}, fh, indent=1)
    np.savez_compressed(
        os.path.join(out_dir, "scores.npz"),
        kept_indices=arr[parts[0]]["kept_indices"],
        **{k: arr[part][k] for k in PRED_KEYS},
        forest_boot=arr[rf[0]]["forest_boot"],
        forest_mask=arr[rf[0]]["forest_mask"])


def example_fixture_dir(example: str) -> str:
    if example == "titanic_simple":
        return os.path.join(TESTDATA, "titanic_simple_f32")
    return os.path.join(TESTDATA, f"{example}_default_f32")


def _main() -> None:
    """python tests/test_torch_multiclass.py MODE ... (see the module
    docstring); every JAX run is in f32 histogram mode."""
    args = sys.argv[1:]
    mode = args[0]
    if mode == "example-part":
        jax_example_part(args[1], args[2], args[3])
    elif mode == "example-run":  # a quick run: models named by a key
        from transmogrifai_tpu import models as jm
        jax_example_run(args[1], quick_models(jm, args[1]), args[2],
                        forest_trees=QUICK_RF_TREES,
                        save_model_to=args[3] if len(args) > 3 else None)
    elif mode == "example-fixture":
        example, parts_dir = args[1], args[2]
        env = dict(os.environ, **F32_ENV)
        procs = []
        for part in EXAMPLE_PARTS[example]:
            out = os.path.join(parts_dir, part)
            if os.path.exists(os.path.join(out, "scores.npz")):
                continue
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "example-part",
                 example, part, out], env=env))
        assert all(p.wait() == 0 for p in procs)
        merge_example_parts(example, parts_dir, example_fixture_dir(example))
    else:
        raise SystemExit(f"unknown mode {mode!r}")


# --------------------------------------------------------------------------- #
# quick runs of both examples                                                 #
# --------------------------------------------------------------------------- #

QUICK_RF_TREES = 3


def quick_models(ns_models, example: str):
    """Every family of the example's default selector, cut small: 2
    elastic-net configs, forests of 3 trees at depths 3 and 6, and for
    Boston a GBT of 5 rounds at depths 3 and 6."""
    m = ns_models
    enet = [{"reg_param": 0.01, "elastic_net_param": 0.1},
            {"reg_param": 0.1, "elastic_net_param": 0.5}]
    trees = [{"max_depth": 3, "min_info_gain": 0.001,
              "min_instances_per_node": 10.0},
             {"max_depth": 6, "min_info_gain": 0.01,
              "min_instances_per_node": 10.0}]
    if example == "iris":
        return [(m.OpLogisticRegression(max_iter=50), enet),
                (m.OpRandomForestClassifier(n_trees=QUICK_RF_TREES), trees)]
    return [(m.OpLinearRegression(), enet),
            (m.OpRandomForestRegressor(n_trees=QUICK_RF_TREES), trees),
            (m.OpGBTRegressor(n_estimators=5, learning_rate=0.1), trees)]


# --------------------------------------------------------------------------- #
# K8-mc and the multiclass metrics                                            #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("k,weights", [(3, "01"), (5, "01"), (3, "frac"),
                                       (32, "01"), (33, "01"), (100, "01"),
                                       (40, "frac")])
def test_confusion_counts_match_multiclass_dev(k, weights):
    import jax.numpy as jnp
    from transmogrifai_tpu.evaluators import device_metrics as jdm
    from transmogrifai_tpu_torch.evaluators import device_metrics as pdm

    rng = np.random.default_rng(k)
    n, P = 301, 4
    y = rng.integers(0, k, n).astype(np.float32)
    pred = np.where(rng.random((P, n)) < 0.6, y,
                    rng.integers(-1, k + 1, (P, n))).astype(np.float32)
    mask = ((rng.random((P, n)) < 0.4).astype(np.float32) if weights == "01"
            else rng.uniform(0, 2, (P, n)).astype(np.float32))
    conf = pdm.confusion_counts(torch.from_numpy(y).int(),
                                torch.from_numpy(pred).int(),
                                torch.from_numpy(mask), k)
    got = pdm.multiclass_dev(torch.from_numpy(y), torch.from_numpy(pred),
                             torch.from_numpy(mask), k)
    for p in range(P):
        yi, pi = np.clip(y, 0, k - 1).astype(int), \
            np.clip(pred[p], 0, k - 1).astype(int)
        want_conf = np.zeros((k, k))
        np.add.at(want_conf, (yi, pi), mask[p].astype(np.float64))
        np.testing.assert_allclose(conf[p].numpy(), want_conf, rtol=1e-6,
                                   atol=0)
        want = jdm.multiclass_dev(jnp.asarray(y), jnp.asarray(pred[p]),
                                  jnp.asarray(mask[p]), k)
        for name in want:
            assert abs(float(got[name][p]) - float(want[name])) <= 1e-6, \
                name
    one = pdm.multiclass_dev(torch.from_numpy(y), torch.from_numpy(pred[0]),
                             torch.from_numpy(mask[0]), k)
    assert one["F1"].dim() == 0 and float(one["F1"]) == float(got["F1"][0])


def test_multiclass_host_metrics_and_evaluator_match_jax():
    from transmogrifai_tpu.evaluators import evaluators as jev
    from transmogrifai_tpu.evaluators import metrics as jmetrics
    from transmogrifai_tpu_torch.evaluators import evaluators as pev
    from transmogrifai_tpu_torch.evaluators import metrics as pmetrics

    rng = np.random.default_rng(7)
    y = rng.integers(0, 4, 200).astype(np.float64)
    p = np.where(rng.random(200) < 0.7, y, rng.integers(0, 4, 200))
    assert pmetrics.multiclass_metrics(y, p).to_json() == \
        jmetrics.multiclass_metrics(y, p).to_json()
    assert pev.MultiClassificationEvaluator().default_metric == \
        jev.MultiClassificationEvaluator().default_metric == "F1"
    assert not pev.MultiClassificationEvaluator("Error").is_larger_better


# --------------------------------------------------------------------------- #
# K1 / K2 / K3 and forests with m = 3 class channels                          #
# --------------------------------------------------------------------------- #

N3, D3, B3, P3 = 240, 9, 16, 3


@pytest.fixture
def exact_histograms(monkeypatch):
    from transmogrifai_tpu.models import trees as jt
    monkeypatch.setattr(jt, "HIST_PRECISION", "f32")
    return jt


def _three_class_values(seed):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, B3, (N3, D3)).astype(np.int8)
    y = np.clip((Xb[:, 0] + rng.integers(0, B3, N3)) * 3 // (2 * B3), 0, 2)
    Y = np.eye(3, dtype=np.float32)[y]
    boot = rng.poisson(1.0, (P3, N3)).astype(np.float32)
    G = (Y.T[None] * boot[:, None, :]).astype(np.float32)
    return Xb, Y, G, boot


@pytest.mark.parametrize("n_nodes", [1, 8])
def test_histograms_with_three_channels_match_jax(exact_histograms, n_nodes):
    import jax.numpy as jnp
    from transmogrifai_tpu_torch.models import trees as pt
    jt = exact_histograms
    Xb, _, G, H = _three_class_values(n_nodes)
    node = np.random.default_rng(2).integers(0, n_nodes, (P3, N3)) \
        .astype(np.int32)
    hg, hh = pt.histograms(torch.from_numpy(Xb), torch.from_numpy(node),
                           torch.from_numpy(G), torch.from_numpy(H),
                           n_nodes, B3)
    assert hg.shape == (P3, 3, n_nodes, D3, B3)
    Bj = jt.bins_onehot(jnp.asarray(Xb), B3)
    for p in range(P3):
        wg, wh = jt._histograms(Bj, jnp.asarray(node[p]),
                                jnp.asarray(G[p].T), jnp.asarray(H[p]),
                                n_nodes)
        np.testing.assert_array_equal(hg[p].numpy(), np.asarray(wg))
        np.testing.assert_array_equal(hh[p].numpy(), np.asarray(wh))


def _assert_trees_equal(got, want, n_bins, leaf_atol=1e-6):
    wb = np.asarray(want["bin"])
    np.testing.assert_array_equal(np.asarray(got["bin"]), wb)
    split = wb < n_bins
    assert split.any()
    np.testing.assert_array_equal(np.asarray(got["feat"])[split],
                                  np.asarray(want["feat"])[split])
    np.testing.assert_allclose(np.asarray(got["leaf"]),
                               np.asarray(want["leaf"]), rtol=0,
                               atol=leaf_atol)


@pytest.mark.parametrize("depth", [5, 12])
def test_grow_trees_with_three_channels_match_jax(exact_histograms, depth):
    """K1, K2 and K3 (routing and the 3-wide leaves) through `grow_trees`;
    depth 12 takes the sibling-subtraction branch (K1-sub)."""
    import jax
    import jax.numpy as jnp
    from transmogrifai_tpu_torch.models import trees as pt
    jt = exact_histograms
    Xb, _, G, H = _three_class_values(20 + depth)
    mcw, mgn = [1.0, 4.0, 2.0], [0.0, 0.01, 0.001]
    tree, node = pt.grow_trees(
        torch.from_numpy(Xb), torch.from_numpy(G), torch.from_numpy(H),
        depth, B3, reg_lambda=1e-6, min_child_weight=mcw,
        min_gain_norm=mgn)
    assert tree["leaf"].shape == (P3, 2 ** depth, 3)
    grow = jax.jit(jax.vmap(lambda g, h, c, t: jt.grow_tree(
        jnp.asarray(Xb), g, h, depth, B3, reg_lambda=1e-6,
        min_child_weight=c, min_gain_norm=t)))
    want = grow(jnp.asarray(np.swapaxes(G, 1, 2)), jnp.asarray(H),
                jnp.asarray(mcw, jnp.float32), jnp.asarray(mgn, jnp.float32))
    _assert_trees_equal(tree, want, B3)
    for p in range(P3):
        walked = jt._tree_walk({k: v[p] for k, v in want.items()},
                               jnp.asarray(Xb))
        np.testing.assert_array_equal(node[p].numpy(), np.asarray(walked))


def test_multiclass_forest_estimator_matches_jax_with_its_draws():
    """`OpRandomForestClassifier` at k = 3 (one-hot labels, 3 class
    channels) against the JAX package's with its draws injected, then its
    probabilities through K5."""
    import jax.numpy as jnp
    from test_torch_train import jax_forest_draws
    from transmogrifai_tpu.models.trees import (
        OpRandomForestClassifier as JaxRF)
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.stages.base import FitContext

    rng = np.random.default_rng(31)
    X = rng.normal(size=(N3, D3)).astype(np.float32)
    y = np.digitize(X[:, 0] + X[:, 3] + rng.normal(size=N3) * 0.5,
                    [-0.7, 0.7]).astype(np.float32)
    kw = dict(n_trees=4, max_depth=12, min_info_gain=0.001,
              min_instances_per_node=5.0)
    jm = JaxRF(**kw).fit_arrays(jnp.asarray(X), jnp.asarray(y),
                                jnp.ones(N3, jnp.float32),
                                JaxCtx(n_rows=N3, seed=5))
    with pt.injected_forest_draws(jax_forest_draws):
        pm = pt.OpRandomForestClassifier(**kw).fit_arrays(
            torch.from_numpy(X), torch.from_numpy(y), torch.ones(N3),
            FitContext(n_rows=N3, seed=5, device="cpu"))
    assert pm.trees["leaf"].shape[-1] == 3
    _assert_trees_equal(pm.trees, jm.trees, 32)
    got = pm.predict_arrays(torch.from_numpy(X))
    want = jm.predict_arrays(jnp.asarray(X))
    np.testing.assert_allclose(got["probability"].numpy(),
                               np.asarray(want["probability"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got["prediction"].numpy(),
                                  np.asarray(want["prediction"]))


# --------------------------------------------------------------------------- #
# more class channels than one K1 / K2 launch takes (m > 4)                   #
# --------------------------------------------------------------------------- #

def _class_values(k, seed, n=N3, d=D3, n_bins=B3, pairs=P3):
    """Binned rows, labels of k classes, and the one-hot value channels G
    (pairs, k, n) times Poisson bootstrap weights H (pairs, n): integer
    sums, exact in any order."""
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, n_bins, (n, d)).astype(np.int8)
    y = np.clip((Xb[:, 0].astype(int) + rng.integers(0, n_bins, n)) * k
                // (2 * n_bins), 0, k - 1)
    Y = np.eye(k, dtype=np.float32)[y]
    boot = rng.poisson(1.0, (pairs, n)).astype(np.float32)
    G = (Y.T[None] * boot[:, None, :]).astype(np.float32)
    return Xb, y, G, boot


@pytest.mark.parametrize("m", [5, 7])
@pytest.mark.parametrize("n_nodes", [1, 8])
def test_histograms_with_many_channels_match_jax(exact_histograms, m,
                                                 n_nodes):
    """`histograms_plain` at m = 5 and 7 value channels against the JAX
    package's `_histograms` (f32 mode): equal (integer sums)."""
    import jax.numpy as jnp
    from transmogrifai_tpu_torch.models import trees as pt
    jt = exact_histograms
    Xb, _, G, H = _class_values(m, 40 + m + n_nodes)
    node = np.random.default_rng(m).integers(0, n_nodes, (P3, N3)) \
        .astype(np.int32)
    hg, hh = pt.histograms(torch.from_numpy(Xb), torch.from_numpy(node),
                           torch.from_numpy(G), torch.from_numpy(H),
                           n_nodes, B3)
    assert hg.shape == (P3, m, n_nodes, D3, B3)
    Bj = jt.bins_onehot(jnp.asarray(Xb), B3)
    for p in range(P3):
        wg, wh = jt._histograms(Bj, jnp.asarray(node[p]),
                                jnp.asarray(G[p].T), jnp.asarray(H[p]),
                                n_nodes)
        np.testing.assert_array_equal(hg[p].numpy(), np.asarray(wg))
        np.testing.assert_array_equal(hh[p].numpy(), np.asarray(wh))


@pytest.mark.parametrize("m", [5, 7])
@pytest.mark.parametrize("masked", [False, True])
def test_split_search_with_many_channels_matches_jax(exact_histograms, m,
                                                     masked):
    """`split_search_plain` at m = 5 and 7 channels against the JAX
    package's `split_from_histograms` on the same histograms: split bins
    equal, and split features equal wherever a node splits."""
    import jax.numpy as jnp
    from transmogrifai_tpu_torch.models import trees as pt
    jt = exact_histograms
    n_nodes = 8
    Xb, _, G, H = _class_values(m, 60 + m)
    node = np.random.default_rng(m + 1).integers(0, n_nodes, (P3, N3)) \
        .astype(np.int32)
    hg, hh = pt.histograms_plain(torch.from_numpy(Xb),
                                 torch.from_numpy(node), torch.from_numpy(G),
                                 torch.from_numpy(H), n_nodes, B3)
    rng = np.random.default_rng(m + 2)
    fmask = rng.random((P3, D3)) < 0.6 if masked else None
    mcw, mgn = [1.0, 3.0, 2.0], [0.0, 0.01, 0.001]
    feat, bins = pt.split_search_plain(
        hg, hh, B3, 1e-6, mcw, 0.0, mgn,
        None if fmask is None else torch.from_numpy(fmask), 1, None)
    for p in range(P3):
        wf, wb = jt.split_from_histograms(
            jnp.asarray(hg[p].numpy()), jnp.asarray(hh[p].numpy()), B3,
            1e-6, mcw[p], 0.0, mgn[p],
            None if fmask is None else jnp.asarray(fmask[p]), 1, None)
        wb = np.asarray(wb)
        np.testing.assert_array_equal(bins[p].numpy(), wb)
        split = wb < B3
        assert split.any()
        np.testing.assert_array_equal(feat[p].numpy()[split],
                                      np.asarray(wf)[split])


@pytest.mark.parametrize("depth", [5, 12])
def test_grow_trees_with_seven_channels_match_jax(exact_histograms, depth):
    """K1, K2 and K3 through `grow_trees` at m = 7 class channels; depth 12
    takes the sibling-subtraction branch."""
    import jax
    import jax.numpy as jnp
    from transmogrifai_tpu_torch.models import trees as pt
    jt = exact_histograms
    Xb, _, G, H = _class_values(7, 80 + depth)
    mcw, mgn = [1.0, 4.0, 2.0], [0.0, 0.01, 0.001]
    tree, node = pt.grow_trees(
        torch.from_numpy(Xb), torch.from_numpy(G), torch.from_numpy(H),
        depth, B3, reg_lambda=1e-6, min_child_weight=mcw,
        min_gain_norm=mgn)
    assert tree["leaf"].shape == (P3, 2 ** depth, 7)
    grow = jax.jit(jax.vmap(lambda g, h, c, t: jt.grow_tree(
        jnp.asarray(Xb), g, h, depth, B3, reg_lambda=1e-6,
        min_child_weight=c, min_gain_norm=t)))
    want = grow(jnp.asarray(np.swapaxes(G, 1, 2)), jnp.asarray(H),
                jnp.asarray(mcw, jnp.float32), jnp.asarray(mgn, jnp.float32))
    _assert_trees_equal(tree, want, B3)


def _seven_class_rows(seed, n=N3, d=D3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.digitize(X[:, 0] + X[:, 3] + rng.normal(size=n) * 0.5,
                    [-1.5, -0.9, -0.3, 0.3, 0.9, 1.5]).astype(np.float32)
    assert len(np.unique(y)) == 7
    return X, y


@pytest.mark.parametrize("estimator", ["forest", "tree"])
def test_seven_class_forest_and_tree_match_jax_with_its_draws(estimator):
    """`OpRandomForestClassifier` (its draws injected) and
    `OpDecisionTreeClassifier` at k = 7 (7 class channels: two K1 launches
    and K2's any-m search on the card) against the JAX package's: trees
    equal, probabilities within 1e-6, predictions equal."""
    import jax.numpy as jnp
    from test_torch_train import jax_forest_draws
    from transmogrifai_tpu.models import trees as jtrees
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.stages.base import FitContext

    X, y = _seven_class_rows(71)
    n = X.shape[0]
    if estimator == "forest":
        kw = dict(n_trees=4, max_depth=12, min_info_gain=0.001,
                  min_instances_per_node=5.0)
        jcls, pcls = jtrees.OpRandomForestClassifier, \
            pt.OpRandomForestClassifier
    else:
        kw = dict(max_depth=6, min_info_gain=0.001,
                  min_instances_per_node=3.0)
        jcls, pcls = jtrees.OpDecisionTreeClassifier, \
            pt.OpDecisionTreeClassifier
    jm = jcls(**kw).fit_arrays(jnp.asarray(X), jnp.asarray(y),
                               jnp.ones(n, jnp.float32),
                               JaxCtx(n_rows=n, seed=5))
    with pt.injected_forest_draws(jax_forest_draws):
        pm = pcls(**kw).fit_arrays(
            torch.from_numpy(X), torch.from_numpy(y), torch.ones(n),
            FitContext(n_rows=n, seed=5, device="cpu"))
    assert pm.trees["leaf"].shape[-1] == 7
    _assert_trees_equal(pm.trees, jm.trees, 32)
    got = pm.predict_arrays(torch.from_numpy(X))
    want = jm.predict_arrays(jnp.asarray(X))
    np.testing.assert_allclose(got["probability"].numpy(),
                               np.asarray(want["probability"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got["prediction"].numpy(),
                                  np.asarray(want["prediction"]))


@pytest.mark.parametrize("m", list(range(1, 14)))
def test_histogram_launches_take_every_channel_once(m):
    """K1's channel groups on the card: the weights once, every value
    channel once, at most 4 value channels and one slot a launch, no
    launch without a value channel."""
    from transmogrifai_tpu_torch.models import trees as pt
    groups = pt.hist_channel_groups(m, 4)
    assert groups[0][0] == 0 and groups[0][2] is None
    seen = []
    for c0, v, slot in groups:
        assert 1 <= v <= 4
        seen.extend(range(c0, c0 + v))
        if slot is not None:
            assert slot == c0 + v
            seen.append(slot)
    assert seen == list(range(m))
    if m <= 4:
        assert groups == [(0, m, None)]


@pytest.mark.parametrize("P,n,k", [(8, 135, 3), (18, 65536, 3),
                                   (18, 65536, 32), (18, 65536, 100),
                                   (18, 65536, 300), (1, 0, 1), (3, 1, 2),
                                   (200, 5000, 7)])
def test_confusion_plan_covers_the_rows(P, n, k):
    """K8-mc's launch plan: G ranges of `chunk` rows cover each pair's n
    rows with no empty range; a block's warps' f64 histograms fit its
    shared memory, else one warp a block over global scratch (k > 170);
    the scratch stays within its budget."""
    from transmogrifai_tpu_torch.evaluators import device_metrics as pdm
    G, chunk, warps, shared = pdm.confusion_plan(P, n, k)
    assert G >= 1 and G * chunk >= n and (G - 1) * chunk < max(n, 1)
    assert 1 <= warps <= 8
    assert shared == (k <= 170)
    if shared:
        assert warps * k * k * 8 <= 227 * 1024
    else:
        assert warps == 1
    if G > 1:
        assert P * G * k * k * 8 <= 1 << 28 and chunk >= 4096
        assert P * G <= 132 * 32  # no more blocks than the SMs hold
    Gr, chunk_r = pdm.moments_row_blocks(P, n)
    assert Gr >= 1 and Gr * chunk_r >= n and (Gr - 1) * chunk_r < max(n, 1)


def test_multinomial_fista_matches_jax():
    import jax.numpy as jnp
    from transmogrifai_tpu.models import logistic as jl
    from transmogrifai_tpu_torch.models import logistic as pl

    rng = np.random.default_rng(41)
    n, d, k = 180, 6, 3
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.argmax(X[:, :3] + rng.normal(size=(n, 3)), 1).astype(np.float32)
    w = (rng.random((2, n)) < 0.75).astype(np.float32)
    l1, l2 = [0.001, 0.05], [0.009, 0.05]
    got = pl.fit_logreg_enet(torch.from_numpy(X), torch.from_numpy(y),
                             torch.from_numpy(w), l1, l2, k, 200)
    for q in range(2):
        want = jl.fit_logreg_enet(jnp.asarray(X), jnp.asarray(y),
                                  jnp.asarray(w[q]), jnp.float32(l1[q]),
                                  jnp.float32(l2[q]), k, 200)
        logits = X @ got["W"][q].numpy() + got["b"][q].numpy()
        jlog = X @ np.asarray(want["W"]) + np.asarray(want["b"])
        p = np.exp(logits - logits.max(1, keepdims=True))
        jp = np.exp(jlog - jlog.max(1, keepdims=True))
        np.testing.assert_allclose(p / p.sum(1, keepdims=True),
                                   jp / jp.sum(1, keepdims=True), rtol=0,
                                   atol=1e-4)


# --------------------------------------------------------------------------- #
# the label indexer and the splitter                                          #
# --------------------------------------------------------------------------- #

def test_string_indexer_orders_labels_like_jax():
    from transmogrifai_tpu import types as JT
    from transmogrifai_tpu.data.columns import Column as JaxColumn
    from transmogrifai_tpu.ops.indexers import OpStringIndexer as JaxIdx
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.data.columns import Column
    from transmogrifai_tpu_torch.ops.indexers import OpStringIndexer
    from transmogrifai_tpu_torch.stages.base import FitContext

    # ties in count broken by the label, as Iris's 50 / 50 / 50
    vals = ["b", "c", "a", None, "c", "a", "b", "d", "c", "a", "b"]
    data = np.array(vals, dtype=object)
    mine = OpStringIndexer().fit_model([Column(PT.Text, data)],
                                       FitContext(n_rows=11))
    theirs = JaxIdx().fit_model([JaxColumn(JT.Text, data)],
                                JaxCtx(n_rows=11))
    assert mine.labels == theirs.labels == ["a", "b", "c", "d"]
    got = mine.host_prepare([Column(PT.Text, data)])
    want = theirs.host_prepare([JaxColumn(JT.Text, data)])
    np.testing.assert_array_equal(got["value"], want["value"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    with pytest.raises(ValueError, match="Unseen label 'e'"):
        mine.host_prepare([Column(PT.Text, np.array(["e"], dtype=object))])


def test_data_cutter_matches_jax():
    from transmogrifai_tpu.selector.splitters import DataCutter as JaxCutter
    from transmogrifai_tpu_torch.selector.splitters import DataCutter

    y = np.random.default_rng(3).integers(0, 6, 400).astype(np.float64)
    y[:5] = 9.0  # a rare label
    for kw in ({}, {"max_label_categories": 3},
               {"min_label_fraction": 0.05}):
        a, b = DataCutter(**kw), JaxCutter(**kw)
        tr, te, sa = a.split(y)
        tr2, te2, sb = b.split(y)
        np.testing.assert_array_equal(tr, tr2)
        np.testing.assert_array_equal(te, te2)
        pa, da = a.prepare(y, tr)
        pb, db = b.prepare(y, tr2)
        np.testing.assert_array_equal(pa, pb)
        assert da == db and sa.to_json() == sb.to_json()


def test_default_multiclass_models_match_jax():
    jns, pns = package("jax"), package("port")
    for (je, jg), (pe, pg) in zip(default_models(jns, "iris"),
                                  default_models(pns, "iris")):
        assert type(je).__name__ == type(pe).__name__
        assert je.get_params() == pe.get_params() and jg == pg
    assert len(sum((g for _, g in default_models(pns, "iris")), [])) == 26


# --------------------------------------------------------------------------- #
# the Iris example, quick and at full width                                   #
# --------------------------------------------------------------------------- #

def port_example_run(example: str, models=None, device="cpu", draws=None):
    """Train the example with the port (the JAX package's forest draws
    injected, `draws` a function of (seed, n_trees, n, d) or a pair)."""
    from test_torch_train import jax_forest_draws
    from transmogrifai_tpu_torch.models import trees as pt

    ns = package("port")
    ds = example_dataset(ns, example)
    label, pred = example_pipeline(ns, example, models)
    with pt.injected_forest_draws(draws or jax_forest_draws):
        model = ns.Workflow().set_result_features(pred, label) \
            .set_input_dataset(ds).train(device=device)
    return model, ds


def jax_quick_run(tmp_path_factory, example):
    """The quick run of `example` by the JAX package in f32 mode, in a
    subprocess, its model saved: (results, arrays, model path)."""
    out = tmp_path_factory.mktemp(f"jax_quick_{example}")
    saved = str(out / "model")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "example-run", example,
         str(out), saved], cwd=REPO, env=dict(os.environ, **F32_ENV),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out, saved


def jax_quick_result(proc, out):
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(os.path.join(out, "results.json")) as fh:
        res = json.load(fh)
    with np.load(os.path.join(out, "scores.npz")) as z:
        arr = {k: z[k] for k in z.files}
    return res, arr


@pytest.fixture(scope="module")
def quick_iris(tmp_path_factory):
    proc, out, saved = jax_quick_run(tmp_path_factory, "iris")
    import transmogrifai_tpu_torch as port
    model, ds = port_example_run("iris", quick_models(port, "iris"))
    res, arr = jax_quick_result(proc, out)
    return res, arr, saved, model, ds


def test_quick_iris_selects_like_jax(quick_iris):
    res, arr, _, model, _ = quick_iris
    summ = selected(model).summary
    np.testing.assert_array_equal(
        fitted_named(model, "SanityCheckerModel").indices,
        arr["kept_indices"])
    assert fitted_named(model, "StringIndexerModel").labels == res["labels"]
    assert [{"model": r.model, "grid": r.grid}
            for r in summ.validation_results] == res["results"]
    # the same class predictions on the same rows; the weighted average
    # of the per-class F1 rounds in f32 in another order (1e-6)
    np.testing.assert_allclose(
        [r.fold_metrics for r in summ.validation_results],
        res["fold_metrics"], rtol=0, atol=1e-6)
    assert (summ.best_model, summ.best_grid) == (res["best_model"],
                                                 res["best_grid"])
    assert summ.problem_type == "multiclass"
    assert summ.splitter_summary == res["splitter"]
    for k in ("F1", "Precision", "Recall", "Error"):
        assert abs(summ.holdout_metrics[k] - res["holdout_metrics"][k]) \
            <= 1e-6, k


def test_quick_iris_scores_and_saves_like_jax(quick_iris, tmp_path):
    """The winner's scores equal the JAX package's (LR probabilities within
    1e-4); the port's save loads in both packages and scores alike; the
    JAX package's saved model loads in the port and scores alike."""
    res, arr, jax_saved, model, ds = quick_iris
    got = prediction_of(model.score_compiled(ds))
    np.testing.assert_array_equal(got["prediction"], arr["prediction"])
    np.testing.assert_allclose(got["probability"], arr["probability"],
                               rtol=0, atol=1e-4)
    path = str(tmp_path / "port_iris")
    model.save(path)
    pns, jns = package("port"), package("jax")
    again = prediction_of(pns.load_model(path, device="cpu")
                          .score_compiled(ds))
    for k in PRED_KEYS:
        np.testing.assert_array_equal(again[k], got[k])
    import transmogrifai_tpu.automl.sanity_checker  # noqa: F401 (ROADMAP F6)
    jds = example_dataset(jns, "iris")
    theirs = prediction_of(jns.load_model(path).score_compiled(jds))
    np.testing.assert_array_equal(theirs["prediction"], got["prediction"])
    np.testing.assert_allclose(theirs["probability"], got["probability"],
                               rtol=0, atol=1e-5)
    mine = prediction_of(pns.load_model(jax_saved, device="cpu")
                         .score_compiled(ds))
    np.testing.assert_array_equal(mine["prediction"], arr["prediction"])
    np.testing.assert_allclose(mine["probability"], arr["probability"],
                               rtol=0, atol=1e-5)


def test_iris_fixture_is_the_default_sweep():
    with open(os.path.join(example_fixture_dir("iris"), "results.json")) \
            as fh:
        res = json.load(fh)
    ns = package("port")
    want = [{"model": type(e).__name__, "grid": g}
            for e, grids in default_models(ns, "iris") for g in grids]
    assert res["results"] == want and res["problem_type"] == "multiclass"
    assert res["labels"] == ["Iris-setosa", "Iris-versicolor",
                             "Iris-virginica"]
    assert res["holdout_metrics"]["F1"] >= 0.80
    with np.load(os.path.join(example_fixture_dir("iris"), "scores.npz")) \
            as z:
        assert z["forest_boot"].shape == (50, res["n_train"])
        assert z["probability"].shape == (150, 3)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _main()
