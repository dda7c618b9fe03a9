"""Parity of the PyTorch port's training slices with the JAX package.

The port trains the README quickstart (transmogrify, sanity checker, a
cross-validated sweep, the winner's refit) on `examples/data/titanic.csv`:
restricted to the XGBoost family over min_child_weight {1, 10}, and
verbatim, with the default LR + RF + XGB sweep. The JAX
package is run in its exact-f32 histogram mode
(TRANSMOGRIFAI_HIST_PRECISION=f32, read once at import, so it runs in a
subprocess started with the variable set); its default bf16 histograms
choose near-tie splits differently by design.

The committed fixture `transmogrifai_tpu_torch/testdata/
titanic_quickstart_train_f32/` holds the JAX package's results at full
width (200 rounds at depth 10, early stopping 20): the sanity checker's
kept indices, the fold-metric matrix, the winner, the refit's round
counts, the train and holdout metrics, and the refit model's scores on
all 891 rows. `chip_smoke.py` holds the port's training on the card to it.
Regenerate it (CPU, several minutes) with:

    TRANSMOGRIFAI_HIST_PRECISION=f32 JAX_PLATFORMS=cpu \\
        python tests/test_torch_train.py

`testdata/titanic_quickstart_default_f32/` holds the JAX package's full
default sweep (28 configs: the fold-metric matrix in the selector's
order, the winner, its train and holdout metrics and scores) and the
forest draws (bootstrap counts and feature masks) of the selector's seed.
Its generator runs one family, and the forest one depth bucket, per
process into a parts directory (a part already there is kept), then
merges them (about 20 minutes on 8 CPU cores, most of it the depth-12
bucket):

    TRANSMOGRIFAI_HIST_PRECISION=f32 JAX_PLATFORMS=cpu \\
        python tests/test_torch_train.py default-fixture <parts_dir>

Tolerances of the quick whole-slice run (20 rounds at depth 4), port on
the CPU against the JAX package in f32 mode:
- kept indices, winner, trees' split features and bins, refit round
  counts: equal;
- fold metrics (AuPR): atol 1e-6 — both sum the PR curve in f32 in
  different orders;
- leaf values: atol 2e-6 — histogram sums run in another order (XLA's
  matmul against row-order adds), which moves a leaf's G/(H+λ) by a few
  ulps;
- scores: rawPrediction atol 2e-5, probability atol 1e-5 (the serving
  tolerances of tests/test_torch_slice.py);
- train and holdout metrics: atol 1e-6.
The quick default-sweep run (2 LR configs, RF of 3 trees at depths 3 and
12, XGB as above; the JAX package's forest draws injected) is held to:
the same configs in the same order, winner equal, fold AuPR within 1e-5
(LR), 1e-3 (RF: equal trees, probabilities summed in another order, so
ties among rows can group differently) and 1e-6 (XGB), train and holdout
AuPR/AuROC within 1e-4, scores at the serving tolerances.
The full-width fixture (200 rounds at depth 10) is held on the card to:
kept indices and winner equal; fold and holdout AuPR atol 1e-2. At that
depth the nodes are small, and two features that split a node's training
rows the same way have gains equal up to the f32 order of their histogram
sums; such a near-tie goes one way in XLA's matmul and the other way in
the port's row-order sums, the trees then differ on the validation rows,
and a fold's early stopping can land 20 rounds apart (observed on the
CPU: one of six folds off by 3.8e-3, the others within 1e-6).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TITANIC = os.path.join(REPO, "examples", "data", "titanic.csv")
TRAIN_FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "testdata",
                             "titanic_quickstart_train_f32")
DEFAULT_FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "testdata",
                               "titanic_quickstart_default_f32")
PRED_KEYS = ("prediction", "rawPrediction", "probability")
QUICK = {"n_estimators": 20, "max_depth": 4}
FULL = {"n_estimators": 200, "max_depth": 10}


def _xgb_kwargs(n_estimators, max_depth):
    return dict(n_estimators=n_estimators, eta=0.02, max_depth=max_depth,
                gamma=0.8, early_stopping_rounds=20)


GRID = [{"min_child_weight": 1.0}, {"min_child_weight": 10.0}]


def _prediction_name(scores):
    names = [k for k, v in scores.items()
             if isinstance(v, dict) and "probability" in v]
    assert len(names) == 1, names
    return names[0]


def _record_refit_rounds(trees_module, record):
    """Wrap the JAX package's `fit_gbt_hosted` (the refit's two passes) in
    `trees_module`'s namespace to record the probe's last live round and
    the shipped round count."""
    inner = trees_module.fit_gbt_hosted

    def wrapped(*args, **kwargs):
        trees, margin = inner(*args, **kwargs)
        leaf = np.asarray(trees["leaf"])
        if kwargs.get("val_w") is not None:
            live = np.any(leaf != 0, axis=(1, 2))
            record["probe_live"] = int(np.flatnonzero(live).max()) + 1
        else:
            record["shipped"] = int(leaf.shape[0])
        return trees, margin

    trees_module.fit_gbt_hosted = wrapped


def jax_train(n_estimators: int, max_depth: int, out_dir: str,
              save_model_to: str = None) -> None:
    """Train the quickstart with the JAX package (call with
    TRANSMOGRIFAI_HIST_PRECISION=f32 set before it is imported) and write
    `results.json` and `scores.npz` to `out_dir`."""
    import transmogrifai_tpu  # noqa: F401  (attaches the DSL)
    from transmogrifai_tpu.automl import transmogrify
    from transmogrifai_tpu.data import Dataset
    from transmogrifai_tpu.features import FeatureBuilder
    from transmogrifai_tpu.models import OpXGBoostClassifier
    from transmogrifai_tpu.models import trees as jt
    from transmogrifai_tpu.selector import BinaryClassificationModelSelector
    from transmogrifai_tpu.workflow import Workflow

    assert jt.HIST_PRECISION == "f32", jt.HIST_PRECISION
    rounds = {}
    _record_refit_rounds(jt, rounds)
    ds = Dataset.from_csv(TITANIC)
    predictors, label = FeatureBuilder.from_dataset(ds, response="survived")
    checked = label.sanity_check(transmogrify(predictors),
                                 remove_bad_features=True)
    pred = BinaryClassificationModelSelector.with_cross_validation(
        models=[(OpXGBoostClassifier(**_xgb_kwargs(n_estimators,
                                                   max_depth)), GRID)]
    ).set_input(label, checked).get_output()
    model = Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).train()
    gbt = next(s for s in model.fitted.values()
               if type(s).__name__ == "GBTClassificationModel")
    checker = next(s for s in model.fitted.values()
                   if type(s).__name__ == "SanityCheckerModel")
    summ = gbt.summary
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as fh:
        json.dump({
            "config": {"n_estimators": n_estimators,
                       "max_depth": max_depth, "grid": GRID},
            "n_kept": len(checker.indices),
            "fold_metrics": [r.fold_metrics
                             for r in summ.validation_results],
            "best_grid": summ.best_grid,
            "refit_rounds": rounds,
            "train_metrics": summ.train_metrics,
            "holdout_metrics": summ.holdout_metrics,
            "splitter": summ.splitter_summary}, fh, indent=1)
    scores = model.score_compiled(ds)
    p = scores[_prediction_name(scores)]
    np.savez_compressed(
        os.path.join(out_dir, "scores.npz"),
        kept_indices=np.asarray(checker.indices, dtype=np.int32),
        **{k: np.asarray(p[k]) for k in PRED_KEYS},
        **({} if n_estimators >= 200 else
           {f"tree_{k}": np.asarray(v) for k, v in gbt.trees.items()}))
    if save_model_to:
        model.save(save_model_to)


# --------------------------------------------------------------------------- #
# the default LR + RF + XGB sweep                                             #
# --------------------------------------------------------------------------- #

# the quick whole-slice run: every family of the default sweep, cut small
QUICK_LR_GRID = [{"reg_param": 0.01, "elastic_net_param": 0.1},
                 {"reg_param": 0.1, "elastic_net_param": 0.5}]
QUICK_RF_GRID = [{"max_depth": 3, "min_info_gain": 0.001,
                  "min_instances_per_node": 10.0},
                 {"max_depth": 12, "min_info_gain": 0.001,
                  "min_instances_per_node": 10.0}]
QUICK_RF_TREES = 3
# the full-width fixture is generated one family at a time (the forest one
# depth bucket at a time), each part in a process of its own
DEFAULT_PARTS = ("lr", "rf3", "rf6", "xgb", "rf12")


def quick_default_models(ns):
    """The quick run's (estimator, grids) list from a namespace holding
    the three estimator classes (either package's)."""
    return [(ns.OpLogisticRegression(max_iter=50),
             [dict(g) for g in QUICK_LR_GRID]),
            (ns.OpRandomForestClassifier(n_trees=QUICK_RF_TREES),
             [dict(g) for g in QUICK_RF_GRID]),
            (ns.OpXGBoostClassifier(**_xgb_kwargs(**QUICK)),
             [dict(g) for g in GRID])]


def jax_forest_draws(seed: int, n_trees: int, n: int, d: int):
    """The bootstrap counts (n_trees, n) and feature masks (n_trees, d)
    that the JAX package's `fit_forest` draws from PRNGKey(seed)
    (`one_tree`, models/trees.py:429-443)."""
    import jax
    import jax.numpy as jnp

    n_sub = max(int(np.sqrt(d)), 1)

    def one(key):
        k1, k2 = jax.random.split(key)
        boot = jax.random.poisson(k1, 1.0, (n,)).astype(jnp.float32)
        scores = jax.random.uniform(k2, (d,))
        return boot, scores <= jnp.sort(scores)[n_sub - 1]

    keys = jax.random.split(jax.random.PRNGKey(seed), n_trees)
    boot, mask = jax.jit(jax.vmap(one))(keys)
    boot = np.asarray(boot)
    assert boot.max() < 256 and np.array_equal(boot, np.round(boot))
    return boot.astype(np.uint8), np.asarray(mask)


def jax_train_selector(models, out_dir: str, forest_trees: int = 0,
                       save_model_to: str = None) -> None:
    """Train the quickstart with the JAX package over `models` (call with
    TRANSMOGRIFAI_HIST_PRECISION=f32 set before it is imported); write
    `results.json` and `scores.npz` (the winner's scores and, with
    `forest_trees`, the forest draws of the selector's seed) to
    `out_dir`."""
    import transmogrifai_tpu  # noqa: F401  (attaches the DSL)
    from transmogrifai_tpu.automl import transmogrify
    from transmogrifai_tpu.data import Dataset
    from transmogrifai_tpu.features import FeatureBuilder
    from transmogrifai_tpu.models import trees as jt
    from transmogrifai_tpu.selector import model_selector as jms
    from transmogrifai_tpu.workflow import Workflow

    assert jt.HIST_PRECISION == "f32", jt.HIST_PRECISION
    seen = {}
    sweep = jms.ModelSelector._run_sweep_with_retry

    def recording_sweep(self, est, grids, X, y_dev, folds, ctx, *a, **kw):
        seen["seed"], seen["shape"] = int(ctx.seed), tuple(X.shape)
        return sweep(self, est, grids, X, y_dev, folds, ctx, *a, **kw)

    jms.ModelSelector._run_sweep_with_retry = recording_sweep
    ds = Dataset.from_csv(TITANIC)
    predictors, label = FeatureBuilder.from_dataset(ds, response="survived")
    checked = label.sanity_check(transmogrify(predictors),
                                 remove_bad_features=True)
    pred = jms.BinaryClassificationModelSelector.with_cross_validation(
        models=models).set_input(label, checked).get_output()
    model = Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).train()
    best = next(s for s in model.fitted.values()
                if hasattr(getattr(s, "summary", None),
                           "validation_results"))
    checker = next(s for s in model.fitted.values()
                   if type(s).__name__ == "SanityCheckerModel")
    summ = best.summary
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as fh:
        json.dump({
            "n_kept": len(checker.indices), "seed": seen["seed"],
            "n_train": seen["shape"][0],
            "results": [{"model": r.model, "grid": r.grid}
                        for r in summ.validation_results],
            "fold_metrics": [r.fold_metrics
                             for r in summ.validation_results],
            "best_model": summ.best_model, "best_grid": summ.best_grid,
            "best_class": type(best).__name__,
            "train_metrics": summ.train_metrics,
            "holdout_metrics": summ.holdout_metrics,
            "splitter": summ.splitter_summary}, fh, indent=1)
    scores = model.score_compiled(ds)
    p = scores[_prediction_name(scores)]
    extra = {}
    if forest_trees:
        extra["forest_boot"], extra["forest_mask"] = jax_forest_draws(
            seen["seed"], forest_trees, *seen["shape"])
    np.savez_compressed(
        os.path.join(out_dir, "scores.npz"),
        kept_indices=np.asarray(checker.indices, dtype=np.int32),
        **{k: np.asarray(p[k]) for k in PRED_KEYS}, **extra)
    if save_model_to:
        model.save(save_model_to)


def jax_default_part(part: str, out_dir: str) -> None:
    """One part of the JAX package's default binary sweep (its
    `_default_binary_models`: LR 8, RF 18 at 50 trees, XGB 2 configs)."""
    from transmogrifai_tpu.selector.model_selector import (
        _default_binary_models)

    lr, rf, xgb = _default_binary_models()
    if part == "lr":
        models = [lr]
    elif part == "xgb":
        models = [xgb]
    else:
        depth = int(part[2:])
        models = [(rf[0], [g for g in rf[1] if g["max_depth"] == depth])]
    jax_train_selector(models, out_dir,
                       forest_trees=rf[0].n_trees if part.startswith("rf")
                       else 0)


def merge_default_parts(parts_dir: str, out_dir: str) -> None:
    """The full default sweep from its parts: fold metrics of the 28
    configs in the selector's order (LR, RF by depth, XGB), the winner by
    its rule (the first largest mean), and the winner's part's refit
    metrics and scores. A part's refit is the full run's refit: the same
    config, rows and seed."""
    res, arr = {}, {}
    for part in DEFAULT_PARTS:
        with open(os.path.join(parts_dir, part, "results.json")) as fh:
            res[part] = json.load(fh)
        with np.load(os.path.join(parts_dir, part, "scores.npz")) as z:
            arr[part] = {k: z[k] for k in z.files}
    order = ("lr", "rf3", "rf6", "rf12", "xgb")
    for key in ("seed", "n_train", "n_kept", "splitter"):
        assert all(res[p][key] == res["lr"][key] for p in order), key
    for p in ("rf6", "rf12"):
        for k in ("forest_boot", "forest_mask"):
            assert np.array_equal(arr[p][k], arr["rf3"][k]), (p, k)
    results, folds, owner = [], [], []
    for p in order:
        results += res[p]["results"]
        folds += res[p]["fold_metrics"]
        owner += [p] * len(res[p]["results"])
    means = [float(np.mean(f)) for f in folds]
    win = max(range(len(means)), key=lambda i: means[i])
    part = owner[win]
    assert res[part]["best_grid"] == results[win]["grid"], part
    assert res[part]["best_model"] == results[win]["model"], part
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as fh:
        json.dump({
            "n_kept": res["lr"]["n_kept"], "seed": res["lr"]["seed"],
            "n_train": res["lr"]["n_train"], "results": results,
            "fold_metrics": folds, "best_model": results[win]["model"],
            "best_grid": results[win]["grid"],
            "best_class": res[part]["best_class"],
            "train_metrics": res[part]["train_metrics"],
            "holdout_metrics": res[part]["holdout_metrics"],
            "splitter": res["lr"]["splitter"]}, fh, indent=1)
    np.savez_compressed(
        os.path.join(out_dir, "scores.npz"),
        kept_indices=arr["lr"]["kept_indices"],
        **{k: arr[part][k] for k in PRED_KEYS},
        forest_boot=arr["rf3"]["forest_boot"],
        forest_mask=arr["rf3"]["forest_mask"])


def _main() -> None:
    """python tests/test_torch_train.py [MODE ...] (see the module
    docstring); every JAX run is in f32 histogram mode."""
    args = sys.argv[1:]
    mode = args[0] if args else "xgb-fixture"
    if mode == "xgb-fixture":
        jax_train(FULL["n_estimators"], FULL["max_depth"], TRAIN_FIXTURE)
    elif mode == "quick-xgb":
        jax_train(QUICK["n_estimators"], QUICK["max_depth"], args[1])
    elif mode == "quick-default":
        from transmogrifai_tpu import models as jm
        jax_train_selector(quick_default_models(jm), args[1],
                           forest_trees=QUICK_RF_TREES,
                           save_model_to=args[2] if len(args) > 2 else None)
    elif mode == "default-part":
        jax_default_part(args[1], args[2])
    elif mode == "default-fixture":
        parts_dir = args[1]
        for part in DEFAULT_PARTS:
            if os.path.exists(os.path.join(parts_dir, part, "scores.npz")):
                continue
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "default-part", part,
                            os.path.join(parts_dir, part)], check=True)
        merge_default_parts(parts_dir, DEFAULT_FIXTURE)
    else:
        raise SystemExit(f"unknown mode {mode!r}")


# --------------------------------------------------------------------------- #
# helpers                                                                     #
# --------------------------------------------------------------------------- #

def port_quickstart(n_estimators, max_depth, device="cpu"):
    from transmogrifai_tpu_torch import (
        BinaryClassificationModelSelector, Dataset, FeatureBuilder,
        OpXGBoostClassifier, Workflow, transmogrify)

    ds = Dataset.from_csv(TITANIC)
    predictors, label = FeatureBuilder.from_dataset(ds, response="survived")
    checked = label.sanity_check(transmogrify(predictors),
                                 remove_bad_features=True)
    pred = BinaryClassificationModelSelector.with_cross_validation(
        models=[(OpXGBoostClassifier(**_xgb_kwargs(n_estimators,
                                                   max_depth)), GRID)]
    ).set_input(label, checked).get_output()
    model = Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).train(device=device)
    return model, ds


def _fitted(model, name):
    return next(s for s in model.fitted.values()
                if type(s).__name__ == name)


def _host(pred):
    return {k: v.cpu().numpy() for k, v in pred.items()}


def assert_scores_close(got, want):
    """The serving tolerances of tests/test_torch_slice.py."""
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=1e-5)
    decided = np.abs(want["rawPrediction"][:, 1]) > 1e-4
    np.testing.assert_array_equal(got["prediction"][decided],
                                  want["prediction"][decided])


# --------------------------------------------------------------------------- #
# feature engineering, sanity checker, splits against the JAX package         #
# --------------------------------------------------------------------------- #

def test_csv_schema_matches_jax():
    from transmogrifai_tpu.data import Dataset as JaxDataset
    from transmogrifai_tpu_torch import Dataset

    want = {k: v.__name__ for k, v in JaxDataset.from_csv(TITANIC)
            .schema.items()}
    got = {k: v.__name__ for k, v in Dataset.from_csv(TITANIC)
           .schema.items()}
    assert list(got.items()) == list(want.items())


@pytest.fixture(scope="module")
def titanic_columns():
    """Raw Titanic columns in both packages, by feature name."""
    from transmogrifai_tpu.data import Dataset as JaxDataset
    from transmogrifai_tpu.features import FeatureBuilder as JaxBuilder
    from transmogrifai_tpu_torch import Dataset, FeatureBuilder

    out = {}
    for ds_cls, builder, key in ((JaxDataset, JaxBuilder, "jax"),
                                 (Dataset, FeatureBuilder, "port")):
        ds = ds_cls.from_csv(TITANIC)
        preds, label = builder.from_dataset(ds, response="survived")
        cols = {f.name: f.origin_stage.materialize(ds)
                for f in preds + [label]}
        out[key] = (preds, label, cols)
    return out


@pytest.mark.parametrize("kind", ["Real", "Integral", "Text"])
def test_vectorizer_fits_match_jax(titanic_columns, kind):
    from transmogrifai_tpu.ops import numeric as jnum, text as jtext
    from transmogrifai_tpu_torch.ops import numeric as pnum, text as ptext
    from transmogrifai_tpu_torch.stages.base import FitContext

    est = {"Real": (jnum.RealVectorizer, pnum.RealVectorizer),
           "Integral": (jnum.IntegralVectorizer, pnum.IntegralVectorizer),
           "Text": (jtext.SmartTextVectorizer, ptext.SmartTextVectorizer)}
    jpreds, _, jcols = titanic_columns["jax"]
    ppreds, _, pcols = titanic_columns["port"]
    names = [f.name for f in jpreds if f.ftype.__name__ == kind]
    assert names
    jfeats = [f for f in jpreds if f.name in names]
    pfeats = [f for f in ppreds if f.name in names]
    jest = est[kind][0]().set_input(*jfeats)
    pest = est[kind][1]().set_input(*pfeats)
    jm = jest.fit([jcols[n] for n in names], None)
    pm = pest.fit([pcols[n] for n in names],
                  FitContext(n_rows=891, device="cpu"))
    jp, pp = jm.get_params(), pm.get_params()
    assert jp.keys() == pp.keys()
    for k in jp:
        if k == "fill_values":  # f32 means: sums in another order
            np.testing.assert_allclose(pp[k], jp[k], rtol=1e-6)
        else:
            assert pp[k] == jp[k], k
    jout = np.asarray(jm.transform([jcols[n] for n in names]).data)
    pout = pm.transform([pcols[n] for n in names], "cpu").data
    np.testing.assert_allclose(pout, jout, rtol=1e-6, atol=0)


def test_binary_vectorizer_fit_matches_jax():
    """Titanic has no Binary column: seeded true/false/missing cells."""
    from transmogrifai_tpu import types as JT
    from transmogrifai_tpu.data.columns import Column as JaxColumn
    from transmogrifai_tpu.ops.numeric import BinaryVectorizer as JaxBV
    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.data.columns import Column
    from transmogrifai_tpu_torch.ops.numeric import BinaryVectorizer
    from transmogrifai_tpu_torch.stages.base import FitContext

    rng = np.random.default_rng(4)
    cells = [[None if r < 0.2 else bool(r < 0.6) for r in rng.random(50)]
             for _ in range(2)]
    for fill in (False, True):
        jm = JaxBV(fill_value=fill).fit_model(
            [JaxColumn.from_values(JT.Binary, c) for c in cells], None)
        pm = BinaryVectorizer(fill_value=fill).fit_model(
            [Column.from_values(PT.Binary, c) for c in cells],
            FitContext(n_rows=50, device="cpu"))
        assert pm.get_params() == jm.get_params()


def test_sanity_checker_matches_jax():
    """Both checkers on the JAX package's 1048-column Titanic vector:
    equal kept indices and drop reasons; moments and label correlations
    within f32 rounding (rtol 1e-5, atol 1e-5: the column sums run in
    another order); min and max equal."""
    import transmogrifai_tpu  # noqa: F401
    from transmogrifai_tpu.automl import sanity_checker as jsc
    from transmogrifai_tpu.automl import transmogrify
    from transmogrifai_tpu.data import Dataset as JaxDataset
    from transmogrifai_tpu.features import FeatureBuilder as JaxBuilder
    from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
    from transmogrifai_tpu_torch.automl import sanity_checker as psc
    from transmogrifai_tpu_torch.data.columns import Column
    from transmogrifai_tpu_torch.data.metadata import VectorMetadata
    from transmogrifai_tpu_torch.stages.base import FitContext
    from transmogrifai_tpu_torch import types as PT

    ds = JaxDataset.from_csv(TITANIC)
    preds, label = JaxBuilder.from_dataset(ds, response="survived")
    vec = transmogrify(preds)
    model = JaxWorkflow().set_result_features(vec, label) \
        .set_input_dataset(ds).train()
    cols = model.score(ds, keep_intermediate=True)
    vcol = cols[vec.uid]
    lcol = cols[label.uid]
    assert vcol.data.shape == (891, 1048)
    jm = jsc.SanityChecker(remove_bad_features=True).fit_model(
        [lcol, vcol], None)
    pv = Column.vector(np.asarray(vcol.data),
                       VectorMetadata.from_json(vcol.meta.to_json()))
    pl = Column(PT.RealNN, {"value": np.asarray(lcol.data["value"]),
                            "mask": np.asarray(lcol.data["mask"])})
    pm = psc.SanityChecker(remove_bad_features=True).fit_model(
        [pl, pv], FitContext(n_rows=891, device="cpu"))
    assert pm.indices == jm.indices
    assert len(pm.indices) == 496
    js, ps = jm.summary, pm.summary
    assert ps["dropped"] == js["dropped"]
    for a, b in zip(ps["stats"], js["stats"]):
        assert a["name"] == b["name"]
        assert a["dropped"] == b["dropped"] or \
            [r.split(" ")[0] for r in a["dropped"]] == \
            [r.split(" ")[0] for r in b["dropped"]]
        for k in ("mean", "variance", "corrLabel"):
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), \
                (a["name"], k, a[k], b[k])
        assert (a["min"], a["max"]) == (b["min"], b["max"])
    assert ps["categoricalStats"] == js["categoricalStats"]


def test_balancer_and_folds_match_jax():
    from transmogrifai_tpu.selector import splitters as jsp
    from transmogrifai_tpu.selector import validators as jva
    from transmogrifai_tpu_torch.selector import splitters as psp
    from transmogrifai_tpu_torch.selector import validators as pva

    from transmogrifai_tpu_torch import Dataset

    rng = np.random.default_rng(0)
    titanic = np.asarray(Dataset.from_csv(TITANIC).column("survived"))
    for y in (titanic, rng.random(5000) < 0.03):
        y = y.astype(np.float64)
        for seed in (42, 7):
            jtr, jte, jsum = jsp.DataBalancer(seed=seed).split(y)
            ptr, pte, psum = psp.DataBalancer(seed=seed).split(y)
            np.testing.assert_array_equal(ptr, jtr)
            np.testing.assert_array_equal(pte, jte)
            jprep, jd = jsp.DataBalancer(seed=seed).prepare(y, jtr)
            pprep, pd = psp.DataBalancer(seed=seed).prepare(y, ptr)
            np.testing.assert_array_equal(pprep, jprep)
            assert pd == jd and psum.to_json() == jsum.to_json()
            for jv, pv in ((jva.OpCrossValidation(3, seed),
                            pva.OpCrossValidation(3, seed)),
                           (jva.OpTrainValidationSplit(0.75, seed),
                            pva.OpTrainValidationSplit(0.75, seed))):
                for (a, b), (c, d) in zip(jv.splits(y[jprep]),
                                          pv.splits(y[pprep])):
                    np.testing.assert_array_equal(c, a)
                    np.testing.assert_array_equal(d, b)


# --------------------------------------------------------------------------- #
# the quick whole-slice run                                                   #
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    """The quick quickstart (20 rounds at depth 4) trained by the JAX
    package in f32 mode in a subprocess, and by the port on the CPU."""
    out = tmp_path_factory.mktemp("jax_quick")
    env = dict(os.environ, TRANSMOGRIFAI_HIST_PRECISION="f32",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "quick-xgb", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "results.json") as fh:
        jax_res = json.load(fh)
    with np.load(out / "scores.npz") as z:
        jax_arr = {k: z[k] for k in z.files}
    model, ds = port_quickstart(**QUICK)
    return jax_res, jax_arr, model, ds


def test_quick_run_selects_like_jax(quick):
    jax_res, jax_arr, model, _ = quick
    gbt = _fitted(model, "GBTClassificationModel")
    checker = _fitted(model, "SanityCheckerModel")
    np.testing.assert_array_equal(checker.indices, jax_arr["kept_indices"])
    summ = gbt.summary
    np.testing.assert_allclose(
        [r.fold_metrics for r in summ.validation_results],
        jax_res["fold_metrics"], rtol=0, atol=1e-6)
    assert summ.best_grid == jax_res["best_grid"]
    assert gbt.refit_rounds == jax_res["refit_rounds"]
    assert summ.splitter_summary == jax_res["splitter"]
    for got, want in ((summ.train_metrics, jax_res["train_metrics"]),
                      (summ.holdout_metrics, jax_res["holdout_metrics"])):
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, k


def test_quick_run_trees_and_scores_match_jax(quick):
    jax_res, jax_arr, model, ds = quick
    gbt = _fitted(model, "GBTClassificationModel")
    bins = jax_arr["tree_bin"]
    np.testing.assert_array_equal(gbt.trees["bin"], bins)
    split = bins < 32
    np.testing.assert_array_equal(gbt.trees["feat"][split],
                                  jax_arr["tree_feat"][split])
    np.testing.assert_allclose(gbt.trees["leaf"], jax_arr["tree_leaf"],
                               rtol=0, atol=2e-6)
    scores = model.score_compiled(ds)
    got = _host(scores[_prediction_name(scores)])
    assert_scores_close(got, jax_arr)


def test_port_saved_model_loads_in_both_packages(quick, tmp_path):
    """The port's save is the JAX package's format: the JAX package's
    load_model scores it within the serving tolerances, and the port's
    own load scores it exactly as the in-memory model does."""
    import transmogrifai_tpu.automl.sanity_checker  # noqa: F401 (ROADMAP F6)
    from transmogrifai_tpu.data import Dataset as JaxDataset
    from transmogrifai_tpu.workflow.serialization import (
        load_model as jax_load)
    from transmogrifai_tpu_torch import load_model

    _, _, model, ds = quick
    path = str(tmp_path / "port_model")
    model.save(path)
    assert sorted(os.listdir(path)) == ["arrays.npz", "integrity.json",
                                        "op-model.json"]
    mine = model.score_compiled(ds)
    want = _host(mine[_prediction_name(mine)])
    again = load_model(path, device="cpu").score_compiled(ds)
    got = _host(again[_prediction_name(again)])
    for k in PRED_KEYS:
        np.testing.assert_array_equal(got[k], want[k])
    jscores = jax_load(path).score_compiled(JaxDataset.from_csv(TITANIC))
    jgot = {k: np.asarray(v) for k, v in
            jscores[_prediction_name(jscores)].items()}
    assert_scores_close(want, jgot)


def test_full_width_fixture_is_the_quickstart():
    with open(os.path.join(TRAIN_FIXTURE, "results.json")) as fh:
        res = json.load(fh)
    with np.load(os.path.join(TRAIN_FIXTURE, "scores.npz")) as z:
        arr = {k: z[k] for k in z.files}
    assert res["config"] == {"n_estimators": 200, "max_depth": 10,
                             "grid": GRID}
    assert res["n_kept"] == 496 and arr["kept_indices"].shape == (496,)
    assert np.array(res["fold_metrics"]).shape == (2, 3)
    assert res["refit_rounds"]["shipped"] == 200
    assert arr["probability"].shape == (891, 2)
    assert res["splitter"]["n_train"] == 802


# --------------------------------------------------------------------------- #
# the default LR + RF + XGB sweep, quick and at full width                    #
# --------------------------------------------------------------------------- #

def test_default_binary_models_match_jax():
    """No `models=`: LR, RF and XGB in the JAX package's order, with its
    grids and estimator parameters."""
    from transmogrifai_tpu.selector.model_selector import (
        _default_binary_models as jax_defaults)
    from transmogrifai_tpu_torch.selector.model_selector import (
        _default_binary_models)

    mine, want = _default_binary_models(), jax_defaults()
    assert [type(e).__name__ for e, _ in mine] == \
        [type(e).__name__ for e, _ in want] == \
        ["OpLogisticRegression", "OpRandomForestClassifier",
         "OpXGBoostClassifier"]
    for (pe, pg), (je, jg) in zip(mine, want):
        assert pg == jg
        assert pe.params == je.params
    assert sum(len(g) for _, g in mine) == 28


@pytest.fixture(scope="module")
def quick_default(tmp_path_factory):
    """The quickstart with every family of the default sweep, cut small
    (2 LR configs, RF of 3 trees at depths 3 and 12, XGB 20 rounds at
    depth 4): the JAX package in f32 mode in a subprocess, and meanwhile
    the port on the CPU with the JAX package's forest draws injected."""
    from transmogrifai_tpu_torch import (
        BinaryClassificationModelSelector, Dataset, FeatureBuilder,
        OpLogisticRegression, OpRandomForestClassifier, OpXGBoostClassifier,
        Workflow, transmogrify)
    from transmogrifai_tpu_torch.models import trees as pt

    out = tmp_path_factory.mktemp("jax_quick_default")
    env = dict(os.environ, TRANSMOGRIFAI_HIST_PRECISION="f32",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "quick-default",
         str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    class Port:
        pass
    for cls in (OpLogisticRegression, OpRandomForestClassifier,
                OpXGBoostClassifier):
        setattr(Port, cls.__name__, cls)
    ds = Dataset.from_csv(TITANIC)
    predictors, label = FeatureBuilder.from_dataset(ds, response="survived")
    checked = label.sanity_check(transmogrify(predictors),
                                 remove_bad_features=True)
    pred = BinaryClassificationModelSelector.with_cross_validation(
        models=quick_default_models(Port)).set_input(label, checked) \
        .get_output()
    with pt.injected_forest_draws(jax_forest_draws):
        model = Workflow().set_result_features(pred, label) \
            .set_input_dataset(ds).train(device="cpu")
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(out / "results.json") as fh:
        jax_res = json.load(fh)
    with np.load(out / "scores.npz") as z:
        jax_arr = {k: z[k] for k in z.files}
    return jax_res, jax_arr, model, ds


def _selected(model):
    return next(s for s in model.fitted.values()
                if hasattr(getattr(s, "summary", None), "validation_results"))


# fold AuPR tolerance per family of the quick default run: LR's products
# sum in another order (weights within 1e-4·max|W|); RF's trees are equal
# (integer histograms) but its probabilities are sums of 3 leaf values in
# another order, so ties among rows can group differently; XGB as in the
# quick XGBoost run
QUICK_DEFAULT_FOLD_ATOL = {"OpLogisticRegression": 1e-5,
                           "OpRandomForestClassifier": 1e-3,
                           "OpXGBoostClassifier": 1e-6}


def test_quick_default_run_selects_like_jax(quick_default):
    jax_res, jax_arr, model, _ = quick_default
    summ = _selected(model).summary
    checker = _fitted(model, "SanityCheckerModel")
    np.testing.assert_array_equal(checker.indices, jax_arr["kept_indices"])
    assert [{"model": r.model, "grid": r.grid}
            for r in summ.validation_results] == jax_res["results"]
    for r, want in zip(summ.validation_results, jax_res["fold_metrics"]):
        np.testing.assert_allclose(r.fold_metrics, want, rtol=0,
                                   atol=QUICK_DEFAULT_FOLD_ATOL[r.model])
    assert (summ.best_model, summ.best_grid) == \
        (jax_res["best_model"], jax_res["best_grid"])
    assert type(_selected(model)).__name__ == jax_res["best_class"]
    assert summ.splitter_summary == jax_res["splitter"]
    for got, want in ((summ.train_metrics, jax_res["train_metrics"]),
                      (summ.holdout_metrics, jax_res["holdout_metrics"])):
        for k in ("AuPR", "AuROC"):
            assert abs(got[k] - want[k]) <= 1e-4, k
    assert set(summ.timings["families"]) == {
        "OpLogisticRegression", "OpRandomForestClassifier",
        "OpXGBoostClassifier"}
    assert "forest:(3, 32, True, 12)" in summ.timings["groups"]


def test_quick_default_model_scores_and_saves_like_jax(quick_default,
                                                       tmp_path):
    """The winner's scores match the JAX package's; its save loads in the
    JAX package's `load_model` and in the port's."""
    import transmogrifai_tpu.automl.sanity_checker  # noqa: F401 (ROADMAP F6)
    from transmogrifai_tpu.data import Dataset as JaxDataset
    from transmogrifai_tpu.workflow.serialization import (
        load_model as jax_load)
    from transmogrifai_tpu_torch import load_model

    _, jax_arr, model, ds = quick_default
    scores = model.score_compiled(ds)
    mine = _host(scores[_prediction_name(scores)])
    assert_scores_close(mine, jax_arr)
    path = str(tmp_path / "port_default_model")
    model.save(path)
    again = load_model(path, device="cpu").score_compiled(ds)
    got = _host(again[_prediction_name(again)])
    for k in PRED_KEYS:
        np.testing.assert_array_equal(got[k], mine[k])
    jscores = jax_load(path).score_compiled(JaxDataset.from_csv(TITANIC))
    assert_scores_close(mine, {k: np.asarray(v) for k, v in
                               jscores[_prediction_name(jscores)].items()})


@pytest.mark.parametrize("family", ["LogisticRegressionModel",
                                    "ForestClassificationModel"])
def test_lr_and_forest_winners_save_for_jax(family, tmp_path):
    """A port-trained LR or forest winner (one config of the quick run)
    saves in the JAX package's format: its `load_model` scores it within
    the serving tolerances, the port's own reload exactly."""
    import transmogrifai_tpu.automl.sanity_checker  # noqa: F401 (ROADMAP F6)
    from transmogrifai_tpu.data import Dataset as JaxDataset
    from transmogrifai_tpu.workflow.serialization import (
        load_model as jax_load)
    from transmogrifai_tpu_torch import (
        BinaryClassificationModelSelector, Dataset, FeatureBuilder,
        OpLogisticRegression, OpRandomForestClassifier, Workflow,
        load_model, transmogrify)

    models = ([(OpLogisticRegression(max_iter=50), [QUICK_LR_GRID[0]])]
              if family == "LogisticRegressionModel" else
              [(OpRandomForestClassifier(n_trees=QUICK_RF_TREES),
                [QUICK_RF_GRID[0]])])
    ds = Dataset.from_csv(TITANIC)
    predictors, label = FeatureBuilder.from_dataset(ds, response="survived")
    pred = BinaryClassificationModelSelector.with_cross_validation(
        models=models).set_input(label, label.sanity_check(
            transmogrify(predictors), remove_bad_features=True)).get_output()
    model = Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).train(device="cpu")
    assert type(_selected(model)).__name__ == family
    path = str(tmp_path / "model")
    model.save(path)
    with open(os.path.join(path, "op-model.json")) as fh:
        assert family in {st["class"] for st in json.load(fh)["stages"]}
    mine = model.score_compiled(ds)
    want = _host(mine[_prediction_name(mine)])
    again = load_model(path, device="cpu").score_compiled(ds)
    got = _host(again[_prediction_name(again)])
    for k in PRED_KEYS:
        np.testing.assert_array_equal(got[k], want[k])
    jscores = jax_load(path).score_compiled(JaxDataset.from_csv(TITANIC))
    assert_scores_close(want, {k: np.asarray(v) for k, v in
                               jscores[_prediction_name(jscores)].items()})


def test_default_fixture_is_the_full_default_sweep():
    from transmogrifai_tpu_torch.selector.model_selector import (
        _default_binary_models)

    with open(os.path.join(DEFAULT_FIXTURE, "results.json")) as fh:
        res = json.load(fh)
    with np.load(os.path.join(DEFAULT_FIXTURE, "scores.npz")) as z:
        arr = {k: z[k] for k in z.files}
    assert res["results"] == [{"model": type(e).__name__, "grid": g}
                              for e, gs in _default_binary_models()
                              for g in gs]
    folds = np.array(res["fold_metrics"])
    assert folds.shape == (28, 3) and np.isfinite(folds).all()
    means = folds.mean(1)
    win = int(np.argmax(means))
    assert res["results"][win] == {"model": res["best_model"],
                                   "grid": res["best_grid"]}
    assert res["n_kept"] == 496 and res["n_train"] == 802
    assert arr["forest_boot"].shape == (50, 802)
    assert arr["forest_mask"].shape == (50, 496)
    assert (arr["forest_mask"].sum(1) == 22).all()
    assert arr["probability"].shape == (891, 2)


# --------------------------------------------------------------------------- #
# entry points and what is not ported                                         #
# --------------------------------------------------------------------------- #

def test_estimators_rebuild_from_jax_params():
    import transmogrifai_tpu  # noqa: F401
    from transmogrifai_tpu.automl.sanity_checker import SanityChecker
    from transmogrifai_tpu.models import (
        OpLogisticRegression, OpRandomForestClassifier, OpXGBoostClassifier)
    from transmogrifai_tpu.ops.numeric import (
        BinaryVectorizer, IntegralVectorizer, RealVectorizer)
    from transmogrifai_tpu.ops.text import SmartTextVectorizer
    from transmogrifai_tpu_torch import from_jax_params

    for est in (RealVectorizer(), IntegralVectorizer(), BinaryVectorizer(),
                SmartTextVectorizer(), SanityChecker(),
                OpXGBoostClassifier(n_estimators=200, eta=0.02,
                                    max_depth=10, gamma=0.8,
                                    early_stopping_rounds=20),
                OpLogisticRegression(max_iter=50),
                OpRandomForestClassifier(n_trees=50)):
        mine = from_jax_params(type(est).__name__, est.get_params())
        assert type(mine).__module__.startswith("transmogrifai_tpu_torch.")
        assert mine.get_params() == est.get_params()


def test_train_raises_without_cuda(monkeypatch):
    import torch
    from transmogrifai_tpu_torch import (
        BinaryClassificationModelSelector, Dataset, FeatureBuilder,
        OpXGBoostClassifier, Workflow, transmogrify)

    ds = Dataset.from_csv(TITANIC)
    preds, label = FeatureBuilder.from_dataset(ds, response="survived")
    pred = BinaryClassificationModelSelector.with_cross_validation(
        models=[(OpXGBoostClassifier(), GRID)]
    ).set_input(label, label.sanity_check(transmogrify(preds))).get_output()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Workflow().set_result_features(pred, label).set_input_dataset(
            ds).train()


def _unported_case(case):
    """Call one path the port has not ported yet (it raises)."""
    import torch
    from transmogrifai_tpu_torch import transmogrify
    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.models import linear as pl
    from transmogrifai_tpu_torch.models import logistic as plog
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.parallel.sweep import run_sweep
    from transmogrifai_tpu_torch.selector import (
        BinaryClassificationModelSelector, MultiClassificationModelSelector)
    from transmogrifai_tpu_torch.stages.base import FeatureGeneratorStage

    X, y3 = torch.zeros((3, 2)), torch.tensor([0., 1., 2.])
    if case == "date_group":
        transmogrify([FeatureGeneratorStage(name="when",
                                            ftype=PT.Date).get_output()])
    elif case == "checkpoint":
        BinaryClassificationModelSelector.with_cross_validation(
            models=[(pt.OpXGBoostClassifier(), GRID)], checkpoint_dir="x")
    elif case == "sweep_family":
        run_sweep(object(), [{}], torch.zeros((4, 2)), torch.zeros(4), [],
                  None, None)
    elif case == "gbt_warm_start":
        est = pt.OpGBTClassifier()
        est.init_params = {"trees": {}}
        est.fit_arrays(X, y3, torch.ones(3), None)
    elif case == "forest_warm_start":
        est = pt.OpRandomForestClassifier()
        est.init_params = {"trees": {}}
        est.fit_arrays(X, y3, torch.ones(3), None)
    elif case == "logistic_warm_start":
        est = plog.OpLogisticRegression(reg_param=0.1)
        est.init_params = {"W": [[0.0] * 3] * 2, "b": [0.0] * 3}
        est.fit_arrays(X, y3, torch.ones(3), None)
    elif case == "warm_start":
        est = pl.OpLinearRegression(reg_param=0.1)
        est.init_params = {"beta": [0.0, 0.0]}
        est.fit_arrays(X, y3, torch.ones(3), None)
    elif case == "multiclass_checkpoint":
        MultiClassificationModelSelector.with_train_validation_split(
            checkpoint_dir="x")


@pytest.mark.parametrize("case,match", [
    ("date_group", "'date' group"), ("checkpoint", "checkpoint"),
    ("sweep_family", "object"), ("gbt_warm_start", "warm starts"),
    ("forest_warm_start", "warm starts"),
    ("logistic_warm_start", "warm starts"),
    ("warm_start", "warm starts"), ("multiclass_checkpoint", "checkpoint")])
def test_unported_paths_raise_and_name_themselves(case, match):
    with pytest.raises(NotImplementedError, match=match):
        _unported_case(case)
    if case == "date_group":
        from transmogrifai_tpu_torch import Dataset, FeatureBuilder
        _, label = FeatureBuilder.from_dataset(Dataset.from_csv(TITANIC),
                                               response="survived")
        assert label.is_response

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["TRANSMOGRIFAI_PERF_MODEL"] = "0"
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    _main()
