"""Parity of the port's feature validation with the JAX package on the
CPU: the RawFeatureFilter (every case of tests/test_raw_feature_filter.py,
its map keys and its rewiring), workflow-level CV (both cases of
tests/test_workflow_cv.py at their sizes, and one with the SanityChecker
as the in-fold supervised stage), and `_apply_rff`'s raise on result
features it leaves unproducible.

Tolerances: the filter's metrics within 1e-12 relative (the same host
f64 arithmetic), its drops, map keys, reasons and config equal. Workflow
CV's fold metrics (L-BFGS logistic regression fits, F5) within PERF.md
§2's rule for the optimizer-path families: max(5e-3, twice the JAX
package's own largest fold-metric move when its raw inputs move by one
f32 ulp), the moves measured by

    JAX_PLATFORMS=cpu python tests/test_torch_feature_validation.py readings

(`ULP_MOVES` below, four noise seeds a case); the best grid equal.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_multiclass import package  # noqa: E402

# the JAX package's largest fold-metric move under one f32 ulp of noise on
# its raw numeric inputs, over NOISE_SEEDS (`readings` prints them): no
# fold AuROC moved at any seed, so the 5e-3 floor holds
ULP_MOVES = {"leaky": 0.0, "honest": 0.0, "parity_plain": 0.0,
             "parity_wcv": 0.0, "checker_wcv": 0.0}
NOISE_SEEDS = (1, 2, 3, 4)
FLOOR = 5e-3
RFF_RTOL = 1e-12


def tolerance(case: str) -> float:
    return max(FLOOR, 2.0 * ULP_MOVES[case])


def api(name: str):
    """The package namespace with the filter, the selector's parts and
    the DAG helpers of either package."""
    ns = package(name)
    if name == "jax":
        from transmogrifai_tpu.automl import raw_feature_filter as rff
        from transmogrifai_tpu.evaluators import (
            BinaryClassificationEvaluator)
        from transmogrifai_tpu.features import dag
        from transmogrifai_tpu.ops.numeric import RealVectorizer
        from transmogrifai_tpu.selector.model_selector import ModelSelector
        from transmogrifai_tpu.selector.validators import OpCrossValidation
        train_kw = {}
    else:
        from transmogrifai_tpu_torch.automl import raw_feature_filter as rff
        from transmogrifai_tpu_torch.evaluators.evaluators import (
            BinaryClassificationEvaluator)
        from transmogrifai_tpu_torch.features import dag
        from transmogrifai_tpu_torch.ops.numeric import RealVectorizer
        from transmogrifai_tpu_torch.selector.model_selector import (
            ModelSelector)
        from transmogrifai_tpu_torch.selector.validators import (
            OpCrossValidation)
        train_kw = {"device": "cpu"}
    ns.rff, ns.dag, ns.RealVectorizer = rff, dag, RealVectorizer
    ns.ModelSelector, ns.OpCrossValidation = ModelSelector, OpCrossValidation
    ns.BinaryEvaluator = BinaryClassificationEvaluator
    ns.train_kw = train_kw
    return ns


# --------------------------------------------------------------------------- #
# RawFeatureFilter                                                            #
# --------------------------------------------------------------------------- #

def filter_rows(n=1000, seed=0, x_fill=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(shift, 1.0, size=n)
    x[rng.uniform(size=n) >= x_fill] = np.nan
    y = (rng.normal(size=n) > 0).astype(float)
    cat = rng.choice(["a", "b", "c"], size=n)
    return [{"x": None if np.isnan(x[i]) else float(x[i]),
             "cat": str(cat[i]), "y": float(y[i])} for i in range(n)]


def filter_dataset(ns, rows):
    t = ns.t
    return ns.Dataset.from_rows(
        rows, schema={"x": t.Real, "cat": t.PickList, "y": t.RealNN})


def leaky_rows():
    n = 600
    rng = np.random.default_rng(3)
    y = (rng.uniform(size=n) > 0.5).astype(float)
    return [{"leaky": (1.0 if y[i] else None), "y": float(y[i]),
             "ok": float(rng.normal())} for i in range(n)]


def map_rows():
    n = 600
    rng = np.random.default_rng(4)
    rows = []
    for i in range(n):
        m = {"good": float(rng.normal())}
        if rng.uniform() < 0.001:  # 'bad' key almost never present
            m["bad"] = 1.0
        rows.append({"m": m, "y": float(i % 2)})
    return rows


def case_datasets(ns, case):
    t = ns.t
    if case == "leakage":
        return ns.Dataset.from_rows(leaky_rows(), schema={
            "leaky": t.Real, "ok": t.Real, "y": t.RealNN}), None
    if case == "map_keys":
        return ns.Dataset.from_rows(map_rows(), schema={
            "m": t.RealMap, "y": t.RealNN}), None
    train, score = FILTER_CASES[case][:2]
    return (filter_dataset(ns, filter_rows(**train)),
            None if score is None else filter_dataset(
                ns, filter_rows(**score)))


# case: (train rows, score rows or None, filter parameters), the cases of
# tests/test_raw_feature_filter.py
FILTER_CASES = {
    "low_fill": ({"x_fill": 0.0005}, None, {"min_fill": 0.01}),
    "healthy": ({}, None, {}),
    "distribution_shift": ({"seed": 1}, {"seed": 2, "shift": 30.0},
                           {"max_js_divergence": 0.5,
                            "min_scoring_rows": 10}),
    "fill_difference": ({"seed": 1, "x_fill": 1.0},
                        {"seed": 2, "x_fill": 0.02},
                        {"max_fill_difference": 0.5,
                         "min_scoring_rows": 10}),
    "small_scoring_set": ({"seed": 1}, {"seed": 2, "shift": 30.0, "n": 50},
                          {"max_js_divergence": 0.1}),
    "protected": ({"x_fill": 0.0005}, None,
                  {"min_fill": 0.01, "protected_features": ["x"]}),
    "leakage": (None, None, {"max_correlation": 0.9}),
    "map_keys": (None, None, {"min_fill": 0.01}),
}


def run_filter(name, case):
    ns = api(name)
    train, score = case_datasets(ns, case)
    preds, label = ns.FeatureBuilder.from_dataset(train, response="y")
    out = ns.rff.RawFeatureFilter(**FILTER_CASES[case][2]) \
        .generate_filtered_raw(train, preds + [label], score_dataset=score,
                               label_feature=label)
    return out


def assert_same_metrics(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gv, wv = vars(g), vars(w)
        assert gv.keys() == wv.keys()
        for k in wv:
            if isinstance(wv[k], float) and wv[k] is not None:
                assert gv[k] == pytest.approx(wv[k], rel=RFF_RTOL,
                                              abs=1e-300), (g.name, k)
            else:
                assert gv[k] == wv[k], (g.name, k)


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_filter_matches_jax(case):
    got, want = run_filter("port", case), run_filter("jax", case)
    assert got.features_to_drop == want.features_to_drop
    assert got.map_keys_to_drop == want.map_keys_to_drop
    assert got.results.config == want.results.config
    assert_same_metrics(got.results.metrics, want.results.metrics)
    assert got.results.to_json()["dropped_map_keys"] == \
        want.results.to_json()["dropped_map_keys"]


def test_filter_outcomes_are_the_jax_tests():
    """What tests/test_raw_feature_filter.py asserts, on the port."""
    drops = {c: run_filter("port", c) for c in FILTER_CASES}
    assert "x" in drops["low_fill"].features_to_drop
    assert "cat" not in drops["low_fill"].features_to_drop
    assert drops["healthy"].features_to_drop == []
    assert "x" in drops["distribution_shift"].features_to_drop
    assert "x" in drops["fill_difference"].features_to_drop
    assert drops["small_scoring_set"].features_to_drop == []
    assert drops["small_scoring_set"].results.config[
        "scoring_set_used"] is False
    assert drops["protected"].features_to_drop == []
    assert drops["leakage"].features_to_drop == ["leaky"]
    out = drops["map_keys"]
    assert out.features_to_drop == [] and out.map_keys_to_drop == {
        "m": ["bad"]}
    cleaned = out.clean_dataset.column("m")
    assert all("bad" not in v for v in cleaned if isinstance(v, dict))


def test_distribution_and_summary_match_jax():
    counts = (np.array([10, 10, 60]), np.array([60, 10, 10]))
    out = {}
    for name in ("port", "jax"):
        rff = api(name).rff
        a = rff.FeatureDistribution("f", None, 100, 20, counts[0])
        b = rff.FeatureDistribution("f", None, 100, 80, counts[1])
        s = rff.Summary.of(np.array([1.0, 2.0, 3.0]))
        out[name] = (a.fill_rate, a.relative_fill_rate(b),
                     a.relative_fill_ratio(b), a.js_divergence(b),
                     a.js_divergence(a), (s.min, s.max, s.sum, s.count),
                     rff.text_bins_formula(s, 7))
    assert out["port"] == out["jax"]


def rewired(name, which):
    ns = api(name)
    ds = filter_dataset(ns, filter_rows())
    preds, label = ns.FeatureBuilder.from_dataset(ds, response="y")
    if which == "variadic":
        result = [ns.transmogrify(preds), label]
    else:
        x = next(f for f in preds if f.name == "x")
        result = [ns.RealVectorizer().set_input(x).get_output()]
    survived, dropped = ns.dag.rewire_without(result, ["x"])
    raws = sorted({r.name for f in survived for r in f.raw_features()})
    kinds = [type(f.origin_stage).__name__ for f in survived]
    return raws, kinds, [d.split("_")[0] for d in dropped]


@pytest.mark.parametrize("which", ["variadic", "fixed_arity"])
def test_rewiring_matches_jax(which):
    got, want = rewired("port", which), rewired("jax", which)
    assert got == want
    if which == "variadic":
        assert got[0] == ["cat", "y"] and got[2] == []
    else:
        assert got[1] == [] and len(got[2]) == 1


def rff_train(name):
    ns = api(name)
    ds = filter_dataset(ns, filter_rows(n=800, x_fill=0.0005))
    preds, label = ns.FeatureBuilder.from_dataset(ds, response="y")
    vec = ns.transmogrify(preds)
    pred = ns.models.OpLogisticRegression(max_iter=15).set_input(
        label, vec).get_output()
    wf = ns.Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).with_raw_feature_filter(min_fill=0.01)
    model = wf.train(**ns.train_kw)
    names = {c.parent_name for c in model.train_columns[vec.uid].meta.columns}
    return wf.blocklist, model.rff_results, sorted(names), model.score(ds)


def test_workflow_with_the_filter_trains_like_jax():
    blocklist, res, names, scores = rff_train("port")
    j_blocklist, j_res, j_names, j_scores = rff_train("jax")
    assert blocklist == j_blocklist == ["x"]
    assert res.dropped_features == j_res.dropped_features
    assert_same_metrics(res.metrics, j_res.metrics)
    assert names == j_names and "x" not in names
    assert len(scores) == len(j_scores) == 2


def unproducible(name):
    ns = api(name)
    ds = filter_dataset(ns, filter_rows(n=800, x_fill=0.0005))
    preds, label = ns.FeatureBuilder.from_dataset(ds, response="y")
    x = next(f for f in preds if f.name == "x")
    only_x = ns.RealVectorizer().set_input(x).get_output()
    wf = ns.Workflow().set_result_features(only_x, label) \
        .set_input_dataset(ds).with_raw_feature_filter(min_fill=0.01)
    with pytest.raises(RuntimeError) as err:
        wf.train(**ns.train_kw)
    return str(err.value), wf.blocklist


def test_apply_rff_raises_on_unproducible_result_features():
    msg, blocklist = unproducible("port")
    j_msg, j_blocklist = unproducible("jax")
    assert blocklist == j_blocklist == ["x"]
    assert "making result features" in msg
    assert msg.split(" making")[0] == j_msg.split(" making")[0]


def test_score_reader_is_refused_until_readers_are_ported():
    ns = api("port")
    with pytest.raises(NotImplementedError, match="queue 1, item 2"):
        ns.Workflow().with_raw_feature_filter(score_reader=object())


# --------------------------------------------------------------------------- #
# workflow-level CV                                                           #
# --------------------------------------------------------------------------- #

def noisy(values: np.ndarray, seed) -> np.ndarray:
    """f32-representable values moved by −1, 0 or +1 f32 ulp (seeded)."""
    if seed is None:
        return values
    r = np.random.default_rng(seed).integers(-1, 2, values.shape)
    v32 = values.astype(np.float32)
    return (v32 * (1.0 + r * 2.0 ** -23)).astype(np.float32).astype(
        np.float64)


def noise_dataset(ns, seed=None):
    rng = np.random.default_rng(11)
    n = 240
    t = ns.t
    return ns.Dataset(
        {"x": noisy(rng.normal(size=n), seed),
         "y": (rng.uniform(size=n) > 0.5).astype(np.float64)},
        {"x": t.Real, "y": t.Integral})


def selector(ns, grids, max_iter, seed):
    return ns.ModelSelector(
        models=[(ns.models.OpLogisticRegression(max_iter=max_iter), grids)],
        validator=ns.OpCrossValidation(n_folds=3, seed=seed),
        splitter=None, evaluator=ns.BinaryEvaluator(metric="AuROC"))


def summary_of(model, pred):
    return model.fitted[pred.origin_stage.uid].summary


def leaky_metrics(name, seed=None):
    """(leaky, honest) fold AuROCs of the JAX test's pipeline: a noise
    feature's supervised buckets (`auto_bucketize`, depth 6) into LR."""
    ns = api(name)
    ds = noise_dataset(ns, seed)
    out = []
    for wcv in (False, True):
        x = ns.FeatureBuilder.Real("x").from_column("x").as_predictor()
        y = ns.FeatureBuilder.RealNN("y").from_column("y").as_response()
        buckets = x.auto_bucketize(y, max_depth=6)
        pred = selector(ns, [{"reg_param": 0.0001}], 30, 7).set_input(
            y, buckets).get_output()
        wf = ns.Workflow().set_result_features(pred, y).set_input_dataset(ds)
        if wcv:
            wf = wf.with_workflow_cv()
        out.append(summary_of(wf.train(**ns.train_kw), pred)
                   .validation_results[0].fold_metrics)
    return out


def parity_dataset(ns, seed=None):
    rng = np.random.default_rng(3)
    n = 300
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    yv = (x1 + 0.5 * x2 + rng.normal(0, 0.7, size=n) > 0).astype(np.float64)
    t = ns.t
    return ns.Dataset({"x1": noisy(x1, seed), "x2": noisy(x2, seed),
                       "y": yv},
                      {"x1": t.Real, "x2": t.Real, "y": t.Integral})


def parity_summaries(name, seed=None, checker=False):
    """(plain CV, workflow CV) summaries of the JAX test's unsupervised
    pipeline (transmogrify into LR, two grids); with `checker` the
    SanityChecker between them, the supervised stage refit in each fold
    under workflow CV."""
    ns = api(name)
    ds = parity_dataset(ns, seed)
    out = []
    for wcv in (False, True):
        preds, label = ns.FeatureBuilder.from_dataset(ds, response="y")
        vec = ns.transmogrify(preds)
        if checker:
            vec = label.sanity_check(vec, remove_bad_features=True)
        pred = selector(ns, [{"reg_param": 0.001}, {"reg_param": 0.1}], 25,
                        5).set_input(label, vec).get_output()
        wf = ns.Workflow().set_result_features(pred, label) \
            .set_input_dataset(ds)
        if wcv:
            wf = wf.with_workflow_cv()
        out.append(summary_of(wf.train(**ns.train_kw), pred))
    return out


def fold_table(summary):
    return {tuple(sorted(r.grid.items())): r.fold_metrics
            for r in summary.validation_results}


@pytest.fixture(scope="module")
def jax_leaky():
    return leaky_metrics("jax")


@pytest.fixture(scope="module")
def jax_parity():
    return parity_summaries("jax")


def test_leaky_stage_scores_honestly_under_workflow_cv(jax_leaky):
    leaky, honest = (float(np.mean(m)) for m in leaky_metrics("port"))
    assert leaky > 0.62, leaky
    assert honest < 0.58, honest
    assert leaky - honest > 0.08
    got = leaky_metrics("port")
    for case, g, w in zip(("leaky", "honest"), got, jax_leaky):
        np.testing.assert_allclose(g, w, rtol=0, atol=tolerance(case))


def test_workflow_cv_parity_when_nothing_leaks(jax_parity):
    plain, wcv = parity_summaries("port")
    assert plain.best_grid == wcv.best_grid
    m_plain = {k: np.mean(v) for k, v in fold_table(plain).items()}
    m_wcv = {k: np.mean(v) for k, v in fold_table(wcv).items()}
    for k in m_plain:
        assert abs(m_plain[k] - m_wcv[k]) < 0.02, (k, m_plain[k], m_wcv[k])
    for case, g, w in zip(("parity_plain", "parity_wcv"), (plain, wcv),
                          jax_parity):
        assert g.best_grid == w.best_grid
        gt, wt = fold_table(g), fold_table(w)
        assert gt.keys() == wt.keys()
        for k in wt:
            np.testing.assert_allclose(gt[k], wt[k], rtol=0,
                                       atol=tolerance(case))


def test_sanity_checker_refits_inside_each_fold():
    """The checker as the in-fold supervised stage: fold metrics and best
    grid as the JAX package's, and under workflow CV the checker fits once
    globally and once a fold, on the fold's training rows."""
    from transmogrifai_tpu_torch.automl import sanity_checker as psc
    calls = []
    fit_model = psc.SanityChecker.fit_model

    def counting(self, cols, ctx):
        calls.append(ctx.n_rows)
        return fit_model(self, cols, ctx)

    psc.SanityChecker.fit_model = counting
    try:
        _, got = parity_summaries("port", checker=True)
    finally:
        psc.SanityChecker.fit_model = fit_model
    # plain CV's one fit, then workflow CV's global fit and one a fold
    assert len(calls) == 2 + 3 and calls[:2] == [300, 300]
    assert all(c < 300 for c in calls[2:])
    _, want = parity_summaries("jax", checker=True)
    assert got.best_grid == want.best_grid
    gt, wt = fold_table(got), fold_table(want)
    for k in wt:
        np.testing.assert_allclose(gt[k], wt[k], rtol=0,
                                   atol=tolerance("checker_wcv"))


def readings() -> None:
    """The JAX package's largest fold-metric move under one f32 ulp of
    noise on its raw numeric inputs, per case (`ULP_MOVES`)."""
    import json
    base_leaky = leaky_metrics("jax")
    base_parity = parity_summaries("jax")
    base_checker = parity_summaries("jax", checker=True)[1]
    moves = {k: 0.0 for k in ULP_MOVES}
    for seed in NOISE_SEEDS:
        for case, g, w in zip(("leaky", "honest"), leaky_metrics("jax", seed),
                              base_leaky):
            moves[case] = max(moves[case], float(np.max(np.abs(
                np.subtract(g, w)))))
        parity = parity_summaries("jax", seed)
        checker = parity_summaries("jax", seed, checker=True)[1]
        for case, g, w in (("parity_plain", parity[0], base_parity[0]),
                           ("parity_wcv", parity[1], base_parity[1]),
                           ("checker_wcv", checker, base_checker)):
            gt, wt = fold_table(g), fold_table(w)
            for k in wt:
                moves[case] = max(moves[case], float(np.max(np.abs(
                    np.subtract(gt[k], wt[k])))))
        print(json.dumps({"seed": seed, "moves": moves}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["readings"]:
        readings()
    else:
        sys.exit("usage: test_torch_feature_validation.py readings")


def fold_width_pipeline(name):
    """A pick list whose rare level clears `pivot`'s min support (10) on
    all rows but not on a fold's training rows, into transmogrify and the
    SanityChecker, under workflow CV."""
    ns = api(name)
    rng = np.random.default_rng(21)
    n = 300
    cat = rng.choice(["a", "b", "c"], size=n).astype(object)
    cat[rng.choice(n, 10, replace=False)] = "rare"
    x = rng.normal(size=n)
    y = ((x + (cat == "a")) > 0.5).astype(np.float64)
    t = ns.t
    ds = ns.Dataset.from_rows(
        [{"cat": cat[i], "x": float(x[i]), "y": float(y[i])}
         for i in range(n)],
        schema={"cat": t.PickList, "x": t.Real, "y": t.RealNN})
    preds, label = ns.FeatureBuilder.from_dataset(ds, response="y")
    checked = label.sanity_check(ns.transmogrify(preds),
                                 remove_bad_features=True)
    pred = selector(ns, [{"reg_param": 0.01}], 20, 3).set_input(
        label, checked).get_output()
    wf = ns.Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).with_workflow_cv()
    return wf, ns, pred


def test_fold_refits_of_other_widths_keep_their_metadata():
    """F17: a fold's refit one-hot is narrower than the global one (the
    rare level misses min support on the fold's rows). The JAX package
    combines the fold's columns under the global metadata, so its fold
    SanityChecker indexes past the fold's matrix; the port's combined
    column carries the metadata of what it combines and trains."""
    wf, ns, pred = fold_width_pipeline("jax")
    with pytest.raises(IndexError):
        wf.train(**ns.train_kw)
    wf, ns, pred = fold_width_pipeline("port")
    folds = summary_of(wf.train(**ns.train_kw), pred) \
        .validation_results[0].fold_metrics
    assert len(folds) == 3 and np.isfinite(folds).all()
