"""Parity of the PyTorch port with the JAX package on the main-path
script, `examples/op_titanic_simple.py`: its math, scaler and row
transformers, the model insights, and the script's whole slice.

The committed fixture `transmogrifai_tpu_torch/testdata/titanic_simple_f32/`
holds the JAX package's run of the script's pipeline in its exact-f32
histogram mode, with the default LR + RF + XGB selector over a
train/validation split: the kept columns, the configs with their
validation AuPR, the winner, its train and holdout metrics, its scores
and insights, the forest draws of the selector's seed, and the saved
model (`model/`, its `age_group` the registered module-level
`chip_smoke.titanic_age_group`: the script's lambda cannot be saved by
the port). `quant_scores.npz` beside it, and beside
`testdata/titanic_quickstart_gbt/`, holds the JAX package's quantized
scores of each saved model (int8, int4, int8-calibrated) over the 891
rows in batches of 64, and the sha256 of each batch's wire
(`chip_smoke.wire_digest`). Regenerate them (a few minutes on 8 CPU
cores):

    JAX_PLATFORMS=cpu python tests/test_torch_multiclass.py \\
        example-fixture titanic_simple <parts_dir>
    JAX_PLATFORMS=cpu python tests/test_torch_titanic_simple.py quant-fixture
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TESTDATA = os.path.join(REPO, "transmogrifai_tpu_torch", "testdata")
SIMPLE_FIXTURE = os.path.join(TESTDATA, "titanic_simple_f32")
GBT_FIXTURE = os.path.join(TESTDATA, "titanic_quickstart_gbt")
QUANT_MODES = ("int8", "int4", "int8-calibrated")
QUANT_BATCH = 64
PRED_KEYS = ("prediction", "rawPrediction", "probability")


def quant_fixture_inputs(ns, which: str):
    """(saved model dir, scoring dataset) of a quant fixture: "simple"
    (the script's model, its schema) or "gbt" (the quickstart GBT)."""
    import chip_smoke
    if which == "simple":
        return (os.path.join(SIMPLE_FIXTURE, "model"),
                ns.Dataset.from_csv(chip_smoke.TITANIC,
                                    schema=chip_smoke.titanic_simple_schema(
                                        ns.t)))
    return GBT_FIXTURE, ns.Dataset.from_csv(chip_smoke.TITANIC)


def jax_quant_scores(which: str) -> None:
    """Score a fixture's saved model with the JAX package in each quant
    mode over the 891 rows in batches of 64 (`score_padded(batch, 64)`),
    recording each batch's wire; write `quant_scores.npz` beside it."""
    import chip_smoke
    import transmogrifai_tpu.automl.sanity_checker  # noqa: F401  (F6)
    from transmogrifai_tpu.workflow import compiled as jc
    from test_torch_multiclass import package, prediction_of, \
        registered_age_group

    ns = package("jax")
    registered_age_group(ns)
    model_dir, ds = quant_fixture_inputs(ns, which)
    model = ns.load_model(model_dir)
    seen, inner = [], jc.quantize_wire

    def recording(tree, bits, ranges=None):
        out = inner(tree, bits, ranges=ranges)
        seen.append(out)
        return out

    jc.quantize_wire = recording
    arrays = {}
    try:
        for mode in QUANT_MODES:
            scorer = model._ensure_compiled(quant=mode)
            parts, digests = [], []
            for s in range(0, len(ds), QUANT_BATCH):
                batch = ds.take(np.arange(s, min(s + QUANT_BATCH,
                                                 len(ds))))
                seen.clear()
                parts.append(prediction_of(
                    scorer.score_padded(batch, QUANT_BATCH)))
                digests.append(chip_smoke.wire_digest(seen))
            for k in PRED_KEYS:
                arrays[f"{mode}:{k}"] = np.concatenate(
                    [p[k] for p in parts])
            arrays[f"{mode}:wire_sha256"] = np.asarray(digests)
    finally:
        jc.quantize_wire = inner
    out_dir = SIMPLE_FIXTURE if which == "simple" else GBT_FIXTURE
    np.savez_compressed(os.path.join(out_dir, "quant_scores.npz"), **arrays)


# --------------------------------------------------------------------------- #
# the script's slice at a 2-config grid (both packages)                       #
# --------------------------------------------------------------------------- #

def smoke_models(m):
    """`TestDefaultProfileParitySmoke::test_titanic_smoke`'s grid."""
    return [(m.OpLogisticRegression(max_iter=40), [{"reg_param": 0.01}]),
            (m.OpXGBoostClassifier(n_estimators=20, max_depth=3),
             [{"eta": 0.3}])]


def train_script(ns, models, age_group=None, **train_kw):
    """The script's pipeline over `models`, trained: (model, dataset,
    prediction feature)."""
    import chip_smoke
    ds, label, pred = chip_smoke.titanic_simple_pipeline(
        ns, models, age_group=age_group)
    model = ns.Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).train(**train_kw)
    return model, ds, pred


def smoke_record(model, ds) -> dict:
    """What the smoke comparison reads of a trained model (either
    package): the selector's results, the kept columns, the insights, the
    calibration by feature name, and the scores."""
    from test_torch_multiclass import fitted_named, prediction_of, selected
    summ = selected(model).summary
    names = {f.uid: f.name for rf in model.result_features
             for f in rf.traverse()}
    ranked = sorted(model.model_insights().features,
                    key=lambda f: -f.importance)
    return {
        "results": [{"model": r.model, "grid": r.grid}
                    for r in summ.validation_results],
        "fold_metrics": [r.fold_metrics for r in summ.validation_results],
        "best_model": summ.best_model, "best_grid": summ.best_grid,
        "holdout_metrics": summ.holdout_metrics,
        "kept": list(fitted_named(model, "SanityCheckerModel").indices),
        "insights": [[f.name, f.importance, [
            [d.name, d.contribution] for d in f.derived]] for f in ranked],
        "calibration": {names[u]: v for u, v in
                        (model.quant_calibration or {}).items()},
        "scores": {k: v.tolist() for k, v in prediction_of(
            model.score_compiled(ds)).items()}}


def jax_smoke_run(out_path: str) -> None:
    """The smoke run in the JAX package (f32 histograms: run with
    TRANSMOGRIFAI_HIST_PRECISION=f32), its record written as JSON."""
    import json
    from test_torch_multiclass import package
    from transmogrifai_tpu.models import trees as jt

    assert jt.HIST_PRECISION == "f32", jt.HIST_PRECISION
    ns = package("jax")
    model, ds, _ = train_script(ns, smoke_models(ns.models))
    with open(out_path, "w") as fh:
        json.dump(smoke_record(model, ds), fh)


# --------------------------------------------------------------------------- #
# the tests                                                                   #
# --------------------------------------------------------------------------- #

import re  # noqa: E402
import subprocess  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from transmogrifai_tpu_torch.stages.base import compiled_scoring  # noqa


def _scalar_inputs(seed, n=257):
    """Seeded value/mask pairs with zeros, negatives, a huge value and
    missing cells."""
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=n) * rng.choice([0.01, 1.0, 300.0], n)).astype(
        np.float32)
    v[rng.integers(0, n, 12)] = 0.0
    v[rng.integers(0, n, 3)] = 3e38
    v[rng.integers(0, n, 5)] = np.float32(2.5)
    m = (rng.random(n) > 0.15).astype(np.float32)
    return {"value": np.where(m > 0, v, 0.0).astype(np.float32), "mask": m}


def _jax_apply(stage, dev, jit):
    import jax
    import jax.numpy as jnp
    args = [{k: jnp.asarray(v) for k, v in d.items()} for d in dev]
    fn = (lambda a: stage.device_apply(None, a))
    out = jax.jit(fn)(args) if jit else fn(args)
    return {k: np.asarray(v).astype(np.float32) for k, v in out.items()}


def _port_apply(stage, dev, jit, consts=None):
    args = [{k: torch.from_numpy(v) for k, v in d.items()} for d in dev]
    if jit:  # the compiled scorer's rounding (`div_const`)
        with compiled_scoring():
            out = (stage.device_apply_with(consts, None, args)
                   if consts is not None else stage.device_apply(None, args))
    else:
        out = (stage.device_apply_with(consts, None, args)
               if consts is not None else stage.device_apply(None, args))
    return {k: v.numpy().astype(np.float32) for k, v in out.items()}


def _ftz(v):
    """Subnormal results as signed zeros: XLA's CPU programs flush them
    (the port's torch ops on the CPU keep them)."""
    v = np.asarray(v, np.float32)
    return np.where(np.abs(v) < np.finfo(np.float32).tiny,
                    np.copysign(np.float32(0), v), v).astype(np.float32)


# exp, log and pow come from each library's own math routines (XLA's CPU
# exp is its own polynomial: up to 79 ulps, 9.4e-6 relative, on these
# inputs): within 2e-5 relative
_TRANSCENDENTAL = {"exp", "log", "power"}
_TRANSCENDENTAL_RTOL = 2e-5

MATH_CASES = (
    [("binary", op, None) for op in ("plus", "minus", "multiply", "divide")]
    + [("scalar", op, s) for op in ("plus", "minus", "rminus", "multiply",
                                    "divide", "rdivide")
       for s in (3.7, 0.0)]
    + [("unary", op, a) for op, a in (
        ("abs", 0.0), ("ceil", 0.0), ("floor", 0.0), ("round", 0.0),
        ("exp", 0.0), ("sqrt", 0.0), ("negate", 0.0), ("log", 0.0),
        ("log", 10.0), ("power", 2.0), ("power", 0.5))])


@pytest.mark.parametrize("kind,op,arg", MATH_CASES)
@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_mathops_match_jax(kind, op, arg, jit):
    """Values and masks equal to the JAX package's (exp, log and pow within
    2e-5 relative; subnormal results compared as the zeros XLA flushes
    them to), op by op (`transform`) and inside the compiled program,
    where a division by a constant is a product with its reciprocal and
    a·x + b one fused multiply-add."""
    from transmogrifai_tpu.ops import mathops as jm
    from transmogrifai_tpu_torch.ops import mathops as pm
    if kind == "binary":
        dev = [_scalar_inputs(1), _scalar_inputs(2)]
        make = (lambda mod: mod.BinaryMathTransformer(op))
    elif kind == "scalar":
        dev = [_scalar_inputs(3)]
        make = (lambda mod: mod.ScalarMathTransformer(op, arg))
    else:
        dev = [_scalar_inputs(4)]
        make = (lambda mod: mod.UnaryMathTransformer(op, arg))
    with np.errstate(all="ignore"):
        want = _jax_apply(make(jm), dev, jit)
    got = _port_apply(make(pm), dev, jit)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    if op in _TRANSCENDENTAL:
        _assert_close_transcendental(got["value"], want["value"])
    else:
        assert _ftz(got["value"]).tobytes() == want["value"].tobytes()


def _assert_close_transcendental(got, want):
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(_ftz(got)[fin], want[fin],
                               rtol=_TRANSCENDENTAL_RTOL, atol=0)


def _fit_pair(jcls, pcls, cols_np, jkw=None):
    """Fit the estimator in both packages on the same scalar column."""
    from transmogrifai_tpu.data.columns import Column as JColumn
    import transmogrifai_tpu.types as jt
    from transmogrifai_tpu_torch.data.columns import Column as PColumn
    from transmogrifai_tpu_torch.stages.base import FitContext
    import transmogrifai_tpu_torch.types as ptt
    data = {"value": cols_np["value"].astype(np.float64),
            "mask": cols_np["mask"] > 0}
    jm = jcls(**(jkw or {})).fit_model([JColumn(jt.Real, data)], None)
    pm = pcls(**(jkw or {})).fit_model([PColumn(ptt.Real, data)],
                                       FitContext(len(data["value"])))
    return jm, pm


SCALER_CASES = ["standard", "standard_no_mean", "standard_no_std",
                "fill_mean", "percentile", "scale_linear", "scale_log",
                "descale_linear", "descale_log"]


@pytest.mark.parametrize("case", SCALER_CASES)
@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_scalers_match_jax(case, jit):
    """Fitted numbers equal; values and masks equal to the JAX package's
    (log and exp within 2e-5 relative), op by op and inside the compiled
    program."""
    from transmogrifai_tpu.ops import scalers as js
    from transmogrifai_tpu_torch.ops import scalers as ps
    col = _scalar_inputs(7)
    col["value"] = np.abs(col["value"]) % 1000
    consts = None
    if case.startswith("standard"):
        kw = {"with_mean": case != "standard_no_mean",
              "with_std": case != "standard_no_std"}
        jmod, pmod = _fit_pair(js.OpScalarStandardScaler,
                               ps.OpScalarStandardScaler, col, kw)
        assert (jmod.mean, jmod.std) == (pmod.mean, pmod.std)
    elif case == "fill_mean":
        jmod, pmod = _fit_pair(js.FillMissingWithMean,
                               ps.FillMissingWithMean, col)
        assert jmod.fill == pmod.fill
    elif case == "percentile":
        jmod, pmod = _fit_pair(js.PercentileCalibrator,
                               ps.PercentileCalibrator, col)
        np.testing.assert_array_equal(jmod.quantiles, pmod.quantiles)
        consts = pmod.device_constants("cpu")
        col["value"][:40] = np.float32(pmod.quantiles[:40])  # on an edge
    else:
        stype = case.split("_")[1]
        jmod = js.ScalerTransformer(stype, slope=2.7, intercept=-1.3)
        pmod = ps.ScalerTransformer(stype, slope=2.7, intercept=-1.3)
        if case.startswith("descale"):
            from transmogrifai_tpu.features import FeatureBuilder as JFB
            from transmogrifai_tpu_torch import FeatureBuilder as PFB
            jx, px = JFB.Real("x").as_predictor(), PFB.Real("x").as_predictor()
            jmod = js.DescalerTransformer().set_input(jx, jmod.set_input(
                jx).get_output())
            pmod = ps.DescalerTransformer().set_input(px, pmod.set_input(
                px).get_output())
    with np.errstate(all="ignore"):
        want = _jax_apply(jmod, [col], jit)
    got = _port_apply(pmod, [col], jit, consts)
    np.testing.assert_array_equal(got["mask"] > 0, want["mask"] > 0)
    if case in ("scale_log", "descale_log"):
        _assert_close_transcendental(got["value"], want["value"])
    else:
        assert _ftz(got["value"]).tobytes() == want["value"].tobytes()


def _rowops_cases():
    def half(v):
        return v is not None and v > 0.5

    def starts(v):
        return str(v).startswith("a")
    texts = ["alpha", "Beta", None, "ALPHABET", "ab", "", "gamma"]
    hay = ["alphabet soup", "beta", "x", None, "cab", "a", "Gamma ray"]
    sets = [["a", "b"], ["b"], None, [], ["x", "y", "z"], ["a"], ["q"]]
    sets2 = [["a"], ["b", "c"], ["x"], [], ["x", "y"], None, ["q"]]
    return {
        "alias": ("AliasTransformer", {"name": "renamed"}, ["real"]),
        "map": ("LambdaMap", {"fn": cs_age_group(), "out_type": "PickList"},
                ["real"]),
        "filter": ("FilterTransformer", {"predicate": half}, ["real"]),
        "exists": ("ExistsTransformer", {"predicate": half}, ["real"]),
        "replace": ("ReplaceTransformer", {"old": "Beta", "new": "B"},
                    [("text", texts)]),
        "occurs": ("ToOccurTransformer", {}, [("text", texts)]),
        "occurs_fn": ("ToOccurTransformer", {"match_fn": starts},
                      [("text", texts)]),
        "substring": ("SubstringTransformer", {},
                      [("text", texts), ("text", hay)]),
        "substring_case": ("SubstringTransformer", {"ignore_case": False},
                           [("text", texts), ("text", hay)]),
        "text_len": ("TextLenTransformer", {}, [("text", texts)]),
        "jaccard": ("JaccardSimilarity", {},
                    [("set", sets), ("set", sets2)]),
        "ngram": ("NGramSimilarity", {"n": 3},
                  [("text", texts), ("text", hay)])}


def cs_age_group():
    import chip_smoke
    return chip_smoke.titanic_age_group


def _rowops_inputs(pkg_types, Column, spec, n=7):
    out, feats = [], []
    rng = np.random.default_rng(9)
    for s in spec:
        if s == "real":
            v = [None if rng.random() < 0.3 else float(x)
                 for x in rng.normal(size=n) * 20 + 15]
            out.append(Column.from_values(pkg_types.Real, v))
            feats.append(pkg_types.Real)
        else:
            kind, vals = s
            t = {"text": pkg_types.Text,
                 "set": pkg_types.MultiPickList}[kind]
            out.append(Column.from_values(t, vals))
            feats.append(t)
    return out, feats


@pytest.mark.parametrize("case", sorted(_rowops_cases()))
def test_rowops_match_jax(case):
    """The host row ops give the JAX package's columns, value for value."""
    import transmogrifai_tpu.ops.rowops as jr
    import transmogrifai_tpu.types as jt
    from transmogrifai_tpu.features import FeatureBuilder as JFB
    from transmogrifai_tpu.data.columns import Column as JColumn
    import transmogrifai_tpu_torch.ops.rowops as pr
    import transmogrifai_tpu_torch.types as ptt
    from transmogrifai_tpu_torch import FeatureBuilder as PFB
    from transmogrifai_tpu_torch.data.columns import Column as PColumn
    cls, kw, spec = _rowops_cases()[case]
    outs = []
    for mod, types, Col, FB in ((jr, jt, JColumn, JFB),
                                (pr, ptt, PColumn, PFB)):
        cols, ftypes = _rowops_inputs(types, Col, spec)
        feats = [getattr(FB, t.__name__)(f"in{i}").as_predictor()
                 for i, t in enumerate(ftypes)]
        kw2 = dict(kw)
        if "out_type" in kw2:
            kw2["out_type"] = getattr(types, kw2["out_type"])
        stage = getattr(mod, cls)(**kw2).set_input(*feats)
        out = stage.transform(cols, None)
        outs.append((stage.get_output().name, out.ftype.__name__,
                     out.to_values() if hasattr(out, "to_values") else None,
                     out.data))
    (jn, jtname, _, jdata), (pn, ptname, _, pdata) = outs
    assert jtname == ptname
    if case == "alias":
        assert jn == pn == "renamed"
    if isinstance(jdata, dict):
        for k in jdata:
            np.testing.assert_array_equal(np.asarray(pdata[k]),
                                          np.asarray(jdata[k]))
    else:
        assert list(pdata) == list(jdata)


def test_dsl_wires_the_jax_stages():
    """The DSL's operators and methods wire the same stage classes with
    the same params in both packages."""
    from test_torch_multiclass import package
    wired = []
    for name in ("jax", "port"):
        ns = package(name)
        FB = ns.FeatureBuilder
        a = FB.Real("a").as_predictor()
        b = FB.Integral("b").as_predictor()
        t = FB.Text("t").as_predictor()
        outs = [a + b, a - 2, 2 - a, a * b, a / b, 3 / a, a + 1, 2 * a,
                a.log(), a.log(10.0), a.power(2.0), a.abs(), a.sqrt(),
                a.exp(), a.round(), a.ceil(), a.floor(), a.negate(),
                a.z_normalize(), a.fill_missing_with_mean(),
                a.to_percentile(), a.scale("log"), a.alias("aa"),
                a.map_values(cs_age_group(), ns.t.PickList),
                a.exists(cs_age_group()), a.filter_values(cs_age_group()),
                t.replace_with("x", "y"), t.occurs(), t.pivot(),
                t.contained_in(t), t.ngram_similarity(t)]
        wired.append([(type(f.origin_stage).__name__,
                       {k: v for k, v in f.origin_stage.params.items()
                        if not callable(v)}) for f in outs])
    assert wired[0] == wired[1]


def test_tree_importances_and_contributions_match_jax():
    """`feature_contributions` (split-frequency importances of trees,
    linear coefficients) of the same fitted arrays: within 1e-6."""
    from transmogrifai_tpu.insights import model_insights as jmi
    from transmogrifai_tpu_torch.insights import model_insights as pmi
    from transmogrifai_tpu_torch.workflow.serialization import load_model
    model = load_model(GBT_FIXTURE, device="cpu")
    gbt = next(s for s in model.fitted.values()
               if type(s).__name__ == "GBTClassificationModel")
    d = gbt.edges.shape[0]
    got = pmi.feature_contributions(gbt, d)
    want = jmi.feature_contributions(gbt, d)
    assert len(got) == len(want) == d
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)
    assert abs(sum(v[0] for v in got) - 1.0) < 1e-9
    W = np.random.default_rng(0).normal(size=(9, 2)).astype(np.float32)

    class Linear:
        pass
    lin = Linear()
    lin.W = W
    np.testing.assert_allclose(pmi.feature_contributions(lin, 9),
                               jmi.feature_contributions(lin, 9), atol=1e-6)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The smoke grid's run in both packages: (port record, JAX record,
    port model, dataset)."""
    import json
    from test_torch_multiclass import F32_ENV, package
    out = str(tmp_path_factory.mktemp("smoke") / "jax.json")
    subprocess.run([sys.executable, os.path.abspath(__file__), "smoke-run",
                    out], check=True, env=dict(os.environ, **F32_ENV))
    with open(out) as fh:
        want = json.load(fh)
    ns = package("port")
    model, ds, _ = train_script(ns, smoke_models(ns.models), device="cpu")
    return smoke_record(model, ds), want, model, ds


def _uidless(name):
    return re.sub(r"_\d{12}", "_UID", name)


def test_smoke_grid_matches_jax(smoke):
    """The script at `test_titanic_smoke`'s 2-config grid: configs, kept
    columns and winner equal; XGBoost's validation AuPR within 1e-6 (equal
    predictions) and LR's within 1e-2 (an unconverged 40-step L-BFGS fit,
    F5); holdout within 1e-6 of the JAX package's and in the smoke test's
    bands; scores at the serving tolerances."""
    got, want, _, _ = smoke
    assert got["results"] == want["results"]
    assert got["kept"] == want["kept"]
    assert (got["best_model"], got["best_grid"]) == (want["best_model"],
                                                      want["best_grid"])
    tol = {"OpLogisticRegression": 1e-2, "OpXGBoostClassifier": 1e-6}
    for r, g, w in zip(got["results"], got["fold_metrics"],
                       want["fold_metrics"]):
        assert abs(g[0] - w[0]) <= tol[r["model"]], (r, g, w)
    hold = got["holdout_metrics"]
    for k in ("AuPR", "AuROC", "Error"):
        assert abs(hold[k] - want["holdout_metrics"][k]) <= 1e-6, k
    assert hold["AuPR"] >= 0.70 and hold["AuROC"] >= 0.75
    assert hold["Error"] <= 0.30
    for k, atol in (("rawPrediction", 2e-5), ("probability", 1e-5)):
        np.testing.assert_allclose(np.asarray(got["scores"][k]),
                                   np.asarray(want["scores"][k]), atol=atol,
                                   rtol=0)


def test_smoke_grid_insights_match_jax(smoke):
    """The winner's insights: the same features with the same derived
    columns; importances equal up to one split of the ensemble (a
    near-tie split may pick another feature with the same partition of
    the rows, F4); a sex, fare or family feature in the top six."""
    got, want, _, _ = smoke
    g = {_uidless(n): (imp, d) for n, imp, d in got["insights"]}
    w = {_uidless(n): (imp, d) for n, imp, d in want["insights"]}
    assert set(g) == set(w)
    for name in w:
        assert [_uidless(c) for c, _ in g[name][1]] == \
            [_uidless(c) for c, _ in w[name][1]]
    step = min(v for v, _ in w.values() if v > 0)  # one split's share
    assert max(abs(g[n][0] - w[n][0]) for n in w) <= step + 1e-9
    top6 = [n for n, _, _ in got["insights"][:6]]
    assert {"sex", "estimatedCostOfTickets", "familySize"} & set(top6)


def test_calibration_matches_jax(smoke):
    """The fit-time quantization ranges, by feature: equal."""
    got, want, _, _ = smoke
    assert got["calibration"] == want["calibration"]
    assert set(got["calibration"]) >= {"familySize", "estimatedCostOfTickets",
                                       "age", "fare"}


def test_lambda_save_raises_and_registered_function_round_trips(
        smoke, tmp_path):
    """F8: the script's lambda `age_group` trains and scores, but saving
    raises; with the registered module-level function the same pipeline
    saves, and both packages load it and score alike."""
    import transmogrifai_tpu.automl.sanity_checker  # noqa: F401  (F6)
    from test_torch_multiclass import (
        package, prediction_of, registered_age_group)
    _, _, model, ds = smoke
    with pytest.raises(ValueError, match="extract_fn"):
        model.save(str(tmp_path / "lambda"))
    ns = package("port")
    fn = registered_age_group(ns)
    registered, ds, _ = train_script(ns, smoke_models(ns.models),
                                     age_group=fn, device="cpu")
    path = str(tmp_path / "registered")
    registered.save(path)
    want = prediction_of(registered.score_compiled(ds))
    again = prediction_of(ns.load_model(path, device="cpu")
                          .score_compiled(ds))
    for k in want:
        np.testing.assert_array_equal(again[k], want[k])
    jns = package("jax")
    registered_age_group(jns)
    jscores = prediction_of(jns.load_model(path).score_compiled(
        jns.Dataset.from_csv(
            os.path.join(REPO, "examples", "data", "titanic.csv"),
            schema=__import__("chip_smoke").titanic_simple_schema(jns.t))))
    np.testing.assert_allclose(jscores["rawPrediction"],
                               want["rawPrediction"], atol=2e-5, rtol=0)


def test_default_sweep_matches_the_fixture():
    """The script verbatim (default LR + RF + XGB grids, its lambda) on
    the CPU with the JAX package's forest draws, held by
    `chip_smoke.judge_titanic_simple` to the committed fixture: every
    check phase 19 makes on the card."""
    import json
    import chip_smoke as cs
    import transmogrifai_tpu_torch as port
    from transmogrifai_tpu_torch.models import trees as pt
    with open(os.path.join(SIMPLE_FIXTURE, "results.json")) as fh:
        want = json.load(fh)
    with np.load(os.path.join(SIMPLE_FIXTURE, "scores.npz")) as z:
        arr = {k: z[k] for k in z.files}
    ds, label, pred = cs.titanic_simple_pipeline(cs.port_namespace(port))
    with pt.injected_forest_draws((arr["forest_boot"], arr["forest_mask"])):
        model = port.Workflow().set_result_features(pred, label) \
            .set_input_dataset(ds).train(device="cpu")
    record, ok = cs.judge_titanic_simple(model, want, arr)
    assert ok, record
    assert record["configs"] == 28 and record["kept_columns"] == 17


def test_fixture_is_the_script():
    import json
    with open(os.path.join(SIMPLE_FIXTURE, "results.json")) as fh:
        res = json.load(fh)
    assert res["example"] == "titanic_simple"
    assert {r["model"] for r in res["results"]} == {
        "OpLogisticRegression", "OpRandomForestClassifier",
        "OpXGBoostClassifier"}
    with np.load(os.path.join(SIMPLE_FIXTURE, "scores.npz")) as z:
        assert z["forest_boot"].shape == (50, res["n_train"])
        assert z["probability"].shape == (891, 2)
    assert os.path.exists(os.path.join(SIMPLE_FIXTURE, "model",
                                       "op-model.json"))



if __name__ == "__main__":
    if sys.argv[1:2] == ["smoke-run"]:
        jax_smoke_run(sys.argv[2])
    elif sys.argv[1:] == ["quant-fixture"]:
        for which in ("simple", "gbt"):
            jax_quant_scores(which)
    else:
        raise SystemExit("usage: python tests/test_torch_titanic_simple.py "
                         "quant-fixture | smoke-run <out.json>")
