"""Parity of the port's structural encoders with the JAX package on the
CPU (ROADMAP queue 1, item 6a): the date, geolocation, multi-picklist and
map vectorizers, the map bucketizer, the column drop and the indexers.
Each stage is fitted on the same columns in both packages: its fitted
state and its metadata equal, its eager transform held to the JAX
package's eager transform and its compiled path (the port's device code
under `compiled_scoring`) to the JAX stage's `device_apply` inside
`jax.jit`, on hostile values (subnormals, -0.0, NaN, absent keys, dates
before 1970 and on leap days, values on an f32-rounded split).

Tolerances: bit-equal, except the sin / cos columns of the unit-circle
encodings (`DateToUnitCircleVectorizer`, `DateMapModel`), which XLA and
torch round apart: 1e-6 absolute (`SINCOS_ATOL`; the largest gap seen is
checked to be at most that).

    python tests/test_torch_structural.py fixture [DIR]
    python tests/test_torch_structural.py avro-fixture [PATH]

write the JAX package's results for `chip_smoke.py` phase 27 (default
DIR: transmogrifai_tpu_torch/testdata/structural_train_f32; f32
histogram mode, F4) and its Avro container of 512 rows (default PATH:
transmogrifai_tpu_torch/testdata/structural_jax_512.avro).
"""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402

SINCOS_ATOL = chip_smoke.STRUCT_VECTOR_ATOL


def jax_namespace():
    """Phase 27's entry points from the JAX package."""
    from types import SimpleNamespace

    import transmogrifai_tpu  # noqa: F401  (attaches the DSL)
    import transmogrifai_tpu.types as t
    from transmogrifai_tpu.automl import transmogrify
    from transmogrifai_tpu.data import Dataset
    from transmogrifai_tpu.features import FeatureBuilder
    from transmogrifai_tpu.ops.bucketizers import (
        DecisionTreeNumericMapBucketizer)
    from transmogrifai_tpu.ops.dates import DateListVectorizer
    from transmogrifai_tpu.ops.drop_indices import DropIndicesByTransformer
    from transmogrifai_tpu.ops.indexers import (
        OpStringIndexerNoFilter, PredictionDeIndexer)
    from transmogrifai_tpu.selector.model_selector import (
        BinaryClassificationModelSelector, _default_binary_models)
    from transmogrifai_tpu.workflow import Workflow
    from transmogrifai_tpu.workflow.serialization import load_model
    return SimpleNamespace(
        t=t, FeatureBuilder=FeatureBuilder, transmogrify=transmogrify,
        Dataset=Dataset, Workflow=Workflow, load_model=load_model,
        OpStringIndexerNoFilter=OpStringIndexerNoFilter,
        PredictionDeIndexer=PredictionDeIndexer,
        DecisionTreeNumericMapBucketizer=DecisionTreeNumericMapBucketizer,
        DateListVectorizer=DateListVectorizer,
        DropIndicesByTransformer=DropIndicesByTransformer,
        BinaryClassificationModelSelector=BinaryClassificationModelSelector,
        default_binary_models=_default_binary_models)


def structural_outcome(ns, model, feats, ds) -> dict:
    """What phase 27 holds a train to: the vector's metadata, per-column
    f64 sums and first 64 rows; the kept columns; the configs, fold
    metrics, winner and holdout metrics."""
    vec = model.score(ds, keep_intermediate=True)[feats["vector"].uid]
    X = np.asarray(vec.data, dtype=np.float32)
    checker = next(s for s in model.fitted.values()
                   if type(s).__name__ == "SanityCheckerModel")
    sel = next(s for s in model.fitted.values() if hasattr(
        getattr(s, "summary", None), "validation_results"))
    summ = sel.summary
    return {
        "rows": int(X.shape[0]),
        "vector_meta": [c.to_json() for c in vec.meta.columns],
        "vector_sums": X.astype(np.float64).sum(axis=0),
        "vector_head": X[:64],
        "kept_indices": [int(i) for i in checker.indices],
        "results": [{"model": r.model, "grid": r.grid}
                    for r in summ.validation_results],
        "fold_metrics": [list(map(float, r.fold_metrics))
                         for r in summ.validation_results],
        "best_model": summ.best_model, "best_grid": summ.best_grid,
        "holdout_metrics": {k: float(v)
                            for k, v in summ.holdout_metrics.items()}}


def jax_structural_train(n_fit: int = chip_smoke.STRUCT_FIT_ROWS):
    ns = jax_namespace()
    _, train_rows, _ = chip_smoke.structural_tables(n_fit)
    ds = ns.Dataset.from_rows(train_rows,
                              schema=chip_smoke.structural_schema(ns.t))
    feats = chip_smoke.structural_pipeline(ns)
    model = ns.Workflow().set_result_features(
        feats["prediction"], feats["named"], feats["tokens"]) \
        .set_input_dataset(ds).train()
    return ns, model, feats, ds


def write_fixture(path: str) -> None:
    _, model, feats, ds = jax_structural_train()
    out = structural_outcome(None, model, feats, ds)
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(os.path.join(path, "vector.npz"),
                        sums=out.pop("vector_sums"),
                        head=out.pop("vector_head"))
    with open(os.path.join(path, "results.json"), "w") as fh:
        json.dump(out, fh, indent=1)


def write_avro_fixture(path: str) -> None:
    """The JAX package's container of phase 27 (a): 512 generated rows of
    the columns it can write, deflate."""
    ns = jax_namespace()
    from transmogrifai_tpu.data.avro import dataset_to_avro
    sch = chip_smoke.structural_schema(ns.t)
    cols = chip_smoke.STRUCT_AVRO_COLUMNS
    rows = [{c: r[c] for c in cols} for r in chip_smoke.structural_rows(
        chip_smoke.STRUCT_AVRO_ROWS, seed=chip_smoke.STRUCT_SEED + 1)]
    dataset_to_avro(ns.Dataset.from_rows(rows, schema={
        c: sch[c] for c in cols}), path, codec="deflate")


# --------------------------------------------------------------------------- #
# per-stage parity                                                            #
# --------------------------------------------------------------------------- #

def packages():
    import jax  # noqa: F401
    import transmogrifai_tpu.types as jt
    import transmogrifai_tpu_torch.types as pt
    from transmogrifai_tpu.data.columns import Column as JColumn
    from transmogrifai_tpu.stages.base import FeatureGeneratorStage as JGen
    from transmogrifai_tpu.stages.base import FitContext as JCtx
    from transmogrifai_tpu_torch.data.columns import Column as PColumn
    from transmogrifai_tpu_torch.stages.base import (
        FeatureGeneratorStage as PGen)
    from transmogrifai_tpu_torch.stages.base import FitContext as PCtx
    return {"port": (pt, PColumn, PGen, PCtx, "transmogrifai_tpu_torch"),
            "jax": (jt, JColumn, JGen, JCtx, "transmogrifai_tpu")}


def stage_class(pkg: str, module: str, name: str):
    import importlib
    root = packages()[pkg][4]
    return getattr(importlib.import_module(f"{root}.ops.{module}"), name)


def build(pkg, module, name, inputs, kw):
    """(stage wired to raw features, the columns): `inputs` is a list of
    (feature name, type name, values)."""
    t, Col, Gen, _, _ = packages()[pkg]
    feats = [Gen(name=f, ftype=getattr(t, tn),
                 is_response=(tn == "RealNN")).get_output()
             for f, tn, _ in inputs]
    cols = [Col.from_values(getattr(t, tn), typed(t, tn, v))
            for _, tn, v in inputs]
    return stage_class(pkg, module, name)(**kw).set_input(*feats), cols


def typed(t, tn, values):
    """Column values: predictions given as dicts become the package's
    Prediction."""
    if tn != "Prediction":
        return list(values)
    return [t.Prediction.build(v["prediction"],
                               raw_prediction=v["rawPrediction"],
                               probability=v["probability"])
            for v in values]


def fit_both(module, name, train, score=None, **kw):
    """The stage (an estimator: fitted on `train`) in both packages and
    the columns of `score` (default: `train`) for each."""
    out = {}
    for pkg in ("port", "jax"):
        t, Col, _, Ctx, _ = packages()[pkg]
        stage, cols = build(pkg, module, name, train, kw)
        if hasattr(stage, "fit_model"):
            stage = stage.fit(cols, Ctx(n_rows=len(train[0][2])))
        if score is not None:
            cols = [Col.from_values(getattr(t, tn), list(v))
                    for _, tn, v in score]
        out[pkg] = (stage, cols)
    return out


def jax_jitted(stage, cols):
    """The JAX stage's `device_apply` inside `jax.jit`, as its compiled
    scorer runs it (host_prepare on the host first)."""
    import jax
    enc = stage.host_prepare(cols)
    dev = [c.device_value() for c in cols]
    return np.asarray(jax.jit(lambda e, d: stage.device_apply(e, d))(
        enc, dev))


def port_compiled(stage, cols):
    """The port stage's device code as its compiled scorer runs it."""
    from transmogrifai_tpu_torch.stages.base import (
        compiled_scoring, to_device)
    enc = to_device(stage.host_prepare(cols), "cpu")
    dev = [c.device_value("cpu") for c in cols]
    consts = stage.device_constants("cpu")
    with compiled_scoring():
        out = (stage.device_apply_with(consts, enc, dev)
               if consts is not None else stage.device_apply(enc, dev))
    return out.numpy()


def meta_json(meta):
    return [c.to_json() for c in meta.columns]


def assert_vectors(got, want, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if atol:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(got, want)
    return float(np.nanmax(np.abs(got.astype(np.float64)
                                  - want.astype(np.float64)),
                           initial=0.0))


def check_stage(module, name, train, score=None, atol=0.0, **kw):
    """Fitted state, metadata, eager and compiled transforms: port
    against JAX. Returns the fitted pair."""
    both = fit_both(module, name, train, score, **kw)
    (ps, pcols), (js, jcols) = both["port"], both["jax"]
    want_params = js.get_params()
    got_params = ps.get_params()
    assert json.dumps(got_params, sort_keys=True, default=str) == \
        json.dumps(want_params, sort_keys=True, default=str)
    got = ps.transform(pcols, "cpu")
    want = js.transform(jcols)
    assert meta_json(got.meta) == meta_json(want.meta)
    assert_vectors(got.data, want.data, atol)
    if ps.jittable:
        assert_vectors(port_compiled(ps, pcols), jax_jitted(js, jcols), atol)
    return ps, js


MS_DAY = 86_400_000
HOSTILE_MS = [
    0, -1, 1, -MS_DAY, -MS_DAY - 1, MS_DAY - 1, 951_868_799_999,
    951_782_400_000, -2_208_988_800_000, -2_203_891_200_001,
    4_107_542_399_999, 1_709_164_800_000, 1_582_934_400_000, None,
    -62_135_596_800_000 + 1, 253_402_300_799_999, 3_600_000 * 23 + 59_999,
    None, 1_234_567_890_123]


def date_cases(n=120, seed=0):
    rng = np.random.default_rng(seed)
    ms = chip_smoke._struct_dates(rng, n, 0.1)
    return ms + HOSTILE_MS


ALL_PERIODS = ("HourOfDay", "DayOfWeek", "DayOfMonth", "DayOfYear",
               "MonthOfYear", "WeekOfYear")


@pytest.mark.parametrize("periods", [None, ALL_PERIODS])
def test_date_unit_circle_equals_jax(periods):
    kw = {} if periods is None else {"periods": periods}
    ps, js = check_stage(
        "dates", "DateToUnitCircleVectorizer",
        [("d", "Date", date_cases()), ("t", "DateTime",
                                        date_cases(seed=1))],
        atol=SINCOS_ATOL, **kw)


@pytest.mark.parametrize("period", [
    "DayOfMonth", "DayOfWeek", "DayOfYear", "HourOfDay", "MonthOfYear",
    "WeekOfMonth", "WeekOfYear"])
def test_time_period_equals_jax(period):
    both = fit_both("dates", "TimePeriodTransformer",
                    [("d", "Date", date_cases())], period=period)
    got = both["port"][0].transform(both["port"][1], "cpu")
    want = both["jax"][0].transform(both["jax"][1])
    np.testing.assert_array_equal(got.data["value"], want.data["value"])
    np.testing.assert_array_equal(got.data["mask"], want.data["mask"])
    lists = [[v for v in date_cases(5, s) if v is not None]
             for s in range(6)] + [None, []]
    both = fit_both("dates", "TimePeriodListTransformer",
                    [("l", "DateList", lists)], period=period)
    got = both["port"][0].transform(both["port"][1], "cpu")
    want = both["jax"][0].transform(both["jax"][1])
    assert list(got.data) == list(want.data)


def date_lists(n=60, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 6))
        out.append([int(v) for v in rng.choice(
            [x for x in HOSTILE_MS if x is not None], k)] or None)
    return out + [[5, 5, 5], [-1], None]


@pytest.mark.parametrize("pivot", ["SinceFirst", "SinceLast", "ModeDay",
                                   "ModeMonth", "ModeHour"])
@pytest.mark.parametrize("reference_ms", [None, 1_767_225_600_000])
@pytest.mark.parametrize("track_nulls", [True, False])
def test_date_list_vectorizer_equals_jax(pivot, reference_ms, track_nulls):
    check_stage("dates", "DateListVectorizer",
                [("a", "DateList", date_lists()),
                 ("b", "DateTimeList", date_lists(seed=3))],
                pivot=pivot, reference_ms=reference_ms,
                track_nulls=track_nulls)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_date_list_since_last_depends_on_the_batch(pkg):
    """F21: without `reference_ms`, SinceLast measures from the batch's
    latest event, so one row's value changes with the rows beside it (in
    both packages); with it, the row stands alone."""
    t, Col, _, _, _ = packages()[pkg]
    row = [[10 * MS_DAY]]
    other = [[40 * MS_DAY]]
    values = {}
    for ref in (None, 50 * MS_DAY):
        stage, _ = build(pkg, "dates", "DateListVectorizer",
                         [("v", "DateList", row)], {"reference_ms": ref})
        alone = stage.transform([Col.from_values(t.DateList, row)],
                                *(["cpu"] if pkg == "port" else []))
        beside = stage.transform([Col.from_values(t.DateList,
                                                  row + other)],
                                 *(["cpu"] if pkg == "port" else []))
        values[ref] = (float(np.asarray(alone.data)[0, 0]),
                       float(np.asarray(beside.data)[0, 0]))
    assert values[None] == (0.0, 30.0)
    assert values[50 * MS_DAY] == (40.0, 40.0)


def geo_values(n=80, seed=4):
    rng = np.random.default_rng(seed)
    out = [[float(rng.uniform(-90, 90)), float(rng.uniform(-180, 180)),
            float(rng.integers(1, 9))] if rng.random() > 0.2 else None
           for _ in range(n)]
    return out + [[1e-40, -0.0, 3.0], [0.0, 0.0, float("nan")],
                  [-90.0, 180.0, 1e-39], None]


@pytest.mark.parametrize("track_nulls", [True, False])
def test_geolocation_vectorizer_equals_jax(track_nulls):
    check_stage("geo", "GeolocationVectorizer",
                [("g", "Geolocation", geo_values()[:-4]),
                 ("h", "Geolocation", geo_values(seed=5)[:-4])],
                score=[("g", "Geolocation", geo_values()),
                       ("h", "Geolocation", geo_values(seed=5))],
                track_nulls=track_nulls)


def pick_sets(n=150, seed=6, k=12):
    rng = np.random.default_rng(seed)
    return [set(f"v{j}" for j in rng.choice(k, int(rng.integers(1, 4)),
                                            replace=False))
            if rng.random() > 0.15 else None for _ in range(n)]


@pytest.mark.parametrize("top_k,min_support", [(20, 10), (3, 1), (5, 40)])
@pytest.mark.parametrize("track_nulls", [True, False])
def test_multipicklist_vectorizer_equals_jax(top_k, min_support,
                                             track_nulls):
    check_stage("categorical", "MultiPickListVectorizer",
                [("p", "MultiPickList", pick_sets()),
                 ("q", "MultiPickList", pick_sets(seed=7, k=30))],
                score=[("p", "MultiPickList",
                        pick_sets(40, 8) + [{"unseen"}, None]),
                       ("q", "MultiPickList",
                        pick_sets(40, 9, 30) + [{"v1", "zz"}, {"v2"}])],
                top_k=top_k, min_support=min_support,
                track_nulls=track_nulls)


def numeric_maps(kind, n=80, seed=10, hostile=False):
    rng = np.random.default_rng(seed)
    cast = {"RealMap": lambda x: float(np.round(x, 3)),
            "IntegralMap": lambda x: int(x * 10),
            "BinaryMap": lambda x: bool(x > 0)}[kind]
    out = [{k: cast(rng.normal()) for k in ("a", "b", "c", "gone")
            if rng.random() < 0.7} or None for _ in range(n)]
    if hostile:  # "gone" is absent from every scored row
        out = [None if m is None else
               {k: v for k, v in m.items() if k != "gone"} for m in out]
        out += {"RealMap": [{"a": 1e-40, "b": -0.0, "c": float("nan")},
                            {"a": -1e-45, "b": 3.4e38}, {}],
                "IntegralMap": [{"a": 0, "b": -(1 << 40)}, {"c": 7}, {}],
                "BinaryMap": [{"a": True, "b": False}, {"c": False}, {}],
                }[kind]
    return out


@pytest.mark.parametrize("kind", ["RealMap", "IntegralMap", "BinaryMap"])
@pytest.mark.parametrize("track_nulls", [True, False])
def test_numeric_map_vectorizer_equals_jax(kind, track_nulls):
    check_stage("maps", "NumericMapVectorizer",
                [("m", kind, numeric_maps(kind)),
                 ("r", "RealMap", numeric_maps("RealMap", seed=11))],
                score=[("m", kind, numeric_maps(kind, hostile=True)),
                       ("r", "RealMap",
                        numeric_maps("RealMap", seed=11, hostile=True))],
                track_nulls=track_nulls)


def test_numeric_map_allow_and_block_keys():
    check_stage("maps", "NumericMapVectorizer",
                [("m", "RealMap", numeric_maps("RealMap"))],
                allow_keys=["a", "b", "zz"], block_keys=["b"])


def text_maps(n=200, seed=12, sets=False):
    rng = np.random.default_rng(seed)
    words = [f"w{j}" for j in range(300)]
    out = []
    for i in range(n):
        m = {}
        if rng.random() < 0.8:
            m["lvl"] = f"L{int(rng.integers(0, 6))}"
        if rng.random() < 0.7:
            m["free"] = " ".join(words[j] for j in rng.integers(0, 300, 3))
        if rng.random() < 0.6:
            m["id"] = f"id-{i}"
        if sets:
            m = {k: set(v.split()) for k, v in m.items()}
        out.append(m or None)
    return out


@pytest.mark.parametrize("kind", ["PickListMap", "TextMap"])
@pytest.mark.parametrize("min_support", [1, 10])
def test_text_map_pivot_equals_jax(kind, min_support):
    check_stage("maps", "TextMapPivotVectorizer",
                [("m", kind, text_maps())],
                score=[("m", kind, text_maps(60, 13) + [{"lvl": "new"}])],
                top_k=4, min_support=min_support)


@pytest.mark.parametrize("track_nulls", [True, False])
def test_multipicklist_map_equals_jax(track_nulls):
    check_stage("maps", "MultiPickListMapVectorizer",
                [("m", "MultiPickListMap", text_maps(sets=True))],
                score=[("m", "MultiPickListMap",
                        text_maps(60, 14, sets=True))],
                top_k=5, min_support=2, track_nulls=track_nulls)


@pytest.mark.parametrize("track_nulls", [True, False])
@pytest.mark.parametrize("max_cardinality", [100, 5])
def test_smart_text_map_equals_jax(track_nulls, max_cardinality):
    """Per key: pivot ("lvl"), hashed tokens ("free") or the null
    indicator only ("id"); the hash seed is seed + 31·i + ki."""
    ps, js = check_stage(
        "maps", "SmartTextMapVectorizer",
        [("m", "TextAreaMap", text_maps()),
         ("n", "TextMap", text_maps(seed=15))],
        score=[("m", "TextAreaMap", text_maps(50, 16)),
               ("n", "TextMap", text_maps(50, 17))],
        num_features=32, min_support=3, max_cardinality=max_cardinality,
        track_nulls=track_nulls, seed=9)
    assert ps.strategies == js.strategies


def geo_maps(n=90, seed=18, hostile=False):
    rng = np.random.default_rng(seed)
    out = [{k: [float(rng.uniform(-60, 60)), float(rng.uniform(-90, 90)),
                float(rng.integers(1, 20))]
            for k in ("home", "work") if rng.random() < 0.7} or None
           for _ in range(n)]
    if hostile:
        out += [{"home": [1e-40, -0.0, float("nan")]}, {"other": [1, 2, 3]}]
    return out


@pytest.mark.parametrize("track_nulls", [True, False])
def test_geolocation_map_equals_jax(track_nulls):
    check_stage("maps", "GeolocationMapVectorizer",
                [("g", "GeolocationMap", geo_maps())],
                score=[("g", "GeolocationMap", geo_maps(30, 19, True))],
                track_nulls=track_nulls)


def date_maps(n=90, seed=20):
    rng = np.random.default_rng(seed)
    ms = [v for v in date_cases(n, seed) if v is not None]
    return [{k: int(ms[int(rng.integers(0, len(ms)))])
             for k in ("open", "close", "due") if rng.random() < 0.7}
            or None for _ in range(n)]


@pytest.mark.parametrize("periods", [None, ALL_PERIODS])
def test_date_map_equals_jax(periods):
    kw = {} if periods is None else {"periods": periods}
    check_stage("maps", "DateMapVectorizer",
                [("d", "DateMap", date_maps()),
                 ("e", "DateTimeMap", date_maps(seed=21))],
                atol=SINCOS_ATOL, **kw)


def test_date_map_without_keys_is_empty():
    check_stage("maps", "DateMapVectorizer", [("d", "DateMap", [None] * 5)])


def test_unit_circle_gap_is_within_its_tolerance():
    """The largest sin/cos gap between the packages over many dates, eager
    and compiled, stays within SINCOS_ATOL (and is not zero everywhere:
    the tolerance is needed)."""
    rng = np.random.default_rng(22)
    ms = [int(v) for v in rng.integers(-3_000_000_000_000,
                                       4_000_000_000_000, 4000)]
    both = fit_both("dates", "DateToUnitCircleVectorizer",
                    [("d", "Date", ms)], periods=ALL_PERIODS)
    (ps, pcols), (js, jcols) = both["port"], both["jax"]
    eager = assert_vectors(ps.transform(pcols, "cpu").data,
                           js.transform(jcols).data, SINCOS_ATOL)
    jit = assert_vectors(port_compiled(ps, pcols), jax_jitted(js, jcols),
                         SINCOS_ATOL)
    assert max(eager, jit) <= SINCOS_ATOL


def hostile_fill_inputs():
    """Values under both masks: NaN, ±0, subnormals, the f32 extremes."""
    v = np.array([np.nan, np.nan, -0.0, -0.0, 1e-40, 1e-40, -1e-45, 3.4e38,
                  -3.4e38, 1.5], dtype=np.float32)
    m = np.array([0, 1, 0, 1, 0, 1, 1, 0, 1, 0], dtype=np.float32)
    return v, m


FILL_MODELS = {
    "NumericMapModel": ("maps", lambda v, m: [{
        "value": np.stack([v, v[::-1]], 1), "mask": np.stack([m, m[::-1]],
                                                             1)}],
                        {"keys_per_feature": [["a", "b"]],
                         "fills": [[2.5, 1e-40]]}),
    "GeolocationModel": ("geo", lambda v, m: [
        (np.stack([v, v[::-1], -v], 1), m)],
        {"fills": [[-0.0, 1e-39, 7.0]]}),
    "GeolocationMapModel": ("maps", lambda v, m: [{
        "value": np.stack([v, v[::-1], -v], 1)[:, None, :],
        "mask": m[:, None]}],
        {"keys_per_feature": [["k"]], "fills": [[[np.nan, 0.0, -1e-40]]]}),
}


@pytest.mark.parametrize("name", sorted(FILL_MODELS))
@pytest.mark.parametrize("track_nulls", [True, False])
def test_fills_on_hostile_values_equal_jax(name, track_nulls):
    """v·m + fill·(1 − m) on NaN, ±0 and subnormal values and fills under
    both masks: the port's eager and compiled device code against the
    JAX package's eager and jitted `device_apply` (F11: XLA reads
    subnormal operands as zero in both)."""
    import jax
    import torch

    from transmogrifai_tpu_torch.stages.base import compiled_scoring
    module, make, kw = FILL_MODELS[name]
    v, m = hostile_fill_inputs()
    enc = make(v, m)
    js = stage_class("jax", module, name)(track_nulls=track_nulls, **kw)
    ps = stage_class("port", module, name)(track_nulls=track_nulls, **kw)
    want_eager = np.asarray(js.device_apply(enc, None))
    want_jit = np.asarray(jax.jit(lambda e: js.device_apply(e, None))(enc))
    penc = [{k: torch.as_tensor(x) for k, x in e.items()}
            if isinstance(e, dict) else
            {"value": torch.as_tensor(e[0]), "mask": torch.as_tensor(e[1])}
            for e in enc]
    consts = ps.device_constants("cpu")
    eager = ps.device_apply_with(consts, penc, None).numpy()
    with compiled_scoring():
        compiled = ps.device_apply_with(consts, penc, None).numpy()
    np.testing.assert_array_equal(eager, want_eager)
    np.testing.assert_array_equal(compiled, want_jit)
    np.testing.assert_array_equal(want_eager, want_jit)


F32_SPLIT = float(np.float32(0.3))  # an f64 value f32 holds exactly


def bucket_maps(n=300, seed=23):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n).astype(float)
    maps = []
    for i in range(n):
        m = {}
        if rng.random() < 0.8:
            m["x"] = float(rng.uniform(0, 1)) + 0.5 * y[i]
        if rng.random() < 0.7:
            m["z"] = float(rng.normal())
        if rng.random() < 0.5:
            m["noise"] = float(rng.integers(0, 3))
        maps.append(m or None)
    return list(y), maps


def hostile_bucket_maps(splits):
    """Each key's values on, beside and across its f32-rounded splits,
    and ±inf, NaN, subnormals, ±0 and absent keys."""
    rows = []
    f = np.float32
    for k, thr in splits.items():
        for s in thr:
            s32 = f(s)
            for v in (float(s32), float(np.nextafter(s32, f(-np.inf))),
                      float(np.nextafter(s32, f(np.inf))), s,
                      np.nextafter(s, -np.inf), np.nextafter(s, np.inf)):
                rows.append({k: float(v)})
        for v in (np.inf, -np.inf, np.nan, 1e-40, -1e-40, 0.0, -0.0,
                  3.4e38, 1e300):
            rows.append({k: float(v)})
    return rows + [None, {}, {"other": 1.0}]


@pytest.mark.parametrize("max_depth", [1, 2, 3])
@pytest.mark.parametrize("track_nulls", [True, False])
def test_map_bucketizer_equals_jax(max_depth, track_nulls):
    y, maps = bucket_maps()
    both = fit_both("bucketizers", "DecisionTreeNumericMapBucketizer",
                    [("y", "RealNN", y), ("m", "RealMap", maps)],
                    max_depth=max_depth, track_nulls=track_nulls)
    splits = both["jax"][0].splits_by_key
    assert both["port"][0].splits_by_key == splits
    assert list(both["port"][0].splits_by_key) == list(splits)
    assert any(splits.values())
    hostile = hostile_bucket_maps(splits)
    check_stage("bucketizers", "DecisionTreeNumericMapBucketizer",
                [("y", "RealNN", y), ("m", "RealMap", maps)],
                score=[("y", "RealNN", [0.0] * len(hostile)),
                       ("m", "RealMap", hostile)],
                max_depth=max_depth, track_nulls=track_nulls)


def test_map_bucketizer_compares_on_f32_rounded_splits():
    """A split that f32 rounds up: the f64 value just below it lands with
    the split, in both packages (F18)."""
    split = 0.1 + 2 ** -30  # not an f32 value
    model = {}
    for pkg in ("port", "jax"):
        cls = stage_class(pkg, "bucketizers",
                          "DecisionTreeMapBucketizerModel")
        stage, _ = build(pkg, "bucketizers",
                         "DecisionTreeNumericMapBucketizer",
                         [("y", "RealNN", [0.0]), ("m", "RealMap", [{}])],
                         {})
        m = cls({"x": [split, F32_SPLIT]}, track_nulls=True)
        m.input_features = stage.input_features
        model[pkg] = m
    s32 = float(np.float32(split))
    vals = [{"x": v} for v in (s32, split, np.nextafter(s32, -1.0),
                               F32_SPLIT, 0.3, np.nextafter(0.3, 0.0))]
    t, Col = packages()["port"][:2]
    jt, JCol = packages()["jax"][:2]
    got = model["port"].transform(
        [Col.from_values(t.RealNN, [0.0] * 6),
         Col.from_values(t.RealMap, vals)], "cpu")
    want = model["jax"].transform(
        [JCol.from_values(jt.RealNN, [0.0] * 6),
         JCol.from_values(jt.RealMap, vals)])
    np.testing.assert_array_equal(np.asarray(got.data),
                                  np.asarray(want.data))
    assert np.asarray(got.data)[:, :3].argmax(axis=1).tolist() == \
        [1, 1, 1, 2, 2, 2]


def drop_accuracy(col):
    return col.descriptor_value == "accuracy"


@pytest.fixture
def registered_drop():
    """`chip_smoke.structural_drop` in both packages' registries."""
    from transmogrifai_tpu.utils import fnser as jf
    chip_smoke.register_structural_drop()
    if "structural_drop" not in jf._EXTRACT_REGISTRY:
        jf.extract_fn("structural_drop")(chip_smoke.structural_drop)
    return chip_smoke.structural_drop


def geo_vector(pkg):
    t, Col, Gen, Ctx, _ = packages()[pkg]
    est, cols = build(pkg, "geo", "GeolocationVectorizer",
                      [("g", "Geolocation", geo_values()[:-4]),
                       ("h", "Geolocation", geo_values(seed=5)[:-4])], {})
    model = est.fit(cols, Ctx(n_rows=len(cols[0].data)))
    return model, model.transform(cols, *(["cpu"] if pkg == "port" else []))


def test_drop_indices_equals_jax(registered_drop):
    out = {}
    for pkg in ("port", "jax"):
        model, vec = geo_vector(pkg)
        cls = stage_class(pkg, "drop_indices", "DropIndicesByTransformer")
        drop = cls(registered_drop).set_input(model.get_output())
        got = drop.transform([vec], *(["cpu"] if pkg == "port" else []))
        out[pkg] = (drop, got, vec)
    (pd, pgot, pvec), (jd, jgot, jvec) = out["port"], out["jax"]
    assert pd._indices == jd._indices == [0, 1, 3, 4, 5, 7]
    assert meta_json(pgot.meta) == meta_json(jgot.meta)
    np.testing.assert_array_equal(np.asarray(pgot.data),
                                  np.asarray(jgot.data))
    assert pd.get_params() == jd.get_params() == {
        "predicate": {"__pyregistry__": "structural_drop"}}
    fresh = stage_class("port", "drop_indices",
                        "DropIndicesByTransformer")(registered_drop)
    fresh.set_input(pd.input_features[0])
    np.testing.assert_array_equal(compiled_drop(fresh, pvec),
                                  np.asarray(jgot.data))


def compiled_drop(stage, vec):
    """The compiled path: the kept indices from the input stage's
    metadata (no column reaches `host_prepare`)."""
    import torch

    from transmogrifai_tpu_torch.stages.base import compiled_scoring
    consts = stage.device_constants("cpu")
    with compiled_scoring():
        return stage.device_apply_with(
            consts, None, [torch.as_tensor(np.asarray(vec.data))]).numpy()


def test_drop_indices_refuses_to_save_a_lambda():
    """F8: the port saves no pickled predicate."""
    cls = stage_class("port", "drop_indices", "DropIndicesByTransformer")
    with pytest.raises(ValueError, match="cannot save"):
        cls(lambda c: c.descriptor_value == "lat").get_params()


def labels_and_preds(n=40, seed=24):
    rng = np.random.default_rng(seed)
    labels = [["won", "lost", "hold"][int(j)] if rng.random() > 0.1 else None
              for j in rng.integers(0, 3, n)]
    return labels


def test_indexers_equal_jax():
    labels = labels_and_preds()
    score = labels[:10] + ["unseen", None]
    out = {}
    for pkg in ("port", "jax"):
        t, Col, Gen, Ctx, _ = packages()[pkg]
        cls = stage_class(pkg, "indexers", "OpStringIndexerNoFilter")
        raw = Gen(name="lbl", ftype=t.PickList, is_response=True)
        est = cls().set_input(raw.get_output())
        model = est.fit([Col.from_values(t.PickList, labels)],
                        Ctx(n_rows=len(labels)))
        dev = ["cpu"] if pkg == "port" else []
        idx = model.transform([Col.from_values(t.PickList, score)], *dev)
        back = stage_class(pkg, "indexers", "OpIndexToString")().set_input(
            model.get_output())
        named = back.transform([idx], *dev)
        explicit = stage_class(pkg, "indexers", "OpIndexToString")(
            labels=["a", "b"], unseen_name="?").set_input(model.get_output())
        pred = Col.from_values(t.Prediction, [t.Prediction.build(
            float(p), raw_prediction=[0.0, 0.0], probability=[0.5, 0.5])
            for p in (0, 1, 2, 3, 1, -1, 0, 2, 1, 0, 3, 1)])
        deidx = stage_class(pkg, "indexers", "PredictionDeIndexer")() \
            .set_input(model.get_output(),
                       Gen(name="p", ftype=t.Prediction).get_output())
        out[pkg] = (model.labels, model.handle_invalid,
                    np.asarray(idx.data["value"]).tolist(),
                    np.asarray(idx.data["mask"]).tolist(),
                    list(named.data),
                    list(explicit.transform([idx], *dev).data),
                    list(deidx.transform([idx, pred], *dev).data))
    assert out["port"] == out["jax"]
    assert out["port"][1] == "keep"


# --------------------------------------------------------------------------- #
# carried state: from_jax_params and both directions of save / load           #
# --------------------------------------------------------------------------- #

FITTED = [
    ("dates", "DateToUnitCircleVectorizer", [("d", "Date", date_cases())],
     {"periods": ALL_PERIODS}),
    ("dates", "TimePeriodTransformer", [("d", "Date", date_cases())],
     {"period": "WeekOfMonth"}),
    ("dates", "TimePeriodListTransformer",
     [("l", "DateList", date_lists())], {"period": "HourOfDay"}),
    ("dates", "DateListVectorizer", [("l", "DateList", date_lists())],
     {"pivot": "ModeMonth", "reference_ms": 5}),
    ("geo", "GeolocationVectorizer",
     [("g", "Geolocation", geo_values()[:-4])], {}),
    ("categorical", "MultiPickListVectorizer",
     [("p", "MultiPickList", pick_sets())], {"top_k": 4}),
    ("maps", "NumericMapVectorizer",
     [("m", "RealMap", numeric_maps("RealMap"))], {"track_nulls": False}),
    ("maps", "TextMapPivotVectorizer",
     [("m", "PickListMap", text_maps())], {"min_support": 1}),
    ("maps", "MultiPickListMapVectorizer",
     [("m", "MultiPickListMap", text_maps(sets=True))], {"min_support": 1}),
    ("maps", "SmartTextMapVectorizer",
     [("m", "TextAreaMap", text_maps())],
     {"num_features": 16, "min_support": 2}),
    ("maps", "GeolocationMapVectorizer",
     [("g", "GeolocationMap", geo_maps())], {}),
    ("maps", "DateMapVectorizer", [("d", "DateMap", date_maps())], {}),
    ("bucketizers", "DecisionTreeNumericMapBucketizer",
     [("y", "RealNN", bucket_maps()[0]), ("m", "RealMap", bucket_maps()[1])],
     {}),
    ("indexers", "OpStringIndexerNoFilter",
     [("l", "PickList", labels_and_preds())], {}),
    ("indexers", "OpIndexToString", [("i", "RealNN", [0.0, 1.0])],
     {"labels": ["a", "b"], "unseen_name": "x"}),
    ("indexers", "PredictionDeIndexer",
     [("i", "RealNN", [0.0]), ("p", "Prediction", [
         {"prediction": 0.0, "probability": [1.0],
          "rawPrediction": [0.0]}])], {"labels": ["a"]}),
]


@pytest.mark.parametrize("case", range(len(FITTED)))
def test_from_jax_params_round_trips(case):
    """Each fitted JAX stage's params rebuild the port's class, whose
    params are the JAX package's again (and the reverse: the JAX class
    takes the port's)."""
    from transmogrifai_tpu.stages.base import StageRegistry as JReg
    from transmogrifai_tpu_torch import from_jax_params
    module, name, inputs, kw = FITTED[case]
    js = fit_both(module, name, inputs, **kw)["jax"][0]
    cls_name = type(js).__name__
    params = js.get_params()
    stage = from_jax_params(cls_name, params, uid="u1")
    assert type(stage).__name__ == cls_name and stage.uid == "u1"
    dump = lambda p: json.dumps(p, sort_keys=True, default=str)  # noqa
    assert dump(stage.get_params()) == dump(params)
    back = JReg.get(cls_name)(uid="u2", **stage.get_params())
    assert dump(back.get_params()) == dump(params)


@pytest.mark.parametrize("name", ["PhoneMapVectorizer", "PhoneMapModel"])
def test_phone_maps_raise_naming_item_6b(name):
    """Item 6b is ported: the phone-map classes build and name no
    refusal (their parity is held in tests/test_torch_enrich.py)."""
    args = {"PhoneMapModel": {"keys_per_feature": [["home"]]}}.get(name, {})
    stage = stage_class("port", "maps", name)(**args)
    assert type(stage).__name__ == name
    import transmogrifai_tpu_torch.ops.maps as pmaps
    assert "item 6b" not in open(pmaps.__file__).read()


NOISE_SEEDS = (1, 2, 3, 4)


def write_noise_run(seed: int, path: str) -> None:
    """The JAX package's XGB family alone on phase 27's rows with the
    selector's matrix moved by one ulp (seeded; the families fixture's
    noise runs, tests/test_torch_families.py): its fold metrics and
    winner, the spread the reference itself has under float noise."""
    import dataclasses

    from test_torch_families import one_ulp_noise
    ns = jax_namespace()
    import transmogrifai_tpu.selector.model_selector as jms
    fit_model = jms.ModelSelector.fit_model

    def noisy_fit_model(self, cols, ctx):
        label_col, vec_col = cols
        vec_col = dataclasses.replace(vec_col, data=one_ulp_noise(
            np.asarray(vec_col.data, dtype=np.float32), seed))
        return fit_model(self, [label_col, vec_col], ctx)

    jms.ModelSelector.fit_model = noisy_fit_model
    _, train_rows, _ = chip_smoke.structural_tables()
    ds = ns.Dataset.from_rows(train_rows,
                              schema=chip_smoke.structural_schema(ns.t))
    xgb = [m for m in chip_smoke.structural_models(ns)
           if type(m[0]).__name__ == "OpXGBoostClassifier"]
    feats = chip_smoke.structural_pipeline(ns, models=xgb)
    model = ns.Workflow().set_result_features(feats["prediction"]) \
        .set_input_dataset(ds).train()
    sel = next(s for s in model.fitted.values() if hasattr(
        getattr(s, "summary", None), "validation_results"))
    summ = sel.summary
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"seed": seed,
                   "results": [{"model": r.model, "grid": r.grid}
                               for r in summ.validation_results],
                   "fold_metrics": [list(map(float, r.fold_metrics))
                                    for r in summ.validation_results],
                   "best_grid": summ.best_grid}, fh)


def merge_noise_runs(parts, path: str) -> None:
    """Add the noise runs to the fixture's results.json (under "noise",
    keyed by family as the families fixtures keep them)."""
    res_path = os.path.join(path, "results.json")
    with open(res_path) as fh:
        res = json.load(fh)
    runs = []
    for p in parts:
        with open(p) as fh:
            runs.append(json.load(fh))
    res["noise"] = {"OpXGBoostClassifier": {
        "seeds": [r["seed"] for r in runs],
        "fold_metrics": [r["fold_metrics"] for r in runs]}}
    with open(res_path, "w") as fh:
        json.dump(res, fh, indent=1)


def _main() -> None:
    args = sys.argv[1:]
    if args and args[0] == "fixture":
        write_fixture(args[1] if len(args) > 1
                      else chip_smoke.STRUCT_FIXTURE)
    elif args and args[0] == "noise-run":
        write_noise_run(int(args[1]), args[2])
    elif args and args[0] == "merge-noise":
        merge_noise_runs(args[2:], args[1])
    elif args and args[0] == "avro-fixture":
        write_avro_fixture(args[1] if len(args) > 1
                           else chip_smoke.STRUCT_AVRO)
    else:
        raise SystemExit("usage: python tests/test_torch_structural.py "
                         "fixture [DIR] | avro-fixture [PATH] | noise-run "
                         "SEED OUT.json | merge-noise DIR PARTS...")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["TRANSMOGRIFAI_HIST_PRECISION"] = "f32"
    os.environ["TRANSMOGRIFAI_PERF_MODEL"] = "0"
    import jax
    jax.config.update("jax_platforms", "cpu")
    _main()
