"""Parity of the port's numeric bucketizers with the JAX package on the
CPU: `NumericBucketizer` (the DSL's `bucketize`) and the decision-tree
bucketizer (`auto_bucketize`): their one-hot device transforms on hostile
values, the host split search, `from_jax_params`, and a saved, reloaded
and compiled workflow.

Tolerance: equal. The port compares f32 values with the splits narrowed
to f32, as the JAX package's jitted `device_apply` does (its compiled
scorer; its splits become f32 arrays with x64 off), so values on a split,
just either side of an f64 split that f32 cannot hold, ±inf, subnormals
(zero to XLA), nulls and out-of-bounds values land in the same columns.
The JAX package's eager transform compares its outer bounds in f64 (the
values reach `device_apply` as numpy arrays there), so the one-hot
transforms are held to the jitted `device_apply`, and to the eager
transform only where no value lies within f32 rounding of a bound.
"""

import os
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import transmogrifai_tpu.ops.bucketizers as jb  # noqa: E402
import transmogrifai_tpu.types as jt  # noqa: E402
from transmogrifai_tpu.data.columns import Column as JColumn  # noqa: E402
from transmogrifai_tpu.stages.base import (  # noqa: E402
    FeatureGeneratorStage as JGen, FitContext as JFitContext)

import transmogrifai_tpu_torch.ops.bucketizers as pb  # noqa: E402
import transmogrifai_tpu_torch.types as pt  # noqa: E402
from transmogrifai_tpu_torch import from_jax_params  # noqa: E402
from transmogrifai_tpu_torch.data.columns import Column as PColumn  # noqa
from transmogrifai_tpu_torch.stages.base import (  # noqa: E402
    FeatureGeneratorStage as PGen, FitContext as PFitContext)

from test_torch_multiclass import package  # noqa: E402

import chip_smoke  # noqa: E402

F64_SPLIT = chip_smoke.BUCKET_F64_SPLIT
SPLITS = {
    "inf_ends": [-np.inf, -1.0, 0.1, F64_SPLIT, 5.0, np.inf],
    "finite_ends": [-2.0, 0.1, F64_SPLIT, 2.5],
    "two": [0.0, 1.0],
    "huge": [-3.4e38, 0.0, 3.4e38],
}
hostile_values = chip_smoke.bucket_hostile_values


def raw(module_gen, name, ftype):
    return module_gen(name=name, ftype=ftype).get_output()


def jitted_apply(stage, cols):
    """The JAX stage's `device_apply` inside `jax.jit`, as its compiled
    scorer runs it."""
    devs = [c.device_value() for c in cols]
    return np.asarray(jax.jit(
        lambda dv: stage.device_apply(None, dv))(devs))


def numeric_outputs(splits, **kw):
    vals = hostile_values()
    jst = jb.NumericBucketizer(splits, **kw).set_input(raw(JGen, "x", jt.Real))
    pst = pb.NumericBucketizer(splits, **kw).set_input(raw(PGen, "x", pt.Real))
    want = jitted_apply(jst, [JColumn.from_values(jt.Real, vals)])
    got = pst.transform([PColumn.from_values(pt.Real, vals)], "cpu")
    assert ([c.indicator_value for c in got.meta.columns]
            == [c.indicator_value for c in jst.output_meta().columns])
    return got, want


@pytest.mark.parametrize("name", sorted(SPLITS))
@pytest.mark.parametrize("track_nulls", [True, False])
@pytest.mark.parametrize("track_invalid", [True, False])
def test_numeric_bucketizer_equals_jax_on_hostile_values(name, track_nulls,
                                                         track_invalid):
    got, want = numeric_outputs(SPLITS[name], track_nulls=track_nulls,
                                track_invalid=track_invalid)
    np.testing.assert_array_equal(np.asarray(got.data), want)


def test_values_beside_an_f64_split_land_as_in_jax():
    """The f32 value just below f32(0.3 + 2^-54) rounds up to it: f32 <
    f64-split would put it in the lower bucket; both packages put it on
    the upper side exactly where the f32 split does."""
    got, _ = numeric_outputs(SPLITS["inf_ends"])
    arr = np.asarray(got.data)
    assert arr[0, 2] == 1.0 and arr[1, 3] == 1.0 and arr[2, 3] == 1.0


def thresholds_cases():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=400)
    return {"signal": (x, (x > 0.25).astype(float), 1),
            "regression": (x, np.round(3 * x + rng.normal(0, .2, 400), 3), 2),
            "multiclass": (x, np.digitize(x, [-0.5, 0.2, 0.6]).astype(float),
                           3),
            "ties": (np.round(x, 1), (x > 0).astype(float), 2),
            "noise": (x, rng.integers(0, 2, 400).astype(float), 2)}


@pytest.mark.parametrize("case", sorted(thresholds_cases()))
def test_decision_tree_splits_equal_jax(case):
    x, y, depth = thresholds_cases()[case]
    cls = jb._is_classification(y)
    assert pb._is_classification(y) == cls
    assert pb.decision_tree_splits(x, y, cls, depth) == \
        jb.decision_tree_splits(x, y, cls, depth)
    assert pb._best_split(x, y, cls, 5) == jb._best_split(x, y, cls, 5)


def tree_models(case, **kw):
    x, y, depth = thresholds_cases()[case]
    x = x.copy()
    x[::17] = np.nan
    xs = [None if np.isnan(v) else float(v) for v in x]
    out = []
    for B, T, Col, Gen, Ctx in ((pb, pt, PColumn, PGen, PFitContext),
                                (jb, jt, JColumn, JGen, JFitContext)):
        cols = [Col.from_values(T.RealNN, list(y)),
                Col.from_values(T.Real, xs)]
        est = B.DecisionTreeNumericBucketizer(max_depth=depth, **kw) \
            .set_input(raw(Gen, "y", T.RealNN), raw(Gen, "x", T.Real))
        out.append((est.fit(cols, Ctx(n_rows=len(y))), cols))
    return out


@pytest.mark.parametrize("case", sorted(thresholds_cases()))
@pytest.mark.parametrize("track_nulls", [True, False])
def test_decision_tree_bucketizer_equals_jax(case, track_nulls):
    (pm, pcols), (jm, jcols) = tree_models(case, track_nulls=track_nulls,
                                           min_info_gain=0.01)
    assert pm.thresholds == jm.thresholds
    assert pm.did_split == jm.did_split
    got = np.asarray(pm.transform(pcols, "cpu").data)
    want = np.asarray(jm.transform(jcols).data)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == (len(pm.thresholds) + 1 if pm.did_split else 0) \
        + int(track_nulls)


def test_decision_tree_model_on_hostile_values():
    thr = [F64_SPLIT, 0.1, -1e-30]
    vals = hostile_values()
    label = [0.0] * len(vals)
    got = pb.DecisionTreeBucketizerModel(sorted(thr)).set_input(
        raw(PGen, "y", pt.RealNN), raw(PGen, "x", pt.Real)).transform(
        [PColumn.from_values(pt.RealNN, label),
         PColumn.from_values(pt.Real, vals)], "cpu")
    want = jitted_apply(
        jb.DecisionTreeBucketizerModel(sorted(thr)).set_input(
            raw(JGen, "y", jt.RealNN), raw(JGen, "x", jt.Real)),
        [JColumn.from_values(jt.RealNN, label),
         JColumn.from_values(jt.Real, vals)])
    np.testing.assert_array_equal(np.asarray(got.data), want)


@pytest.mark.parametrize("cls,params", [
    ("NumericBucketizer", {"splits": np.array(SPLITS["inf_ends"]),
                           "track_nulls": True, "track_invalid": True,
                           "labels": ["a", "b", "c", "d", "e"]}),
    ("NumericBucketizerModel", {"splits": np.array([0.0, 0.5, 1.0]),
                                "track_nulls": False,
                                "track_invalid": False, "labels": []}),
    ("DecisionTreeBucketizerModel",
     {"thresholds": np.array([-0.25, F64_SPLIT]), "track_nulls": True}),
    ("DecisionTreeBucketizerModel",
     {"thresholds": np.array([]), "track_nulls": True}),
    ("DecisionTreeNumericBucketizer",
     {"max_depth": 3, "min_info_gain": 0.01, "min_instances_per_node": 2,
      "track_nulls": False}),
])
def test_from_jax_params_round_trips(cls, params):
    jstage = getattr(jb, cls)(**params)
    stage = from_jax_params(cls, jstage.get_params(), uid="s1")
    assert type(stage).__name__ == cls and stage.uid == "s1"
    got, want = stage.get_params(), jstage.get_params()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))


def test_map_bucketizer_is_refused_until_maps_are_ported():
    """Refused until item 6a ported the maps; now it fits, as the JAX
    package's does (parity in tests/test_torch_structural.py)."""
    y = [0.0, 1.0] * 20
    rows = [{"k": float(i) + (5.0 if y[i] else 0.0)} for i in range(40)]
    cols = [PColumn.from_values(pt.RealNN, y),
            PColumn.from_values(pt.RealMap, rows)]
    jcols = [JColumn.from_values(jt.RealNN, y),
             JColumn.from_values(jt.RealMap, rows)]
    got = pb.DecisionTreeNumericMapBucketizer().set_input(
        raw(PGen, "y", pt.RealNN), raw(PGen, "m", pt.RealMap)).fit(
        cols, PFitContext(n_rows=40))
    want = jb.DecisionTreeNumericMapBucketizer().set_input(
        raw(JGen, "y", jt.RealNN), raw(JGen, "m", jt.RealMap)).fit(
        jcols, JFitContext(n_rows=40))
    assert got.splits_by_key == want.splits_by_key
    np.testing.assert_array_equal(np.asarray(got.transform(cols, "cpu").data),
                                  np.asarray(want.transform(jcols).data))


def bucket_workflow(ns):
    t = ns.t
    rng = np.random.default_rng(7)
    n = 300
    age = rng.uniform(0, 80, n)
    age[::11] = np.nan
    fare = rng.exponential(30, n)
    y = ((np.nan_to_num(age, nan=30) < 18) | (fare > 60)).astype(float)
    ds = ns.Dataset({"age": age, "fare": fare, "y": y},
                    {"age": t.Real, "fare": t.Real, "y": t.RealNN})
    age_f = ns.FeatureBuilder.Real("age").from_column("age").as_predictor()
    fare_f = ns.FeatureBuilder.Real("fare").from_column("fare") \
        .as_predictor()
    label = ns.FeatureBuilder.RealNN("y").from_column("y").as_response()
    vec = ns.transmogrify([age_f.auto_bucketize(label, max_depth=3),
                           fare_f.bucketize([0.0, 10.0, F64_SPLIT * 100,
                                             np.inf], track_invalid=True),
                           fare_f])
    pred = ns.models.OpLogisticRegression(max_iter=20).set_input(
        label, vec).get_output()
    return ds, label, vec, pred


def test_saved_bucketizers_score_compiled_like_score(tmp_path):
    ns = package("port")
    ds, label, vec, pred = bucket_workflow(ns)
    model = ns.Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).train(device="cpu")
    model.save(str(tmp_path / "m"))
    loaded = ns.load_model(str(tmp_path / "m"), device="cpu")
    eager = model.score(ds)[pred.name].data
    compiled = {k: v.cpu().numpy()
                for k, v in loaded.score_compiled(ds)[pred.name].items()}
    for k in ("prediction", "rawPrediction", "probability"):
        np.testing.assert_array_equal(compiled[k], np.asarray(eager[k]))
    # the JAX package reads the port's artifact and vectorizes alike
    jns = package("jax")
    jmodel = jns.load_model(str(tmp_path / "m"))
    jvec = jmodel.score(jns.Dataset(dict(ds.columns), {
        k: getattr(jns.t, v.__name__) for k, v in ds.schema.items()}),
        keep_intermediate=True)[vec.uid]
    pvec = loaded.score(ds, keep_intermediate=True)[vec.uid]
    np.testing.assert_array_equal(np.asarray(pvec.data),
                                  np.asarray(jvec.data))


def test_auto_bucketize_vector_equals_jax():
    """The DSL's `bucketize` and `auto_bucketize` trained through each
    package's workflow: the vectorized matrix equal."""
    vecs = {}
    for name, kw in (("port", {"device": "cpu"}), ("jax", {})):
        ns = package(name)
        ds, label, vec, pred = bucket_workflow(ns)
        model = ns.Workflow().set_result_features(vec, label) \
            .set_input_dataset(ds).train(**kw)
        vecs[name] = np.asarray(model.score(ds)[vec.name].data)
    np.testing.assert_array_equal(vecs["port"], vecs["jax"])
