"""The port's record insights against the JAX package on the CPU (ROADMAP
queue 1, item 6b): `RecordInsightsLOCO` over LR, GBT (binary, regression,
multiclass), forest and a selector's winner, with and without vector
metadata, both ablation paths (tree models through `loco_scores` and
K5-loco's plain version, the rest through `predict_arrays`);
`RecordInsightsCorr` with every norm type and both correlation types;
`RecordInsightsParser`; and F24, LOCO after save and load.

Tolerances (PERF.md §2): LOCO diffs within the serving tolerance, 1e-5
a (group, row, class) — tree diffs are the same walk sums, rounded apart
only by the families' sigmoid and softmax; each row's top-K group names
equal, but where two swapped groups' strengths lie within 1e-5 (such
rows are counted). Correlations within `CORR_ATOL` = 1e-6 (a tolerance
on Pcᵀ·Xc relative to sp·sx: XLA's and torch's f32 products sum in
different orders); NaN where a column has no variance, in both.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from test_torch_enrichment import jax_loco_diffs  # noqa: E402

LOCO_ATOL = 1e-5
CORR_ATOL = 1e-6


def meta_of(pkg, d, with_meta=True):
    """A vector's metadata in package `pkg`: six parents of 1 to 6 slots,
    one of them split by a grouping (a map's keys), or None."""
    if not with_meta:
        return None
    from importlib import import_module
    md = import_module(("transmogrifai_tpu_torch" if pkg == "port"
                        else "transmogrifai_tpu") + ".data.metadata")
    cols, j, p = [], 0, 0
    while j < d:
        k = min(p % 6 + 1, d - j)
        for s in range(k):
            cols.append(md.VectorColumnMetadata(
                parent_name=f"p{p}", parent_type="Real",
                grouping=(f"k{s % 2}" if p % 4 == 3 else None),
                indicator_value=f"v{s}", index=j + s))
        j += k
        p += 1
    return md.VectorMetadata("vec", tuple(cols))


def problem(n=240, d=18, classes=2, seed=0, hostile=True):
    """(X f32 with NaN, ±inf and an all-NaN column where `hostile`, y)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    z = X[:, 0] + 0.8 * X[:, 3] - 0.5 * X[:, 7]
    if classes == 0:
        y = z.astype(np.float32)
    elif classes == 2:
        y = (z + rng.normal(0, 0.5, n) > 0).astype(np.float32)
    else:
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float32)
    X[:, 5] = np.round(X[:, 5])      # ties
    X[:, 11] = 0.0                   # a column no split reads
    if hostile:
        X[rng.random((n, d)) < 0.03] = np.nan
        X[:, 9] = np.nan             # a column of NaN only
        X[::37, 2] = np.inf
        X[::41, 4] = -np.inf
    return X, y


def jax_fit(est, X, y):
    import jax.numpy as jnp
    from transmogrifai_tpu.stages.base import FitContext
    return est.fit_arrays(jnp.asarray(X), jnp.asarray(y),
                          jnp.ones(len(y), jnp.float32),
                          FitContext(n_rows=len(y)))


def port_of(jm):
    from transmogrifai_tpu_torch import from_jax_params
    return from_jax_params(type(jm).__name__, jm.get_params())


def loco_both(jm, pm, X, with_meta, top_k=5, group_chunk=4):
    """(port diffs, JAX diffs, port rows, JAX rows, JAX strength, names)
    of LOCO over the same model in both packages."""
    from transmogrifai_tpu.data.columns import Column as JColumn
    from transmogrifai_tpu.insights import RecordInsightsLOCO as JLoco
    from transmogrifai_tpu_torch.data.columns import Column as PColumn
    from transmogrifai_tpu_torch.insights import RecordInsightsLOCO as PLoco
    d = X.shape[1]
    jcol = JColumn.vector(X, meta_of("jax", d, with_meta))
    pcol = PColumn.vector(X, meta_of("port", d, with_meta))
    js = JLoco(jm, top_k=top_k, group_chunk=group_chunk)
    ps = PLoco(pm, top_k=top_k, group_chunk=group_chunk)
    names, jd, _ = jax_loco_diffs(js, jcol)
    pnames, masks = ps._groups(pcol.meta, d)
    assert pnames == names
    pd = ps.diffs(torch.from_numpy(X), masks)
    prow = ps.transform([pcol], "cpu").data
    jrow = js.transform([jcol]).data
    return pd, jd, list(prow), list(jrow), np.max(np.abs(jd), axis=2), names


def assert_loco_equal(pd, jd, prow, jrow, strength, names, atol=LOCO_ATOL):
    """Diffs within `atol`; every row's top-K names equal but for swaps of
    groups whose strengths lie within `atol`; parsed values within
    `atol`. Returns the count of rows with such a swap."""
    from transmogrifai_tpu_torch.insights import RecordInsightsParser
    assert pd.shape == jd.shape and pd.dtype == jd.dtype
    np.testing.assert_allclose(pd, jd, rtol=0, atol=atol)
    idx = {n: g for g, n in enumerate(names)}
    swapped = 0
    for i, (p, j) in enumerate(zip(prow, jrow)):
        pk, jk = list(p), list(j)
        if pk != jk:
            swapped += 1
            assert len(pk) == len(jk)
            for a, b in zip(pk, jk):
                assert abs(strength[idx[a], i] - strength[idx[b], i]) \
                    <= atol, (i, a, b)
        pp = RecordInsightsParser.parse_row(p)
        jp = RecordInsightsParser.parse_row(j)
        for k in set(pp) & set(jp):
            assert [c for c, _ in pp[k]] == [c for c, _ in jp[k]]
            np.testing.assert_allclose([v for _, v in pp[k]],
                                       [v for _, v in jp[k]], rtol=0,
                                       atol=atol + 1e-9)
    return swapped


def jax_models():
    from transmogrifai_tpu import models as jmod
    return {
        "lr": (lambda: jmod.OpLogisticRegression(max_iter=30), 2),
        "svc": (lambda: jmod.OpLinearSVC(max_iter=30), 2),
        "gbt": (lambda: jmod.OpXGBoostClassifier(
            n_estimators=12, max_depth=4, eta=0.3), 2),
        "gbt_regression": (lambda: jmod.OpXGBoostRegressor(
            n_estimators=8, max_depth=3), 0),
        "gbt_multiclass": (lambda: jmod.OpXGBoostClassifier(
            n_estimators=6, max_depth=3), 3),
        "forest": (lambda: jmod.OpRandomForestClassifier(
            n_trees=7, max_depth=5), 2),
        "tree": (lambda: jmod.OpDecisionTreeClassifier(max_depth=4), 2),
    }


@pytest.mark.parametrize("with_meta", [True, False])
@pytest.mark.parametrize("family", sorted(jax_models()))
def test_loco_equals_jax(family, with_meta):
    """LOCO over a JAX-fitted model and the port's copy of it (from its
    params), with the vector's metadata (groups of slots) and without
    (G = d), on hostile values; tree families take the K5-loco path."""
    make, classes = jax_models()[family]
    X, y = problem(classes=classes, seed=len(family))
    jm = jax_fit(make(), X, y)
    pm = port_of(jm)
    assert hasattr(pm, "loco_scores") == (family not in ("lr", "svc"))
    out = loco_both(jm, pm, X, with_meta)
    assert_loco_equal(*out)
    if family.startswith("gbt") or family in ("forest", "tree"):
        # unused groups give a diff of exactly 0.0 in both
        pd, jd = out[0], out[1]
        zero = np.all(jd == 0.0, axis=(1, 2))
        assert zero.any() and np.array_equal(zero,
                                             np.all(pd == 0.0, axis=(1, 2)))


def test_k5_loco_plain_equals_the_jax_walk_of_each_ablation():
    """K5-loco's plain version on bin(X) and bin(X · 0) against the JAX
    package's margin of each materialized ablation bin(X · (1 − m_g)):
    equal sums (times the learning rate: equal margins)."""
    import jax.numpy as jnp
    import transmogrifai_tpu.models.trees as jt
    from transmogrifai_tpu_torch.models import trees as pt
    make, _ = jax_models()["gbt"]
    X, y = problem(seed=5)
    jm = jax_fit(make(), X, y)
    pm = port_of(jm)
    e = torch.from_numpy(pm.edges)
    tables = {k: torch.from_numpy(np.asarray(v)) for k, v in pm.trees.items()}
    masks = chip_smoke.loco_masks(X.shape[1], [[0], [3, 4], [], [9],
                                               list(range(18))])
    off, cols = pt.loco_groups(masks)
    Xt = torch.from_numpy(X)
    s = pt.tree_walk_loco_plain(
        pt.bin_features(Xt, e), pt.bin_features(Xt * 0.0, e),
        tables["feat"], tables["bin"], tables["leaf"],
        torch.from_numpy(off), torch.from_numpy(cols))
    lr = np.float32(pm.learning_rate)
    jtab = {k: jnp.asarray(np.asarray(v)) for k, v in jm.trees.items()}
    for g in range(masks.shape[0]):
        Xa = jnp.asarray(X * (1.0 - masks[g]))
        Xb = jt.bin_features(Xa, jnp.asarray(np.asarray(jm.edges)))
        want = np.asarray(jt.predict_gbt_margin(jtab, Xb, float(lr)))
        np.testing.assert_array_equal((lr * s[g, :, 0]).numpy(), want)


def test_loco_over_a_selectors_winner_equals_jax():
    """The port's trained selector (LR + XGB over 3 folds): its fitted
    stage is the winner model, and LOCO over it equals the JAX package's
    LOCO over the same model (its params in the JAX class)."""
    from transmogrifai_tpu.stages.base import StageRegistry as JReg
    import transmogrifai_tpu_torch as port
    from transmogrifai_tpu_torch import models as pmod
    from transmogrifai_tpu_torch.data.columns import Column as PColumn
    from transmogrifai_tpu_torch.stages.base import (
        FeatureGeneratorStage as PGen)
    import transmogrifai_tpu_torch.types as pt
    X, y = problem(hostile=False, seed=9)
    label = PGen(name="y", ftype=pt.RealNN, is_response=True).get_output()
    vec = PGen(name="v", ftype=pt.OPVector).get_output()
    sel = port.BinaryClassificationModelSelector.with_cross_validation(
        models=[(pmod.OpLogisticRegression(max_iter=20),
                 [{"reg_param": 0.1}]),
                (pmod.OpXGBoostClassifier(n_estimators=10, max_depth=3),
                 [{"min_child_weight": 1.0}])]).set_input(label, vec)
    from transmogrifai_tpu_torch.stages.base import FitContext
    cols = [PColumn.from_values(pt.RealNN, y.tolist()),
            PColumn.vector(X, meta_of("port", X.shape[1]))]
    winner = sel.fit(cols, FitContext(n_rows=len(y)))
    assert winner.summary.best_model in ("OpLogisticRegression",
                                         "OpXGBoostClassifier")
    jm = JReg.get(type(winner).__name__)(**winner.get_params())
    assert_loco_equal(*loco_both(jm, winner, X, True))


def test_titanic_gbt_loco_equals_the_committed_jax_diffs():
    """The Titanic quickstart GBT over its 891 rows, with its vector's
    metadata: the port's LOCO diffs (K5-loco's plain version) against
    the JAX package's committed beside the fixture."""
    from transmogrifai_tpu_torch import Dataset, load_model
    from transmogrifai_tpu_torch.insights import RecordInsightsLOCO
    model = load_model(chip_smoke.FIXTURE, device="cpu")
    gbt = chip_smoke.fitted_of(model, "GBTClassificationModel")
    vec = model.score(Dataset.from_csv(chip_smoke.TITANIC),
                      keep_intermediate=True)[gbt.input_features[-1].uid]
    stage = RecordInsightsLOCO(gbt, top_k=chip_smoke.ENRICH_LOCO_TOP_K)
    X = vec.device_value("cpu")
    _, masks = stage._groups(vec.meta, X.shape[1])
    got = stage.diffs(X, masks)
    with np.load(chip_smoke.TITANIC_LOCO) as z:
        want, top = z["meta_diffs"], z["meta_top"]
    np.testing.assert_allclose(got, want, rtol=0, atol=LOCO_ATOL)
    strength = np.max(np.abs(want), axis=2)
    mine = np.argsort(-np.max(np.abs(got), axis=2), axis=0)[:top.shape[0]]
    for i in np.flatnonzero((mine != top).any(axis=0)):
        assert np.all(np.abs(strength[mine[:, i], i]
                             - strength[top[:, i], i]) <= LOCO_ATOL)


def test_parser_reads_both_packages_rows():
    from transmogrifai_tpu.insights import RecordInsightsParser as JP
    from transmogrifai_tpu_torch.insights import RecordInsightsParser as PP
    rows = [{"a": json.dumps([[0, -0.5], [1, 0.5]]), "b": "[[0, 1e-09]]"},
            {}, None, {"x_1": "[]"}]
    assert [PP.parse_row(r) for r in rows] == [JP.parse_row(r) for r in rows]


def prediction_cols(P, classes):
    """The same predictions as a Prediction column of each package."""
    from transmogrifai_tpu.data.columns import Column as JColumn
    from transmogrifai_tpu_torch.data.columns import Column as PColumn
    import transmogrifai_tpu.types as jt
    import transmogrifai_tpu_torch.types as pt
    if classes:
        data = {"prediction": P.argmax(1).astype(np.float32),
                "rawPrediction": P, "probability": P}
    else:
        data = {"prediction": P[:, 0], "rawPrediction": P,
                "probability": np.zeros((len(P), 0), np.float32)}
    return (PColumn(pt.Prediction, {k: np.array(v) for k, v in data.items()}),
            JColumn(jt.Prediction, {k: np.array(v) for k, v in data.items()}))


@pytest.mark.parametrize("norm", ["minmax", "znorm", "minmax_centered"])
@pytest.mark.parametrize("corr_type", ["pearson", "spearman"])
@pytest.mark.parametrize("classes", [2, 0])
def test_corr_insights_equal_jax(norm, corr_type, classes):
    """The fitted correlations within CORR_ATOL (NaN where a column has no
    variance), the normalizer equal, and the transform's top-K rows equal
    but for near-ties, values within CORR_ATOL times the scaled value."""
    from transmogrifai_tpu.data.columns import Column as JColumn
    from transmogrifai_tpu.insights import RecordInsightsCorr as JCorr
    from transmogrifai_tpu.stages.base import FitContext as JCtx
    from transmogrifai_tpu_torch.data.columns import Column as PColumn
    from transmogrifai_tpu_torch.insights import RecordInsightsCorr as PCorr
    from transmogrifai_tpu_torch.stages.base import FitContext as PCtx
    X, _ = problem(n=400, d=24, hostile=False, seed=3)
    X[:, 13] = 2.5                       # no variance: NaN correlations
    rng = np.random.default_rng(4)
    logit = X[:, 0] - X[:, 5] + rng.normal(0, 0.3, len(X))
    p1 = (1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    P = np.stack([1 - p1, p1], 1) if classes else (2 * logit)[:, None]
    P = P.astype(np.float32)
    pcol, jcol = prediction_cols(P, classes)
    kw = {"top_k": 6, "norm_type": norm, "correlation_type": corr_type}
    pv = PColumn.vector(X, meta_of("port", X.shape[1]))
    jv = JColumn.vector(X, meta_of("jax", X.shape[1]))
    pm = PCorr(**kw).fit_model([pcol, pv], PCtx(n_rows=len(X)))
    jm = JCorr(**kw).fit_model([jcol, jv], JCtx(n_rows=len(X)))
    np.testing.assert_array_equal(np.isnan(pm.corr), np.isnan(jm.corr))
    assert np.isnan(pm.corr[:, 13]).all()
    gap = float(np.nanmax(np.abs(pm.corr - jm.corr)))
    assert gap <= CORR_ATOL, gap
    np.testing.assert_array_equal(pm.shift, jm.shift)
    np.testing.assert_array_equal(pm.scale, jm.scale)
    assert pm.names == jm.names and pm.top_k == jm.top_k
    prow = pm.transform([pcol, pv], "cpu").data
    jrow = jm.transform([jcol, jv]).data
    Z = np.where(jm.scale != 0, (X.astype(np.float64) - jm.shift)
                 / np.where(jm.scale != 0, jm.scale, 1.0), 0.0)
    strength = np.abs(Z) * np.abs(np.nan_to_num(jm.corr)).max(0)[None, :]
    idx = {n: j for j, n in enumerate(jm.names)}
    for i, (p, j) in enumerate(zip(prow, jrow)):
        tol = CORR_ATOL * np.abs(Z[i]).max() + 1e-9
        for a, b in zip(p, j):
            assert a == b or abs(strength[i, idx[a]] - strength[i, idx[b]]
                                 ) <= tol
        for k in set(p) & set(j):
            np.testing.assert_allclose(
                [v for _, v in json.loads(p[k])],
                [v for _, v in json.loads(j[k])], rtol=0, atol=tol)


def test_corr_model_params_round_trip():
    from transmogrifai_tpu.stages.base import StageRegistry as JReg
    from transmogrifai_tpu_torch import from_jax_params
    params = {"corr": np.array([[0.5, np.nan, -0.25]]),
              "shift": np.zeros(3), "scale": np.ones(3),
              "names": ["a", "b", "c"], "top_k": 2}
    stage = from_jax_params("RecordInsightsCorrModel", params, uid="c")
    back = JReg.get("RecordInsightsCorrModel")(uid="d",
                                                 **stage.get_params())
    for k in ("corr", "shift", "scale"):
        np.testing.assert_array_equal(back.get_params()[k], params[k])
    loco = from_jax_params("RecordInsightsLOCO",
                           {"top_k": 7, "group_chunk": 3}, uid="l")
    assert loco.get_params() == {"top_k": 7, "group_chunk": 3}
    assert JReg.get("RecordInsightsLOCO")(**loco.get_params()).get_params() \
        == loco.get_params()


def loco_workflow(pkg, tmp):
    """A trained workflow whose result is LOCO over its LR model, saved to
    `tmp`; (model, loaded model, the LOCO feature, dataset)."""
    from importlib import import_module
    root = "transmogrifai_tpu_torch" if pkg == "port" else "transmogrifai_tpu"
    t = import_module(f"{root}.types")
    Dataset = import_module(f"{root}.data").Dataset
    FB = import_module(f"{root}.features").FeatureBuilder
    Workflow = import_module(f"{root}.workflow").Workflow
    ins = import_module(f"{root}.insights")
    models = import_module(f"{root}.models")
    X, y = problem(n=120, d=12, hostile=False)
    rows = [{"y": float(y[i]), **{f"x{j}": float(X[i, j]) for j in range(4)}}
            for i in range(len(y))]
    ds = Dataset.from_rows(rows, schema={"y": t.RealNN,
                                         **{f"x{j}": t.Real
                                            for j in range(4)}})
    label = FB.RealNN("y").from_column("y").as_response()
    xs = [FB.Real(f"x{j}").from_column(f"x{j}").as_predictor()
          for j in range(4)]
    vec = import_module(f"{root}.automl.transmogrify").transmogrify(xs)
    est = models.OpLogisticRegression(max_iter=10)
    pred = est.set_input(label, vec).get_output()
    kw = {"device": "cpu"} if pkg == "port" else {}
    first = Workflow().set_result_features(pred, vec).set_input_dataset(
        ds).train(**kw)
    lm = first.fitted[pred.origin_stage.uid]
    loco = ins.RecordInsightsLOCO(lm, top_k=2).set_input(vec).get_output()
    model = Workflow().set_result_features(pred, loco).set_input_dataset(
        ds).train(**kw)
    path = os.path.join(tmp, pkg)
    model.save(path)
    return model, loco, ds, path


def test_loco_after_save_and_load_f24(tmp_path):
    """F24: LOCO's saved params hold no model (JAX insights/loco.py:
    125-127), so a loaded workflow's LOCO stage has none and scoring it
    raises "needs a fitted model" — in the JAX package, in the port on
    the JAX package's save, and in the port on its own. LOCO over a
    loaded model is built in code (as tests/test_insights.py does)."""
    import transmogrifai_tpu.automl.sanity_checker  # noqa: F401 (F6)
    from transmogrifai_tpu.workflow.serialization import (
        load_model as jload)
    from transmogrifai_tpu_torch import load_model as pload
    jmodel, jloco, jds, jpath = loco_workflow("jax", str(tmp_path))
    pmodel, ploco, pds, ppath = loco_workflow("port", str(tmp_path))
    assert len(jmodel.score(jds)[jloco.name].data) == len(jds)
    assert len(pmodel.score(pds)[ploco.name].data) == len(pds)
    with pytest.raises(RuntimeError, match="needs a fitted model"):
        jload(jpath).score(jds)
    for path in (jpath, ppath):
        loaded = pload(path, device="cpu")
        stage = next(s for s in loaded.fitted.values()
                     if type(s).__name__ == "RecordInsightsLOCO")
        assert stage.model is None
        with pytest.raises(RuntimeError, match="needs a fitted model"):
            loaded.score(pds)
