"""The structural slice through the port's entry points against the JAX
package on the CPU: `transmogrify` over every item-6a group, the DSL
methods, models saved by each package and loaded by the other, a small
LR + XGB train end to end, the scoring service's coalesced text and
token-list answers (F10), and `chip_smoke.py` phase 27's fixture.

Tolerances: vectors bit-equal but the unit-circle columns (1e-6, see
tests/test_torch_structural.py); kept columns, configs and winner equal;
fold AuPR 1e-4 for LR and 1e-2 for XGB (PERF.md §2).
"""

import json
import os
import sys
import threading

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from test_torch_structural import (  # noqa: E402
    SINCOS_ATOL, jax_namespace, structural_outcome)

ATOL = SINCOS_ATOL


def port_namespace():
    return chip_smoke.structural_namespace()


@pytest.fixture(scope="module")
def namespaces():
    from transmogrifai_tpu.utils import fnser as jf
    if "structural_drop" not in jf._EXTRACT_REGISTRY:
        jf.extract_fn("structural_drop")(chip_smoke.structural_drop)
    return {"port": port_namespace(), "jax": jax_namespace()}


def dataset(ns, rows):
    return ns.Dataset.from_rows(rows, schema=chip_smoke.structural_schema(
        ns.t))


def train_kw(name):
    return {"device": "cpu"} if name == "port" else {}


def feature_models(namespaces, rows):
    """Phase 27's feature graph (no selector) trained in each package."""
    out = {}
    for name, ns in namespaces.items():
        feats = chip_smoke.structural_pipeline(ns, models=[])
        ds = dataset(ns, rows)
        model = ns.Workflow().set_result_features(
            feats["vector"], feats["label"], feats["tokens"]) \
            .set_input_dataset(ds).train(**train_kw(name))
        out[name] = (model, feats, ds)
    return out


@pytest.fixture(scope="module")
def fitted(namespaces):
    _, rows, score = chip_smoke.structural_tables(300)
    return feature_models(namespaces, rows), score[:120]


def host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def test_transmogrify_every_group_equals_jax(fitted, namespaces):
    models, score_rows = fitted
    (pm, pf, pds), (jm, jf, jds) = models["port"], models["jax"]
    pvec = pm.score(pds, keep_intermediate=True)[pf["vector"].uid]
    jvec = jm.score(jds, keep_intermediate=True)[jf["vector"].uid]
    assert chip_smoke.meta_entries(pvec.meta.columns) == \
        chip_smoke.meta_entries(jvec.meta.columns)
    kinds = {c.parent_type for c in pvec.meta.columns}
    assert {"Date", "DateTime", "DateList", "Geolocation", "MultiPickList",
            "TextList", "RealMap", "IntegralMap", "BinaryMap", "PickListMap",
            "TextAreaMap", "MultiPickListMap", "GeolocationMap",
            "DateMap"} <= kinds
    np.testing.assert_allclose(np.asarray(pvec.data), np.asarray(jvec.data),
                               rtol=0, atol=ATOL)
    # the scored rows, eager and compiled, in both packages
    ps = dataset(namespaces["port"], score_rows)
    js = dataset(namespaces["jax"], score_rows)
    eager = np.asarray(pm.score(ps)[pf["vector"].name].data)
    compiled = host(pm.score_compiled(ps)[pf["vector"].name])
    jeager = np.asarray(jm.score(js)[jf["vector"].name].data)
    jcompiled = np.asarray(jm.score_compiled(js)[jf["vector"].name])
    np.testing.assert_allclose(eager, jeager, rtol=0, atol=ATOL)
    np.testing.assert_allclose(compiled, jcompiled, rtol=0, atol=ATOL)
    sincos = np.array([(c.descriptor_value or "").endswith(("_sin", "_cos"))
                       for c in pvec.meta.columns])
    np.testing.assert_array_equal(eager[:, ~sincos], jeager[:, ~sincos])
    np.testing.assert_array_equal(compiled[:, ~sincos],
                                  jcompiled[:, ~sincos])
    tokens = pm.score_compiled(ps)[pf["tokens"].name]
    assert list(tokens) == list(jm.score(js)[jf["tokens"].name].data)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_saved_models_load_in_the_other_package(fitted, namespaces,
                                                tmp_path, direction):
    models, score_rows = fitted
    src, dst = direction.split("_to_")
    model, feats, _ = models[src]
    path = str(tmp_path / "m")
    model.save(path)
    ns = namespaces[dst]
    loaded = (ns.load_model(path, device="cpu") if dst == "port"
              else ns.load_model(path))
    ds_src = dataset(namespaces[src], score_rows)
    ds_dst = dataset(ns, score_rows)
    want = np.asarray(model.score(ds_src)[feats["vector"].name].data)
    got = np.asarray(loaded.score(ds_dst)[feats["vector"].name].data)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if dst == "port":
        compiled = host(loaded.score_compiled(ds_dst)[feats["vector"].name])
        np.testing.assert_array_equal(
            compiled, np.asarray(loaded.score(ds_dst)[
                feats["vector"].name].data))


@pytest.mark.parametrize("ftype", ["Email", "URL", "Phone", "Base64",
                                   "PhoneMap"])
def test_enrichment_groups_raise_naming_item_6b(ftype):
    """Item 6b is ported: transmogrify takes the email, url, phone and
    base64 groups and phone maps, wiring the JAX package's stages
    (their values are held in tests/test_torch_enrich.py)."""
    import transmogrifai_tpu.types as jt
    import transmogrifai_tpu_torch.types as pt
    from transmogrifai_tpu.automl.transmogrify import transmogrify as jtr
    from transmogrifai_tpu.stages.base import FeatureGeneratorStage as JGen
    from transmogrifai_tpu_torch import transmogrify
    from transmogrifai_tpu_torch.stages.base import FeatureGeneratorStage

    def chain(vec):
        out, stack = [], [vec]
        while stack:
            f = stack.pop()
            stage = f.origin_stage
            out.append(type(stage).__name__)
            stack.extend(f.parents)
        return out
    f = FeatureGeneratorStage(name="x", ftype=getattr(pt, ftype)) \
        .get_output()
    g = JGen(name="x", ftype=getattr(jt, ftype)).get_output()
    assert chain(transmogrify([f])) == chain(jtr([g]))


def test_prediction_maps_are_refused_as_in_jax():
    import transmogrifai_tpu_torch.types as pt
    from transmogrifai_tpu_torch.ops.maps import map_vectorizers
    from transmogrifai_tpu_torch.automl.transmogrify import (
        TransmogrifierDefaults)
    from transmogrifai_tpu_torch.stages.base import FeatureGeneratorStage
    f = FeatureGeneratorStage(name="p", ftype=pt.Prediction).get_output()
    with pytest.raises(TypeError, match="refusing to vectorize Prediction"):
        map_vectorizers([f], TransmogrifierDefaults())


DSL_CASES = {
    "vectorize": ("created", lambda f: f.vectorize()),
    "combine": ("location", lambda f: f.vectorize().combine(f.vectorize())),
    "tokenize": ("description", lambda f: f.tokenize(min_token_length=2)),
    "smart_vectorize": ("description",
                        lambda f: f.smart_vectorize(num_features=8)),
    "to_unit_circle": ("created", lambda f: f.to_unit_circle(["HourOfDay"])),
    "to_time_period": ("closed_at",
                       lambda f: f.to_time_period("MonthOfYear")),
    "deindexed": ("outcome", lambda f: f.indexed().deindexed()),
}


@pytest.mark.parametrize("method", sorted(DSL_CASES))
def test_dsl_methods_equal_jax(namespaces, method):
    col, fn = DSL_CASES[method]
    rows = chip_smoke.structural_rows(80, seed=5)
    out = {}
    for name, ns in namespaces.items():
        ftype = chip_smoke.structural_schema(ns.t)[col]
        f = getattr(ns.FeatureBuilder, ftype.__name__)(col) \
            .from_column(col).as_predictor()
        res = fn(f)
        model = ns.Workflow().set_result_features(res).set_input_dataset(
            dataset(ns, rows)).train(**train_kw(name))
        c = model.score(dataset(ns, rows))[res.name]
        data = c.data
        out[name] = (type(res.origin_stage).__name__,
                     res.ftype.__name__,
                     data if isinstance(data, dict) else np.asarray(data))
    (ps, pt_, pd), (js, jt_, jd) = out["port"], out["jax"]
    assert (ps, pt_) == (js, jt_)
    if isinstance(pd, dict):
        for k in pd:
            np.testing.assert_array_equal(np.asarray(pd[k]),
                                          np.asarray(jd[k]))
    elif pd.dtype == object:
        assert list(pd) == list(jd)
    else:
        np.testing.assert_allclose(pd, jd, rtol=0, atol=ATOL)


def small_models(ns):
    """LR over two grid points and XGB at a few rounds."""
    lr, xgb = chip_smoke.structural_models(ns)
    lr_est = type(lr[0])(max_iter=50)
    xgb_est = type(xgb[0])(n_estimators=6, eta=0.3, max_depth=3,
                           gamma=0.0, early_stopping_rounds=3)
    return [(lr_est, lr[1][:2]), (xgb_est, xgb[1])]


def test_small_train_end_to_end_equals_jax(namespaces, monkeypatch):
    """LR + XGB over 3 folds on 400 generated rows: kept columns, configs
    and winner equal, fold AuPR within 1e-4 (LR) and 1e-2 (XGB)."""
    import transmogrifai_tpu.models.trees as jtrees
    monkeypatch.setattr(jtrees, "HIST_PRECISION", "f32")
    _, rows, score = chip_smoke.structural_tables(400)
    res = {}
    for name, ns in namespaces.items():
        ds = dataset(ns, rows)
        feats = chip_smoke.structural_pipeline(ns, models=small_models(ns))
        model = ns.Workflow().set_result_features(
            feats["prediction"], feats["named"], feats["tokens"]) \
            .set_input_dataset(ds).train(**train_kw(name))
        res[name] = (structural_outcome(ns, model, feats, ds), model,
                     feats)
    got, want = res["port"][0], res["jax"][0]
    assert chip_smoke.meta_entries(got["vector_meta"]) == \
        chip_smoke.meta_entries(want["vector_meta"])
    assert got["kept_indices"] == want["kept_indices"]
    assert got["results"] == want["results"]
    assert (got["best_model"], got["best_grid"]) == \
        (want["best_model"], want["best_grid"])
    for r, a, b in zip(got["results"], got["fold_metrics"],
                       want["fold_metrics"]):
        atol = chip_smoke.STRUCT_FOLD_ATOL[r["model"]]
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    # served: the de-indexed label and the tokens, compiled and eager
    pm, pf = res["port"][1], res["port"][2]
    ps = dataset(namespaces["port"], score[:50])
    compiled = pm.score_compiled(ps)
    eager = pm.score(ps)
    assert list(compiled[pf["named"].name]) == \
        list(eager[pf["named"].name].data)
    assert set(compiled[pf["named"].name]) <= {"won", "lost"}
    assert list(compiled[pf["tokens"].name]) == \
        list(eager[pf["tokens"].name].data)


def test_service_slices_text_and_token_list_answers(fitted, namespaces):
    """F10: requests coalesced into one batch each get their own rows of
    a TextList result (the tokens) and a Text result (the label)."""
    from transmogrifai_tpu_torch.serving import (
        ScoringService, ServingConfig)
    ns = namespaces["port"]
    _, rows, score = chip_smoke.structural_tables(200)
    feats = chip_smoke.structural_pipeline(ns, models=[])
    from transmogrifai_tpu_torch.ops.indexers import OpIndexToString
    named = OpIndexToString().set_input(feats["label"]).get_output()
    model = ns.Workflow().set_result_features(
        feats["tokens"], named, feats["vector"]).set_input_dataset(
        dataset(ns, rows)).train(device="cpu")
    reqs = [score[0:1], score[1:4], score[4:21], score[21:40]]
    want = model.score_compiled(dataset(ns, score[:40]))
    svc = ScoringService(model, ServingConfig(max_batch=64,
                                              batch_wait_ms=300.0)).start()
    answers = [None] * len(reqs)
    try:
        def ask(i):
            answers[i] = svc.score([dict(r) for r in reqs[i]])
        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        batches = svc.health()["batches"]
    finally:
        svc.stop()
    assert batches < len(reqs)  # the requests were coalesced
    off = 0
    for req, ans in zip(reqs, answers):
        n = len(req)
        toks = ans.outputs[feats["tokens"].name]
        labels = ans.outputs[named.name]
        assert len(toks) == len(labels) == n
        assert list(toks) == list(want[feats["tokens"].name][off:off + n])
        assert list(labels) == [r["outcome"] for r in req]
        np.testing.assert_array_equal(
            ans.outputs[feats["vector"].name],
            host(want[feats["vector"].name])[off:off + n])
        off += n


def test_slice_result_tree_cuts_lists_and_refuses_other_leaves():
    from transmogrifai_tpu_torch.workflow.compiled import slice_result_tree
    tree = {"a": np.arange(6), "b": [[1], [2], None, [4], [5], [6]],
            "c": np.array(["x", None, "z", "w", "v", "u"], dtype=object),
            "d": {"e": (1, 2, 3, 4, 5, 6)}}
    got = slice_result_tree(tree, 2, 4)
    assert got["a"].tolist() == [2, 3] and got["b"] == [None, [4]]
    assert got["c"].tolist() == ["z", "w"] and got["d"]["e"] == (3, 4)
    for leaf in ("whole batch", 3.0, np.float32(1.0), None):
        with pytest.raises(TypeError, match="cannot slice"):
            slice_result_tree({"x": leaf}, 0, 1)


def test_port_matches_the_phase_27_fixture(namespaces):
    """The committed JAX fixture of `chip_smoke.py` phase 27 against the
    port's CPU features on the same rows: the vector's metadata equal,
    its column sums and first 64 rows within tolerance, the SanityChecker
    keeping the same columns (the selector is held on the card)."""
    with open(os.path.join(chip_smoke.STRUCT_FIXTURE, "results.json")) as fh:
        want = json.load(fh)
    with np.load(os.path.join(chip_smoke.STRUCT_FIXTURE, "vector.npz")) as z:
        sums, head = z["sums"], z["head"]
    ns = namespaces["port"]
    _, rows, _ = chip_smoke.structural_tables()
    assert want["rows"] == len(rows) == chip_smoke.STRUCT_FIT_ROWS
    feats = chip_smoke.structural_pipeline(ns, models=[])
    ds = dataset(ns, rows)
    model = ns.Workflow().set_result_features(feats["checked"]) \
        .set_input_dataset(ds).train(device="cpu")
    got = chip_smoke.structural_vector_check(model, feats, ds, want, sums,
                                             head)
    assert got["ok"], got



def witness_case(**change):
    """A shadow record, launch counts and two train outcomes that pass
    `judge_structural_witness`, with `change` applied."""
    rec = {k: {"calls": 3, "bad": 0, "max_abs_err": 0.0}
           for k in chip_smoke.STRUCT_SHADOWED}
    launches = {k: 3 for k in chip_smoke.STRUCT_TRAIN_KERNELS}
    launches.update(split_search=1, split_search_live=2)
    main = {"configs": [("OpXGBoostClassifier", {"min_child_weight": 1.0})],
            "fold_metrics": [[0.5, 0.45, 0.52]],
            "winner": ("OpXGBoostClassifier", {"min_child_weight": 1.0}),
            "kept": [0, 2, 3]}
    again = json.loads(json.dumps(main))
    again["configs"] = [tuple(c) for c in again["configs"]]
    again["winner"] = tuple(again["winner"])
    if "bad" in change:
        rec["histograms"]["bad"] = change["bad"]
    if "calls" in change:
        rec["route_level"]["calls"] = change["calls"]
    if "launches" in change:
        launches["split_search_live"] = change["launches"]
    for k in ("fold_metrics", "winner", "kept"):
        if k in change:
            again[k] = change[k]
    return rec, launches, main, again


@pytest.mark.parametrize("change, ok", [
    ({}, True),
    ({"bad": 1}, False),
    ({"calls": 2}, False),
    ({"launches": 3}, False),
    ({"fold_metrics": [[0.5, 0.45 + 2 ** -24, 0.52]]}, False),
    ({"winner": ("OpXGBoostClassifier", {"min_child_weight": 10.0})},
     False),
    ({"kept": [0, 2]}, False),
])
def test_structural_witness_judge(change, ok):
    """Phase 27's witness: every launch of the path shadowed by its plain
    version, none apart from it, and the second train the same bits as
    the first."""
    got = chip_smoke.judge_structural_witness(*witness_case(**change))
    assert got["ok"] is ok, got


def test_shadow_kernels_pass_cpu_tensors_through_and_restore():
    """On CPU tensors the shadows call the wrappers and compare nothing;
    every binding they replaced is restored on exit."""
    import torch

    from transmogrifai_tpu_torch.evaluators import device_metrics as pdm
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.parallel import sweep
    before = (pt.histograms, pt.bin_features, sweep.bin_features,
              pdm.binned_aupr)
    rng = np.random.default_rng(3)
    X = torch.as_tensor(rng.normal(size=(64, 4)).astype(np.float32))
    edges = torch.as_tensor(np.sort(rng.normal(size=(4, 7)), axis=1)
                            .astype(np.float32))
    node = torch.as_tensor(rng.integers(0, 2, size=(1, 64)),
                           dtype=torch.int32)
    G = torch.as_tensor(rng.normal(size=(1, 1, 64)).astype(np.float32))
    H = torch.ones((1, 64))
    with chip_smoke.shadow_kernels() as rec:
        assert sweep.bin_features is not before[2]
        Xb = pt.bin_features(X, edges)
        hg, hh = pt.histograms(Xb, node, G, H, 2, 8)
        s = pdm.binned_aupr(G[0], (G[0, 0] > 0).float(), H, 16, True)
    assert torch.equal(Xb, pt.bin_features_plain(X, edges))
    want = pt.histograms_plain(Xb, node, G, H, 2, 8)
    assert torch.equal(hg, want[0]) and torch.equal(hh, want[1])
    assert torch.equal(s, pdm.binned_aupr_plain(
        G[0], (G[0, 0] > 0).float(), H, 16, True))
    assert all(r["calls"] == 0 for r in rec.values())
    assert (pt.histograms, pt.bin_features, sweep.bin_features,
            pdm.binned_aupr) == before
