"""The text-enrichment slice end to end against the JAX package on the
CPU (ROADMAP queue 1, item 6b): `chip_smoke.py` phase 28's pipeline (the
contact table's email, url, phone, phone-map and base64 groups, the note
through the language-aware tokenizer, stopwords, counts, LDA and
Word2Vec, the language, name and entity detectors, the SanityChecker and
LR + XGB over 3 folds, correlation insights) trained small in both
packages, and the fixture phase 28 holds the card to.

Tolerances: vectors bit-equal; kept columns, configs and winner equal;
fold AuPR 1e-4 for LR and 1e-2 for XGB (PERF.md §2).

    python tests/test_torch_enrichment.py fixture [DIR]

writes the JAX package's results for phase 28 (default DIR:
transmogrifai_tpu_torch/testdata/enrichment_train_f32; f32 histogram
mode, F4) and the Titanic GBT's LOCO diffs beside its fixture
(`testdata/titanic_quickstart_gbt/loco_diffs.npz`);
`noise-run SEED OUT.json` and `merge-noise DIR PARTS...` add the XGB
family's one-ulp noise runs, as for phase 27.
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


def jax_namespace():
    """Phase 28's entry points from the JAX package."""
    from types import SimpleNamespace

    import transmogrifai_tpu  # noqa: F401  (attaches the DSL)
    import transmogrifai_tpu.types as t
    from transmogrifai_tpu.automl import transmogrify
    from transmogrifai_tpu.data import Dataset
    from transmogrifai_tpu.features import FeatureBuilder
    from transmogrifai_tpu.insights import (
        RecordInsightsCorr, RecordInsightsLOCO, RecordInsightsParser)
    from transmogrifai_tpu.selector.model_selector import (
        BinaryClassificationModelSelector, _default_binary_models)
    from transmogrifai_tpu.workflow import Workflow
    from transmogrifai_tpu.workflow.serialization import load_model
    return SimpleNamespace(
        t=t, FeatureBuilder=FeatureBuilder, transmogrify=transmogrify,
        Dataset=Dataset, Workflow=Workflow, load_model=load_model,
        BinaryClassificationModelSelector=BinaryClassificationModelSelector,
        RecordInsightsCorr=RecordInsightsCorr,
        RecordInsightsLOCO=RecordInsightsLOCO,
        RecordInsightsParser=RecordInsightsParser,
        default_binary_models=_default_binary_models)


def dataset(ns, rows):
    return ns.Dataset.from_rows(rows, schema=chip_smoke.enrichment_schema(
        ns.t))


def host(a):
    return np.asarray(a.detach().cpu() if hasattr(a, "detach") else a)


def enrichment_outcome(model, feats, ds) -> dict:
    """What phase 28 holds a train to: the vector's metadata, per-column
    f64 sums and first 64 rows; the kept columns; the configs, fold
    metrics, winner and holdout metrics."""
    vec = model.score(ds, keep_intermediate=True)[feats["vector"].uid]
    X = host(vec.data).astype(np.float32)
    checker = chip_smoke.fitted_of(model, "SanityCheckerModel")
    summ = chip_smoke.selector_summary(model)
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


def jax_loco_diffs(stage, vec_col):
    """The JAX LOCO stage's (G, n, C) diffs and (K, n) top groups, by the
    calls of its `transform` (insights/loco.py:88-108)."""
    import jax
    import jax.numpy as jnp
    X = jnp.asarray(vec_col.device_value())
    n, d = X.shape
    names, masks_np = stage._groups(vec_col.meta, d)
    masks = jnp.asarray(masks_np)
    base = stage._scores(X)
    chunk = max(1, stage.params.get("group_chunk", 32))
    parts = [np.zeros((0, n, base.shape[1]), np.float32)]
    for s in range(0, masks.shape[0], chunk):
        ablated = jax.vmap(
            lambda m: stage._scores(X * (1.0 - m)))(masks[s:s + chunk])
        parts.append(np.asarray(base[None, :, :] - ablated))
    diffs = np.concatenate(parts, axis=0)
    top_k = min(stage.params["top_k"], len(names))
    strength = np.max(np.abs(diffs), axis=2)
    top = np.argsort(-strength, axis=0)[:top_k, :]
    return names, diffs, top


def save_params(path: str, stage) -> None:
    """A fitted stage's class and params: `<path>.json` with arrays of 64
    or more elements in `<path>.npz` (the model format's rule)."""
    from transmogrifai_tpu_torch.workflow.serialization import (
        _offload_arrays)
    store = {}
    params = _offload_arrays(stage.get_params(), store, "p")
    with open(path + ".json", "w") as fh:
        json.dump({"class": type(stage).__name__, "params": params}, fh)
    np.savez_compressed(path + ".npz", **store)


def jax_enrichment_train(n_fit: int = None, models=None):
    ns = jax_namespace()
    rows, _ = chip_smoke.enrichment_tables(n_fit or chip_smoke.ENRICH_FIT_ROWS)
    ds = dataset(ns, rows)
    feats = chip_smoke.enrichment_pipeline(ns, models=models)
    model = ns.Workflow().set_result_features(
        feats["prediction"], feats["corr"]).set_input_dataset(ds).train()
    return ns, model, feats, ds


def write_fixture(path: str) -> None:
    """Phase 28's fixture from the JAX package (f32 histograms, F4)."""
    import jax.numpy as jnp

    from transmogrifai_tpu.data.columns import Column
    ns, model, feats, ds = jax_enrichment_train()
    out = enrichment_outcome(model, feats, ds)
    os.makedirs(path, exist_ok=True)
    _, score_rows = chip_smoke.enrichment_tables(
        chip_smoke.ENRICH_FIT_ROWS)
    sds = dataset(ns, score_rows)
    scored = model.score(sds, keep_intermediate=True)
    xs = host(scored[feats["checked"].uid].data).astype(np.float32)
    xt = host(model.score(ds, keep_intermediate=True)[
        feats["checked"].uid].data).astype(np.float32)
    checked_meta = scored[feats["checked"].uid].meta
    # the checked vectors themselves: LOCO and the correlations are held
    # on the JAX package's inputs (the Real group's mean fill is one ulp
    # apart in the port, which can move a tree's bin)
    arrays = {"sums": out.pop("vector_sums"), "head": out.pop("vector_head"),
              "checked_train": xt, "checked_score": xs}
    # the winner, and the grid's XGB fitted alone on the checked vector
    winner = next(s for s in model.fitted.values() if hasattr(
        getattr(s, "summary", None), "validation_results"))
    import copy
    xgb_est, xgb_grid = chip_smoke.enrichment_models(ns)[1]
    xgb_est = copy.deepcopy(xgb_est)
    for k, v in xgb_grid[0].items():
        setattr(xgb_est, k, v)
    from transmogrifai_tpu.stages.base import FitContext
    y = np.asarray(model.score(ds, keep_intermediate=True)[
        feats["label"].uid].data["value"], np.float32)
    xgb = xgb_est.fit_arrays(jnp.asarray(xt), jnp.asarray(y),
                             jnp.ones(len(y), jnp.float32),
                             FitContext(n_rows=len(y)))
    save_params(os.path.join(path, "winner"), winner)
    save_params(os.path.join(path, "xgb"), xgb)
    vec_col = Column.vector(xs, checked_meta)
    for name, m in (("winner", winner), ("xgb", xgb)):
        stage = ns.RecordInsightsLOCO(m, top_k=chip_smoke.ENRICH_LOCO_TOP_K)
        groups, diffs, top = jax_loco_diffs(stage, vec_col)
        arrays[f"loco_{name}_diffs"] = diffs
        arrays[f"loco_{name}_top"] = top.astype(np.int32)
        out[f"loco_{name}_groups"] = groups
    corr = chip_smoke.fitted_of(model, "RecordInsightsCorrModel")
    save_params(os.path.join(path, "corr"), corr)
    rows = ns.RecordInsightsParser.parse_column(
        scored[feats["corr"].uid])
    out["corr_rows"] = [{k: v for k, v in r.items()} for r in rows[:200]]
    np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "results.json"), "w") as fh:
        json.dump(out, fh, indent=1)


def write_titanic_loco(path: str) -> None:
    """The Titanic quickstart GBT's LOCO diffs over its 891 rows, with
    its vector's metadata and without (G = d)."""
    ns = jax_namespace()
    import transmogrifai_tpu.automl.sanity_checker  # noqa: F401  (F6)
    from transmogrifai_tpu.data.columns import Column
    model = ns.load_model(chip_smoke.FIXTURE)
    gbt = chip_smoke.fitted_of(model, "GBTClassificationModel")
    ds = ns.Dataset.from_csv(chip_smoke.TITANIC)
    vec = model.score(ds, keep_intermediate=True)[
        gbt.input_features[-1].uid]
    arrays = {}
    for name, col in (("meta", vec),
                      ("bare", Column.vector(host(vec.data), None))):
        stage = ns.RecordInsightsLOCO(gbt, top_k=chip_smoke.ENRICH_LOCO_TOP_K)
        _, diffs, top = jax_loco_diffs(stage, col)
        arrays[f"{name}_diffs"] = diffs
        arrays[f"{name}_top"] = top.astype(np.int32)
    np.savez_compressed(path, **arrays)


NOISE_SEEDS = (1, 2, 3, 4)


def write_noise_run(seed: int, path: str) -> None:
    """The JAX package's XGB family alone on phase 28's rows with the
    selector's matrix moved by one ulp (seeded): its fold metrics, the
    spread the reference itself has under float noise (F23's rule)."""
    import dataclasses

    from test_torch_families import one_ulp_noise
    import transmogrifai_tpu.selector.model_selector as jms
    fit_model = jms.ModelSelector.fit_model

    def noisy_fit_model(self, cols, ctx):
        label_col, vec_col = cols
        vec_col = dataclasses.replace(vec_col, data=one_ulp_noise(
            np.asarray(vec_col.data, dtype=np.float32), seed))
        return fit_model(self, [label_col, vec_col], ctx)

    jms.ModelSelector.fit_model = noisy_fit_model
    ns = jax_namespace()
    xgb = chip_smoke.enrichment_models(ns)[1:]
    _, model, _, _ = jax_enrichment_train(models=xgb)
    summ = chip_smoke.selector_summary(model)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"seed": seed,
                   "results": [{"model": r.model, "grid": r.grid}
                               for r in summ.validation_results],
                   "fold_metrics": [list(map(float, r.fold_metrics))
                                    for r in summ.validation_results]}, fh)


def merge_noise_runs(parts, path: str) -> None:
    """Add the noise runs to the fixture's results.json (under "noise",
    keyed by family)."""
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


def small_models(ns):
    """LR over two grid points and XGB at a few shallow rounds."""
    lr, xgb = chip_smoke.enrichment_models(ns)
    lr_est = type(lr[0])(max_iter=50)
    xgb_est = type(xgb[0])(n_estimators=6, eta=0.3, max_depth=3,
                           gamma=0.0, early_stopping_rounds=3)
    return [(lr_est, lr[1][:2]), (xgb_est, xgb[1])]


@pytest.fixture(scope="module")
def small_trains():
    """Phase 28's pipeline with `small_models` trained on 300 rows in each
    package (the JAX package in f32 histogram mode, F4)."""
    import transmogrifai_tpu.models.trees as jtrees
    precision = jtrees.HIST_PRECISION
    jtrees.HIST_PRECISION = "f32"
    try:
        rows, score = chip_smoke.enrichment_tables(300)
        out = {}
        for name, ns in (("port", chip_smoke.enrichment_namespace()),
                         ("jax", jax_namespace())):
            ds = dataset(ns, rows)
            feats = chip_smoke.enrichment_pipeline(
                ns, models=small_models(ns), lda_k=4)
            model = ns.Workflow().set_result_features(
                feats["prediction"], feats["corr"], feats["tokens"],
                feats["languages"], feats["entities"]) \
                .set_input_dataset(ds).train(
                    **({"device": "cpu"} if name == "port" else {}))
            out[name] = (ns, model, feats, ds, score[:60])
        return out
    finally:
        jtrees.HIST_PRECISION = precision


def checked_matrix(entry) -> np.ndarray:
    """The checked vector a train scored on its own rows, as f32."""
    ns, model, feats, ds, _ = entry
    col = model.score(ds, keep_intermediate=True)[feats["checked"].uid]
    return host(col.data).astype(np.float32)


def test_small_train_end_to_end_equals_jax(small_trains):
    """LR + XGB over 3 folds on 300 contact rows through every enrichment
    stage: the vector's metadata equal; its column sums and first rows,
    and the checked vector cell by cell, within ENRICH_VECTOR_RTOL (the
    Real group's mean fill is an f32 sum the two packages order apart);
    kept columns, configs and winner equal; fold AuPR within 1e-4 (LR)
    and 1e-2 (XGB)."""
    got = enrichment_outcome(*small_trains["port"][1:4])
    want = enrichment_outcome(*small_trains["jax"][1:4])
    assert chip_smoke.meta_entries(got["vector_meta"]) == \
        chip_smoke.meta_entries(want["vector_meta"])
    # every enrichment group reached the vector (email and url as their
    # domains' picklists, base64 as its MIME type's text)
    parents = {e["parent_name"].split("_")[0] for e in got["vector_meta"]}
    assert {"email", "website", "phone", "phones", "attachment", "note",
            "contact", "revenue", "tenure"} <= parents
    ns, model, feats, ds, _ = small_trains["port"]
    X = host(model.score(ds, keep_intermediate=True)[
        feats["vector"].uid].data).astype(np.float32)
    gap = chip_smoke.vector_gap(X, want["vector_sums"], want["vector_head"])
    assert gap["ok"], gap
    cells = chip_smoke.matrix_gap(checked_matrix(small_trains["port"]),
                                  checked_matrix(small_trains["jax"]))
    assert cells["ok"], cells
    assert got["kept_indices"] == want["kept_indices"]
    assert got["results"] == want["results"]
    assert (got["best_model"], got["best_grid"]) == \
        (want["best_model"], want["best_grid"])
    for r, a, b in zip(got["results"], got["fold_metrics"],
                       want["fold_metrics"]):
        atol = chip_smoke.STRUCT_FOLD_ATOL[r["model"]]
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_small_train_insights_and_text_results_equal_jax(small_trains):
    """The trained graph's text results on 60 score rows: the tokens, the
    detected languages and entities equal the JAX package's; the port's
    correlation insights fitted on the JAX package's prediction and
    checked vector give its correlations within ENRICH_CORR_ATOL (NaN
    where they are NaN) and its normalizer within ENRICH_VECTOR_RTOL (the
    two XGB refits part at near-tie splits, F23, so each package's own
    predictions are not compared); the port's compiled scorer gives its
    eager answers."""
    from transmogrifai_tpu_torch.data.columns import Column
    from transmogrifai_tpu_torch.stages.base import FitContext
    pns, pm, pf, _, rows = small_trains["port"]
    jns, jm, jf, jds, _ = small_trains["jax"]
    ps, js = dataset(pns, rows), dataset(jns, rows)
    peager, jeager = pm.score(ps), jm.score(js)
    for key in ("tokens", "languages", "entities"):
        assert list(peager[pf[key].name].data) == \
            list(jeager[jf[key].name].data), key
    jscored = jm.score(jds, keep_intermediate=True)
    pred = {k: host(v) for k, v in
            jscored[jf["prediction"].uid].data.items()}
    jvec = jscored[jf["checked"].uid]
    pvec = pm.score(dataset(pns, chip_smoke.enrichment_tables(300)[0]),
                    keep_intermediate=True)[pf["checked"].uid]
    corr = pns.RecordInsightsCorr().fit_model(
        [Column(pns.t.Prediction, pred),
         Column.vector(host(jvec.data).astype(np.float32), pvec.meta)],
        FitContext(n_rows=len(pred["prediction"])))
    jc = chip_smoke.fitted_of(jm, "RecordInsightsCorrModel")
    np.testing.assert_array_equal(np.isnan(corr.corr), np.isnan(jc.corr))
    np.testing.assert_allclose(corr.corr, jc.corr, rtol=0,
                               atol=chip_smoke.ENRICH_CORR_ATOL)
    for a, b in ((corr.shift, jc.shift), (corr.scale, jc.scale)):
        np.testing.assert_allclose(a, b, rtol=chip_smoke.ENRICH_VECTOR_RTOL,
                                   atol=0)
    assert chip_smoke.meta_entries([{"parent_name": n} for n in corr.names]
                                   ) == chip_smoke.meta_entries(
        [{"parent_name": n} for n in jc.names])
    compiled = pm.score_compiled(ps)
    for key in ("tokens", "languages", "entities", "corr"):
        assert list(compiled[pf[key].name]) == \
            list(peager[pf[key].name].data), key
    np.testing.assert_array_equal(
        host(compiled[pf["prediction"].name]["probability"]),
        host(peager[pf["prediction"].name].data["probability"]))


LOCO_ROWS = 100


def test_port_matches_the_phase_28_fixture():
    """The committed JAX fixture of `chip_smoke.py` phase 28 against the
    port on the CPU on the same rows: the vector's metadata equal, its
    column sums and first 64 rows within ENRICH_VECTOR_RTOL, the same kept
    columns, the score rows' checked vector cell by cell within it; LOCO
    (the plain walk of K5-loco) over the fixture's XGB and winner within
    ENRICH_LOCO_ATOL of the JAX package's diffs with the same top groups
    but for swaps within it, and the correlation insights within
    ENRICH_CORR_ATOL (`chip_smoke.fixture_insights`, as phase 28 holds
    the card). The selector is held on the card."""
    from transmogrifai_tpu_torch.automl.sanity_checker import SanityChecker
    from transmogrifai_tpu_torch.data.columns import Column
    with open(os.path.join(chip_smoke.ENRICH_FIXTURE, "results.json")) as fh:
        want = json.load(fh)
    with np.load(os.path.join(chip_smoke.ENRICH_FIXTURE, "arrays.npz")) as z:
        fx = {k: z[k] for k in z.files}
    ns = chip_smoke.enrichment_namespace()
    rows, score = chip_smoke.enrichment_tables(chip_smoke.ENRICH_FIT_ROWS)
    assert want["rows"] == len(rows)
    feats = chip_smoke.enrichment_pipeline(ns, models=[])
    with chip_smoke.fit_calls(SanityChecker) as checker_in:
        model = ns.Workflow().set_result_features(feats["checked"]) \
            .set_input_dataset(dataset(ns, rows)).train(device="cpu")
    vec = checker_in[-1][1][1]
    assert chip_smoke.meta_entries(vec.meta.columns) == \
        chip_smoke.meta_entries(want["vector_meta"])
    gap = chip_smoke.vector_gap(host(vec.data).astype(np.float32),
                                fx["sums"], fx["head"])
    assert gap["ok"], gap
    assert list(chip_smoke.fitted_of(model, "SanityCheckerModel").indices) \
        == want["kept_indices"]
    checked = chip_smoke.transform_walls(model, feats, dataset(ns, score),
                                         "cpu", result="checked")["column"]
    cells = chip_smoke.matrix_gap(host(checked.data).astype(np.float32),
                                  fx["checked_score"])
    assert cells["ok"], cells
    # LOCO on the first LOCO_ROWS score rows (a row's diffs depend on that
    # row alone; the plain walk of 200 depth-10 trees a group is slow on
    # the CPU), the correlations fitted on every training row
    fx.update({k: v[:, :LOCO_ROWS] for k, v in fx.items()
               if k.startswith("loco_")})
    want["corr_rows"] = want["corr_rows"][:LOCO_ROWS]
    held = chip_smoke.fixture_insights(
        ns, Column.vector(fx["checked_score"][:LOCO_ROWS], checked.meta),
        Column.vector(fx["checked_train"], checked.meta), want, fx, "cpu")
    assert held["ok"], {k: held[k] for k in ("loco", "corr")}


def _main() -> None:
    args = sys.argv[1:]
    if args and args[0] == "fixture":
        write_fixture(args[1] if len(args) > 1
                      else chip_smoke.ENRICH_FIXTURE)
    elif args and args[0] == "titanic-loco":
        write_titanic_loco(args[1] if len(args) > 1
                           else chip_smoke.TITANIC_LOCO)
    elif args and args[0] == "noise-run":
        write_noise_run(int(args[1]), args[2])
    elif args and args[0] == "merge-noise":
        merge_noise_runs(args[2:], args[1])
    else:
        raise SystemExit("usage: python tests/test_torch_enrichment.py "
                         "fixture [DIR] | titanic-loco [PATH] | noise-run "
                         "SEED OUT.json | merge-noise DIR PARTS...")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["TRANSMOGRIFAI_HIST_PRECISION"] = "f32"
    os.environ["TRANSMOGRIFAI_PERF_MODEL"] = "0"
    import jax
    jax.config.update("jax_platforms", "cpu")
    _main()
