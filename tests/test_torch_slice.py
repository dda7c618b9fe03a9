"""Parity of the PyTorch port's serving slice with the JAX package.

The committed fixture `transmogrifai_tpu_torch/testdata/titanic_quickstart_gbt`
is the README quickstart trained by the JAX package on
`examples/data/titanic.csv` (XGBoost family, 200 rounds at depth 10),
saved with `model.save`, plus `expected_scores.npz`: the JAX package's
`score_compiled` output for all 891 rows. Regenerate it (CPU, about three
minutes) with:

    JAX_PLATFORMS=cpu python tests/test_torch_slice.py

Tolerances, against the JAX package on the same rows:
- the vectorized feature matrices (1048 combined, 496 kept columns) must
  be equal: they are fills with 0/1 masks, hash counts and one-hot;
- GBT margin / rawPrediction: atol 2e-5 and probability: atol 1e-5 —
  200 f32 leaf values are summed in tree order here and in 64-tree
  vmapped chunks in the JAX program;
- prediction equal on every row with |margin| > 1e-4;
- logistic regression rawPrediction / probability: atol 1e-5 — the
  (d, k) product sums in another order than XLA's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "testdata",
                       "titanic_quickstart_gbt")
TITANIC = os.path.join(REPO, "examples", "data", "titanic.csv")
PRED_KEYS = ("prediction", "rawPrediction", "probability")


def _prediction_name(scores):
    names = [k for k, v in scores.items()
             if isinstance(v, dict) and "probability" in v]
    assert len(names) == 1, names
    return names[0]


def _host(pred):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in pred.items()}


def assert_gbt_close(got, want):
    """The stated GBT tolerances (module docstring)."""
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=1e-5)
    decided = np.abs(want["rawPrediction"][:, 1]) > 1e-4
    np.testing.assert_array_equal(got["prediction"][decided],
                                  want["prediction"][decided])


def _quickstart(models, cross_validation: bool):
    """The README quickstart pipeline with an explicit model grid."""
    from transmogrifai_tpu.automl import transmogrify
    from transmogrifai_tpu.data import Dataset
    from transmogrifai_tpu.features import FeatureBuilder
    from transmogrifai_tpu.selector import BinaryClassificationModelSelector
    from transmogrifai_tpu.workflow import Workflow

    ds = Dataset.from_csv(TITANIC)
    predictors, label = FeatureBuilder.from_dataset(ds, response="survived")
    features = transmogrify(predictors)
    checked = label.sanity_check(features, remove_bad_features=True)
    factory = (BinaryClassificationModelSelector.with_cross_validation
               if cross_validation else
               BinaryClassificationModelSelector.with_train_validation_split)
    prediction = factory(models=models).set_input(label, checked).get_output()
    model = Workflow().set_result_features(prediction, label) \
        .set_input_dataset(ds).train()
    return model, ds


def generate_fixture(out_dir: str) -> None:
    """Train the quickstart with the JAX package, save it to `out_dir`
    and write `expected_scores.npz` from its `score_compiled`."""
    import transmogrifai_tpu  # noqa: F401  (attaches the DSL)
    from transmogrifai_tpu.models import OpXGBoostClassifier

    model, ds = _quickstart([(OpXGBoostClassifier(
        n_estimators=200, eta=0.02, max_depth=10, gamma=0.8,
        early_stopping_rounds=20), [{"min_child_weight": 1.0}])],
        cross_validation=True)
    model.save(out_dir)
    scores = model.score_compiled(ds)
    pred = scores[_prediction_name(scores)]
    np.savez(os.path.join(out_dir, "expected_scores.npz"),
             **{k: np.asarray(pred[k]) for k in PRED_KEYS})


# --------------------------------------------------------------------------- #
# (b) the committed fixture                                                   #
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def expected():
    with np.load(os.path.join(FIXTURE, "expected_scores.npz")) as z:
        return {k: z[k] for k in PRED_KEYS}


@pytest.fixture(scope="module")
def port_model():
    from transmogrifai_tpu_torch import load_model
    return load_model(FIXTURE, device="cpu")


@pytest.fixture(scope="module")
def port_ds():
    from transmogrifai_tpu_torch import Dataset
    return Dataset.from_csv(TITANIC)


def test_jax_package_reproduces_fixture_scores(expected):
    """Guards the fixture: the JAX package's own load + score_compiled
    gives the committed scores (atol 1e-6: the same program on the same
    kind of CPU)."""
    # the JAX package's load does not import the SanityChecker module
    # itself, so a process that did not train must import it first
    import transmogrifai_tpu.automl.sanity_checker  # noqa: F401
    from transmogrifai_tpu.data import Dataset
    from transmogrifai_tpu.workflow.serialization import load_model

    model = load_model(FIXTURE)
    scores = model.score_compiled(Dataset.from_csv(TITANIC))
    got = _host(scores[_prediction_name(scores)])
    for k in PRED_KEYS:
        np.testing.assert_allclose(got[k], expected[k], rtol=0, atol=1e-6)


def test_fixture_is_the_full_width_quickstart_model(port_model):
    from transmogrifai_tpu_torch.workflow.compiled import CompiledScorer

    gbt = [s for s in port_model.fitted.values()
           if type(s).__name__ == "GBTClassificationModel"]
    assert len(gbt) == 1
    assert gbt[0].edges.shape == (496, 31)
    assert gbt[0].trees["feat"].shape == (200, 10, 1024)
    assert gbt[0].trees["leaf"].shape == (200, 1024, 1)
    scorer = CompiledScorer(port_model)
    assert scorer.fusable
    assert [s.operation_name for s in scorer.device_stages] == [
        "IntegralVectorizerModel", "RealVectorizerModel", "SmartTextModel",
        "VectorsCombiner", "SanityCheckerModel", "GBTClassificationModel"]


def test_port_scores_match_jax_fixture(port_model, port_ds, expected):
    scores = port_model.score_compiled(port_ds)
    got = _host(scores[_prediction_name(scores)])
    assert got["probability"].shape == (891, 2)
    assert_gbt_close(got, expected)


def test_port_eager_score_equals_compiled(port_model, port_ds):
    eager = port_model.score(port_ds)
    compiled = port_model.score_compiled(port_ds)
    name = _prediction_name(compiled)
    got = _host(compiled[name])
    for k in PRED_KEYS:
        np.testing.assert_array_equal(eager[name].data[k], got[k])


def test_feature_matrices_match_jax_exactly(port_model, port_ds):
    """The combined (1048) and kept (496) vectors equal the JAX
    package's, element for element."""
    # the JAX package's load does not import the SanityChecker module
    # itself, so a process that did not train must import it first
    import transmogrifai_tpu.automl.sanity_checker  # noqa: F401
    from transmogrifai_tpu.data import Dataset
    from transmogrifai_tpu.workflow.serialization import load_model

    jax_cols = load_model(FIXTURE).score(
        Dataset.from_csv(TITANIC), keep_intermediate=True)
    port_cols = port_model.score(port_ds, keep_intermediate=True)
    widths = set()
    for uid, col in port_cols.items():
        if col.kind == "vector":
            np.testing.assert_array_equal(col.data,
                                          np.asarray(jax_cols[uid].data))
            widths.add(col.data.shape[1])
    assert {496, 1048} <= widths


def test_hashing_matches_jax_bit_for_bit():
    from transmogrifai_tpu.ops import text as jtext
    from transmogrifai_tpu_torch.ops import text as ptext

    values = np.array(["Braund, Mr. Owen Harris", None, "", "O'Brien-Smith",
                       "東京都 Tōkyō", "مُحَمَّد", "a_b c__d 123", "ÀÉÎ õü"],
                      dtype=object)
    for seed in (0, 42, 7):
        want = jtext._hash_counts(values, jtext.TokenHasher(512, seed),
                                  False, False)
        got = ptext._hash_counts(values, ptext.TokenHasher(512, seed), False)
        np.testing.assert_array_equal(got, want)
        for tok in ("mr", "東京", "x" * 13):
            assert ptext.murmur3_32(tok.encode(), seed) == \
                jtext.murmur3_32(tok.encode(), seed)


# --------------------------------------------------------------------------- #
# (c) quick end-to-end parity through save/load                               #
# --------------------------------------------------------------------------- #

def _train_save_score(tmp_path, models):
    import transmogrifai_tpu  # noqa: F401
    model, ds = _quickstart(models, cross_validation=False)
    path = str(tmp_path / "model")
    model.save(path)
    scores = model.score_compiled(ds)
    return path, _host(scores[_prediction_name(scores)])


def _port_scores(path):
    from transmogrifai_tpu_torch import Dataset, load_model
    scores = load_model(path, device="cpu").score_compiled(
        Dataset.from_csv(TITANIC))
    return _host(scores[_prediction_name(scores)])


def test_quick_xgb_parity_through_save_load(tmp_path):
    from transmogrifai_tpu.models import OpXGBoostClassifier
    path, want = _train_save_score(tmp_path, [(OpXGBoostClassifier(
        n_estimators=5, max_depth=3), [{"min_child_weight": 1.0}])])
    assert_gbt_close(_port_scores(path), want)


def test_quick_logistic_parity_through_save_load(tmp_path):
    from transmogrifai_tpu.models import OpLogisticRegression
    path, want = _train_save_score(tmp_path, [(OpLogisticRegression(
        max_iter=20), [{"reg_param": 0.01}])])
    got = _port_scores(path)
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=1e-5)
    logits = want["rawPrediction"]
    decided = np.abs(logits[:, 1] - logits[:, 0]) > 1e-4
    np.testing.assert_array_equal(got["prediction"][decided],
                                  want["prediction"][decided])


def test_from_jax_params_carries_fitted_models_across():
    """In-memory carry-over: a JAX model's `get_params()` rebuilds the
    port's stage, which predicts the same on the same matrix."""
    from transmogrifai_tpu.models.logistic import (
        LogisticRegressionModel as JaxLR)
    from transmogrifai_tpu.models.trees import (
        ForestClassificationModel as JaxForest,
        GBTClassificationModel as JaxGBT)
    from transmogrifai_tpu_torch import from_jax_params

    rng = np.random.default_rng(3)
    n, d, depth, n_trees = 97, 11, 3, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    edges = np.sort(rng.normal(size=(d, 7)), axis=1).astype(np.float32)
    trees = {
        "feat": rng.integers(0, d, (n_trees, depth, 2 ** depth)).astype(
            np.int32),
        "bin": rng.integers(0, 9, (n_trees, depth, 2 ** depth)).astype(
            np.int32),
    }
    cases = [
        JaxGBT(edges, dict(trees, leaf=rng.normal(
            size=(n_trees, 2 ** depth, 1)).astype(np.float32)), 0.3),
        JaxForest(edges, dict(trees, leaf=rng.random(
            (n_trees, 2 ** depth, 3)).astype(np.float32))),
        JaxLR(rng.normal(size=(d, 2)), rng.normal(size=2)),
    ]
    for jax_model in cases:
        want = _host(jax_model.predict_arrays(X))
        port = from_jax_params(type(jax_model).__name__,
                               jax_model.get_params())
        got = _host(port.predict(port.device_constants("cpu"),
                                 torch.from_numpy(X)))
        for k in PRED_KEYS:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-5)


def test_unported_stage_class_raises_and_names_itself():
    from transmogrifai_tpu_torch import from_jax_params
    with pytest.raises(KeyError, match="MinVarianceFilter"):
        from_jax_params("MinVarianceFilter", {"min_variance": 1e-5})


# --------------------------------------------------------------------------- #
# (d) the scoring service                                                     #
# --------------------------------------------------------------------------- #

def test_scoring_service_answers_equal_score_compiled(port_model, port_ds):
    """Mixed request sizes on both wires. rawPrediction and prediction are
    equal; probability within 1e-6, because torch's CPU sigmoid takes a
    vectorized path for full SIMD chunks and a scalar path for the rest,
    which can differ in the last ulp by the row's place in the batch."""
    from transmogrifai_tpu_torch.serving import (
        ScoreError, ScoringService, ServingConfig)

    ref = _host(port_model.score_compiled(port_ds)[
        _prediction_name(port_model.score_compiled(port_ds))])
    svc = ScoringService.from_path(FIXTURE, ServingConfig(max_batch=64),
                                   device="cpu").start()
    try:
        rows = port_ds.to_rows()
        off = 0
        for size in (1, 3, 17, 64, 2, 33):
            res = svc.score([dict(r) for r in rows[off:off + size]])
            got = res.outputs[_prediction_name(res.outputs)]
            np.testing.assert_array_equal(
                got["rawPrediction"], ref["rawPrediction"][off:off + size])
            np.testing.assert_array_equal(
                got["prediction"], ref["prediction"][off:off + size])
            np.testing.assert_allclose(
                got["probability"], ref["probability"][off:off + size],
                rtol=0, atol=1e-6)
            off += size
        cols = {k: [r[k] for r in rows[:9]] for k in rows[0]
                if k != "survived"}
        res = svc.score_columns(cols)
        got = res.outputs[_prediction_name(res.outputs)]
        np.testing.assert_array_equal(got["rawPrediction"],
                                      ref["rawPrediction"][:9])
        with pytest.raises(ScoreError, match="exceeds the largest bucket"):
            svc.score([dict(rows[0])] * 65)
        with pytest.raises(ScoreError, match="unknown columns"):
            svc.score_columns({"nope": [1]})
        with pytest.raises(ScoreError, match="deadline_ms must be a number"):
            svc.score([dict(rows[0])], deadline_ms="soon")
        health = svc.health()
        assert health["status"] == "ok"
        assert health["rows"] == 1 + 3 + 17 + 64 + 2 + 33 + 9
    finally:
        svc.stop()
    assert svc.health()["status"] == "down"


def test_scoring_service_fails_a_bad_request_alone(port_model, port_ds):
    """A request the scorer cannot take (a predictor column missing) fails
    with `internal`; requests batched with it still get their answers."""
    import threading
    from transmogrifai_tpu_torch.serving import (
        ScoreError, ScoringService, ServingConfig)

    svc = ScoringService(port_model, ServingConfig(
        max_batch=8, batch_wait_ms=50.0)).start()
    rows = port_ds.to_rows()
    bad = {k: v for k, v in rows[0].items() if k != "name"}
    results = {}

    def call(key, payload):
        try:
            results[key] = svc.score(payload)
        except ScoreError as e:
            results[key] = e

    try:
        threads = [threading.Thread(target=call, args=("bad", [bad])),
                   threading.Thread(target=call, args=(
                       "good", [dict(r) for r in rows[:3]]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        svc.stop()
    assert isinstance(results["bad"], ScoreError)
    assert results["bad"].code == "internal"
    good = results["good"].outputs
    assert good[_prediction_name(good)]["probability"].shape == (3, 2)


# --------------------------------------------------------------------------- #
# (e) the port imports nothing of JAX, (f) no silent CPU                      #
# --------------------------------------------------------------------------- #

def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter (this process already imported jax via
    tests/conftest.py): import every module of the port, then check
    sys.modules."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import transmogrifai_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'transmogrifai_tpu' or m.startswith('transmogrifai_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_have_no_jax_imports():
    import re
    pat = re.compile(
        r"^\s*(from|import)\s+(jax|transmogrifai_tpu)(\.|\s|$)", re.M)
    root = os.path.join(REPO, "transmogrifai_tpu_torch")
    hits = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    hits += [f"{path}: {m.group(0).strip()}"
                             for m in pat.finditer(fh.read())]
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        hits += [f"chip_smoke.py: {m.group(0).strip()}"
                 for m in pat.finditer(fh.read())]
    assert not hits, hits


def test_stage_registries_are_separate():
    from transmogrifai_tpu.stages.base import StageRegistry as JaxRegistry
    from transmogrifai_tpu_torch.stages.base import StageRegistry
    from transmogrifai_tpu_torch.workflow.serialization import (
        _ensure_stage_library)
    import transmogrifai_tpu.models.trees  # noqa: F401

    _ensure_stage_library()
    port_cls = StageRegistry.get("GBTClassificationModel")
    jax_cls = JaxRegistry.get("GBTClassificationModel")
    assert port_cls is not jax_cls
    assert port_cls.__module__.startswith("transmogrifai_tpu_torch.")
    assert jax_cls.__module__.startswith("transmogrifai_tpu.")


def test_entry_points_raise_without_cuda(monkeypatch):
    from transmogrifai_tpu_torch import WorkflowModel, load_model
    from transmogrifai_tpu_torch.serving import ScoringService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(FIXTURE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScoringService.from_path(FIXTURE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WorkflowModel([], {})


def test_load_refuses_a_corrupted_model(tmp_path):
    import shutil
    from transmogrifai_tpu_torch import load_model
    from transmogrifai_tpu_torch.workflow import ModelIntegrityError

    bad = tmp_path / "m"
    shutil.copytree(FIXTURE, bad)
    with open(bad / "arrays.npz", "r+b") as fh:
        fh.seek(100)
        byte = fh.read(1)
        fh.seek(100)
        fh.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ModelIntegrityError, match="checksum"):
        load_model(str(bad), device="cpu")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    os.environ["TRANSMOGRIFAI_PERF_MODEL"] = "0"
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    generate_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
