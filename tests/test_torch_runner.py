"""Parity of the port's application layer with the JAX package on the CPU:
`OpParams` (`workflow/params.py`), `WorkflowRunner` (`workflow/runner.py`)
and the observability it writes (`obs/trace.py`, `obs/export.py`,
`obs/goodput.py`, `utils/profiling.py`).

- `OpParams` JSON: every block (readers, serving with its fleet block,
  sweep checkpoints, the mesh, the feature cache, the continual loop, the
  cost model) parsed and written back equal to the JAX package's.
- examples/op_titanic_app.py's runner (`chip_smoke.titanic_app_runner`,
  an LR-only selector) through `train`, `score`, `evaluate` and
  `features` in both packages, each run's OpParams read back from its
  own JSON with a `stage_params` override: the override applied in both;
  the best grid equal; holdout, score and evaluate AuPR / AuROC within
  1e-4 (the LR family's tolerance, PERF.md §2); the same RunResult keys,
  profile phases and row counts, goodput categories, and span names
  (past the JAX package's spans of subsystems the port does not have);
  the scores written equal to `score_compiled`'s. Never the times.
- The refused run types and parameters raise, naming their ROADMAP items.
"""

import csv
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from test_torch_multiclass import package, registered_age_group  # noqa: E402

AUC_ATOL = 1e-4

FULL_PARAMS = {
    "stage_params": {"SanityChecker": {"max_correlation": 0.9},
                     "uid_1": {"x": [1, 2]}},
    "reader_params": {"train": {"path": "t.csv", "format": "csv",
                                "key_column": "id", "batch_size": 64,
                                "extra": "kept"},
                      "score": {"path": "s.parquet"}},
    "model_location": "m", "write_location": "w", "metrics_location": "x",
    "trace_location": "t.json", "batch_duration_secs": 5,
    "custom_tag_name": "team", "custom_tag_value": "a",
    "log_stage_metrics": True, "collect_stage_metrics": False,
    "custom_params": {"verify_model": False, "n": 3},
    "serving": {"host": "0.0.0.0", "port": 0, "max_batch": 32,
                "buckets": [1, 8, 32], "quantize": "int8",
                "fleet": {"models": {"a": "p"}}, "tracing": {"enabled": True},
                "slo": {"x": 1}, "autopilot": {"period_s": 1.0}},
    "sweep_checkpoint": {"checkpoint_dir": "c", "fsync": False},
    "mesh": {"n_devices": 4, "sweep": 2},
    "feature_cache": {"dir": "fc", "wire": "int8"},
    "continual": {"window_rows": 1024, "min_window_rows": 64,
                  "psi_threshold": 0.3},
    "perf_model": {"corpus_dir": "p", "min_rows": 4},
}


def params_module(name):
    if name == "jax":
        from transmogrifai_tpu.workflow import params
    else:
        from transmogrifai_tpu_torch.workflow import params
    return params


@pytest.mark.parametrize("which", ["full", "empty", "defaults"])
def test_op_params_json_round_trips_like_jax(which):
    d = {"full": FULL_PARAMS, "empty": {}}.get(which)
    out = []
    for name in ("port", "jax"):
        P = params_module(name).OpParams
        p = P() if d is None else P.from_json(json.loads(json.dumps(d)))
        js = p.to_json()
        again = P.from_json(json.loads(json.dumps(js))).to_json()
        assert again == js
        out.append(json.dumps(js, sort_keys=True))
    assert out[0] == out[1]


def test_op_params_load_and_set_parameters(tmp_path):
    path = tmp_path / "p.json"
    path.write_text(json.dumps(FULL_PARAMS))
    P = params_module("port").OpParams
    p = P.load(str(path))
    assert p.mesh.sweep == 2 and p.feature_cache.policy == "readwrite"
    assert p.serving.to_config().max_batch == 32
    ns = package("port")
    wf = ns.Workflow().set_parameters(p)
    assert wf.parameters == p.to_json()
    assert ns.Workflow().set_parameters({"a": 1}).parameters == {"a": 1}


# --------------------------------------------------------------------------- #
# the runner                                                                  #
# --------------------------------------------------------------------------- #

def app_ns(name):
    ns = package(name)
    if name == "jax":
        from transmogrifai_tpu import evaluators, readers
        from transmogrifai_tpu.workflow import params, runner
        ns.readers, ns.evaluators, ns.params, ns.runner = (
            readers, evaluators, params, runner)
        return ns
    import transmogrifai_tpu_torch as port
    return chip_smoke.app_namespace(port)


def lr_models(ns):
    return [(ns.models.OpLogisticRegression(max_iter=20),
             [{"reg_param": 0.01, "elastic_net_param": 0.1},
              {"reg_param": 0.1, "elastic_net_param": 0.5}])]


def app_run(name, root):
    ns = app_ns(name)
    kw = {} if name == "jax" else {"device": "cpu"}
    runner, survived, pred = chip_smoke.titanic_app_runner(
        ns, lr_models(ns), age_group=registered_age_group(ns), **kw)
    runs = chip_smoke.app_runs(ns, runner, str(root))
    return ns, runs, runner, survived, pred


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    out = {}
    for name in ("port", "jax"):
        root = tmp_path_factory.mktemp(f"app_{name}")
        out[name] = (root,) + app_run(name, root)
    return out


def traces(root, rt):
    with open(os.path.join(root, f"{rt}-trace.json")) as fh:
        return json.load(fh)


# spans only the JAX package opens (subsystems the port does not have)
JAX_ONLY_SPAN_PREFIXES = ("compile:", "retrace:", "ingest:")


@pytest.mark.parametrize("rt", chip_smoke.APP_RUN_TYPES)
def test_run_records_have_the_jax_structure(both_runs, rt):
    proot, _, pruns, *_ = both_runs["port"]
    jroot, _, jruns, *_ = both_runs["jax"]
    pres, jres = pruns[rt][0], jruns[rt][0]
    assert sorted(pres.to_json()) == sorted(jres.to_json())
    pp, jp = pres.profile, jres.profile
    assert sorted(pp) == sorted(jp)
    assert [(ph["name"], ph.get("n_rows")) for ph in pp["phases"]] == \
        [(ph["name"], ph.get("n_rows")) for ph in jp["phases"]]
    assert sorted(pp["goodput"]) == sorted(jp["goodput"])
    assert sorted(pp["goodput"]["buckets"]) == \
        sorted(jp["goodput"]["buckets"])
    assert sorted(pres.metrics) == sorted(jres.metrics)
    from transmogrifai_tpu_torch.obs.export import validate_chrome_trace
    pt, jt = traces(proot, rt), traces(jroot, rt)
    assert validate_chrome_trace(pt) == []
    got = chip_smoke.span_names(pt)
    want = [n for n in chip_smoke.span_names(jt)
            if not n.startswith(JAX_ONLY_SPAN_PREFIXES)]
    assert got == want
    with open(os.path.join(proot, f"{rt}-trace.json.events.jsonl")) as fh:
        kinds = [json.loads(line)["kind"] for line in fh]
    assert kinds == ["run_start", "run_end"]
    with open(os.path.join(proot, "metrics", f"{rt}-metrics.json")) as fh:
        assert json.load(fh)["run_type"] == rt


def test_runs_match_jax_metrics_and_the_override(both_runs):
    _, pns, pruns, prunner, psurv, ppred = both_runs["port"]
    _, jns, jruns, jrunner, jsurv, jpred = both_runs["jax"]
    pt, jt = pruns["train"][0].metrics, jruns["train"][0].metrics
    assert pt["best_model"] == jt["best_model"] == "OpLogisticRegression"
    assert pt["best_grid"] == jt["best_grid"]
    for part in ("train", "holdout"):
        for k in ("AuPR", "AuROC"):
            assert abs(pt[part][k] - jt[part][k]) <= AUC_ATOL, (part, k)
    for rt in ("score", "evaluate"):
        pm, jm = pruns[rt][0].metrics, jruns[rt][0].metrics
        if rt == "score":
            assert pm["n_rows"] == jm["n_rows"] == 891
            pm, jm = pm["evaluation"], jm["evaluation"]
        for k in ("AuPR", "AuROC"):
            assert abs(pm[k] - jm[k]) <= AUC_ATOL, (rt, k)
    # the stage override reached the trained DAG's SanityChecker in both
    for runner in (prunner, jrunner):
        assert runner.workflow.parameters["stage_params"] == \
            chip_smoke.APP_STAGE_PARAMS


def test_override_applies_to_the_cloned_checker(both_runs, tmp_path):
    """`stage_params` reaches the trained copy of the DAG, not the
    caller's graph, in both packages."""
    got = []
    for name in ("port", "jax"):
        ns = app_ns(name)
        kw = {} if name == "jax" else {"device": "cpu"}
        ds, survived, pred = chip_smoke.titanic_simple_pipeline(
            ns, lr_models(ns), age_group=registered_age_group(ns))
        wf = ns.Workflow().set_result_features(pred, survived) \
            .set_input_dataset(ds).set_parameters(
                ns.params.OpParams(stage_params={
                    "SanityChecker": {"max_correlation": 0.05}}))
        model = wf.train(**kw)
        checker = next(s for s in model.fitted.values()
                       if type(s).__name__ == "SanityCheckerModel")
        caller = next(f.origin_stage for f in pred.traverse()
                      if type(f.origin_stage).__name__ == "SanityChecker")
        got.append((len(checker.indices), caller.params["max_correlation"]))
    assert got[0] == got[1]
    assert got[0][1] != 0.05


def test_written_scores_equal_score_compiled(both_runs):
    root, ns, runs, runner, survived, pred = both_runs["port"]
    from transmogrifai_tpu_torch import load_model
    from transmogrifai_tpu_torch.workflow.runner import (
        host_scores, score_columns)
    model = load_model(os.path.join(str(root), "model"), device="cpu")
    ds = ns.Dataset.from_csv(chip_smoke.TITANIC,
                             schema=chip_smoke.titanic_simple_schema(ns.t))
    want = score_columns(host_scores(model.score_compiled(ds)))
    for rt in ("score", "evaluate"):
        with open(os.path.join(str(root), rt, "scores.csv")) as fh:
            rows = list(csv.reader(fh))
        assert rows[0] == list(want)
        for j, name in enumerate(rows[0]):
            col = np.array([float(r[j]) if r[j] else np.nan
                            for r in rows[1:]])
            np.testing.assert_array_equal(col, want[name])
    # the features run writes the result features' vector columns: this
    # app's results are a prediction and a label, so none, as in the JAX
    # package's features.parquet
    import pyarrow.parquet as pq
    jroot = both_runs["jax"][0]
    with open(os.path.join(str(root), "features", "features.csv")) as fh:
        header = next(csv.reader(fh), [])
    assert header == pq.read_table(os.path.join(
        str(jroot), "features", "features.parquet")).column_names


def test_model_evaluate_equals_the_runs_metrics(both_runs):
    """`WorkflowModel.evaluate` on the same rows gives the evaluate run's
    AuPR and AuROC (the eager and the compiled scores agree)."""
    root, ns, runs, runner, survived, pred = both_runs["port"]
    from transmogrifai_tpu_torch import load_model
    model = load_model(os.path.join(str(root), "model"), device="cpu")
    ds = ns.Dataset.from_csv(chip_smoke.TITANIC,
                             schema=chip_smoke.titanic_simple_schema(ns.t))
    label = next(f for f in model.result_features if f.is_response)
    p = next(f for f in model.result_features if not f.is_response)
    m = model.evaluate(ds, ns.evaluators.BinaryClassificationEvaluator(),
                       label, p).to_json()
    for k in ("AuPR", "AuROC", "Error"):
        assert m[k] == pytest.approx(runs["evaluate"][0].metrics[k],
                                     abs=1e-9)


@pytest.mark.parametrize("case,item", [
    ("streaming-score", "item 10"), ("serve", "item 10"),
    ("mesh", "item 9b"), ("sweep_checkpoint", "item 7"),
    ("continual", "item 10"), ("perf_model", "item 10")])
def test_refused_runs_and_parameters_name_their_items(case, item,
                                                      tmp_path):
    """Run types and parameter blocks the port has not ported raise,
    naming their ROADMAP items. Two blocks are ported and run: a mesh with
    a data axis (item 9b: the train sweeps on row shards of a (1, 2) mesh
    and selects the winner of the train without a mesh), and
    `sweep_checkpoint` (item 7: the train runs and journals its sweep)."""
    ns = app_ns("port")
    runner, survived, pred = chip_smoke.titanic_app_runner(
        ns, lr_models(ns), age_group=registered_age_group(ns),
        device="cpu")
    P = ns.params.OpParams
    if case in ("streaming-score", "serve"):
        run_type, params = case, P()
    else:
        block = {"mesh": {"n_devices": 2, "sweep": 1},
                 "sweep_checkpoint": {"checkpoint_dir": str(tmp_path),
                                      "fsync": False},
                 "continual": {"window_rows": 512},
                 "perf_model": {"min_rows": 4}}[case]
        run_type, params = "train", P.from_json({case: block})
    if case == "sweep_checkpoint":
        runner.run(run_type, params)
        assert any(n.endswith(".journal") for n in os.listdir(tmp_path))
        return
    if case == "mesh":
        assert params.mesh.build("cpu").shape == {"sweep": 1, "data": 2}
        sharded = runner.run(run_type, params).metrics
        plain = runner.run(run_type, P()).metrics
        assert (sharded["best_model"], sharded["best_grid"]) == (
            plain["best_model"], plain["best_grid"])
        assert sharded["holdout"]["AuPR"] == pytest.approx(
            plain["holdout"]["AuPR"], rel=2e-4)
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue 1, {item}"):
        runner.run(run_type, params)
