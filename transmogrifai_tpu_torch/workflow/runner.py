"""WorkflowRunner: the train / score / features / evaluate run types.

The port's counterpart of the JAX package's `workflow/runner.py`
(`OpWorkflowRunner.scala:296-440` run-type dispatch driven by OpParams,
`OpApp.scala` the application shell). A run opens its root span
(``run:<type>``), an event log beside `trace_location` when one is given,
a `RunProfile` of its phases and a goodput report of its trace, and
writes the Chrome trace where `trace_location` asks and its result where
`metrics_location` asks.

Scores and features are written as CSV (`scores.csv`, `features.csv`,
floats in their shortest round-trip form), where the JAX package writes
parquet: the GPU machine has no pyarrow. The `streaming-score` and
`serve` run types are refused by name: they need `obs/metrics.Histogram`
and `serving/http.py` (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import csv
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.data.dataset import Dataset
from transmogrifai_tpu_torch.device import DeviceLike
from transmogrifai_tpu_torch.obs import export as obs_export
from transmogrifai_tpu_torch.obs import goodput as obs_goodput
from transmogrifai_tpu_torch.obs.trace import TRACER, new_run_id
from transmogrifai_tpu_torch.utils import profiling
from transmogrifai_tpu_torch.utils.profiling import RunProfile
from transmogrifai_tpu_torch.workflow.params import (
    OpParams, ReaderParams)
from transmogrifai_tpu_torch.workflow.workflow import Workflow, WorkflowModel

log = logging.getLogger(__name__)

RUN_TYPES = ("train", "score", "streaming-score", "features", "evaluate",
             "serve")
SERVING_REFUSAL = ("the {} run type is not ported yet: it needs "
                   "obs/metrics.Histogram and serving/http.py (ROADMAP.md "
                   "queue 1, item 10)")


@dataclass
class RunResult:
    """OpWorkflowRunnerResult analogue."""

    run_type: str
    metrics: Dict[str, Any] = field(default_factory=dict)
    model_location: Optional[str] = None
    write_location: Optional[str] = None
    profile: Optional[Dict[str, Any]] = None
    batches: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {"run_type": self.run_type, "metrics": self.metrics,
                "model_location": self.model_location,
                "write_location": self.write_location,
                "profile": self.profile, "batches": self.batches}


def _reader_from_params(rp: ReaderParams):
    from transmogrifai_tpu_torch.readers import DataReaders
    if rp.format == "csv":
        return DataReaders.csv(rp.path, key_column=rp.key_column)
    if rp.format == "parquet":
        return DataReaders.parquet(rp.path, key_column=rp.key_column)
    if rp.format == "stream":
        if rp.path and rp.path.endswith(".parquet"):
            return DataReaders.stream(parquet_path=rp.path,
                                      batch_size=rp.batch_size)
        return DataReaders.stream(csv_path=rp.path, batch_size=rp.batch_size)
    raise ValueError(f"Unknown reader format {rp.format!r}")


class WorkflowRunner:
    """Dispatch a workflow run: the workflow, its train / score /
    evaluation readers, an evaluator and the features that wire scoring
    outputs (OpWorkflowRunner.scala:70-131). Runs train and score on
    `device` (default CUDA; raises without it unless ``device="cpu"``)."""

    def __init__(self, workflow: Workflow, train_reader=None,
                 score_reader=None, evaluation_reader=None, evaluator=None,
                 label_feature=None, prediction_feature=None,
                 device: DeviceLike = "cuda"):
        self.workflow = workflow
        self.train_reader = train_reader
        self.score_reader = score_reader
        self.evaluation_reader = evaluation_reader
        self.evaluator = evaluator
        self.label_feature = label_feature
        self.prediction_feature = prediction_feature
        self.device = device
        self._end_handlers: List = []

    def add_application_end_handler(self, fn) -> "WorkflowRunner":
        """Callback receiving the RunProfile when a run finishes
        (OpWorkflowRunner.addApplicationEndHandler)."""
        self._end_handlers.append(fn)
        return self

    def run(self, run_type: str, params: OpParams) -> RunResult:
        if run_type not in RUN_TYPES:
            raise ValueError(
                f"run_type must be one of {RUN_TYPES}, got {run_type!r}")
        if run_type in ("streaming-score", "serve"):
            raise NotImplementedError(SERVING_REFUSAL.format(run_type))
        log.info("Assuming OP params: %s", json.dumps(params.to_json()))
        run_id = new_run_id()
        profile = RunProfile(run_type=run_type,
                             custom_tag_name=params.custom_tag_name,
                             custom_tag_value=params.custom_tag_value,
                             run_id=run_id)
        self.workflow.set_parameters(params)
        dispatch = {"train": self._train, "score": self._score,
                    "features": self._features, "evaluate": self._evaluate}
        event_log = None
        if params.trace_location:
            event_log = obs_export.EventLog(
                params.trace_location + ".events.jsonl", run_id=run_id)
            obs_export.install_event_log(event_log)
            obs_export.emit_event("run_start", run_type=run_type)
        try:
            # trace_id=run_id: the trace, the profile and the event log
            # share one correlation id
            with TRACER.span(f"run:{run_type}", category="run",
                             new_trace=True, trace_id=run_id,
                             run_id=run_id, run_type=run_type) as root:
                result = dispatch[run_type](params, profile)
        finally:
            if event_log is not None:
                obs_export.emit_event("run_end")
                obs_export.uninstall_event_log(event_log)
                event_log.close()
        spans = TRACER.trace_spans(root.trace_id)
        profile.goodput = obs_goodput.build_report(root, spans).to_json()
        result.profile = profile.to_json()
        if params.trace_location:
            obs_export.write_chrome_trace(params.trace_location, spans)
            log.info("trace written to %s (%d spans, run %s)",
                     params.trace_location, len(spans), run_id)
        if params.metrics_location:
            os.makedirs(params.metrics_location, exist_ok=True)
            with open(os.path.join(params.metrics_location,
                                   f"{run_type}-metrics.json"), "w") as f:
                json.dump(result.to_json(), f, indent=2, default=str)
        if params.log_stage_metrics:
            log.info("%s", profile.pretty())
        for fn in self._end_handlers:
            fn(profile)
        return result

    def _resolve_reader(self, default, params: OpParams, name: str,
                        model: Optional[WorkflowModel] = None):
        rp = params.reader_params.get(name)
        if rp is not None and rp.path:
            reader = _reader_from_params(rp)
        elif default is None:
            raise ValueError(
                f"Run requires a {name!r} reader: construct the runner with "
                f"one or put reader_params[{name!r}].path in the params")
        else:
            reader = default
        if model is not None:
            _ensure_schema(reader, model)
        return reader

    def _train(self, params: OpParams, profile: RunProfile) -> RunResult:
        reader = self._resolve_reader(self.train_reader, params, "train")
        with profile.phase(profiling.DATA_READING):
            ds = reader.read(self.workflow._raw_features())
        # mesh params: build the (sweep, data) device mesh so selector
        # sweeps run the distributed work-stealing scheduler
        mesh = (params.mesh.build(self.device) if params.mesh is not None
                else None)
        with profile.phase(profiling.TRAINING, n_rows=len(ds)):
            model = self.workflow.set_input_dataset(ds).train(
                device=self.device, mesh=mesh)
        metrics: Dict[str, Any] = {}
        if self.prediction_feature is not None:
            fitted = model.fitted.get(self.prediction_feature.origin_stage.uid)
            summary = getattr(fitted, "summary", None)
            if summary is not None:
                metrics = {"train": summary.train_metrics,
                           "holdout": summary.holdout_metrics,
                           "best_model": summary.best_model,
                           "best_grid": summary.best_grid}
        loc = params.model_location
        if loc:
            model.save(loc)
        return RunResult("train", metrics=metrics, model_location=loc)

    def _load_model(self, params: OpParams) -> WorkflowModel:
        from transmogrifai_tpu_torch.workflow.serialization import load_model
        if not params.model_location:
            raise ValueError("model_location required")
        # custom_params["verify_model"]: false skips the integrity check
        # (artifacts saved before integrity manifests existed)
        verify = bool(params.custom_params.get("verify_model", True))
        return load_model(params.model_location, device=self.device,
                          verify=verify)

    def _score(self, params: OpParams, profile: RunProfile) -> RunResult:
        model = self._load_model(params)
        reader = self._resolve_reader(self.score_reader, params, "score",
                                      model=model)
        with profile.phase(profiling.DATA_READING):
            ds = reader.read([f for f in model.result_features])
        with profile.phase(profiling.SCORING, n_rows=len(ds)):
            scores = host_scores(model.score_compiled(ds))
        loc = params.write_location
        if loc:
            os.makedirs(loc, exist_ok=True)
            write_scores(scores, os.path.join(loc, "scores.csv"))
        metrics: Dict[str, Any] = {"n_rows": len(ds)}
        if self.evaluator is not None and self.label_feature is not None \
                and self.prediction_feature is not None:
            with profile.phase(profiling.EVALUATION):
                try:
                    label_col = self.label_feature.origin_stage.materialize(ds)
                except KeyError:
                    # scoring data without the label column: the scores
                    # are written, the evaluation is skipped
                    log.info("score: label column absent, skipping "
                             "evaluation")
                else:
                    metrics["evaluation"] = self._eval_scores(
                        model, ds, scores, label_col)
        return RunResult("score", metrics=metrics, write_location=loc)

    def _features(self, params: OpParams, profile: RunProfile) -> RunResult:
        """Materialize and write the result features' vector columns
        (the computeFeatures run type)."""
        model = self._load_model(params)
        reader = self._resolve_reader(self.score_reader, params, "score",
                                      model=model)
        with profile.phase(profiling.DATA_READING):
            ds = reader.read([f for f in model.result_features])
        with profile.phase(profiling.FEATURE_ENG, n_rows=len(ds)):
            columns = model.score(ds, keep_intermediate=True)
        loc = params.write_location
        if loc:
            os.makedirs(loc, exist_ok=True)
            arrays: Dict[str, np.ndarray] = {}
            for f in model.result_features:
                col = columns[f.uid]
                if col.kind == "vector":
                    arr = np.asarray(col.data)
                    for j in range(arr.shape[1]):
                        arrays[f"{f.name}_{j}"] = arr[:, j].astype(np.float64)
            write_columns(arrays, os.path.join(loc, "features.csv"))
        return RunResult("features", metrics={"n_rows": len(ds)},
                         write_location=loc)

    def _evaluate(self, params: OpParams, profile: RunProfile) -> RunResult:
        if self.evaluator is None or self.label_feature is None or \
                self.prediction_feature is None:
            raise ValueError(
                "evaluate requires evaluator + label_feature + "
                "prediction_feature on the runner")
        model = self._load_model(params)
        reader = self._resolve_reader(
            self.evaluation_reader or self.score_reader, params,
            "evaluation", model=model)
        with profile.phase(profiling.DATA_READING):
            ds = reader.read([f for f in model.result_features])
        with profile.phase(profiling.EVALUATION, n_rows=len(ds)):
            scores = host_scores(model.score_compiled(ds))
            metrics = self._eval_scores(model, ds, scores)
        loc = params.write_location
        if loc:
            os.makedirs(loc, exist_ok=True)
            write_scores(scores, os.path.join(loc, "scores.csv"))
        return RunResult("evaluate", metrics=metrics, write_location=loc)

    def _eval_scores(self, model: WorkflowModel, ds: Dataset,
                     scores: Dict[str, Any], label_col=None
                     ) -> Dict[str, Any]:
        if label_col is None:
            label_col = self.label_feature.origin_stage.materialize(ds)
        # the prediction by the LOADED model's graph: derived feature
        # names embed process-local uid counters, so the rebuilt app
        # graph's name need not match the saved one
        pred_name = next(
            (f.name for f in model.result_features
             if issubclass(f.ftype, T.Prediction)),
            self.prediction_feature.name)
        pcol = Column(T.Prediction, dict(scores[pred_name]))
        m = self.evaluator.evaluate(label_col, pcol).to_json()
        return {k: v for k, v in m.items() if not isinstance(v, list)}


def _ensure_schema(reader, model: WorkflowModel) -> None:
    """Schema-less file readers infer types that can clash with the
    model's raw feature types (integer-looking PickLists); give them the
    model's own raw schema (DataReader.scala:221-259)."""
    schema = {}
    for rf in model.result_features:
        for f in rf.raw_features():
            schema[f.name] = f.ftype
    for attr in ("_schema", "schema"):
        if hasattr(reader, attr) and getattr(reader, attr) is None:
            setattr(reader, attr, schema)
            break


def host_scores(scores: Dict[str, Any]) -> Dict[str, Any]:
    """`score_compiled`'s output with every tensor moved to host numpy."""
    def host(v):
        if isinstance(v, dict):
            return {k: host(a) for k, a in v.items()}
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return v
    return {name: host(v) for name, v in scores.items()}


def score_columns(scores: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Flatten result features into named float64 / text columns, as the
    JAX package's `_write_scores` does: a prediction into
    `<name>_prediction` and `<name>_probability_<j>`, a scalar into its
    value with NaN where masked, a vector into `<name>_<j>`."""
    arrays: Dict[str, np.ndarray] = {}
    for name, v in scores.items():
        if isinstance(v, dict) and "prediction" in v:
            arrays[f"{name}_prediction"] = np.asarray(
                v["prediction"], dtype=np.float64)
            prob = np.asarray(v["probability"])
            if prob.ndim == 2:
                for j in range(prob.shape[1]):
                    arrays[f"{name}_probability_{j}"] = prob[:, j].astype(
                        np.float64)
        elif isinstance(v, dict) and "value" in v:
            val = np.asarray(v["value"], dtype=np.float64).copy()
            val[~np.asarray(v["mask"]).astype(bool)] = np.nan
            arrays[name] = val
        else:
            arr = np.asarray(v)
            if arr.dtype == object:
                arrays[name] = np.array(
                    [None if x is None else str(x) for x in arr],
                    dtype=object)
            elif arr.ndim == 1:
                arrays[name] = arr.astype(np.float64)
            else:
                for j in range(arr.shape[1]):
                    arrays[f"{name}_{j}"] = arr[:, j].astype(np.float64)
    return arrays


def write_columns(arrays: Dict[str, np.ndarray], path: str) -> None:
    """Named columns as a headered CSV: floats in their shortest
    round-trip form (`repr`), NaN and None as empty cells."""
    names = list(arrays)
    n = len(next(iter(arrays.values()))) if arrays else 0

    def cell(x) -> str:
        if x is None:
            return ""
        if isinstance(x, (float, np.floating)):
            return "" if np.isnan(x) else repr(float(x))
        return str(x)

    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(names)
        for i in range(n):
            w.writerow([cell(arrays[k][i]) for k in names])


def write_scores(scores: Dict[str, Any], path: str) -> None:
    """Host scores (`host_scores`) flattened by `score_columns` into a
    CSV file (the saveScores analogue)."""
    write_columns(score_columns(scores), path)
