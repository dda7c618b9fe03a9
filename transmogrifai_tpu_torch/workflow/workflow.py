"""Workflow (train) and WorkflowModel (score, save).

The port's counterpart of the JAX package's `workflow/workflow.py`.
`Workflow.train` materializes the raw features, then fits the feature DAG
layer by layer on a private copy: each estimator fits on its inputs'
columns and its fitted model transforms them for the next layer. A
RawFeatureFilter (`with_raw_feature_filter`) first drops unhealthy raw
features and rewires the DAG around them; workflow-level CV
(`with_workflow_cv`) refits the estimators that feed a ModelSelector
inside each of its folds. `train` returns a `WorkflowModel`, whose `score` walks the fitted DAG eagerly and
whose `score_compiled` runs the planned scorer (`workflow/compiled.py`),
and whose `save` writes the JAX package's on-disk format.
"""

from __future__ import annotations

import logging
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch.data.columns import SCALAR, VECTOR, Column
from transmogrifai_tpu_torch.data.dataset import Dataset
from transmogrifai_tpu_torch.device import DeviceLike, resolve_device
from transmogrifai_tpu_torch.features.dag import (
    clone_graph, rewire_without, topological_layers)
from transmogrifai_tpu_torch.models.base import WARM_STARTS
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FeatureGeneratorStage, FitContext, Transformer,
    is_host_stage)

log = logging.getLogger(__name__)


class Workflow:
    """Declarative workflow: wire result features, then `train()`."""

    def __init__(self):
        self.result_features: Tuple = ()
        self._dataset: Optional[Dataset] = None
        self.parameters: Dict[str, Any] = {}
        self._rff = None
        self._rff_score_dataset: Optional[Dataset] = None
        self.blocklist: List[str] = []
        self._workflow_cv = False

    def set_result_features(self, *features) -> "Workflow":
        self.result_features = tuple(features)
        return self

    def set_input_dataset(self, dataset: Dataset) -> "Workflow":
        self._dataset = dataset
        return self

    def set_parameters(self, params) -> "Workflow":
        """Workflow parameters; none is ported yet, so any parameter
        raises at train time."""
        self.parameters = dict(params)
        return self

    def with_workflow_cv(self) -> "Workflow":
        """Move the feature DAG before each ModelSelector inside its CV
        folds: the estimators feeding the selector's vector refit on each
        fold's training rows, so fold-global statistics (supervised
        buckets, sanity-check selections) cannot leak into validation
        metrics."""
        self._workflow_cv = True
        return self

    def with_raw_feature_filter(self, score_dataset: Optional[Dataset] = None,
                                score_reader=None,
                                **rff_params) -> "Workflow":
        """Run a RawFeatureFilter (`rff_params` are its arguments) before
        training: raw features whose train (and, given `score_dataset`,
        score) distributions fail its rules are dropped, and the DAG is
        rewired around them."""
        from transmogrifai_tpu_torch.automl.raw_feature_filter import (
            RawFeatureFilter)
        if score_reader is not None:
            raise NotImplementedError(
                "with_raw_feature_filter(score_reader=...): readers are not "
                "ported yet (ROADMAP.md, queue 1, item 2); pass "
                "score_dataset")
        self._rff = RawFeatureFilter(**rff_params)
        self._rff_score_dataset = score_dataset
        return self

    def with_model_stages(self, *args, **kwargs) -> "Workflow":
        raise NotImplementedError(
            "warm starts (with_model_stages) are not ported yet "
            f"(ROADMAP.md, {WARM_STARTS})")

    def train(self, dataset: Optional[Dataset] = None, seed: int = 42,
              device: DeviceLike = "cuda") -> "WorkflowModel":
        """Materialize raw features, then fit the DAG layer by layer on
        `device` (default CUDA; raises without it unless
        ``device="cpu"``). The returned model scores on the same device
        and carries `stage_seconds`: (stage, seconds) per fitted stage,
        fit and transform together."""
        dev = resolve_device(device)
        if not self.result_features:
            raise RuntimeError("set_result_features before train()")
        if self.parameters:
            raise NotImplementedError(
                f"workflow parameters {sorted(self.parameters)} are not "
                "ported yet (stage_params, sweep checkpoints and the rest: "
                "ROADMAP.md, queue 1: selector and workflow completeness "
                "and the sweep journal)")
        ds = dataset if dataset is not None else self._dataset
        if ds is None:
            raise RuntimeError(
                "No input data: call set_input_dataset or pass a dataset "
                "to train()")
        rff_results = None
        source_features = self.result_features
        if self._rff is not None:
            ds, source_features, rff_results = self._apply_rff(ds)
        result_features = clone_graph(source_features)
        layers = topological_layers(result_features)
        ctx = FitContext(n_rows=len(ds), seed=seed, device=dev)
        columns: Dict[str, Column] = {}
        fitted: Dict[str, Transformer] = {}
        stage_seconds: List[Tuple[str, float]] = []
        t0 = time.perf_counter()
        for gen in layers[0] if layers else []:
            if not isinstance(gen, FeatureGeneratorStage):
                raise TypeError(
                    f"Layer-0 stage {gen!r} is not a feature generator")
            columns[gen.get_output().uid] = gen.materialize(ds)
        stage_seconds.append(("materialize", time.perf_counter() - t0))
        for li, layer in enumerate(layers[1:], start=1):
            for stage in layer:
                t0 = time.perf_counter()
                inputs = [columns[f.uid] for f in stage.input_features]
                est = getattr(stage, "_estimator", None) or stage
                if isinstance(est, Estimator):
                    stage_ctx = ctx.child(li)
                    if self._workflow_cv and _is_selector(est):
                        stage_ctx.cv_refit = _make_cv_refit(
                            stage, layers, columns, ctx)
                    model = est.fit(inputs, stage_ctx)
                    fitted[est.uid] = model
                    out = model.transform(inputs, dev)
                elif isinstance(stage, Transformer):
                    fitted[stage.uid] = stage
                    out = stage.transform(inputs, dev)
                else:
                    raise TypeError(f"Cannot execute stage {stage!r}")
                columns[stage.get_output().uid] = out
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                stage_seconds.append((stage.operation_name,
                                      time.perf_counter() - t0))
        model = WorkflowModel(result_features=result_features, fitted=fitted,
                              device=dev)
        model.stage_seconds = stage_seconds
        model.train_columns = columns
        model.rff_results = rff_results
        model.blocklist = list(self.blocklist)
        model.quant_calibration = capture_quant_calibration(
            result_features, fitted, columns)
        return model

    def _raw_features(self) -> List:
        seen: Dict[str, Any] = {}
        for f in self.result_features:
            for r in f.raw_features():
                seen.setdefault(r.uid, r)
        return list(seen.values())

    def _apply_rff(self, ds: Dataset):
        """Run the RawFeatureFilter and rewire the DAG around the raw
        features it drops (they become `blocklist`). A result feature
        that can no longer be produced raises, as in the JAX package."""
        raws = self._raw_features()
        label = next((f for f in raws if f.is_response), None)
        filtered = self._rff.generate_filtered_raw(
            ds, raws, score_dataset=self._rff_score_dataset,
            label_feature=label)
        self.blocklist = list(filtered.features_to_drop)
        if not filtered.features_to_drop:
            return (filtered.clean_dataset, self.result_features,
                    filtered.results)
        survived, dropped = rewire_without(
            self.result_features, filtered.features_to_drop)
        if dropped:
            raise RuntimeError(
                f"RawFeatureFilter removed raw features "
                f"{filtered.features_to_drop} making result features "
                f"{dropped} unproducible; protect them via "
                f"protected_features or relax thresholds")
        return filtered.clean_dataset, tuple(survived), filtered.results


def _is_selector(est) -> bool:
    from transmogrifai_tpu_torch.selector.model_selector import ModelSelector
    return isinstance(est, ModelSelector)


def _make_cv_refit(selector_stage, layers, columns, ctx: FitContext):
    """Workflow-level CV's refit as a closure: `refit(fold_rows)` refits
    every estimator feeding the selector's feature vector on `fold_rows`
    only, reruns the transformers, and returns the fold's feature matrix
    for all rows (host numpy). The label's subtree is not refit (the
    global pass's columns are reused), so the folds' rows stay aligned.
    A fold model fits with seed `ctx.seed * 1000003 + salt` (salt counting
    the refit stages in layer order) through `fit_model`, so the globally
    fitted model stays in the graph."""
    label_f, vec_f = selector_stage.input_features
    label_uids = {f.uid for f in label_f.traverse()}
    during_stage_uids = {
        f.origin_stage.uid for f in vec_f.traverse()
        if not f.is_raw and f.uid not in label_uids}
    base = dict(columns)  # the global columns materialized so far

    def refit(fold_rows: np.ndarray) -> np.ndarray:
        cols = dict(base)
        salt = 0
        for layer in layers[1:]:
            for stage in layer:
                if (stage is selector_stage
                        or stage.uid not in during_stage_uids):
                    continue
                salt += 1
                ins_full = [cols[f.uid] for f in stage.input_features]
                est = getattr(stage, "_estimator", None) or stage
                if isinstance(est, Estimator):
                    fold_ctx = FitContext(
                        n_rows=len(fold_rows),
                        seed=ctx.seed * 1000003 + salt, device=ctx.device)
                    m = est.fit_model(
                        [c.take(fold_rows) for c in ins_full], fold_ctx)
                    m.uid = est.uid
                    m.input_features = est.input_features
                    out = m.transform(ins_full, ctx.device)
                else:
                    out = stage.transform(ins_full, ctx.device)
                cols[stage.get_output().uid] = out
        return np.asarray(cols[vec_f.uid].data)

    return refit


def capture_quant_calibration(result_features, fitted, columns
                              ) -> Optional[Dict[str, Any]]:
    """Fit-time per-column [lo, hi] ranges for the quantized serving wire
    (the JAX package's `Workflow._capture_quant_calibration`): one entry
    per host-origin device-input column (raw generator outputs and host
    stage outputs, the leaves `quantize_wire` quantizes at serving time).
    A scalar range is extended to include 0.0, since masked slots ride the
    wire as exact 0.0 fills; rows are strided past 262,144 (a vector's
    past 65,536). Returns None when no column has a finite range or the
    capture fails: quantized serving then falls back to batch-relative
    ranges."""
    try:
        host_uids = {f.uid for rf in result_features
                     for f in rf.raw_features()}
        for s in fitted.values():
            if is_host_stage(s):
                host_uids.add(s.get_output().uid)
        cal = {}
        for uid in host_uids:
            col = columns.get(uid)
            if col is None:
                continue
            if col.kind == SCALAR:
                v = np.asarray(col.data["value"], np.float64)
                v = v[np.asarray(col.data["mask"]).astype(bool)]
                if v.size > 262_144:
                    v = v[::v.size // 262_144]
                if v.size == 0:
                    continue
                with np.errstate(invalid="ignore"):
                    fin = v[np.isfinite(v)]
                if fin.size == 0:
                    continue
                cal[uid] = {"lo": [min(float(fin.min()), 0.0)],
                            "hi": [max(float(fin.max()), 0.0)]}
            elif col.kind == VECTOR:
                a = np.asarray(col.data)
                if a.ndim != 2 or a.size == 0:
                    continue
                if a.shape[0] > 65_536:
                    a = a[::a.shape[0] // 65_536]
                with np.errstate(invalid="ignore"), \
                        warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    fin = np.where(np.isfinite(a), a, np.nan)
                    lo = np.nanmin(fin, axis=0)
                    hi = np.nanmax(fin, axis=0)
                lo = np.where(np.isfinite(lo), lo, 0.0)
                hi = np.where(np.isfinite(hi), hi, lo)
                cal[uid] = {"lo": [float(x) for x in lo],
                            "hi": [float(x) for x in hi]}
        return cal or None
    except Exception as e:
        log.warning("quant calibration capture failed (%s: %s); quantized "
                    "serving will use batch-relative ranges",
                    type(e).__name__, e, exc_info=True)
        return None


class WorkflowModel:
    """A fitted workflow: result features, fitted stages by uid, and the
    device it scores on (default CUDA; raises without it unless
    ``device="cpu"``)."""

    def __init__(self, result_features: Sequence,
                 fitted: Dict[str, Transformer],
                 device: DeviceLike = "cuda"):
        self.result_features = tuple(result_features)
        self.fitted = dict(fitted)
        self.device = resolve_device(device)
        self.loaded_from: Optional[str] = None
        self.stage_seconds: List[Tuple[str, float]] = []
        # the training columns by feature uid (set by `Workflow.train`;
        # empty on a loaded model), which `model_insights` reads
        self.train_columns: Dict[str, Column] = {}
        # fit-time quantization ranges, uid -> {"lo": [...], "hi": [...]}
        self.quant_calibration: Optional[Dict[str, Any]] = None
        # the RawFeatureFilterResults when the filter ran, and the raw
        # features it dropped
        self.rff_results = None
        self.blocklist: List[str] = []
        self._compiled = None

    def save(self, path: str, overwrite: bool = True) -> None:
        """Write the model in the JAX package's format (`op-model.json`,
        `arrays.npz`, `integrity.json`), readable by both packages'
        `load_model`."""
        from transmogrifai_tpu_torch.workflow.serialization import save_model
        save_model(self, path, overwrite=overwrite)

    def _execute(self, ds: Dataset) -> Dict[str, Column]:
        """Eager layer-by-layer transform walk."""
        layers = topological_layers(self.result_features)
        columns: Dict[str, Column] = {}
        for gen in layers[0] if layers else []:
            columns[gen.get_output().uid] = gen.materialize(
                ds, allow_missing_response=True)
        for layer in layers[1:]:
            for stage in layer:
                model = self.fitted.get(stage.uid)
                if model is None:
                    raise RuntimeError(
                        f"Stage {stage.operation_name} ({stage.uid}) has no "
                        "fitted model")
                inputs = [columns[f.uid] for f in stage.input_features]
                columns[stage.get_output().uid] = model.transform(
                    inputs, self.device)
        return columns

    def score(self, dataset: Dataset,
              keep_intermediate: bool = False) -> Dict[str, Column]:
        """Eager scoring: {feature_name: host Column} for the result
        features (every feature by uid with `keep_intermediate`)."""
        columns = self._execute(dataset)
        if keep_intermediate:
            return columns
        return {f.name: columns[f.uid] for f in self.result_features}

    def _ensure_compiled(self, quant: Any = None):
        """The model's `CompiledScorer` for quantized mode `quant` (None,
        "int8", "int4", their "-calibrated" variants or a ScoringQuant),
        rebuilt when the mode changes."""
        from transmogrifai_tpu_torch.workflow.compiled import (
            CompiledScorer, ScoringQuant)
        q = ScoringQuant.resolve(quant)
        if self._compiled is None or self._compiled.quant != q:
            self._compiled = CompiledScorer(self, quant=q)
        return self._compiled

    def compiled(self):
        """The model's exact-f32 `CompiledScorer` (built once)."""
        return self._ensure_compiled()

    def score_compiled(self, dataset: Dataset) -> Dict[str, Any]:
        """Planned scoring: {feature_name: tensor pytree on the model's
        device} for the result features."""
        return self.compiled()(dataset)

    def model_insights(self):
        """The merged explanation artifact (ModelInsights.scala:74)."""
        from transmogrifai_tpu_torch.insights import ModelInsights
        return ModelInsights.extract(self)
