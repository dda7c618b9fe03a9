"""Workflow (train) and WorkflowModel (score, save).

The port's counterpart of the JAX package's `workflow/workflow.py`.
`Workflow.train` materializes the raw features, then fits the feature DAG
layer by layer on a private copy: each estimator fits on its inputs'
columns and its fitted model transforms them for the next layer. It
returns a `WorkflowModel`, whose `score` walks the fitted DAG eagerly and
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
    clone_graph, topological_layers)
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
        raise NotImplementedError(
            "workflow-level CV is not ported yet (ROADMAP.md, queue 1: "
            "feature validation at full scope)")

    def with_raw_feature_filter(self, *args, **kwargs) -> "Workflow":
        raise NotImplementedError(
            "RawFeatureFilter is not ported yet (ROADMAP.md, queue 1: "
            "feature validation at full scope)")

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
        result_features = clone_graph(self.result_features)
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
                    model = est.fit(inputs, ctx.child(li))
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
        model.quant_calibration = capture_quant_calibration(
            result_features, fitted, columns)
        return model


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
